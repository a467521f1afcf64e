"""Multi-host CTR training on one machine — the port's counterpart of the
reference walkthrough ``examples/train_multihost.py``: the launcher and
the TCP global shuffle.

Starts N worker processes through the port's launcher
(``distributed/launch.launch_local``; each sees PBOX_RANK /
PBOX_WORLD_SIZE, like the reference's paddle.distributed.launch ranks),
and each worker:

  1. reads its round-robin shard of the file list,
  2. exchanges records with its peers through the TcpShuffler
     (the PaddleShuffler/ShuffleData role — data_set.cc:2573),
  3. trains DeepFM on its post-shuffle partition and reports AUC, and
  4. all ranks' AUC tables go through the host collective
     (``metrics.auc_compute_global`` over ``TcpCollective``): ONE global
     AUC, the same on every rank.

A host-only job: the workers form no ``torch.distributed`` group. On a
real multi-host cluster the same worker runs once per host with the env
your scheduler provides; only the endpoints change. Every worker trains
on the card unless ``--device cpu``:

    python -m paddlebox_tpu_torch.examples.train_multihost [--workers 2]
        [--rows 4000] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time
from typing import Optional, Sequence

# the workers are stopped, and the run fails, past this many seconds
WORKERS_TIMEOUT_SEC = 600.0


def worker(args) -> None:
    import torch

    from paddlebox_tpu_torch.config import FLAGS
    from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
    from paddlebox_tpu_torch.distributed.collective import TcpCollective
    from paddlebox_tpu_torch.distributed.launch import init_runtime_env
    from paddlebox_tpu_torch.distributed.shuffle import TcpShuffler
    from paddlebox_tpu_torch.metrics import auc_compute_global
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import EmbeddingTable
    from paddlebox_tpu_torch.train.trainer import Trainer

    info = init_runtime_env()
    rank, world = info["rank"], info["world_size"]
    endpoints = os.environ["SHUFFLE_ENDPOINTS"].split(",")

    desc = DataFeedDesc.criteo(batch_size=args.batch_size)
    FLAGS.native_parse = False   # the exchange moves record objects
    ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
    files = sorted(os.path.join(args.data, f)
                   for f in os.listdir(args.data))
    ds.set_filelist(files, shard_by_rank=True)
    ds.load_into_memory()
    loaded = len(ds.records)

    sh = TcpShuffler(rank, world, endpoints, seed=7)
    ds.global_shuffle(sh)        # records route to hash(record) % world
    sh.close()

    table = EmbeddingTable(
        mf_dim=8, capacity=1 << 16,
        cfg=SparseSGDConfig(mf_create_thresholds=0.0), device=args.device)
    torch.manual_seed(rank)
    tr = Trainer(DeepFM(26, 3 + 8, 13, hidden=(64, 32)), table, desc,
                 tx=lambda p: torch.optim.Adam(p, lr=1e-2), seed=rank,
                 device=args.device)
    for _ in range(args.passes):
        res = tr.train_pass(ds, log_prefix=f"[rank {rank}] ")
    # ONE global AUC across all workers (metrics.cc:288-304): allreduce
    # the bucket tables over the host collective plane
    coll = TcpCollective(rank, world,
                         os.environ["COLLECTIVE_ENDPOINTS"].split(","))
    global_auc = round(float(auc_compute_global(tr.state.auc, coll).auc), 4)
    coll.close()
    out = dict(rank=rank, loaded=loaded, after_shuffle=len(ds.records),
               auc=round(float(res["auc"]), 4), global_auc=global_auc,
               features=int(table.feature_count))
    print(json.dumps(out), flush=True)
    if args.out:
        with open(os.path.join(args.out, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)


def _free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--rows", type=int, default=4000)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--data", default=None)
    ap.add_argument("--out", default=None,
                    help="directory for each rank's result JSON")
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)  # internal re-exec flag
    args = ap.parse_args(argv)
    if args.worker:
        worker(args)
        return 0

    from paddlebox_tpu_torch.data.criteo import generate_criteo_files
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pbox_mh_") as tmp:
        data = args.data or os.path.join(tmp, "data")
        if not os.path.isdir(data) or not os.listdir(data):
            generate_criteo_files(
                data, num_files=2 * args.workers,
                rows_per_file=args.rows // (2 * args.workers),
                vocab_per_slot=200, seed=1)
        rc = _launch(args, data)
    if rc:
        print(f"worker failures: exit {rc}", file=sys.stderr)
        return rc
    print(f"all workers done in {time.perf_counter() - t0:.1f}s")
    return 0


def _launch(args, data: str) -> int:
    from paddlebox_tpu_torch.distributed.launch import (LaunchConfig,
                                                        launch_local)
    ports = _free_ports(2 * args.workers)
    os.environ["SHUFFLE_ENDPOINTS"] = ",".join(
        f"127.0.0.1:{p}" for p in ports[:args.workers])
    os.environ["COLLECTIVE_ENDPOINTS"] = ",".join(
        f"127.0.0.1:{p}" for p in ports[args.workers:])
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ["PYTHONPATH"] = root + os.pathsep + os.environ.get(
        "PYTHONPATH", "")
    cmd = [sys.executable, "-m", "paddlebox_tpu_torch.examples."
           "train_multihost", "--worker", "--data", data,
           "--rows", str(args.rows), "--passes", str(args.passes),
           "--batch-size", str(args.batch_size), "--device", args.device]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        cmd += ["--out", args.out]
    return launch_local(cmd, LaunchConfig(nproc=args.workers,
                                          timeout_sec=WORKERS_TIMEOUT_SEC))


if __name__ == "__main__":
    sys.exit(main())
