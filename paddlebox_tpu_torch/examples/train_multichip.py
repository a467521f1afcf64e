"""Multi-shard CTR training — the port's counterpart of the reference
walkthrough ``examples/train_multichip.py``: the sharded embedding table
and the data-parallel dense net with ZeRO-1, in resident passes.

The table's rows split by key % N over N shards, each on a device of
``--devices`` (by default N shards on the one card; a list such as
``cuda:0,cuda:1,cuda:2,cuda:3`` puts one on each). Every pass is staged
on the shards' devices once (``ShardedTrainer.train_pass_resident``),
then runs with no host plan and no host→device copy per step. Runs on
the card unless ``--devices cpu``:

    python -m paddlebox_tpu_torch.examples.train_multichip [--shards 4] \\
        [--rows 8000] [--passes 3] [--batch-size 128] [--devices cuda]

``main`` returns what it printed, as a dict.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, Optional, Sequence

import torch

from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
from paddlebox_tpu_torch.data.criteo import generate_criteo_files
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable
from paddlebox_tpu_torch.train.sharded import ShardedTrainer

MF_DIM = 8


def _args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--rows", type=int, default=8000)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=128,
                    help="records a local batch (a shard's)")
    ap.add_argument("--vocab-per-slot", type=int, default=500)
    ap.add_argument("--capacity", type=int, default=1 << 15,
                    help="rows a shard")
    ap.add_argument("--devices", default="cuda",
                    help="one device for every shard, or N comma separated")
    ap.add_argument("--workdir", default=None)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = _args(argv)
    work = args.workdir or tempfile.mkdtemp(prefix="pbox_shards_")
    devices = args.devices.split(",")
    devices = devices[0] if len(devices) == 1 else devices
    files = generate_criteo_files(os.path.join(work, "data"), num_files=2,
                                  rows_per_file=args.rows // 2,
                                  vocab_per_slot=args.vocab_per_slot, seed=0)
    desc = DataFeedDesc.criteo(batch_size=args.batch_size)
    desc.key_bucket_min = 4096
    ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.local_shuffle(seed=1)

    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=1e-3,
                          learning_rate=0.05, mf_learning_rate=0.05)
    table = ShardedEmbeddingTable(args.shards, mf_dim=MF_DIM,
                                  capacity_per_shard=args.capacity, cfg=cfg,
                                  devices=devices)
    torch.manual_seed(0)
    model = DeepFM(len(desc.sparse_slots), 3 + MF_DIM, desc.dense_dim,
                   hidden=(128, 64))
    tr = ShardedTrainer(model, table, desc,
                        tx=lambda p: torch.optim.Adam(p, lr=1e-3),
                        zero1=True)
    out: Dict[str, object] = {"workdir": work, "passes": []}
    for p in range(args.passes):
        res = tr.train_pass_resident(ds)       # the whole pass staged
        tr.reset_metrics()
        out["passes"].append(res)
        print(f"pass {p}: auc={res['auc']:.4f} "
              f"{res['examples_per_sec']:.0f} ex/s "
              f"features={table.feature_count()}")
    path = os.path.join(work, "sharded_base.npz")
    out["saved_rows"] = table.save_base(path)
    print(f"artifacts in {work}")
    return out


if __name__ == "__main__":
    main()
