"""Chunked-schedule parity gate (the port's counterpart of the digest half
of ``scripts/scaling_check.py``, its check 1).

Chunked parity end to end through ``train_pass``: with
``FLAGS.a2a_chunks=2`` (one exchange per slot group, each group pooled
alone) the sharded trainer reproduces the ``a2a_chunks=1`` model state
(``sharded_state_digest``: the dense params, every shard's table state,
every destination's AUC tables) BIT FOR BIT, and the monolithic digest
repeats across two seeded runs — the chunked schedule changes the
exchange's shape, never its math. ``n`` shards (default 8, the
reference's mesh width) all on one device.

The reference's check 2 (multichip bench rows into a perf trajectory)
reads benchmark records the port does not have yet; it is not here.

Usage::

    python -m paddlebox_tpu_torch.tools.scaling_check [--device cpu]

The trainers live on the card unless ``--device cpu``. Exit code 0 ==
parity held.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from typing import Optional, Sequence, Tuple


def parity_check(rows_per_file: int = 500, chunks: Tuple[int, ...] = (2,),
                 n: int = 8, device: str = "cuda") -> dict:
    """a2a_chunks ∈ chunks reproduce the chunks=1 digest through
    train_pass (chunks=1 run twice). Returns {ok, digest, chunked (the
    global batches that ran the chunked schedule, per chunk count),
    batches, seconds}."""
    import torch

    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
    from paddlebox_tpu_torch.data.criteo import generate_criteo_files
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable
    from paddlebox_tpu_torch.train.checkpoint import sharded_state_digest
    from paddlebox_tpu_torch.train.sharded import ShardedTrainer

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pbox_scaling_") as td:
        files = generate_criteo_files(td, num_files=1,
                                      rows_per_file=rows_per_file,
                                      vocab_per_slot=40, seed=17)
        desc = DataFeedDesc.criteo(batch_size=32)
        desc.key_bucket_min = 1024
        ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
        ds.set_filelist(files)
        ds.load_into_memory()

        def run(c: int):
            cfg = SparseSGDConfig(mf_create_thresholds=0.0,
                                  mf_initial_range=0.0,
                                  learning_rate=0.1, mf_learning_rate=0.1)
            table = ShardedEmbeddingTable(
                n, mf_dim=4, capacity_per_shard=4096, cfg=cfg,
                req_bucket_min=256, serve_bucket_min=256,
                devices=[device] * n)
            torch.manual_seed(0)
            model = DeepFM(26, 3 + 4, 13, hidden=(16, 16))
            with flags_scope(a2a_chunks=c):
                tr = ShardedTrainer(
                    model, table, desc,
                    tx=lambda p: torch.optim.Adam(p, lr=2e-3))
                res = tr.train_pass(ds)
            return sharded_state_digest(tr), res

        want, res = run(1)
        out = {"ok": True, "digest": want, "batches": res["batches"],
               "chunked": {}}
        again, _ = run(1)
        if again != want:
            print("scaling_check: FAIL — the chunks=1 digest is not "
                  "deterministic across seeded runs", file=sys.stderr)
            out["ok"] = False
        for c in chunks:
            got, res_c = run(c)
            out["chunked"][c] = res_c["chunked_batches"]
            if got != want:
                print(f"scaling_check: FAIL — a2a_chunks={c} digest "
                      f"{got[:16]} != monolithic {want[:16]}",
                      file=sys.stderr)
                out["ok"] = False
    out["seconds"] = time.perf_counter() - t0
    if out["ok"]:
        print(f"scaling_check: parity OK — a2a_chunks {list(chunks)} "
              f"bit-identical to monolithic over {n} shards on {device} "
              f"(digest {want[:16]}, {out['batches']} global batches, "
              f"chunked {out['chunked']}) in {out['seconds']:.1f}s")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the trainers' device (default: the card)")
    args = ap.parse_args(argv)
    out = parity_check(device=args.device)
    if not out["ok"]:
        return 1
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
