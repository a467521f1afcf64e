"""Beyond-device-memory training — the port's counterpart of the
reference walkthrough ``examples/train_tiered.py``: a model BIGGER than
the pass windows, trained across day-passes on N shards — the
AIBox/BoxPS architecture end to end.

Each key % N shard's window holds only one pass's working set; the full
model lives in per-shard host stores (RAM + optional disk spill). Per
pass: stage (BuildPull: host fetch) → begin_pass (BuildGPUTask: scatter
into the window) → train → end_pass (EndPass: write-back). Reference:
ps_gpu_wrapper.cc:337,684,983; box_wrapper.cc:1415 (LoadSSD2Mem).

Eight shards, the reference's one per chip of an 8-chip host, all on
one device: the card unless ``--device cpu``:

    python -m paddlebox_tpu_torch.examples.train_tiered [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
from paddlebox_tpu_torch.data.criteo import generate_criteo_files
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.ps.box_helper import BoxPSHelper
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.tiered import TieredShardedEmbeddingTable
from paddlebox_tpu_torch.train.sharded import ShardedTrainer

VOCAB = 400
MF_DIM = 8
SHARDS = 8
DAYS = 4
EPOCHS = 3          # train_pass calls a day, in the day's window


def write_day(work: str, day: int, rows: int = 3000) -> str:
    """Day-k criteo files in a SLIDING value range — consecutive days
    share half their feature space (the production CTR pattern: day k+1
    mostly re-touches day k's features while the multi-day union still
    exceeds any pass window), so the persistent window's delta staging
    has real reuse to exploit."""
    return generate_criteo_files(
        os.path.join(work, f"day{day}"), num_files=1, rows_per_file=rows,
        vocab_per_slot=VOCAB, seed=1000 + day,
        value_base=day * VOCAB // 2)[0]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    n = SHARDS
    work = tempfile.mkdtemp(prefix="pbox_tiered_")
    desc = DataFeedDesc.criteo(batch_size=128)
    desc.key_bucket_min = 4096

    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=1e-3,
                          learning_rate=0.05, mf_learning_rate=0.05)
    # the window deliberately smaller than the multi-day union: each
    # pass's working set (~10.4k uniques) fits, the 4-day model does not
    cap = (12_000 + n - 1) // n
    table = TieredShardedEmbeddingTable(n, mf_dim=MF_DIM,
                                        capacity_per_shard=cap, cfg=cfg,
                                        devices=args.device)
    torch.manual_seed(0)
    model = DeepFM(len(desc.sparse_slots), 3 + MF_DIM, desc.dense_dim,
                   hidden=(128, 64))
    tr = ShardedTrainer(model, table, desc,
                        tx=lambda p: torch.optim.Adam(p, lr=2e-3))
    helper = BoxPSHelper(table, trainer=tr)

    def make_day(day: int):
        """PaddleBoxDataset so day k+1's IO/parse can ALSO overlap day
        k's training (preload_into_memory / wait_feed_pass_done — the
        box_wrapper.h:1142 double-buffering)."""
        d = DatasetFactory().create_dataset("PaddleBoxDataset", desc)
        d.set_filelist([write_day(work, day)])
        return d

    ds = make_day(0)
    helper.read_data_to_memory(ds)
    for day in range(DAYS):
        tr.reset_metrics()                          # per-day AUC
        helper.begin_pass(ds)                       # host → the window
        st = dict(table.last_pass_stats)            # delta accounting
        ds_next = make_day(day + 1) if day < DAYS - 1 else None
        if ds_next is not None:
            helper.preload_into_memory(ds_next)     # IO overlaps epoch 1
        for e in range(EPOCHS):                     # epochs in the window
            res = tr.train_pass(ds)
            if e == 0 and ds_next is not None:
                # the FULL overlap pipeline: day k+1's IO/parse rode
                # epoch 1 in reader threads; its host-tier fetch of
                # MISSING keys (pre_build_thread, ps_gpu_wrapper.cc:913)
                # now rides the next epochs — with the sliding feature
                # space, ~half of day k+1 is already resident and never
                # re-ships
                helper.wait_feed_pass_done(ds_next)
                helper.stage_pass(ds_next)
        helper.end_pass(ds, need_save_delta=True,
                        delta_path=os.path.join(work, f"delta_{day}.npz"))
        print(f"day {day}: auc={res['auc']:.4f} "
              f"staged={st['staged']} resident={st['resident']} "
              f"evicted={st['evicted']} "
              f"window_rows={sum(len(ix) for ix in table.indexes)} "
              f"host_tier_rows={table.feature_count()}")
        ds = ds_next

    window = n * table.capacity
    total = table.feature_count()
    print(f"\nhost tier holds {total} features vs {window} window rows "
          f"({total / window:.1f}x beyond device memory)")

    # full-model lifecycle runs on the host tier between passes; the
    # threshold ≈ 5 unclicked shows after decay — features seen only a
    # handful of times genuinely age out
    base = os.path.join(work, "base.npz")
    helper.save_base(base)
    freed = helper.shrink_table(delete_threshold=0.5)
    print(f"saved full base ({base}); shrink aged out {freed} rows; "
          f"{time.perf_counter() - t0:.1f}s on {args.device}")


if __name__ == "__main__":
    main()
