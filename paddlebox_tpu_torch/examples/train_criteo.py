"""End-to-end Criteo CTR training on the port — the counterpart of the
reference walkthrough ``examples/train_criteo.py``.

Covers the whole production loop on synthetic Criteo-shaped data: files
written by ``generate_criteo_files``, native-parsed (``DatasetFactory`` →
``load_into_memory``) into the columnar store and shuffled; device-resident
passes, pass k+1 building on the ``PassPreloader`` while pass k trains;
base and delta checkpoints that publish into an ``ArtifactStore``; a
held-out ``eval_pass`` feeding a registered metric; a ``ServingModel`` that
adopts the newest version and predicts. Runs on the card unless
``--device cpu``:

    python -m paddlebox_tpu_torch.examples.train_criteo [--rows 20000] \\
        [--passes 3] [--batch-size 512] [--workdir DIR] [--device cuda]

``--vocab-per-slot``, ``--capacity`` and ``--hidden`` size the data, the
table and the tower (the defaults are the reference walkthrough's).
``main`` returns what it printed, as a dict.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from paddlebox_tpu_torch.artifacts import ArtifactStore
from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
from paddlebox_tpu_torch.data.criteo import generate_criteo_files
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.serving import ServingModel
from paddlebox_tpu_torch.train import (CheckpointManager, PassPreloader,
                                       Trainer)

MF_DIM = 8


def _args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=20_000)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--vocab-per-slot", type=int, default=1000)
    ap.add_argument("--capacity", type=int, default=1 << 18)
    ap.add_argument("--hidden", default="256,128",
                    help="the DeepFM tower's widths, comma separated")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = _args(argv)
    work = args.workdir or tempfile.mkdtemp(prefix="pbox_demo_")
    hidden = tuple(int(h) for h in args.hidden.split(","))
    out: Dict[str, object] = {"workdir": work}

    # 1) data: synthetic criteo files, native C++ parse → columnar store
    files = generate_criteo_files(os.path.join(work, "data"), num_files=4,
                                  rows_per_file=args.rows // 4,
                                  vocab_per_slot=args.vocab_per_slot,
                                  seed=0)
    desc = DataFeedDesc.criteo(batch_size=args.batch_size)
    desc.key_bucket_min = args.batch_size * 26

    def day(seed: int):
        ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
        ds.set_filelist(files)
        ds.set_thread(4)
        ds.load_into_memory()
        out["parse_route"] = ds.parse_route
        ds.local_shuffle(seed=seed)
        return ds

    # 2) model + device embedding table + trainer
    def model() -> DeepFM:
        torch.manual_seed(0)
        return DeepFM(26, 3 + MF_DIM, 13, hidden=hidden)

    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=1e-3,
                          learning_rate=0.05, mf_learning_rate=0.05)
    table = EmbeddingTable(mf_dim=MF_DIM, capacity=args.capacity, cfg=cfg,
                           unique_bucket_min=1 << 12, device=args.device)
    tr = Trainer(model(), table, desc,
                 tx=lambda p: torch.optim.Adam(p, lr=1e-3),
                 device=args.device)
    store = ArtifactStore(os.path.join(work, "store"))
    ckpt = CheckpointManager(os.path.join(work, "ckpt"), keep=3,
                             artifacts=store)

    # 3) device-resident passes, pass k+1 preloading while pass k trains
    pre = PassPreloader(iter(day(s) for s in range(args.passes)), table)
    pre.start_next()
    passes = []
    try:
        for p in range(args.passes):
            rp = pre.wait()
            pre.start_next()
            res = tr.train_pass_resident(rp)
            passes.append(res)
            print(f"pass {p}: auc={res['auc']:.4f} "
                  f"ex/s={res['examples_per_sec']:.0f} "
                  f"features={table.feature_count}")
            ckpt.save(tr, delta=p > 0)
    finally:
        pre.drain()
    out["passes"] = passes

    # 4) held-out eval with a registered metric variant
    tr.metrics.init_metric("test_auc", method="auc")
    tr.eval_pass(day(98))
    out["eval"] = tr.metrics.get_metric_msg("test_auc")
    print(f"eval: {out['eval']}")

    # 5) the published versions → an online serving consumer
    srv = ServingModel(model(), desc, mf_dim=MF_DIM, capacity=args.capacity,
                       cfg=cfg, device=args.device)
    out["adopted"] = srv.adopt(store)
    batch = next(day(99).batches())
    preds, valid = srv.predict(batch, return_valid=True)
    live = preds[valid > 0]
    out["served"] = int(valid.sum())
    out["mean_ctr"] = float(live.mean()) if len(live) else float("nan")
    out["preds_finite"] = bool(np.isfinite(preds).all())
    print(f"serving: adopted {out['adopted']}, {out['served']} predictions,"
          f" mean CTR {out['mean_ctr']:.4f}")
    print(f"artifacts in {work}")
    return out


if __name__ == "__main__":
    main()
