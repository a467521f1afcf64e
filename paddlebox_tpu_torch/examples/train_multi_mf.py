"""Per-slot embedding dims (multi_mf_dim) end to end — the port's
counterpart of the reference walkthrough ``examples/train_multi_mf.py``.

Production CTR tables mix embedding widths per slot (a user-id slot may
carry 64 dims while a small categorical carries 4 — feature_value.h:42,
ps_gpu_wrapper.cc multi-mf build). This trains CtrDnn on synthetic
criteo data with three dim classes (10 slots of 4, 10 of 8, 6 of 16)
through ``MultiMfEmbeddingTable`` / ``MultiMfTrainer``, then saves one
file a class, reloads them into a fresh table and checks a pull. Runs on
the card unless ``--device cpu``:

    python -m paddlebox_tpu_torch.examples.train_multi_mf [--passes 3] \\
        [--rows 8000] [--batch-size 256] [--device cuda]

``main`` returns what it printed, as a dict; ``run`` is the same
configuration with the model's start and the lazy-mf init range
settable, which a comparison against the reference needs.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
from paddlebox_tpu_torch.data.criteo import generate_criteo_files
from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn
from paddlebox_tpu_torch.ps.multi_mf import MultiMfEmbeddingTable
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.train.multi_mf_step import MultiMfTrainer

#: 26 criteo slots: 10 narrow, 10 medium, 6 wide
SLOT_DIMS = [4] * 10 + [8] * 10 + [16] * 6
HIDDEN = (64, 32)
CAPACITY = 1 << 15


def dataset(files: Sequence[str], batch_size: int = 256):
    """The example's in-memory dataset over criteo ``files``."""
    desc = DataFeedDesc.criteo(batch_size=batch_size)
    ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
    ds.set_filelist(list(files))
    ds.set_thread(2)
    ds.load_into_memory()
    return ds, desc


def run(ds, desc, passes: int = 3, device: str = "cuda",
        mf_initial_range: float = 1e-3,
        model_state: Optional[Mapping[str, torch.Tensor]] = None,
        compute_dtype: torch.dtype = torch.bfloat16):
    """Train ``passes`` passes of the example's configuration. Returns
    (trainer, per-pass results)."""
    cfg = SparseSGDConfig(mf_create_thresholds=0.0,
                          mf_initial_range=mf_initial_range)
    table = MultiMfEmbeddingTable(SLOT_DIMS, capacity=CAPACITY, cfg=cfg,
                                  device=device)
    torch.manual_seed(0)
    model = CtrDnn(1, table.pooled_width(), desc.dense_dim, hidden=HIDDEN,
                   compute_dtype=compute_dtype)
    if model_state is not None:
        model.load_state_dict(model_state)
    tr = MultiMfTrainer(model, table, desc,
                        tx=lambda p: torch.optim.Adam(p, lr=1e-3, eps=1e-8))
    results = [tr.train_pass(ds, log_prefix=f"[pass {p}] ")
               for p in range(passes)]
    return tr, results


def _args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--rows", type=int, default=8000)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--vocab-per-slot", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = _args(argv)
    work = args.workdir or tempfile.mkdtemp(prefix="pbox_mmf_")
    files = generate_criteo_files(os.path.join(work, "data"), num_files=2,
                                  rows_per_file=args.rows // 2,
                                  vocab_per_slot=args.vocab_per_slot, seed=7)
    ds, desc = dataset(files, args.batch_size)
    tr, results = run(ds, desc, args.passes, args.device)
    table = tr.table
    res = results[-1]
    print(f"final auc={res['auc']:.4f} over dim classes {table.dims} "
          f"({table.feature_count} features)")

    # one file a dim class, reloaded into a fresh table, a pull checked
    path = os.path.join(work, "mmf_base")
    n = table.save_base(path)
    t2 = MultiMfEmbeddingTable(SLOT_DIMS, capacity=CAPACITY,
                               cfg=table.cfg, device=args.device)
    if t2.load(path) != n:
        raise AssertionError("reloaded row count differs")
    ds.columnarize()
    col = ds.columnar
    keys, slots = col.keys[:8].astype(np.uint64), col.key_slot[:8]
    np.testing.assert_allclose(t2.pull(keys, slots),
                               table.pull(keys, slots), rtol=1e-6)
    print(f"save/load roundtrip ok ({n} rows across {len(table.dims)} "
          f"class files) in {work}")
    return {"workdir": work, "passes": results, "saved_rows": n,
            "features": table.feature_count}


if __name__ == "__main__":
    main()
