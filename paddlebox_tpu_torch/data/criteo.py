"""Synthetic Criteo-style data generation (test/bench fixture; copy of
``paddlebox_tpu/data/criteo.py``, which writes the same bytes for the same
arguments).

Reference test fixture analogue: python/paddle/fluid/tests/unittests/
ctr_dataset_reader.py (synthetic CTR data generator used across dataset and
trainer tests).

Generates clicks from a planted logistic model over hashed categorical
features so that learned models have real signal (AUC well above 0.5) —
letting end-to-end tests assert learning, not just shape-correctness.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def generate_criteo_files(
    out_dir: str,
    num_files: int = 2,
    rows_per_file: int = 5000,
    vocab_per_slot: int = 1000,
    seed: int = 0,
    planted_dim: int = 8,
    value_base: int = 0,
) -> List[str]:
    """Write criteo-format TSV files; returns file paths.

    ``value_base`` offsets every categorical value — day-k datasets with
    ``value_base=k*vocab_per_slot`` have disjoint feature spaces (fresh
    features per pass, the tiered-PS workload) while keeping the planted
    learnable signal (weights hash from the offset value)."""
    rng = np.random.default_rng(seed)
    # planted model: each (slot, value) id gets a latent weight via hashing
    w_dense = rng.normal(0, 0.3, size=13).astype(np.float32)
    paths = []
    os.makedirs(out_dir, exist_ok=True)
    for fi in range(num_files):
        path = os.path.join(out_dir, f"criteo_part_{fi:03d}.txt")
        with open(path, "w") as fh:
            for _ in range(rows_per_file):
                dense_raw = rng.integers(0, 100, size=13)
                cats = value_base + rng.integers(0, vocab_per_slot,
                                                 size=26)
                # latent weight of a categorical value: deterministic hash → N(0, .25)
                hvals = ((cats * 2654435761 + np.arange(26) * 97) % 1000003)
                w_cat = ((hvals.astype(np.float64) / 1000003.0) - 0.5)
                logit = float(np.log1p(dense_raw) @ w_dense) * 0.2 + float(w_cat.sum()) * 1.2
                p = 1.0 / (1.0 + np.exp(-logit))
                label = int(rng.random() < p)
                dense_s = "\t".join(str(int(v)) if rng.random() > 0.05 else ""
                                    for v in dense_raw)
                cat_s = "\t".join(format(int(c), "x") for c in cats)
                fh.write(f"{label}\t{dense_s}\t{cat_s}\n")
        paths.append(path)
    return paths
