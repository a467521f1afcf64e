"""Sparse optimizer configs (from ``paddlebox_tpu/ps/sgd.py``). Serving
applies no update; the configs matter only because the optimizer's
extension block sets the width of a table row."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SparseSGDConfig:
    """Adagrad config; field names/defaults from optimizer_conf.h:22-45."""

    nonclk_coeff: float = 0.1
    clk_coeff: float = 1.0
    # embed (wide 1-dim) part
    min_bound: float = -10.0
    max_bound: float = 10.0
    learning_rate: float = 0.05
    initial_g2sum: float = 3.0
    initial_range: float = 0.0
    # embedx (mf) part
    mf_create_thresholds: float = 10.0
    mf_learning_rate: float = 0.05
    mf_initial_g2sum: float = 3.0
    mf_initial_range: float = 1e-4
    mf_min_bound: float = -10.0
    mf_max_bound: float = 10.0


@dataclasses.dataclass(frozen=True)
class SparseAdamConfig(SparseSGDConfig):
    """Selects the Adam row optimizer; ``shared=True`` keeps one scalar
    moment per row for all embedx dims."""

    beta1_decay_rate: float = 0.9
    beta2_decay_rate: float = 0.999
    ada_epsilon: float = 1e-8
    shared: bool = False


def opt_ext_width(cfg: SparseSGDConfig, mf_dim: int) -> int:
    """Width of the per-row optimizer extension block appended after
    embedx_w: 0 for Adagrad, 5 + 2*mf for Adam, 7 for shared Adam."""
    if not isinstance(cfg, SparseAdamConfig):
        return 0
    return 7 if cfg.shared else 5 + 2 * mf_dim
