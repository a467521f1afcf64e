"""Sparse in-table optimizers (from ``paddlebox_tpu/ps/sgd.py``): the
configs, which also set the width of a table row, and the Adagrad row
update as plain tensor functions over ``[U]`` / ``[U, mf_dim]`` rows.

Lazy mf creation draws ``uniform[0, 1) × mf_initial_range``. The
reference draws from jax's threefry; the port takes either an explicit
``init`` tensor of uniform draws (the tests hand both sides the same
numbers) or a ``torch.Generator`` (Philox on the card), so the two agree
bit for bit only through ``init`` or with ``mf_initial_range == 0``.

The Adam and shared-Adam row optimizers are not ported yet:
``sparse_update`` raises for a ``SparseAdamConfig``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch


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


class RowState(NamedTuple):
    """Per-row slice of the table state touched by one update."""

    show: torch.Tensor          # [U]
    clk: torch.Tensor           # [U]
    delta_score: torch.Tensor   # [U]
    embed_w: torch.Tensor       # [U]
    embed_g2sum: torch.Tensor   # [U]
    embedx_w: torch.Tensor      # [U, mf_dim]
    embedx_g2sum: torch.Tensor  # [U]
    mf_size: torch.Tensor       # [U] 0/1 — embedx materialized flag
    opt_ext: torch.Tensor       # [U, opt_ext_width] optimizer extension


def _adagrad_dir(g: torch.Tensor, g2sum: torch.Tensor, scale: torch.Tensor,
                 lr: float, g0: float, lo: float, hi: float,
                 w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update_value_work (optimizer.cuh.h:42-72) on [U] or [U, n]
    grads. Returns (new_w, g2sum_increment)."""
    ratio = lr * torch.sqrt(g0 / (g0 + g2sum))
    safe = torch.clamp_min(scale, 1e-20)  # g_show == 0 rows are masked
    if g.dim() == 2:
        scaled = g / safe[:, None]
        neww = torch.clamp(w + scaled * ratio[:, None], lo, hi)
        inc = torch.mean(scaled * scaled, dim=-1)
    else:
        scaled = g / safe
        neww = torch.clamp(w + scaled * ratio, lo, hi)
        inc = scaled * scaled
    return neww, inc


def adagrad_update(rows: RowState, g_show: torch.Tensor,
                   g_clk: torch.Tensor, g_embed: torch.Tensor,
                   g_embedx: torch.Tensor, touched: torch.Tensor,
                   cfg: SparseSGDConfig,
                   init: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> RowState:
    """Batched dy_mf_update_value; untouched (padding) rows pass
    through. ``init`` [U, mf_dim] holds the uniform[0, 1) draws for lazy
    mf creation; without it they are drawn from ``generator``."""
    show = rows.show + g_show
    clk = rows.clk + g_clk
    delta = rows.delta_score + cfg.nonclk_coeff * (g_show - g_clk) \
        + cfg.clk_coeff * g_clk

    embed_w, embed_inc = _adagrad_dir(
        g_embed, rows.embed_g2sum, g_show, cfg.learning_rate,
        cfg.initial_g2sum, cfg.min_bound, cfg.max_bound, rows.embed_w)
    embed_g2sum = rows.embed_g2sum + embed_inc

    # existing mf rows: normal adagrad step
    embedx_new, embedx_inc = _adagrad_dir(
        g_embedx, rows.embedx_g2sum, g_show, cfg.mf_learning_rate,
        cfg.mf_initial_g2sum, cfg.mf_min_bound, cfg.mf_max_bound,
        rows.embedx_w)
    has_mf = rows.mf_size > 0
    # lazy creation: threshold on the post-update counters (:105-113)
    score = cfg.nonclk_coeff * (show - clk) + cfg.clk_coeff * clk
    create = (~has_mf) & (score >= cfg.mf_create_thresholds)
    if init is None:
        if generator is None:
            raise ValueError("adagrad_update: pass init draws or a "
                             "generator")
        init = torch.rand(rows.embedx_w.shape, generator=generator,
                          dtype=rows.embedx_w.dtype,
                          device=rows.embedx_w.device)
    init = init * cfg.mf_initial_range
    embedx_w = torch.where(create[:, None], init,
                           torch.where(has_mf[:, None], embedx_new,
                                       rows.embedx_w))
    embedx_g2sum = torch.where(has_mf, rows.embedx_g2sum + embedx_inc,
                               rows.embedx_g2sum)
    mf_size = torch.where(create, torch.ones_like(rows.mf_size),
                          rows.mf_size)

    upd = RowState(show, clk, delta, embed_w, embed_g2sum, embedx_w,
                   embedx_g2sum, mf_size, rows.opt_ext)
    return _mask_untouched(upd, rows, touched)


def _mask_untouched(upd: RowState, rows: RowState,
                    touched: torch.Tensor) -> RowState:
    return RowState(*[
        torch.where(touched[:, None] if new.dim() == 2 else touched,
                    new, old)
        for new, old in zip(upd, rows)])


def sparse_update(rows: RowState, g_show, g_clk, g_embed, g_embedx,
                  touched, cfg: SparseSGDConfig,
                  init: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> RowState:
    """Dispatch to the configured in-table optimizer. Only Adagrad is
    ported; the Adam variants raise."""
    if isinstance(cfg, SparseAdamConfig):
        raise NotImplementedError(
            "the sparse Adam / shared-Adam row optimizers are not ported "
            "yet (ROADMAP queue 1)")
    return adagrad_update(rows, g_show, g_clk, g_embed, g_embedx, touched,
                          cfg, init=init, generator=generator)
