"""Sparse in-table optimizers (from ``paddlebox_tpu/ps/sgd.py``): the
configs, which also set the width of a table row, and the Adagrad, Adam
and shared-Adam row updates as plain tensor functions over ``[U]`` /
``[U, mf_dim]`` rows.

Lazy mf creation draws ``uniform[0, 1) × mf_initial_range``. The
reference draws from jax's threefry; the port takes either an explicit
``init`` tensor of uniform draws (the tests hand both sides the same
numbers) or a ``torch.Generator`` (Philox on the card), so the two agree
bit for bit only through ``init`` or with ``mf_initial_range == 0``.
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
                   generator: Optional[torch.Generator] = None,
                   draw_rows: Optional[int] = None) -> RowState:
    """Batched dy_mf_update_value; untouched (padding) rows pass
    through. ``init`` [U, mf_dim] holds the uniform[0, 1) draws for lazy
    mf creation; without it they are drawn from ``generator``, for the
    first ``draw_rows`` rows (default all U; the rest get zeros)."""
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
    init = _lazy_init(rows, cfg, init, generator, draw_rows)
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


def _lazy_init(rows: RowState, cfg: SparseSGDConfig,
               init: Optional[torch.Tensor],
               generator: Optional[torch.Generator],
               draw_rows: Optional[int] = None) -> torch.Tensor:
    """The lazy-mf init values [U, mf_dim]: the uniform[0, 1) draws in
    ``init`` (or drawn from ``generator`` for the first ``draw_rows``
    rows, zeros after them) times ``mf_initial_range``. On the card a
    draw's values depend on its size, so a caller whose padded width
    varies for the same real rows draws for the real rows only."""
    if init is None:
        if generator is None:
            raise ValueError("sparse update: pass init draws or a "
                             "generator")
        u, mf = rows.embedx_w.shape
        n = u if draw_rows is None else draw_rows
        init = torch.rand((n, mf), generator=generator,
                          dtype=rows.embedx_w.dtype,
                          device=rows.embedx_w.device)
        if n < u:
            init = torch.cat([init, init.new_zeros((u - n, mf))])
    return init * cfg.mf_initial_range


def _mask_untouched(upd: RowState, rows: RowState,
                    touched: torch.Tensor) -> RowState:
    return RowState(*[
        torch.where(touched[:, None] if new.dim() == 2 else touched,
                    new, old)
        for new, old in zip(upd, rows)])


def _adam_dir(w: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor,
              b1p: torch.Tensor, b2p: torch.Tensor, g: torch.Tensor,
              scale: torch.Tensor, cfg: SparseAdamConfig
              ) -> Tuple[torch.Tensor, ...]:
    """One SparseAdam update_lr/update_mf (optimizer.cuh.h:159-236) over
    [U] or [U, n] grads with per-row moments (shaped like ``g``, or
    [U, 1] to broadcast) and per-row beta powers. Returns (new_w, new_m1,
    new_m2, new_b1p, new_b2p). Both directions use ``learning_rate`` and
    the mf bounds, as the reference does."""
    b1, b2 = cfg.beta1_decay_rate, cfg.beta2_decay_rate
    ratio = cfg.learning_rate * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    safe = torch.clamp_min(scale, 1e-20)
    scaled = g / (safe[:, None] if g.dim() == 2 else safe)
    new_m1 = b1 * m1 + (1.0 - b1) * scaled
    new_m2 = b2 * m2 + (1.0 - b2) * scaled * scaled
    step = new_m1 / (torch.sqrt(new_m2) + cfg.ada_epsilon)
    r = ratio[:, None] if g.dim() == 2 else ratio
    new_w = torch.clamp(w + r * step, cfg.mf_min_bound, cfg.mf_max_bound)
    return new_w, new_m1, new_m2, b1p * b1, b2p * b2


def adam_update(rows: RowState, g_show: torch.Tensor, g_clk: torch.Tensor,
                g_embed: torch.Tensor, g_embedx: torch.Tensor,
                touched: torch.Tensor, cfg: SparseAdamConfig,
                init: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                draw_rows: Optional[int] = None) -> RowState:
    """Batched SparseAdam[Shared]Optimizer::dy_mf_update_value
    (optimizer.cuh.h:244-273 / :395-446); untouched (padding) rows pass
    through. ``opt_ext`` holds [embed m1, embed b1p, embed b2p, embedx
    b1p, embedx b2p, embedx m1, embedx m2] (the embed m2 lives in
    ``embed_g2sum``); the embedx moments are [U, mf] each, or [U, 1] when
    ``cfg.shared`` (the mean of the new per-dim moments is kept). A beta
    power of 0 with show == 0 marks a never-initialized row, whose
    powers act as the creation value (beta itself). ``init`` /
    ``generator`` / ``draw_rows`` feed lazy mf creation, as in
    ``adagrad_update``."""
    b1, b2 = cfg.beta1_decay_rate, cfg.beta2_decay_rate
    mf = rows.embedx_w.shape[1]
    ext = rows.opt_ext
    e_gsum, e_b1p, e_b2p = ext[:, 0], ext[:, 1], ext[:, 2]
    x_b1p, x_b2p = ext[:, 3], ext[:, 4]
    if cfg.shared:
        x_m1, x_m2 = ext[:, 5:6], ext[:, 6:7]
    else:
        x_m1, x_m2 = ext[:, 5:5 + mf], ext[:, 5 + mf:5 + 2 * mf]

    show = rows.show + g_show
    clk = rows.clk + g_clk
    delta = rows.delta_score + cfg.nonclk_coeff * (g_show - g_clk) \
        + cfg.clk_coeff * g_clk

    # embed (lr) direction
    fresh = (rows.show == 0) & (e_b1p == 0)
    eb1p = torch.where(fresh, torch.full_like(e_b1p, b1), e_b1p)
    eb2p = torch.where(fresh, torch.full_like(e_b2p, b2), e_b2p)
    embed_w, e_gsum_n, e_g2sum_n, eb1p_n, eb2p_n = _adam_dir(
        rows.embed_w, e_gsum, rows.embed_g2sum, eb1p, eb2p, g_embed,
        g_show, cfg)

    # embedx (mf) direction: update existing, lazily create the rest
    upd_w, m1_n, m2_n, xb1p_n, xb2p_n = _adam_dir(
        rows.embedx_w, x_m1, x_m2, x_b1p, x_b2p, g_embedx, g_show, cfg)
    if cfg.shared:
        m1_n = torch.mean(m1_n, dim=1, keepdim=True)
        m2_n = torch.mean(m2_n, dim=1, keepdim=True)
    has_mf = rows.mf_size > 0
    score = cfg.nonclk_coeff * (show - clk) + cfg.clk_coeff * clk
    create = (~has_mf) & (score >= cfg.mf_create_thresholds)
    init = _lazy_init(rows, cfg, init, generator, draw_rows)
    embedx_w = torch.where(create[:, None], init,
                           torch.where(has_mf[:, None], upd_w,
                                       rows.embedx_w))
    # on creation the beta powers become the decay rates
    # (optimizer.cuh.h:285-289); the moments start at 0
    x_m1_out = torch.where(has_mf[:, None], m1_n, x_m1)
    x_m2_out = torch.where(has_mf[:, None], m2_n, x_m2)
    xb1p_out = torch.where(create, torch.full_like(x_b1p, b1),
                           torch.where(has_mf, xb1p_n, x_b1p))
    xb2p_out = torch.where(create, torch.full_like(x_b2p, b2),
                           torch.where(has_mf, xb2p_n, x_b2p))
    mf_size = torch.where(create, torch.ones_like(rows.mf_size),
                          rows.mf_size)

    ext_new = torch.cat(
        [e_gsum_n[:, None], eb1p_n[:, None], eb2p_n[:, None],
         xb1p_out[:, None], xb2p_out[:, None], x_m1_out, x_m2_out], dim=1)
    upd = RowState(show, clk, delta, embed_w, e_g2sum_n, embedx_w,
                   rows.embedx_g2sum, mf_size, ext_new)
    return _mask_untouched(upd, rows, touched)


def sparse_update(rows: RowState, g_show, g_clk, g_embed, g_embedx,
                  touched, cfg: SparseSGDConfig,
                  init: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  draw_rows: Optional[int] = None) -> RowState:
    """Dispatch to the configured in-table optimizer (adagrad / adam /
    shared adam, the OptimizerType selection of heter_ps)."""
    update = adam_update if isinstance(cfg, SparseAdamConfig) \
        else adagrad_update
    return update(rows, g_show, g_clk, g_embed, g_embedx, touched, cfg,
                  init=init, generator=generator, draw_rows=draw_rows)
