"""The fused_seqpool_cvm variant family (counterpart of
``paddlebox_tpu/ops/seqpool_variants.py``).

Reference ops (paddle/fluid/operators/fused/):
- ``fused_seqpool_cvm_with_diff_thres_op.cu`` — per-slot filter
  thresholds (threshold_vec[slot] replaces the scalar).
- ``fused_seqpool_cvm_tradew_op.cu`` — value layout
  [cvm | trade weights | embed]; normal mode skips the trade columns;
  trade_id mode scales embeds by the chosen trade weight; grads (normal:
  cvm←batch-cvm, trade←0, embed←g; trade_id: cvm←0, chosen trade←Σ
  g·embed_in, embed←g·w).
- ``fused_seqpool_cvm_with_credit_op.cu`` — cvm_offset=4
  [show, click, conv, credit], CVM head = log1p of each cvm column;
  show_filter drops the show column.
- ``fused_seqpool_cvm_with_pcoc_op.cu`` — input cvm
  [show, clk, show2, clk2, pclk_1..p]; output head
  [log1p(show), log1p(clk)-log1p(show), log1p(pclk_i)-log1p(show2) ∀i,
  log1p(pclk_i)-log1p(clk2) ∀i]; backward: the first 4 cvm columns ←
  batch cvm values, the pclk columns ← per-instance q_values.

Every variant pools through ``seqpool_cvm._pool_core`` (one
``ops.segment_sum`` into B*S + 1 bins) and applies its head in torch;
every backward writes each key's grad row with ``ops.segment_gather``
(its epilogue mode where the row is [head | zeros | embed grad], the
gather mode where tradew's trade_id rule needs the raw grad rows).
"""

from __future__ import annotations

import torch

from paddlebox_tpu_torch.ops.kernels import KERNELS, KernelSet
from paddlebox_tpu_torch.ops.seqpool_cvm import _pool_core


def _grad_rows(g: torch.Tensor, n_head: int, width: int,
               segments: torch.Tensor, head: torch.Tensor, a: dict,
               mask=None, ets: int = 0) -> torch.Tensor:
    """The per-key grad rows [K, H + ets + width]: [head[instance] |
    zeros(ets) | the segment's output grad after its ``n_head`` head
    columns]; pads (ids >= B*S) and ``mask`` = 0 give zero rows."""
    b, s = a["batch_size"], a["num_slots"]
    src = g.float().reshape(b * s, n_head + width)[:, n_head:]
    return a["ops"].segment_gather(src, segments, head.float().contiguous(),
                                   mask, b, s, ets)


def _cvm_head(pooled: torch.Tensor, cvm_offset: int) -> torch.Tensor:
    """[log1p(show), log1p(clk) - log1p(show), pooled[cvm_offset:]]."""
    show_l = torch.log1p(pooled[..., 0:1])
    ctr = torch.log1p(pooled[..., 1:2]) - show_l
    return torch.cat([show_l, ctr, pooled[..., cvm_offset:]], dim=-1)


# ---------------------------------------------------------------------------
# diff_thres
# ---------------------------------------------------------------------------

class _DiffThres(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, segments, batch_show_clk, threshold_vec, a):
        s, co = a["num_slots"], a["cvm_offset"]
        slot = (segments.long() % s).clamp_max(s - 1)
        score = ((values[:, 0] - values[:, 1]) * a["show_coeff"]
                 + values[:, 1] * a["clk_coeff"])
        keep = score >= threshold_vec[slot]
        pooled = _pool_core(values, segments, a["batch_size"], s, keep,
                            a["pad_value"], a["ops"])
        out = _cvm_head(pooled, co) if a["use_cvm"] else pooled[..., co:]
        ctx.a, ctx.shape, ctx.dtype = a, values.shape, values.dtype
        ctx.save_for_backward(segments, keep, batch_show_clk)
        return out

    @staticmethod
    def backward(ctx, g):
        segments, keep, batch_show_clk = ctx.saved_tensors
        a = ctx.a
        co = a["cvm_offset"]
        # the reference slices the output grad at cvm_offset
        out = _grad_rows(g, co if a["use_cvm"] else 0, ctx.shape[1] - co,
                         segments, batch_show_clk, a, keep.float())
        return out.to(ctx.dtype), None, None, None, None


def fused_seqpool_cvm_with_diff_thres(
    values: torch.Tensor,             # [K, D]
    segments: torch.Tensor,           # [K] int32 ins*S + slot; pads → B*S
    batch_show_clk: torch.Tensor,     # [B, 2]
    threshold_vec: torch.Tensor,      # [S] per-slot thresholds
    batch_size: int,
    num_slots: int,
    use_cvm: bool = True,
    cvm_offset: int = 2,
    pad_value: float = 0.0,
    show_coeff: float = 0.2,
    clk_coeff: float = 1.0,
    xbox_diff_thres_filter: bool = True,
    ops: KernelSet = KERNELS,
) -> torch.Tensor:
    """The show/clk filter with a threshold per slot, then the plain CVM
    pool [B, S, D] (``D - cvm_offset`` without cvm).
    ``xbox_diff_thres_filter`` is accepted and, as in the reference,
    unused."""
    del xbox_diff_thres_filter
    a = dict(batch_size=batch_size, num_slots=num_slots, ops=ops,
             use_cvm=use_cvm, cvm_offset=cvm_offset, pad_value=pad_value,
             show_coeff=show_coeff, clk_coeff=clk_coeff)
    return _DiffThres.apply(values, segments, batch_show_clk, threshold_vec,
                            a)


# ---------------------------------------------------------------------------
# tradew
# ---------------------------------------------------------------------------

class _TradeW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, segments, batch_show_clk, a):
        co, tn, tid = a["cvm_offset"], a["trade_num"], a["trade_id"]
        embed = values[:, co + tn:]
        if tid >= 0:
            embed = embed * values[:, co + tid:co + tid + 1]
        v = torch.cat([values[:, :co], embed], dim=1)
        pooled = _pool_core(v, segments, a["batch_size"], a["num_slots"],
                            ops=a["ops"])
        out = _cvm_head(pooled, co) if a["use_cvm"] else pooled[..., co:]
        ctx.a, ctx.dtype = a, values.dtype
        # normal mode's backward never reads the inputs
        ctx.save_for_backward(segments, batch_show_clk,
                              values if tid >= 0 else None)
        ctx.shape = values.shape
        return out

    @staticmethod
    def backward(ctx, g):
        segments, batch_show_clk, values = ctx.saved_tensors
        a = ctx.a
        co, tn, tid = a["cvm_offset"], a["trade_num"], a["trade_id"]
        k, d = ctx.shape
        e = d - co - tn
        n_head = co if a["use_cvm"] else 0
        if tid < 0:
            # cvm ← batch show/clk, trade ← 0, embed ← its segment's grad
            out = _grad_rows(g, n_head, e, segments, batch_show_clk, a,
                             ets=tn)
            return out.to(ctx.dtype), None, None, None
        # trade_id (FusedSeqpoolCVMTradeWGradKernel :295-345): cvm ← 0,
        # the chosen trade column ← Σ_j g_j·embed_in_j, embed ← g·w
        b, s = a["batch_size"], a["num_slots"]
        src = g.float().reshape(b * s, n_head + e)[:, n_head:]
        g_seg = a["ops"].segment_gather(src, segments)      # [K, E]
        w = values[:, co + tid:co + tid + 1]
        out = g_seg.new_zeros((k, d))
        out[:, co + tid] = (g_seg * values[:, co + tn:]).sum(dim=1)
        out[:, co + tn:] = g_seg * w
        live = (segments < b * s)[:, None]
        return (torch.where(live, out, 0.0).to(ctx.dtype), None, None,
                None)


def fused_seqpool_cvm_tradew(
    values: torch.Tensor,             # [K, cvm_offset + trade_num + E]
    segments: torch.Tensor,
    batch_show_clk: torch.Tensor,     # [B, cvm_offset]
    batch_size: int,
    num_slots: int,
    trade_num: int,
    trade_id: int = -1,               # >= 0: scale embeds by that weight
    use_cvm: bool = True,
    cvm_offset: int = 2,
    ops: KernelSet = KERNELS,
) -> torch.Tensor:
    """Pool [cvm | embed] (the trade columns skipped; with ``trade_id``
    the embeds scaled by that trade weight first) with the CVM head."""
    a = dict(batch_size=batch_size, num_slots=num_slots, ops=ops,
             trade_num=trade_num, trade_id=trade_id, use_cvm=use_cvm,
             cvm_offset=cvm_offset)
    return _TradeW.apply(values, segments, batch_show_clk, a)


# ---------------------------------------------------------------------------
# credit
# ---------------------------------------------------------------------------

_CREDIT_OFFSET = 4  # show, click, conv, credit


class _Credit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, segments, batch_cvm, a):
        co = _CREDIT_OFFSET
        pooled = _pool_core(values, segments, a["batch_size"],
                            a["num_slots"], ops=a["ops"])
        if a["use_cvm"]:
            head = torch.log1p(pooled[..., :co])
            if a["show_filter"]:
                head = head[..., 1:]
            out = torch.cat([head, pooled[..., co:]], dim=-1)
        else:
            out = pooled[..., co:]
        ctx.a, ctx.shape, ctx.dtype = a, values.shape, values.dtype
        ctx.save_for_backward(segments, batch_cvm)
        return out

    @staticmethod
    def backward(ctx, g):
        segments, batch_cvm = ctx.saved_tensors
        a = ctx.a
        co = _CREDIT_OFFSET
        n_head = ((co - 1 if a["show_filter"] else co) if a["use_cvm"]
                  else 0)
        out = _grad_rows(g, n_head, ctx.shape[1] - co, segments, batch_cvm,
                         a)
        return out.to(ctx.dtype), None, None, None


def fused_seqpool_cvm_with_credit(
    values: torch.Tensor,             # [K, 4 + E]
    segments: torch.Tensor,
    batch_cvm: torch.Tensor,          # [B, 4]
    batch_size: int,
    num_slots: int,
    use_cvm: bool = True,
    show_filter: bool = False,
    ops: KernelSet = KERNELS,
) -> torch.Tensor:
    """Pool with the credit head: log1p of [show, click, conv, credit]
    (``show_filter`` drops the show column), then the embeds."""
    a = dict(batch_size=batch_size, num_slots=num_slots, ops=ops,
             use_cvm=use_cvm, show_filter=show_filter)
    return _Credit.apply(values, segments, batch_cvm, a)


# ---------------------------------------------------------------------------
# pcoc
# ---------------------------------------------------------------------------

class _Pcoc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, segments, batch_cvm, q_values, a):
        used = batch_cvm.shape[1]        # 4 + pclk_num
        pooled = _pool_core(values, segments, a["batch_size"],
                            a["num_slots"], ops=a["ops"])
        if a["use_cvm"]:
            lg = torch.log1p(pooled[..., :used])
            show_l, clk_l = lg[..., 0:1], lg[..., 1:2]
            pclk_l = lg[..., 4:used]
            out = torch.cat([show_l, clk_l - show_l, pclk_l - lg[..., 2:3],
                             pclk_l - lg[..., 3:4], pooled[..., used:]],
                            dim=-1)
        else:
            out = pooled[..., used:]
        ctx.a, ctx.shape, ctx.dtype = a, values.shape, values.dtype
        ctx.save_for_backward(segments, batch_cvm, q_values)
        return out

    @staticmethod
    def backward(ctx, g):
        segments, batch_cvm, q_values = ctx.saved_tensors
        a = ctx.a
        p = batch_cvm.shape[1] - 4
        used = 4 + p
        # the first 4 cvm columns carry the batch cvm, the pclk columns
        # the per-instance q_values
        head = torch.cat([batch_cvm[:, :4].float(), q_values.float()], dim=1)
        out = _grad_rows(g, (2 + 2 * p) if a["use_cvm"] else 0,
                         ctx.shape[1] - used, segments, head, a)
        return out.to(ctx.dtype), None, None, None, None


def fused_seqpool_cvm_with_pcoc(
    values: torch.Tensor,             # [K, 4 + pclk_num + E]
    segments: torch.Tensor,
    batch_cvm: torch.Tensor,          # [B, 4 + pclk_num]
    q_values: torch.Tensor,           # [B, pclk_num]
    batch_size: int,
    num_slots: int,
    use_cvm: bool = True,
    ops: KernelSet = KERNELS,
) -> torch.Tensor:
    """Output head (use_cvm): [log1p(show), log1p(clk)-log1p(show),
    {log1p(pclk_i)-log1p(show2)}, {log1p(pclk_i)-log1p(clk2)}] + embeds."""
    a = dict(batch_size=batch_size, num_slots=num_slots, ops=ops,
             use_cvm=use_cvm)
    return _Pcoc.apply(values, segments, batch_cvm, q_values, a)
