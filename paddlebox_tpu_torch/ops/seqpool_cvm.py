"""fused_seqpool_cvm — the core CTR fusion, forward and backward
(counterpart of ``paddlebox_tpu/ops/seqpool_cvm.py``).

Every slot of every instance is one segment (``ins*S + slot``) of a
single flattened ``[K, D]`` value tensor. On the ragged layout the
forward pools and applies the CVM head in one kernel
(``ops.kernels.pool_cvm``) and the backward writes each key's grad row
in one kernel (``ops.kernels.segment_gather`` in its epilogue mode). The
trivial layout (``segments is None``: exactly one key per (instance,
slot), slot-ordered) is a reshape forward and a slice backward.

The backward follows the reference's contract (fused_seqpool_cvm_op.cu
:634-716): the embed/embedx columns receive the output grad of their
segment, the first ``cvm_offset`` columns receive the batch show/clk
values instead of a chain-rule grad (so the sparse push learns its
counters), and keys that were filtered, padded or are not valid get
zero. Quantization and the log transform are straight-through. One
difference from the reference: a key with a NEGATIVE segment id gets a
zero grad row here, where the reference reads the last instance's
show/clk into its head; no batch builder emits such ids.

The concat (``embedx_concate_size > 1``) and embed-threshold-filter
variants are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from paddlebox_tpu_torch.ops.kernels import (CVM_FULL, CVM_NONE, CVM_SHOW,
                                             KERNELS, KernelSet,
                                             _cvm_slice, _cvm_transform_wide,
                                             cvm_out_width, show_clk_keep)


class _Attrs(NamedTuple):
    batch_size: int
    num_slots: int
    use_cvm: bool
    cvm_offset: int
    pad_value: float
    need_filter: bool
    show_coeff: float
    clk_coeff: float
    threshold: float
    quant_ratio: int
    clk_filter: bool
    ets: int              # embed_thres_size
    ops: KernelSet


def _forward(values: torch.Tensor, segments: Optional[torch.Tensor],
             a: _Attrs):
    """Pooled output [B, S, D_out] and the keep mask (None: all kept)."""
    d = values.shape[1]
    v = values
    if a.quant_ratio > 0:
        # quantize embedx dims only; the cvm dims pass through, so the
        # filter below (which reads only them) is unaffected
        q = torch.floor(v * a.quant_ratio + 0.5) / a.quant_ratio
        col = torch.arange(d, device=v.device) >= a.cvm_offset
        v = torch.where(col[None, :], q, v)
    keep = (show_clk_keep(v, a.show_coeff, a.clk_coeff, a.threshold)
            if a.need_filter else None)
    mode = CVM_NONE if not a.use_cvm else (CVM_SHOW if a.clk_filter
                                           else CVM_FULL)
    ets = 0 if a.use_cvm else a.ets
    b, s = a.batch_size, a.num_slots
    if segments is not None:
        out = a.ops.pool_cvm(v, segments,
                             None if keep is None else keep.float(), b, s,
                             cvm_mode=mode, cvm_offset=a.cvm_offset,
                             ets=ets, pad_value=a.pad_value)
        return out, keep
    # trivial layout: key j is segment j, so the pool is a reshape
    cvm_out_width(d, mode, a.cvm_offset, ets)
    k, n = v.shape[0], b * s
    if keep is not None:
        v = torch.where(keep[:, None], v, 0.0)
    if k < n:  # key bucket smaller than B*S (partial batches)
        v = torch.cat([v, v.new_zeros((n - k, d))])
    pooled = v[:n].reshape(b, s, d) + a.pad_value
    out = _cvm_slice(_cvm_transform_wide(pooled, mode), mode, a.cvm_offset,
                     ets)
    return out, keep


def _backward(g: torch.Tensor, segments: Optional[torch.Tensor],
              keep: Optional[torch.Tensor], batch_show_clk: torch.Tensor,
              key_valid: Optional[torch.Tensor], k: int, d: int,
              a: _Attrs) -> torch.Tensor:
    """Grad of the values [K, D] from the output grad [B, S, D_out]."""
    if batch_show_clk is None:
        raise ValueError("fused_seqpool_cvm backward needs batch_show_clk")
    b, s = a.batch_size, a.num_slots
    n = b * s
    # the use_cvm output head is the TRANSFORMED columns: one for the
    # clk_filter head, two (log1p(show), ctr) otherwise
    n_head = (1 if a.clk_filter else 2) if a.use_cvm else 0
    ets = 0 if a.use_cvm else a.ets
    w = d - a.cvm_offset - ets
    head = batch_show_clk.float().contiguous()
    if head.shape != (b, a.cvm_offset):
        raise ValueError(f"batch_show_clk {tuple(head.shape)} is not "
                         f"[batch_size, cvm_offset] = [{b}, "
                         f"{a.cvm_offset}]")
    mask = None if keep is None else keep.float()
    if key_valid is not None:
        kv = (key_valid > 0).float()
        mask = kv if mask is None else mask * kv
    src = g.float().reshape(n, n_head + w)[:, n_head:]
    if segments is not None:
        out = a.ops.segment_gather(src, segments, head,
                                   None if mask is None else mask.contiguous(),
                                   b, s, ets)
        return out.to(g.dtype)
    # trivial layout: key j ↔ segment j, so the gather is a slice
    if k > n:
        src = torch.cat([src, src.new_zeros((k - n, w))])
    ids = torch.arange(k, device=g.device)
    live = ids < n
    if mask is not None:
        live = live & (mask != 0)
    ins = (ids // s).clamp_max(b - 1)
    out = torch.cat([head[ins], src.new_zeros((k, ets)), src[:k]], dim=1)
    return torch.where(live[:, None], out, 0.0).to(g.dtype)


class _SeqpoolCVM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, segments, batch_show_clk, key_valid, attrs):
        out, keep = _forward(values, segments, attrs)
        ctx.attrs = attrs
        ctx.shape = values.shape
        ctx.save_for_backward(segments, keep, batch_show_clk, key_valid)
        return out

    @staticmethod
    def backward(ctx, g):
        segments, keep, batch_show_clk, key_valid = ctx.saved_tensors
        k, d = ctx.shape
        g_values = _backward(g.contiguous(), segments, keep, batch_show_clk,
                             key_valid, k, d, ctx.attrs)
        return g_values, None, None, None, None


def fused_seqpool_cvm(
    values: torch.Tensor,             # [K, D] pulled embeddings (D incl. cvm)
    segments: Optional[torch.Tensor],  # [K] int32 ins*S + slot; pads → B*S
    batch_show_clk: Optional[torch.Tensor],  # [B, cvm_offset] show/clk
    batch_size: int,
    num_slots: int,
    use_cvm: bool = True,
    cvm_offset: int = 2,
    pad_value: float = 0.0,
    need_filter: bool = False,
    show_coeff: float = 0.2,
    clk_coeff: float = 1.0,
    threshold: float = 0.96,
    quant_ratio: int = 0,
    clk_filter: bool = False,
    embed_threshold_filter: bool = False,
    embed_threshold: float = 0.0,
    embed_thres_size: int = 0,
    embedx_concate_size: int = 1,
    embedx_concate_filter: bool = False,
    key_valid: Optional[torch.Tensor] = None,
    ops: KernelSet = KERNELS,
) -> torch.Tensor:
    """Pooled, CVM-transformed features [B, S, D_out], differentiable in
    ``values``.

    Output width per slot: ``D`` with use_cvm, ``D-1`` with use_cvm and
    clk_filter, ``D - cvm_offset - embed_thres_size`` without cvm. The
    arguments are the reference's, in its positions. ``batch_show_clk``
    is read only by the backward (it may be None where no grad is
    taken); ``key_valid`` (float [K], 1.0 = real key) masks batch padding
    in the backward. ``ops`` selects the device functions (the kernels,
    unless a check passes ``kernels.PLAIN``)."""
    if embed_threshold_filter:
        raise NotImplementedError(
            "embed_threshold_filter is not ported yet (ROADMAP queue 1)")
    kk = 1 if (use_cvm and not clk_filter) else embedx_concate_size
    if kk != 1:
        raise NotImplementedError(
            "embedx_concate_size > 1 is not ported yet (ROADMAP queue 1)")
    del embed_threshold, embedx_concate_filter  # concat/threshold only
    attrs = _Attrs(batch_size, num_slots, use_cvm, cvm_offset, pad_value,
                   need_filter, show_coeff, clk_coeff, threshold,
                   quant_ratio, clk_filter, embed_thres_size, ops)
    return _SeqpoolCVM.apply(values, segments, batch_show_clk, key_valid,
                             attrs)
