"""fused_seqpool_cvm and its siblings — the core CTR fusion, forward and
backward (counterpart of ``paddlebox_tpu/ops/seqpool_cvm.py``).

Every slot of every instance is one segment (``ins*S + slot``) of a
single flattened ``[K, D]`` value tensor. On the ragged layout the
forward pools and applies the CVM head in one kernel
(``ops.kernels.pool_cvm``) and the backward writes each key's grad row
in one kernel (``ops.kernels.segment_gather`` in its epilogue mode). The
trivial layout (``segments is None``: exactly one key per (instance,
slot), slot-ordered) is a reshape forward and a slice backward. The
concat form (``embedx_concate_size`` k > 1) emits the first k keys of
each sequence one by one: it sums each key into its own (segment, rank)
bin with ``ops.kernels.segment_sum``, the dropped keys marked −1, and
gathers its grad with ``segment_gather`` — the JAX package's form under
``FLAGS.use_pallas_seqpool``.

The backward follows the reference's contract (fused_seqpool_cvm_op.cu
:634-716): the embed/embedx columns receive the output grad of their
segment, the first ``cvm_offset`` columns receive the batch show/clk
values instead of a chain-rule grad (so the sparse push learns its
counters), and keys that were filtered, padded or are not valid get
zero. Quantization and the log transform are straight-through. A key
with a NEGATIVE segment id keeps its head row — the batch show/clk of
instance ``floor(id / S)``, counted from the end as JAX indexes — and
zero embedx columns, as in the JAX package under both flag settings.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from paddlebox_tpu_torch.ops import _build
from paddlebox_tpu_torch.ops.kernels import (CVM_CONV, CVM_FULL, CVM_NONE,
                                             CVM_SHOW, KERNELS, KernelSet,
                                             _cvm_slice, _cvm_transform_wide,
                                             cvm_out_width, keep_or_ones,
                                             show_clk_keep)


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
    embed_threshold_filter: bool
    embed_threshold: float
    ets: int              # embed_thres_size
    kk: int               # embedx_concate_size where it applies, else 1
    concate_filter: bool  # embedx_concate_filter
    ops: KernelSet


def _keep_mask(v: torch.Tensor, cvm_offset: int, need_filter: bool,
               show_coeff: float, clk_coeff: float, threshold: float,
               embed_threshold_filter: bool, embed_threshold: float,
               embed_thres_size: int) -> Optional[torch.Tensor]:
    """Key keep flags, bool [K] (None: every key kept): the show/clk
    significance (QuantFilter :93-133) and the embed-magnitude test
    (KernelEmbedQuantFilter :134-176)."""
    if not (need_filter or embed_threshold_filter):
        return None
    keep = show_clk_keep(v, show_coeff, clk_coeff, threshold)
    if embed_threshold_filter:
        ets = (embed_thres_size if embed_thres_size > 0
               else v.shape[1] - cvm_offset)
        e = v[:, cvm_offset:cvm_offset + ets]
        score = torch.sqrt((e[:, 1:] * e[:, 1:]).sum(dim=1)) + e[:, 0].abs()
        keep = keep & (score >= embed_threshold)
    return keep


def _segment_ranks(segments: torch.Tensor) -> torch.Tensor:
    """Occurrence index of each key within its segment (stable), int32.
    The first sorted position of each run comes from a binary search of
    the sorted ids, not a scan."""
    k = segments.shape[0]
    ss, order = torch.sort(segments, stable=True)
    rank = (torch.arange(k, device=segments.device)
            - torch.searchsorted(ss, ss)).to(torch.int32)
    return torch.empty_like(rank).scatter_(0, order, rank)


def _concat_ids(segs: torch.Tensor, rank: torch.Tensor, drop: torch.Tensor,
                a: _Attrs) -> torch.Tensor:
    """Each key's (segment, rank) bin ``seg*k + rank``, −1 where it is
    dropped or a pad: the kept ids stay nondecreasing."""
    n = a.batch_size * a.num_slots
    return torch.where(drop | (segs >= n), -1,
                       segs * a.kk + rank).to(torch.int32).contiguous()


def _concat_drop(rank: torch.Tensor, keep: Optional[torch.Tensor],
                 a: _Attrs) -> torch.Tensor:
    """Keys past the first k of their sequence, and with
    ``embedx_concate_filter`` the filtered ones."""
    drop = rank >= a.kk
    if a.concate_filter and keep is not None:
        drop = drop | ~keep
    return drop


def _forward(values: torch.Tensor, segments: Optional[torch.Tensor],
             a: _Attrs):
    """Pooled output [B, S, D_out], the keep mask (None: all kept) and
    the concat ranks (None for k = 1)."""
    d = values.shape[1]
    v = values
    if a.quant_ratio > 0:
        # quantize embedx dims only; the cvm dims pass through, so the
        # filter below (which reads only them) is unaffected
        q = torch.floor(v * a.quant_ratio + 0.5) / a.quant_ratio
        col = torch.arange(d, device=v.device) >= a.cvm_offset
        v = torch.where(col[None, :], q, v)
    keep = _keep_mask(v, a.cvm_offset, a.need_filter, a.show_coeff,
                      a.clk_coeff, a.threshold, a.embed_threshold_filter,
                      a.embed_threshold, a.ets)
    b, s = a.batch_size, a.num_slots
    if a.kk > 1:
        return _concat_forward(v, segments, keep, a)
    mode = CVM_NONE if not a.use_cvm else (CVM_SHOW if a.clk_filter
                                           else CVM_FULL)
    ets = 0 if a.use_cvm else a.ets
    if segments is not None:
        out = a.ops.pool_cvm(v, segments,
                             None if keep is None else keep.float(), b, s,
                             cvm_mode=mode, cvm_offset=a.cvm_offset,
                             ets=ets, pad_value=a.pad_value)
        return out, keep, None
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
    return out, keep, None


def _concat_forward(v: torch.Tensor, segments: Optional[torch.Tensor],
                    keep: Optional[torch.Tensor], a: _Attrs):
    """…EmbedxConcate kernels: the j-th block of a (instance, slot) is
    its j-th key, not a sum; keys of rank >= k drop. ``pad_value`` fills
    the EMPTY blocks only."""
    k, d = v.shape
    b, s, kk = a.batch_size, a.num_slots, a.kk
    if segments is None:
        # trivial layout: one key per segment, so every rank is 0
        segs = torch.arange(k, dtype=torch.int32, device=v.device)
        rank = torch.zeros_like(segs)
    else:
        segs, rank = segments, _segment_ranks(segments)
    drop = _concat_drop(rank, keep, a)
    seg2 = _concat_ids(segs, rank, drop, a)
    n2 = b * s * kk
    vv = torch.where(drop[:, None], 0.0, v)
    pooled = a.ops.segment_sum(vv, seg2, n2 + 1)[:-1]
    if a.pad_value:
        cnt = a.ops.segment_sum((~drop).float()[:, None], seg2, n2 + 1)[:-1]
        pooled = torch.where(cnt > 0, pooled, a.pad_value)
    pooled = pooled.reshape(b, s, kk, d)
    if a.use_cvm:
        # FusedCVMKernelWithShow :301 (k > 1 needs clk_filter with cvm):
        # [log(show+1), embedx…], the click column skipped
        out = torch.cat([torch.log1p(pooled[..., 0:1]),
                         pooled[..., a.cvm_offset:]], dim=-1)
    else:
        out = pooled[..., a.cvm_offset + a.ets:]
    return out.reshape(b, s, -1), keep, rank


def _backward(g: torch.Tensor, segments: Optional[torch.Tensor],
              keep: Optional[torch.Tensor], rank: Optional[torch.Tensor],
              batch_show_clk: torch.Tensor,
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
    if a.kk > 1:
        segs = (torch.arange(k, dtype=torch.int32, device=g.device)
                if segments is None else segments)
        drop = _concat_drop(rank, keep, a)
        live = ~drop & (segs < n)
        if key_valid is not None:
            live = live & (key_valid > 0)
        # one bin per (segment, rank): S*k bins an instance, so the
        # epilogue's head index id // (S*k) is the key's instance
        src = g.float().reshape(n * a.kk, n_head + w)[:, n_head:]
        out = a.ops.segment_gather(src, _concat_ids(segs, rank, drop, a),
                                   head, live.float().contiguous(), b,
                                   s * a.kk, ets)
        return out.to(g.dtype)
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
        out, keep, rank = _forward(values, segments, attrs)
        ctx.attrs = attrs
        ctx.shape = values.shape
        ctx.save_for_backward(segments, keep, rank, batch_show_clk,
                              key_valid)
        return out

    @staticmethod
    def backward(ctx, g):
        segments, keep, rank, batch_show_clk, key_valid = ctx.saved_tensors
        k, d = ctx.shape
        g_values = _backward(g.contiguous(), segments, keep, rank,
                             batch_show_clk, key_valid, k, d, ctx.attrs)
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

    Output width per slot, with k = ``embedx_concate_size``: ``(D-1)*k``
    with use_cvm and clk_filter, ``D`` with use_cvm alone (k is ignored
    there, as in the reference), ``(D - cvm_offset - embed_thres_size)*k``
    without cvm. ``embed_threshold_filter`` also drops keys whose embed
    magnitude |e0| + ||e1..ets-1|| is below ``embed_threshold``; k > 1
    emits the first k keys of each (instance, slot) one by one, and with
    ``embedx_concate_filter`` a filtered key leaves its block empty
    (``pad_value``). The arguments are the reference's, in its
    positions. ``batch_show_clk`` is read only by the backward (it may be
    None where no grad is taken); ``key_valid`` (float [K], 1.0 = real
    key) masks batch padding in the backward. ``ops`` selects the device
    functions (the kernels, unless a check passes ``kernels.PLAIN``)."""
    kk = 1 if (use_cvm and not clk_filter) else embedx_concate_size
    if kk == 1 and segments is None and ops is KERNELS:
        # the trivial layout pools by a reshape, no kernel: booked as the
        # reference books its dispatch decision
        _build.book(ops.pool_cvm, "reshape")
    attrs = _Attrs(batch_size, num_slots, use_cvm, cvm_offset, pad_value,
                   need_filter, show_coeff, clk_coeff, threshold,
                   quant_ratio, clk_filter, embed_threshold_filter,
                   embed_threshold, embed_thres_size, kk,
                   embedx_concate_filter, ops)
    return _SeqpoolCVM.apply(values, segments, batch_show_clk, key_valid,
                             attrs)


# ---------------------------------------------------------------------------
# The shared pooling body
# ---------------------------------------------------------------------------

def _pool_core(values: torch.Tensor, segments: Optional[torch.Tensor],
               batch_size: int, num_slots: int,
               keep: Optional[torch.Tensor] = None, pad_value: float = 0.0,
               ops: KernelSet = KERNELS) -> torch.Tensor:
    """mask → segment sum → [B, S, D] (+pad): the pool of the variants
    and of ``fused_seqpool_concat``, through ``ops.segment_sum`` into
    B*S + 1 bins (the last, where the batch pads go, is cut off).
    ``segments=None`` declares the trivial layout: the pool is a
    reshape."""
    if keep is not None:
        values = torch.where(keep[:, None], values, 0.0)
    d = values.shape[1]
    n = batch_size * num_slots
    if segments is None:
        k = values.shape[0]
        if k < n:  # key bucket smaller than B*S (partial batches)
            values = torch.cat([values, values.new_zeros((n - k, d))])
        return values[:n].reshape(batch_size, num_slots, d) + pad_value
    pooled = ops.segment_sum(values, segments, n + 1)
    return pooled[:-1].reshape(batch_size, num_slots, d) + pad_value


def _filtered_pool(values: torch.Tensor, segments: Optional[torch.Tensor],
                   batch_size: int, num_slots: int, pad_value: float,
                   need_filter: bool, show_coeff: float, clk_coeff: float,
                   threshold: float, ops: KernelSet = KERNELS):
    """The show/clk filter, then :func:`_pool_core`; returns the pooled
    block and the keep mask."""
    keep = keep_or_ones(values, need_filter, show_coeff, clk_coeff,
                        threshold)
    return _pool_core(values, segments, batch_size, num_slots, keep,
                      pad_value, ops), keep


# ---------------------------------------------------------------------------
# conv
# ---------------------------------------------------------------------------

_CONV_OFFSET = 3


class _SeqpoolConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, segments, batch_cvm, a):
        keep = keep_or_ones(values, a["need_filter"], a["show_coeff"],
                            a["clk_coeff"], a["threshold"])
        out = a["ops"].pool_cvm(
            values, segments, keep.float(), a["batch_size"],
            a["num_slots"],
            cvm_mode=CVM_CONV if a["use_cvm"] else CVM_NONE,
            cvm_offset=_CONV_OFFSET, pad_value=a["pad_value"])
        if a["use_cvm"] and a["show_filter"]:
            out = out[..., 1:].contiguous()
        ctx.a = a
        ctx.shape, ctx.dtype = values.shape, values.dtype
        ctx.save_for_backward(segments, keep, batch_cvm)
        return out

    @staticmethod
    def backward(ctx, g):
        segments, keep, batch_cvm = ctx.saved_tensors
        a = ctx.a
        b, s = a["batch_size"], a["num_slots"]
        n_head = ((_CONV_OFFSET - 1 if a["show_filter"] else _CONV_OFFSET)
                  if a["use_cvm"] else 0)
        w = ctx.shape[1] - _CONV_OFFSET
        src = g.float().reshape(b * s, n_head + w)[:, n_head:]
        out = a["ops"].segment_gather(src, segments,
                                      batch_cvm.float().contiguous(),
                                      keep.float(), b, s)
        return out.to(ctx.dtype), None, None, None


def fused_seqpool_cvm_with_conv(
    values: torch.Tensor,             # [K, D], D incl. show, clk, conv
    segments: torch.Tensor,           # [K] int32 ins*S + slot; pads → B*S
    batch_show_clk_conv: torch.Tensor,  # [B, 3]
    batch_size: int,
    num_slots: int,
    use_cvm: bool = True,
    show_filter: bool = False,
    pad_value: float = 0.0,
    need_filter: bool = False,
    show_coeff: float = 0.2,
    clk_coeff: float = 1.0,
    threshold: float = 0.96,
    ops: KernelSet = KERNELS,
) -> torch.Tensor:
    """Show/click/conversion variant (fused_seqpool_cvm_with_conv_op.cu
    :143-147): the CVM head is [log(show+1), log(clk+1),
    log(conv+1)-log(clk+1)], pooled and transformed in one ``pool_cvm``
    (conv head); ``show_filter`` strips the show column. The backward is
    ``segment_gather``'s grad row with the batch [show, clk, conv]
    head."""
    a = dict(batch_size=batch_size, num_slots=num_slots, use_cvm=use_cvm,
             show_filter=show_filter, pad_value=pad_value,
             need_filter=need_filter, show_coeff=show_coeff,
             clk_coeff=clk_coeff, threshold=threshold, ops=ops)
    return _SeqpoolConv.apply(values, segments, batch_show_clk_conv, a)


# ---------------------------------------------------------------------------
# slot groups and seqpool_concat
# ---------------------------------------------------------------------------

def slot_group_bounds(num_slots: int, groups: int) -> List[Tuple[int, int]]:
    """Contiguous slot partition: ``groups`` spans [lo, hi) covering [0,
    num_slots), the first ``num_slots % groups`` spans one slot wider."""
    groups = max(1, min(groups, num_slots))
    base, rem = divmod(num_slots, groups)
    bounds = []
    lo = 0
    for g in range(groups):
        hi = lo + base + (1 if g < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def fused_seqpool_cvm_slot_group(
    values: torch.Tensor,             # [K_g, D] the group's pulled rows
    segments: torch.Tensor,           # [K_g] GLOBAL ins*S + slot; pads → B*S
    batch_show_clk: torch.Tensor,     # [B, cvm_offset]
    batch_size: int,
    num_slots_total: int,
    slot_lo: int,
    slot_hi: int,
    use_cvm: bool = True,
    cvm_offset: int = 2,
    ops: KernelSet = KERNELS,
) -> torch.Tensor:
    """Pool ONE contiguous slot group [slot_lo, slot_hi) of the batch into
    its [B, S_g, D'] block. Every key of the group's stream must have its
    slot inside the group (pads at B*S go to the group's discard bin);
    the blocks of all groups, concatenated in slot order, equal the
    monolithic ``fused_seqpool_cvm``. Ids renumber as ``ins*S + slot →
    ins*S_g + (slot - slot_lo)``."""
    s, sg = num_slots_total, slot_hi - slot_lo
    if slot_lo == 0 and slot_hi == s:
        return fused_seqpool_cvm(values, segments, batch_show_clk,
                                 batch_size, s, use_cvm, cvm_offset, ops=ops)
    ins = segments // s
    local = ins * sg + (segments - ins * s) - slot_lo
    seg_local = torch.where(segments >= batch_size * s, batch_size * sg,
                            local).to(segments.dtype)
    return fused_seqpool_cvm(values, seg_local, batch_show_clk, batch_size,
                             sg, use_cvm, cvm_offset, ops=ops)


def fused_seqpool_concat(values: torch.Tensor, segments: torch.Tensor,
                         batch_size: int, num_slots: int,
                         pad_value: float = 0.0,
                         ops: KernelSet = KERNELS) -> torch.Tensor:
    """Plain seqpool + concat (fusion_seqpool_concat_op): the sum of each
    (instance, slot) [B, S, D] + ``pad_value``, no CVM columns.
    Differentiable through ``ops.segment_sum``."""
    return _pool_core(values, segments, batch_size, num_slots,
                      pad_value=pad_value, ops=ops)
