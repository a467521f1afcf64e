"""The port's device kernels and their plain PyTorch versions — the
counterpart of ``paddlebox_tpu/ops/pallas_kernels.py``.

Each kernel wrapper takes its plain version for a tensor on the CPU and
launches the CUDA kernel (``csrc/<name>.cu``, the two DMA row copies
sharing ``csrc/row_dma.cu``; built on first use by ``ops/_build.py``)
for a tensor on the card. There is no other dispatch:
a CUDA tensor never reaches a plain version inside the port, and a
failed build or launch raises. Each wrapper counts its launches in its
``launches`` attribute, so a run can show which kernels it went through.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch

from paddlebox_tpu_torch.ops import _build, ctr_kernels, index

#: static CVM epilogue modes (which head columns transform)
CVM_NONE = 0      # no transform (use_cvm=False; the head is sliced off)
CVM_FULL = 1      # [log1p(show), log1p(clk)-log1p(show), embedx…]
CVM_SHOW = 2      # clk_filter head: [log1p(show), embedx…]
CVM_CONV = 3      # conv head: [log1p(show), log1p(clk), log1p(conv)-log1p(clk)]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# C signatures of the kernel entries (csrc/*.cu)
_GATHER_ARGS = [_P, _P, _P, _I64, _I64, _I32, _I32, _P]
_BOUNDS_ARGS = [_P, _I64, _I32, _P, _P]
_POOL_ARGS = [_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _I32,
              ctypes.c_float, _P]
_SEG_GATHER_ARGS = [_P, _I64, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32,
                    _I32, _I32, _P]
_SCATTER_ADD_ARGS = [_P, _P, _P, _I64, _I64, _I32, _I32, _P]
_SEG_SUM_ARGS = [_P, _P, _P, _P, _I64, _I32, _I32, _P]
_ROW_ARGS = [_P, _P, _P, _I64, _I64, _I32, _I32, _P]   # scatter_rows, row_dma
#: keys a pool kernel takes (its key indexes are int32)
_MAX_POOL_KEYS = 2 ** 31 - 2
#: rows per grid block of the TPU's DMA row kernels (pallas_kernels._TR):
#: their row count must be a multiple of min(_DMA_BLOCK, K)
_DMA_BLOCK = 2048


def show_clk_keep(values: torch.Tensor, show_coeff: float, clk_coeff: float,
                  threshold: float) -> torch.Tensor:
    """The show/clk significance filter (QuantFilter), bool [K]."""
    show, clk = values[:, 0], values[:, 1]
    return ((show - clk) * show_coeff + clk * clk_coeff) >= threshold


def keep_or_ones(values: torch.Tensor, need_filter: bool, show_coeff: float,
                 clk_coeff: float, threshold: float) -> torch.Tensor:
    """bool [K] keep mask: the show/clk filter when requested, all ones
    otherwise."""
    if need_filter:
        return show_clk_keep(values, show_coeff, clk_coeff, threshold)
    return torch.ones(values.shape[0], dtype=torch.bool,
                      device=values.device)


def _vec4(f: int, *tensors: torch.Tensor) -> bool:
    """Whether rows of ``f`` floats move as 16-byte vectors."""
    return f % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


# ---------------------------------------------------------------------------
# Row gather (the pull)
# ---------------------------------------------------------------------------

def gather_rows_plain(table: torch.Tensor, rows: torch.Tensor
                      ) -> torch.Tensor:
    """table [C+1, F], rows [U] int → [U, F]; ids outside [0, C] read the
    sentinel row C."""
    c = table.shape[0] - 1
    r = rows.long().clamp_max(c)
    return table[torch.where(r < 0, c, r)]


def gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """table [C+1, F] f32, rows [U] int32 → [U, F] = table[min(rows, C)]
    (ids outside [0, C] read the zero sentinel row C). Exact."""
    if table.device.type == "cpu" and rows.device.type == "cpu":
        return gather_rows_plain(table, rows)
    _build.require_cuda("gather_rows", table, rows)
    if table.dtype != torch.float32 or rows.dtype != torch.int32:
        raise TypeError("gather_rows: needs a float32 table and int32 rows")
    if table.dim() != 2 or rows.dim() != 1:
        raise ValueError("gather_rows: table [C+1, F] and rows [U]")
    u, f = rows.shape[0], table.shape[1]
    out = torch.empty((u, f), dtype=table.dtype, device=table.device)
    if u == 0:
        return out
    vec = 4 if _vec4(f, table, out) else 1
    fn = _build.function("gather_rows", "pbx_gather_rows", _GATHER_ARGS)
    _build.check(fn(table.data_ptr(), rows.data_ptr(), out.data_ptr(),
                    u, table.shape[0] - 1, f, vec, _build.stream(table)),
                 "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


# ---------------------------------------------------------------------------
# Fused pool + CVM forward
# ---------------------------------------------------------------------------

def _cvm_transform_wide(pooled: torch.Tensor, cvm_mode: int
                        ) -> torch.Tensor:
    """Column-in-place CVM transform of the pooled block (the head
    columns are replaced, the width is unchanged)."""
    if cvm_mode == CVM_NONE:
        return pooled
    out = pooled.clone()
    l0 = torch.log1p(pooled[..., 0])
    out[..., 0] = l0
    if cvm_mode == CVM_FULL:
        out[..., 1] = torch.log1p(pooled[..., 1]) - l0
    elif cvm_mode == CVM_CONV:
        l1 = torch.log1p(pooled[..., 1])
        out[..., 1] = l1
        out[..., 2] = torch.log1p(pooled[..., 2]) - l1
    return out


def _cvm_slice(buf: torch.Tensor, cvm_mode: int, cvm_offset: int,
               ets: int) -> torch.Tensor:
    """The output columns of a transformed block, per head mode (the
    InferShape width contract)."""
    if cvm_mode == CVM_NONE:
        return buf[..., cvm_offset + ets:]
    if cvm_mode == CVM_FULL:
        return torch.cat([buf[..., :2], buf[..., cvm_offset:]], dim=-1)
    if cvm_mode == CVM_SHOW:
        return torch.cat([buf[..., :1], buf[..., cvm_offset:]], dim=-1)
    return buf


def cvm_out_width(d: int, cvm_mode: int, cvm_offset: int, ets: int) -> int:
    """Output width per segment; raises on a mode/offset combination the
    head cannot take."""
    need = {CVM_NONE: (0, cvm_offset + ets), CVM_FULL: (2, cvm_offset),
            CVM_SHOW: (1, cvm_offset), CVM_CONV: (0, 3)}
    if cvm_mode not in need:
        raise ValueError(f"unknown cvm_mode {cvm_mode}")
    min_off, cut = need[cvm_mode]
    if cvm_offset < min_off or cut > d or ets < 0:
        raise ValueError(f"cvm_mode {cvm_mode} with cvm_offset "
                         f"{cvm_offset}, ets {ets} on width {d}")
    if cvm_mode == CVM_NONE:
        return d - cut
    if cvm_mode == CVM_CONV:
        return d
    return min_off + d - cut


def pool_cvm_plain(values: torch.Tensor, segments: torch.Tensor,
                   keep: Optional[torch.Tensor], batch_size: int,
                   num_slots: int, cvm_mode: int = CVM_FULL,
                   cvm_offset: int = 2, ets: int = 0,
                   pad_value: float = 0.0) -> torch.Tensor:
    """Plain version of :func:`pool_cvm`: an accumulating ``index_put_``
    over the segments (ids outside [0, B*S) fall into a discarded bin),
    then ``pad_value`` and the CVM epilogue. The accumulating put sorts
    the ids stably and sums each segment's keys in key order, as the
    kernel does, so the two agree bit for bit on the card (``index_add_``
    would add in atomic order there, which differs from run to run)."""
    k, d = values.shape
    n = batch_size * num_slots
    cvm_out_width(d, cvm_mode, cvm_offset, ets)
    seg = segments.long()
    seg = torch.where((seg >= 0) & (seg < n), seg, n)
    v = values.float()
    if keep is not None:
        v = torch.where(keep[:, None] != 0, v, 0.0)
    pooled = torch.zeros((n + 1, d), dtype=torch.float32,
                         device=values.device).index_put_(
                             (seg,), v, accumulate=True)[:n]
    out = _cvm_slice(_cvm_transform_wide(pooled + pad_value, cvm_mode),
                     cvm_mode, cvm_offset, ets)
    return out.reshape(batch_size, num_slots, -1).to(values.dtype)


def segment_bounds_plain(ids: torch.Tensor, n: int) -> torch.Tensor:
    """What the pool kernels' bounds pass computes: [2, n] int32, row 0
    the first key j with ids[j] == s, row 1 the last one + 1, both −1 for
    a segment with no key. Ids outside [0, n) are dropped."""
    idl = ids.long()
    ok = (idl >= 0) & (idl < n)
    j = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)[ok]
    start = torch.full((n,), _MAX_POOL_KEYS, dtype=torch.int32,
                       device=ids.device).scatter_reduce_(0, idl[ok], j,
                                                          "amin")
    end = torch.full((n,), -1, dtype=torch.int32,
                     device=ids.device).scatter_reduce_(0, idl[ok], j + 1,
                                                        "amax")
    return torch.stack([torch.where(end < 0, -1, start), end])


def _bounds_scratch(name: str, values: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """The [2, n] int32 scratch of a CUDA pool's bounds pass."""
    if values.shape[0] > _MAX_POOL_KEYS:
        raise ValueError(f"{name}: {values.shape[0]} keys, more than "
                         f"{_MAX_POOL_KEYS}")
    return torch.empty((2, n), dtype=torch.int32, device=values.device)


def pool_cvm(values: torch.Tensor, segments: torch.Tensor,
             keep: Optional[torch.Tensor], batch_size: int, num_slots: int,
             cvm_mode: int = CVM_FULL, cvm_offset: int = 2, ets: int = 0,
             pad_value: float = 0.0) -> torch.Tensor:
    """values [K, D] f32 pulled embeddings, segments [K] int32 (ins*S +
    slot; the ids inside [0, B*S) must be nondecreasing, anything else is
    dropped), keep [K] optional f32 0/1 key mask (None keeps every key) →
    the CVM-transformed pooled output [B, S, D_out] (``csrc/pool_cvm.cu``:
    one C call enqueues the segment bounds pass and the tile kernel).
    ``ets`` (embed_thres_size) only affects the CVM_NONE output slice."""
    if values.device.type == "cpu" and segments.device.type == "cpu":
        return pool_cvm_plain(values, segments, keep, batch_size, num_slots,
                              cvm_mode, cvm_offset, ets, pad_value)
    extra = () if keep is None else (keep,)
    _build.require_cuda("pool_cvm", values, segments, *extra)
    if (values.dtype != torch.float32 or segments.dtype != torch.int32
            or any(t.dtype != torch.float32 for t in extra)):
        raise TypeError("pool_cvm: needs float32 values and keep, int32 "
                        "segments")
    k, d = values.shape
    n = batch_size * num_slots
    d_out = cvm_out_width(d, cvm_mode, cvm_offset, ets)
    if d > 128:
        raise ValueError(f"pool_cvm: width {d} > 128")
    if segments.shape != (k,) or (keep is not None and keep.shape != (k,)):
        raise ValueError("pool_cvm: values [K, D], segments and keep [K]")
    out = torch.empty((n, d_out), dtype=torch.float32, device=values.device)
    if n == 0:
        return out.reshape(batch_size, num_slots, d_out)
    bounds = _bounds_scratch("pool_cvm", values, n)
    fn = _build.function("pool_cvm", "pbx_pool_cvm", _POOL_ARGS)
    _build.check(fn(values.data_ptr(), segments.data_ptr(),
                    None if keep is None else keep.data_ptr(),
                    bounds.data_ptr(), out.data_ptr(), k, n, d, d_out,
                    cvm_mode, cvm_offset, ets, float(pad_value),
                    _build.stream(values)), "pool_cvm")
    pool_cvm.launches += 1
    return out.reshape(batch_size, num_slots, d_out)


pool_cvm.launches = 0


# ---------------------------------------------------------------------------
# Segment gather (the pool backward)
# ---------------------------------------------------------------------------

def segment_gather_plain(src: torch.Tensor, ids: torch.Tensor,
                         head: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None,
                         batch_size: int = 0, num_slots: int = 0,
                         ets: int = 0) -> torch.Tensor:
    """Plain version of :func:`segment_gather`: an index into ``src``
    with a zero row appended for the ids outside [0, N), then the
    epilogue's head, zeros and mask."""
    n, w = src.shape
    idl = ids.long()
    ok = (idl >= 0) & (idl < n)
    live = ok
    flat = torch.cat([src, src.new_zeros((1, w))])
    out = flat[torch.where(ok, idl, n)]
    if head is not None:
        live = ok | (idl < 0)
        out = torch.cat([head[_head_index(idl, batch_size, num_slots)],
                         src.new_zeros((ids.shape[0], ets)), out], dim=1)
    if mask is not None:
        live = live & (mask != 0)
    return torch.where(live[:, None], out, 0.0)


def _head_index(ids: torch.Tensor, batch_size: int, num_slots: int
                ) -> torch.Tensor:
    """The head row of each key's grad, ``min(floor(id / S), B - 1)``
    read as the JAX package indexes: a negative index counts from the
    end, then clamps to [0, B)."""
    ins = torch.div(ids, num_slots, rounding_mode="floor").clamp_max(
        batch_size - 1)
    return torch.where(ins < 0, ins + batch_size, ins).clamp_min(0)


def _segment_gather_args(src: torch.Tensor, ids: torch.Tensor,
                         head: Optional[torch.Tensor],
                         mask: Optional[torch.Tensor], batch_size: int,
                         num_slots: int, ets: int) -> None:
    """Raise the error that :func:`segment_gather`'s one combined check
    stands for (it runs only when that check fails)."""
    extra = [t for t in (head, mask) if t is not None]
    _build.require_cuda("segment_gather", ids, *extra)
    if src.device != ids.device:
        raise ValueError(f"segment_gather: tensors on {ids.device} and "
                         f"{src.device}")
    if (src.dtype != torch.float32 or ids.dtype != torch.int32
            or any(t.dtype != torch.float32 for t in extra)):
        raise TypeError("segment_gather: needs float32 src/head/mask and "
                        "int32 ids")
    if src.dim() != 2 or ids.dim() != 1 or (src.shape[1] > 1
                                            and src.stride(1) != 1):
        raise ValueError("segment_gather: src [N, w] with contiguous "
                         "columns and ids [K]")
    if head is not None:
        if head.dim() != 2 or head.shape[0] != batch_size \
                or batch_size < 1 or num_slots < 1:
            raise ValueError("segment_gather: head [batch_size, H] needs "
                             "batch_size, num_slots >= 1")
    elif ets:
        raise ValueError("segment_gather: ets needs the head epilogue")
    if mask is not None and mask.shape != (ids.shape[0],):
        raise ValueError("segment_gather: mask [K]")
    raise AssertionError("segment_gather: the combined check and its "
                         "errors disagree")


def segment_gather(src: torch.Tensor, ids: torch.Tensor,
                   head: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   batch_size: int = 0, num_slots: int = 0,
                   ets: int = 0) -> torch.Tensor:
    """src [N, w] f32 (rows may be strided, columns contiguous), ids [K]
    int32 → out [K, w] = src[ids] with zero rows for ids outside [0, N)
    (``csrc/segment_gather.cu``: one allocation, one C call). Exact.

    With ``head`` [batch_size, H] f32 it writes the fused seqpool grad
    row instead, out [K, H + ets + w] = [head[min(ids // num_slots,
    batch_size - 1)] | zeros(ets) | src[ids]], the reference's grad row:
    ids >= N give zero rows, and a NEGATIVE id keeps its head row (the
    index counts from the end, as in JAX) with zero embedx columns.
    ``mask`` [K] f32 zeroes the rows where it is 0 (in both modes)."""
    if src.device.type == "cpu" and ids.device.type == "cpu":
        return segment_gather_plain(src, ids, head, mask, batch_size,
                                    num_slots, ets)
    dev = ids.device
    k = ids.shape[0]
    f32 = torch.float32
    # every check of _segment_gather_args in one expression of cheap
    # attribute reads (this call is on the step's host path); on failure
    # that function raises the matching error
    if not (ids.is_cuda and ids.dtype == torch.int32 and ids.ndim == 1
            and ids.is_contiguous() and src.dtype == f32
            and src.device == dev and src.ndim == 2
            and (src.shape[1] < 2 or src.stride(1) == 1)
            and (mask is None or (
                mask.dtype == f32 and mask.device == dev
                and mask.is_contiguous() and mask.shape == (k,)))
            and (ets == 0 if head is None else (
                head.dtype == f32 and head.device == dev
                and head.is_contiguous() and head.ndim == 2
                and head.shape[0] == batch_size and batch_size >= 1
                and num_slots >= 1))):
        _segment_gather_args(src, ids, head, mask, batch_size, num_slots,
                             ets)
    n, w = src.shape
    n_head = 0 if head is None else head.shape[1]
    out = torch.empty((k, n_head + ets + w), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    fn = _build.function("segment_gather", "pbx_segment_gather",
                         _SEG_GATHER_ARGS)
    _build.check(fn(src.data_ptr(), src.stride(0) if n else w,
                    ids.data_ptr(), None if head is None else head.data_ptr(),
                    None if mask is None else mask.data_ptr(),
                    out.data_ptr(), k, n, w, n_head, ets, max(num_slots, 1),
                    max(batch_size, 1), _build.stream(ids)), "segment_gather")
    segment_gather.launches += 1
    return out


segment_gather.launches = 0


# ---------------------------------------------------------------------------
# Segment sum (the pool of the seqpool op family)
# ---------------------------------------------------------------------------

def segment_sum_plain(values: torch.Tensor, segments: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Plain version of :func:`segment_sum`: an accumulating
    ``index_put`` into ``num_segments + 1`` f32 bins (ids outside [0,
    num_segments) fall into the last one, which is cut off), so each
    segment's keys are summed in key order as the kernel sums them.
    Differentiable in ``values``."""
    seg = segments.long()
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    out = torch.zeros((num_segments + 1, values.shape[1]),
                      dtype=torch.float32, device=values.device).index_put(
                          (seg,), values.float(), accumulate=True)
    return out[:num_segments].to(values.dtype)


def _segment_sum_forward(values: torch.Tensor, segments: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    if values.device.type == "cpu" and segments.device.type == "cpu":
        return segment_sum_plain(values, segments, num_segments)
    if not values.is_floating_point() or segments.dtype != torch.int32:
        raise TypeError("segment_sum: needs float values and int32 segments")
    if values.dim() != 2 or segments.shape != (values.shape[0],):
        raise ValueError("segment_sum: values [K, D] and segments [K]")
    v = values.float().contiguous()
    _build.require_cuda("segment_sum", v, segments)
    k, d = values.shape
    n = int(num_segments)
    out = torch.empty((n, d), dtype=torch.float32, device=values.device)
    if out.numel() == 0:
        return out.to(values.dtype)
    bounds = _bounds_scratch("segment_sum", v, n)
    fn = _build.function("segment_sum", "pbx_segment_sum", _SEG_SUM_ARGS)
    _build.check(fn(v.data_ptr(), segments.data_ptr(), bounds.data_ptr(),
                    out.data_ptr(), k, n, d, _build.stream(values)),
                 "segment_sum")
    segment_sum.launches += 1
    return out.to(values.dtype)


class _SegmentSum(torch.autograd.Function):
    """The sum forward (kernel) and its exact backward, a gather of the
    output grad's rows (``segment_gather`` in gather mode: the port of
    ``_seg_sum_bwd`` under the flag)."""

    @staticmethod
    def forward(ctx, values, segments, num_segments):
        ctx.save_for_backward(segments)
        ctx.dtype = values.dtype
        return _segment_sum_forward(values, segments, num_segments)

    @staticmethod
    def backward(ctx, g):
        segments, = ctx.saved_tensors
        g_values = segment_gather(g.float().contiguous(), segments)
        return g_values.to(ctx.dtype), None, None


def segment_sum(values: torch.Tensor, segments: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """values [K, D] (any float type), segments [K] int32 →
    [num_segments, D] (``csrc/segment_sum.cu``: one C call enqueues the
    segment bounds pass and the tile kernel): the f32 sum of each
    segment's values, cast back to ``values.dtype``. Ids
    outside [0, num_segments) are dropped (−1 markers may sit anywhere);
    the others must be nondecreasing in key order; a segment with no
    keys is 0. Differentiable in ``values``; the backward is exact."""
    return _SegmentSum.apply(values, segments, num_segments)


segment_sum.launches = 0


# ---------------------------------------------------------------------------
# Unique-row scatter-add (the push write-back)
# ---------------------------------------------------------------------------

def scatter_add_update_plain(values: torch.Tensor, rows: torch.Tensor,
                             deltas: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`scatter_add_update`: ``index_add_`` of
    the rows inside [0, C)."""
    r = rows.long()
    keep = (r >= 0) & (r < values.shape[0])
    return values.index_add_(0, r[keep], deltas[keep])


def scatter_add_update(values: torch.Tensor, rows: torch.Tensor,
                       deltas: torch.Tensor) -> torch.Tensor:
    """values [C, F] f32 += deltas [U, F] at rows [U] int32, IN PLACE
    (``csrc/scatter_add_update.cu``); rows must be duplicate-free inside
    [0, C), rows outside it are dropped. Returns ``values``. Exact."""
    if values.device.type == "cpu" and rows.device.type == "cpu":
        return scatter_add_update_plain(values, rows, deltas)
    _build.require_cuda("scatter_add_update", values, rows, deltas)
    if (values.dtype != torch.float32 or deltas.dtype != torch.float32
            or rows.dtype != torch.int32):
        raise TypeError("scatter_add_update: needs float32 values/deltas "
                        "and int32 rows")
    if values.dim() != 2 or rows.dim() != 1 or deltas.shape != (
            rows.shape[0], values.shape[1]):
        raise ValueError("scatter_add_update: values [C, F], rows [U], "
                         "deltas [U, F]")
    u, f = deltas.shape
    if u == 0 or f == 0:
        return values
    vec = 4 if _vec4(f, values, deltas) else 1
    fn = _build.function("scatter_add_update", "pbx_scatter_add_update",
                         _SCATTER_ADD_ARGS)
    _build.check(fn(values.data_ptr(), rows.data_ptr(), deltas.data_ptr(),
                    u, values.shape[0], f, vec, _build.stream(values)),
                 "scatter_add_update")
    scatter_add_update.launches += 1
    return values


scatter_add_update.launches = 0


# ---------------------------------------------------------------------------
# Row scatter and the DMA row copies (no consumer in either package)
# ---------------------------------------------------------------------------

def _rows_args(name: str, table: torch.Tensor, rows: torch.Tensor,
               block: Optional[torch.Tensor] = None) -> None:
    """Raise unless table [C, F] f32 (C >= 1), rows [K] int32 and the
    optional block [K, F] f32 are contiguous on one CUDA device."""
    extra = () if block is None else (block,)
    _build.require_cuda(name, table, rows, *extra)
    if (table.dtype != torch.float32 or rows.dtype != torch.int32
            or any(t.dtype != torch.float32 for t in extra)):
        raise TypeError(f"{name}: needs a float32 table/values and int32 "
                        f"rows")
    if table.dim() != 2 or rows.dim() != 1 or table.shape[0] == 0 or (
            block is not None
            and block.shape != (rows.shape[0], table.shape[1])):
        raise ValueError(f"{name}: table [C, F] with C >= 1, rows [K], "
                         f"values [K, F]")


def scatter_rows_plain(table: torch.Tensor, rows: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`scatter_rows`: an ``index_put_`` with the
    ids outside [0, C) sent to the last row."""
    c = table.shape[0]
    r = rows.long()
    return table.index_put_((torch.where((r >= 0) & (r < c), r, c - 1),),
                            values)


def scatter_rows(table: torch.Tensor, rows: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """table [C, F] f32, rows [U] int32, values [U, F] f32:
    ``table[rows[i]] = values[i]`` IN PLACE (``csrc/scatter_rows.cu``).
    In-bounds rows must be duplicate-free; rows outside [0, C) all write
    the last row (the sentinel), so its content is one of theirs. Returns
    ``table``. Exact."""
    if table.device.type == "cpu" and rows.device.type == "cpu":
        return scatter_rows_plain(table, rows, values)
    _rows_args("scatter_rows", table, rows, values)
    u, f = values.shape
    if u == 0 or f == 0:
        return table
    fn = _build.function("scatter_rows", "pbx_scatter_rows", _ROW_ARGS)
    _build.check(fn(table.data_ptr(), rows.data_ptr(), values.data_ptr(),
                    u, table.shape[0], f, 4 if _vec4(f, table, values) else 1,
                    _build.stream(table)), "scatter_rows")
    scatter_rows.launches += 1
    return table


scatter_rows.launches = 0


def _dma_count(name: str, rows: torch.Tensor) -> None:
    """The TPU kernels' grid contract: K a multiple of min(2048, K)."""
    k = rows.shape[0]
    tr = min(_DMA_BLOCK, k)
    if k and k % tr:
        raise ValueError(f"{name}: pad the {k} rows to a multiple of {tr}")


def _dma_vec(d: int, *tensors: torch.Tensor) -> int:
    """Whether the row copies move 16-byte vectors (``csrc/row_dma.cu``):
    16-byte multiples on aligned bases, at most one vector a lane (d <=
    128); any other row takes ordinary loads."""
    return int(d <= 128 and _vec4(d, *tensors))


def gather_rows_dma_plain(table: torch.Tensor, rows: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version of :func:`gather_rows_dma` (the gather of
    :func:`gather_rows_plain`, under the DMA kernels' row-count check)."""
    _dma_count("gather_rows_dma", rows)
    return gather_rows_plain(table, rows)


def gather_rows_dma(table: torch.Tensor, rows: torch.Tensor
                    ) -> torch.Tensor:
    """table [C+1, D] f32, rows [K] int32 with K a multiple of min(2048,
    K) → out [K, D] = table[min(rows, C)] (ids outside [0, C] read the
    sentinel row C), with several rows in flight on every lane
    (``csrc/row_dma.cu``). Exact."""
    if table.device.type == "cpu" and rows.device.type == "cpu":
        return gather_rows_dma_plain(table, rows)
    _dma_count("gather_rows_dma", rows)
    _rows_args("gather_rows_dma", table, rows)
    k, d = rows.shape[0], table.shape[1]
    out = torch.empty((k, d), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    fn = _build.function("row_dma", "pbx_gather_rows_dma", _ROW_ARGS)
    _build.check(fn(table.data_ptr(), rows.data_ptr(), out.data_ptr(), k,
                    table.shape[0] - 1, d, _dma_vec(d, table, out),
                    _build.stream(table)), "gather_rows_dma")
    gather_rows_dma.launches += 1
    return out


gather_rows_dma.launches = 0


def scatter_rows_dma_plain(table: torch.Tensor, rows: torch.Tensor,
                           values: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`scatter_rows_dma` (the write of
    :func:`scatter_rows_plain`, under the DMA kernels' row-count
    check)."""
    _dma_count("scatter_rows_dma", rows)
    return scatter_rows_plain(table, rows, values)


def scatter_rows_dma(table: torch.Tensor, rows: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """table [C+1, D] f32, rows [K] int32 with K a multiple of min(2048,
    K), values [K, D] f32: ``table[min(rows[i], C)] = values[i]`` IN
    PLACE, with several rows in flight on every lane
    (``csrc/row_dma.cu``).
    In-bounds rows must be duplicate-free; rows outside [0, C] all write
    the sentinel row C, racily. Returns ``table``. Exact."""
    if table.device.type == "cpu" and rows.device.type == "cpu":
        return scatter_rows_dma_plain(table, rows, values)
    _dma_count("scatter_rows_dma", rows)
    _rows_args("scatter_rows_dma", table, rows, values)
    k, d = values.shape
    if k == 0 or d == 0:
        return table
    fn = _build.function("row_dma", "pbx_scatter_rows_dma", _ROW_ARGS)
    _build.check(fn(table.data_ptr(), rows.data_ptr(), values.data_ptr(), k,
                    table.shape[0] - 1, d, _dma_vec(d, table, values),
                    _build.stream(table)), "scatter_rows_dma")
    scatter_rows_dma.launches += 1
    return table


scatter_rows_dma.launches = 0


class KernelSet(NamedTuple):
    """The device functions of the port's paths: training, serving, the
    key index, PV ranking and the seqpool op family (the last three
    fields have no consumer; they stand here so a check can run them
    both ways). ``KERNELS`` is what every entry point uses; ``PLAIN``
    exists so a check on the card can run the same path through the
    plain versions (it is passed explicitly, never chosen by a device
    test)."""

    gather_rows: Callable
    pool_cvm: Callable
    segment_gather: Callable
    scatter_add_update: Callable
    index_insert: Callable
    index_lookup: Callable
    rank_attention: Callable
    batch_fc: Callable
    cross_norm: Callable
    segment_sum: Callable
    scatter_rows: Callable
    scatter_rows_dma: Callable
    gather_rows_dma: Callable


KERNELS = KernelSet(gather_rows, pool_cvm, segment_gather,
                    scatter_add_update, index.insert, index.lookup,
                    ctr_kernels.rank_attention, ctr_kernels.batch_fc,
                    ctr_kernels.cross_norm, segment_sum, scatter_rows,
                    scatter_rows_dma, gather_rows_dma)
PLAIN = KernelSet(gather_rows_plain, pool_cvm_plain, segment_gather_plain,
                  scatter_add_update_plain, index.insert_plain,
                  index.lookup_plain, ctr_kernels.rank_attention_plain,
                  ctr_kernels.batch_fc_plain, ctr_kernels.cross_norm_plain,
                  segment_sum_plain, scatter_rows_plain,
                  scatter_rows_dma_plain, gather_rows_dma_plain)


# ---------------------------------------------------------------------------
# The standalone fused embed-pool-CVM op
# ---------------------------------------------------------------------------

class _FusedEmbedPoolCVM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, segments, batch_show_clk, a):
        keep = keep_or_ones(values, a["need_filter"], a["show_coeff"],
                            a["clk_coeff"], a["threshold"]).float()
        out = a["ops"].pool_cvm(
            values, segments, keep, a["batch_size"], a["num_slots"],
            cvm_mode=CVM_FULL if a["use_cvm"] else CVM_NONE,
            cvm_offset=a["cvm_offset"], pad_value=a["pad_value"])
        ctx.a = a
        ctx.shape, ctx.dtype = values.shape, values.dtype
        ctx.save_for_backward(segments, keep, batch_show_clk)
        return out

    @staticmethod
    def backward(ctx, g):
        segments, keep, batch_show_clk = ctx.saved_tensors
        a = ctx.a
        b, s = a["batch_size"], a["num_slots"]
        # the CVM_FULL head is always two transformed columns, whatever
        # cvm_offset is; a negative id is a pad here
        n_head = 2 if a["use_cvm"] else 0
        w = ctx.shape[1] - a["cvm_offset"]
        src = g.float().reshape(b * s, n_head + w)[:, n_head:]
        mask = (keep * (segments >= 0)).contiguous()
        out = a["ops"].segment_gather(
            src, segments, batch_show_clk.float().contiguous(), mask, b, s)
        return out.to(ctx.dtype), None, None, None


def fused_embed_pool_cvm(values: torch.Tensor, segments: torch.Tensor,
                         batch_show_clk: torch.Tensor, batch_size: int,
                         num_slots: int, use_cvm: bool = True,
                         cvm_offset: int = 2, pad_value: float = 0.0,
                         need_filter: bool = False, show_coeff: float = 0.2,
                         clk_coeff: float = 1.0, threshold: float = 0.96,
                         ops: KernelSet = KERNELS) -> torch.Tensor:
    """The standalone differentiable form of the fused pool (counterpart
    of ``pallas_kernels.fused_embed_pool_cvm``): forward ``pool_cvm``
    with the FULL head (or none), backward the reference grad row by
    ``segment_gather``'s epilogue: embedx columns get their segment's
    output grad, the first ``cvm_offset`` columns the batch show/clk,
    filtered keys and pads (ids < 0 or >= B*S) zero. It covers the kk=1
    attributes of ``ops.seqpool_cvm.fused_seqpool_cvm``."""
    a = dict(batch_size=batch_size, num_slots=num_slots, use_cvm=use_cvm,
             cvm_offset=cvm_offset, pad_value=pad_value,
             need_filter=need_filter, show_coeff=show_coeff,
             clk_coeff=clk_coeff, threshold=threshold, ops=ops)
    return _FusedEmbedPoolCVM.apply(values, segments, batch_show_clk, a)
