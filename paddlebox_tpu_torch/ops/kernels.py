"""The port's device kernels and their plain PyTorch versions — the
counterpart of ``paddlebox_tpu/ops/pallas_kernels.py``.

Each kernel wrapper takes its plain version for a tensor on the CPU and
launches the CUDA kernel (``csrc/<name>.cu``, built on first use by
``ops/_build.py``) for a tensor on the card. There is no other dispatch:
a CUDA tensor never reaches a plain version inside the port, and a
failed build or launch raises. Each wrapper counts its launches in its
``launches`` attribute, so a run can show which kernels it went through.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch

from paddlebox_tpu_torch.ops import _build, index

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
_POOL_ARGS = [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _I32,
              ctypes.c_float, _P]
_SEG_GATHER_ARGS = [_P, _I64, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32,
                    _I32, _I32, _P]
_SCATTER_ADD_ARGS = [_P, _P, _P, _I64, _I64, _I32, _I32, _P]


def show_clk_keep(values: torch.Tensor, show_coeff: float, clk_coeff: float,
                  threshold: float) -> torch.Tensor:
    """The show/clk significance filter (QuantFilter), bool [K]."""
    show, clk = values[:, 0], values[:, 1]
    return ((show - clk) * show_coeff + clk * clk_coeff) >= threshold


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
    vec = 4 if (f % 4 == 0 and table.data_ptr() % 16 == 0
                and out.data_ptr() % 16 == 0) else 1
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


def _suffix_min(x: torch.Tensor, fill: int, row: int = 1024
                ) -> torch.Tensor:
    """out[j] = min(x[j:]) for a 1-D tensor, in two levels: within rows
    of ``row`` elements, then across rows: PyTorch's CUDA scan of a 1-D
    tensor runs in a single thread block, of a 2-D one in a block per
    row."""
    k = x.shape[0]
    rows = max(1, -(-k // row))
    xp = x.new_full((rows * row,), fill)
    xp[:k] = x
    m = xp.view(rows, row).flip(1).cummin(1).values.flip(1)
    later = m[:, 0].flip(0).cummin(0).values.flip(0)[1:]   # min of rows > r
    carry = torch.cat([later, later.new_full((1,), fill)])
    return torch.minimum(m, carry[:, None]).view(-1)[:k]


def pool_cvm(values: torch.Tensor, segments: torch.Tensor,
             keep: Optional[torch.Tensor], batch_size: int, num_slots: int,
             cvm_mode: int = CVM_FULL, cvm_offset: int = 2, ets: int = 0,
             pad_value: float = 0.0) -> torch.Tensor:
    """values [K, D] f32 pulled embeddings, segments [K] int32 (ins*S +
    slot; the ids inside [0, B*S) must be nondecreasing, anything else is
    dropped), keep [K] optional 0/1 key mask → the CVM-transformed pooled
    output [B, S, D_out] in one kernel (``csrc/pool_cvm.cu``). ``ets``
    (embed_thres_size) only affects the CVM_NONE output slice."""
    if values.device.type == "cpu" and segments.device.type == "cpu":
        return pool_cvm_plain(values, segments, keep, batch_size, num_slots,
                              cvm_mode, cvm_offset, ets, pad_value)
    if keep is None:
        keep = torch.ones(values.shape[0], dtype=torch.float32,
                          device=values.device)
    _build.require_cuda("pool_cvm", values, segments, keep)
    if values.dtype != torch.float32 or segments.dtype != torch.int32:
        raise TypeError("pool_cvm: needs float32 values, int32 segments")
    k, d = values.shape
    n = batch_size * num_slots
    d_out = cvm_out_width(d, cvm_mode, cvm_offset, ets)
    if d > 128:
        raise ValueError(f"pool_cvm: width {d} > 128")
    # the kernel binary-searches each segment's run of keys: make the id
    # stream nondecreasing by giving each dropped key (keep → 0) the id
    # of the NEXT valid key, so the tail pads get n and join no segment
    valid = (segments >= 0) & (segments < n)
    seg = _suffix_min(torch.where(valid, segments, n), n).contiguous()
    keep_v = torch.where(valid, keep.float(), 0.0).contiguous()
    out = torch.empty((n, d_out), dtype=torch.float32, device=values.device)
    if n == 0:
        return out.reshape(batch_size, num_slots, d_out)
    fn = _build.function("pool_cvm", "pbx_pool_cvm", _POOL_ARGS)
    _build.check(fn(values.data_ptr(), seg.data_ptr(), keep_v.data_ptr(),
                    out.data_ptr(), k, n, d, d_out, cvm_mode, cvm_offset,
                    ets, float(pad_value), _build.stream(values)), "pool_cvm")
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
    live = ok if mask is None else ok & (mask != 0)
    flat = torch.cat([src, src.new_zeros((1, w))])
    out = flat[torch.where(ok, idl, n)]
    if head is not None:
        ins = (torch.where(ok, idl, 0) // num_slots).clamp_max(
            batch_size - 1)
        out = torch.cat([head[ins], src.new_zeros((ids.shape[0], ets)),
                         out], dim=1)
    return torch.where(live[:, None], out, 0.0)


def segment_gather(src: torch.Tensor, ids: torch.Tensor,
                   head: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   batch_size: int = 0, num_slots: int = 0,
                   ets: int = 0) -> torch.Tensor:
    """src [N, w] f32 (rows may be strided, columns contiguous), ids [K]
    int32 → out [K, w] = src[ids] with zero rows for ids outside [0, N)
    (``csrc/segment_gather.cu``). Exact.

    With ``head`` [batch_size, H] f32 it writes the fused seqpool grad
    row instead, out [K, H + ets + w] = [head[min(ids // num_slots,
    batch_size - 1)] | zeros(ets) | src[ids]]. ``mask`` [K] f32 zeroes
    the rows where it is 0 (in both modes)."""
    if src.device.type == "cpu" and ids.device.type == "cpu":
        return segment_gather_plain(src, ids, head, mask, batch_size,
                                    num_slots, ets)
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
    n, w = src.shape
    k = ids.shape[0]
    n_head = 0
    if head is not None:
        if head.dim() != 2 or head.shape[0] != batch_size \
                or batch_size < 1 or num_slots < 1:
            raise ValueError("segment_gather: head [batch_size, H] needs "
                             "batch_size, num_slots >= 1")
        n_head = head.shape[1]
    elif ets:
        raise ValueError("segment_gather: ets needs the head epilogue")
    if mask is not None and mask.shape != (k,):
        raise ValueError("segment_gather: mask [K]")
    out = torch.empty((k, n_head + ets + w), dtype=torch.float32,
                      device=src.device)
    if out.numel() == 0:
        return out
    ld = src.stride(0) if n else w
    fn = _build.function("segment_gather", "pbx_segment_gather",
                         _SEG_GATHER_ARGS)
    _build.check(fn(src.data_ptr(), ld, ids.data_ptr(),
                    None if head is None else head.data_ptr(),
                    None if mask is None else mask.data_ptr(),
                    out.data_ptr(), k, n, w, n_head, ets, max(num_slots, 1),
                    max(batch_size, 1), _build.stream(ids)), "segment_gather")
    segment_gather.launches += 1
    return out


segment_gather.launches = 0


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
    vec = 4 if (f % 4 == 0 and values.data_ptr() % 16 == 0
                and deltas.data_ptr() % 16 == 0) else 1
    fn = _build.function("scatter_add_update", "pbx_scatter_add_update",
                         _SCATTER_ADD_ARGS)
    _build.check(fn(values.data_ptr(), rows.data_ptr(), deltas.data_ptr(),
                    u, values.shape[0], f, vec, _build.stream(values)),
                 "scatter_add_update")
    scatter_add_update.launches += 1
    return values


scatter_add_update.launches = 0


class KernelSet(NamedTuple):
    """The device functions the training, serving and key-index paths
    call.
    ``KERNELS`` is what every entry point uses; ``PLAIN`` exists so a
    check on the card can run the same path through the plain versions
    (it is passed explicitly, never chosen by a device test)."""

    gather_rows: Callable
    pool_cvm: Callable
    segment_gather: Callable
    scatter_add_update: Callable
    index_insert: Callable
    index_lookup: Callable


KERNELS = KernelSet(gather_rows, pool_cvm, segment_gather,
                    scatter_add_update, index.insert, index.lookup)
PLAIN = KernelSet(gather_rows_plain, pool_cvm_plain, segment_gather_plain,
                  scatter_add_update_plain, index.insert_plain,
                  index.lookup_plain)
