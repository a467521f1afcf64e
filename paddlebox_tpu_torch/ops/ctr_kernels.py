"""The device-side CTR op family: kernels, their plain PyTorch versions and
their autograd Functions — the counterpart of
``paddlebox_tpu/ops/pallas_ctr.py``.

- ``rank_attention`` (``csrc/rank_attention.cu``): ``out[n] = Σ_k
  valid(n,k) · X[idx(n,k)] @ P[blk(n,k)]`` with the block table decoded
  from ``rank_offset`` by :func:`decode_rank_offset`.
- ``batch_fc`` (``csrc/batch_fc.cu``): per slot ``x[s] @ w[s] + bias[s]``,
  the weight read transposed by index in transpose mode.
- ``cross_norm`` (``csrc/cross_norm.cu``): per (row, field) the
  normalized ``[(a, b, a⊙b, a·b) − mean] · scale`` block.

Each kernel wrapper takes its plain version for tensors on the CPU and
launches its kernel for tensors on the card, counting the launch in its
``launches`` attribute and booking ``pbox_kernel_dispatch_total{kernel,
impl}`` (``ops/_build.book``) while the telemetry hub is active; a failed
build or launch raises. The kernels
accumulate in float32 (no TF32, no library product), as the TPU kernels
run ``Precision.HIGHEST``.

The JAX package has no backward kernel for these ops: its backwards are
hand-written jnp einsums (``_ra_bwd``, ``_bfc_bwd``, ``_cn_bwd``), and
the Functions below mirror them in plain PyTorch. ``ops`` (a
``kernels.KernelSet``) selects the forward: the kernels, or the plain
versions when a check on the card passes ``kernels.PLAIN``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from paddlebox_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# C signatures of the kernel entries (csrc/*.cu)
_RANK_ATTN_ARGS = [_P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _P]
_RANK_BUCKETS_ARGS = [_P, _P, _I32, _I32, _I32, _P]
_RANK_TILES_ARGS = [_P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _P]
_BATCH_FC_ARGS = [_P, _I64, _I64, _I64, _P, _P, _P, _I32, _I64, _I32, _I32,
                  _I32, _P]
# pbx_batch_fc_path: the same, then the kernel to take (0 by size, 1 the
# tile kernel, 2 the per-element kernel) before the stream
_BATCH_FC_PATH_ARGS = _BATCH_FC_ARGS[:-1] + [_I32, _P]
_CROSS_NORM_ARGS = [_P, _P, _P, _P, _I64, _I32, _I32, _P]
# pbx_cross_norm_path: the same, then the kernel (0 as cross_norm_branch
# picks, 1 the tile kernel, 2 the rows kernel) before the stream
_CROSS_NORM_PATH_ARGS = _CROSS_NORM_ARGS[:-1] + [_I32, _P]
#: rank_attention.cu stages at most this many co-shown ads per row
MAX_RANK_LIMIT = 16
#: rows a block of cross_norm.cu's tile kernel stages (its kTileRows)
CROSS_NORM_ROWS = 8
#: dynamic shared memory a cross_norm.cu block may take, in bytes (its
#: kSmemBudget)
CROSS_NORM_SMEM = 227 * 1024


# ---------------------------------------------------------------------------
# rank_attention
# ---------------------------------------------------------------------------

def decode_rank_offset(rank_offset: torch.Tensor, max_rank: int, n: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``rank_offset`` [N, 1+2K] → (blk [N, K] int32 with −1 for invalid
    entries, idx [N, K] int64 X-row indices clipped to [0, N−1], valid
    [N, K] bool).

    blk = (own−1)·max_rank + (rank_k−1), the RankParam block of the
    (own-rank, co-rank) pair; an entry with own ≤ 0 or rank_k ≤ 0 is
    invalid and contributes nothing. Out-of-range ranks clip into the
    block table."""
    ks = torch.arange(max_rank, device=rank_offset.device)
    ro = rank_offset.long()
    own = ro[:, 0] - 1                                  # [N], −1 ⇒ invalid
    faster = ro[:, 1 + 2 * ks] - 1                      # [N, K]
    idx = ro[:, 2 + 2 * ks].clamp(0, max(n - 1, 0))
    valid = (own[:, None] >= 0) & (faster >= 0)
    blk = (own[:, None].clamp(0, max_rank - 1) * max_rank
           + faster.clamp(0, max_rank - 1))
    return torch.where(valid, blk, -1).to(torch.int32), idx, valid


def normalize_rank_param(rank_param: torch.Tensor, max_rank: int,
                         d: int) -> torch.Tensor:
    """[max_rank²·D, P] (reference layout) or [max_rank², D, P] → the 3-D
    block view."""
    if rank_param.dim() == 2:
        return rank_param.reshape(max_rank * max_rank, d,
                                  rank_param.shape[-1])
    return rank_param


def _grouped_input(x: torch.Tensor, blk: torch.Tensor, idx: torch.Tensor,
                   valid: torch.Tensor, mr2: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gmat [max_rank², N, D], onehot [N, K, max_rank²]): the co-shown
    rows summed per param block, the block-grouped form of the JAX XLA
    composition."""
    x_k = torch.where(valid[..., None], x[idx], 0.0)          # [N, K, D]
    onehot = (blk[..., None] == torch.arange(
        mr2, device=x.device)).to(x.dtype)                     # [N, K, MR2]
    return torch.einsum("nkd,nkb->bnd", x_k, onehot), onehot


def rank_buckets_plain(rank_offset: torch.Tensor, max_rank: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the CUDA rank_attention's bucket pass computes: (perm [N]
    int32, bounds [max_rank + 2] int32). The rows sorted stably by
    clipped own rank ``min(own, max_rank − 1)``, rows with own < 0 (own =
    rank_offset[:, 0] − 1) last, in bucket ``max_rank``; bucket b holds
    ``perm[bounds[b]:bounds[b + 1]]``."""
    own = rank_offset[:, 0].long() - 1
    bucket = torch.where(own < 0, max_rank, own.clamp(max=max_rank - 1))
    perm = torch.sort(bucket, stable=True).indices.to(torch.int32)
    counts = torch.bincount(bucket, minlength=max_rank + 1)
    bounds = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return perm, bounds.to(torch.int32)


def rank_attention_plain(x: torch.Tensor, rank_offset: torch.Tensor,
                         param3: torch.Tensor, max_rank: int) -> torch.Tensor:
    """Plain version of :func:`rank_attention`: the block-grouped
    composition ``Σ_b (Σ_{k: blk=b} X[idx_k]) @ P[b]``."""
    n = x.shape[0]
    blk, idx, valid = decode_rank_offset(rank_offset, max_rank, n)
    gmat, _ = _grouped_input(x, blk, idx, valid, max_rank * max_rank)
    return torch.einsum("bnd,bdp->np", gmat, param3)


def rank_attention(x: torch.Tensor, rank_offset: torch.Tensor,
                   param3: torch.Tensor, max_rank: int) -> torch.Tensor:
    """x [N, D] f32, rank_offset int32 [N, ≥1+2·max_rank], param3
    [max_rank², D, P] f32 → [N, P] f32 (``csrc/rank_attention.cu``: one C
    call enqueues the bucket pass, whose output goes to an int32 scratch
    [N + max_rank + 2], and the tile kernel)."""
    if x.device.type == "cpu" and rank_offset.device.type == "cpu":
        _build.book(rank_attention, "plain")
        return rank_attention_plain(x, rank_offset, param3, max_rank)
    _build.require_cuda("rank_attention", x, rank_offset, param3)
    if (x.dtype != torch.float32 or param3.dtype != torch.float32
            or rank_offset.dtype != torch.int32):
        raise TypeError("rank_attention: needs float32 x/param and int32 "
                        "rank_offset")
    n, d = x.shape
    mr2 = max_rank * max_rank
    if (param3.dim() != 3 or param3.shape[:2] != (mr2, d)
            or rank_offset.dim() != 2 or rank_offset.shape[0] != n
            or rank_offset.shape[1] < 1 + 2 * max_rank):
        raise ValueError("rank_attention: x [N, D], rank_offset [N, "
                         "1+2K], param [K², D, P]")
    if not 1 <= max_rank <= MAX_RANK_LIMIT:
        raise ValueError(f"rank_attention: max_rank {max_rank} outside "
                         f"[1, {MAX_RANK_LIMIT}]")
    p = param3.shape[2]
    out = torch.empty((n, p), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    scratch = torch.empty(n + max_rank + 2, dtype=torch.int32,
                          device=x.device)
    fn = _build.function("rank_attention", "pbx_rank_attention",
                         _RANK_ATTN_ARGS)
    _build.check(fn(x.data_ptr(), rank_offset.data_ptr(), param3.data_ptr(),
                    scratch.data_ptr(), out.data_ptr(), n, d, p, max_rank,
                    rank_offset.shape[1], _build.stream(x)), "rank_attention")
    rank_attention.launches += 1
    _build.book(rank_attention, "cuda")
    return out


rank_attention.launches = 0
rank_attention.label = "rank_attention"


class RankAttentionFn(torch.autograd.Function):
    """The forward through ``ops.rank_attention``; the backward mirrors
    ``_ra_bwd`` (pallas_ctr.py): the param grad scattered into its
    max_rank² blocks, dX only under ``enable_input_bp``."""

    @staticmethod
    def forward(ctx, x, rank_offset, rank_param, max_rank, enable_input_bp,
                ops):
        param3 = normalize_rank_param(rank_param, max_rank, x.shape[1])
        ctx.save_for_backward(x, rank_offset, rank_param)
        ctx.max_rank = max_rank
        ctx.enable_input_bp = enable_input_bp
        return ops.rank_attention(x, rank_offset, param3, max_rank)

    @staticmethod
    def backward(ctx, g):
        x, rank_offset, rank_param = ctx.saved_tensors
        mr = ctx.max_rank
        n, d = x.shape
        blk, idx, valid = decode_rank_offset(rank_offset, mr, n)
        gmat, onehot = _grouped_input(x, blk, idx, valid, mr * mr)
        d_param = torch.einsum("bnd,np->bdp", gmat, g).reshape(
            rank_param.shape).to(rank_param.dtype)
        dx = None
        if ctx.enable_input_bp and ctx.needs_input_grad[0]:
            param3 = normalize_rank_param(rank_param, mr, d)
            d_gmat = torch.einsum("np,bdp->bnd", g, param3)
            d_xk = torch.einsum("bnd,nkb->nkd", d_gmat, onehot)
            d_xk = torch.where(valid[..., None], d_xk, 0.0)
            # an accumulating put sums each row's entries in key order (an
            # index_add_ adds in atomic order on the card)
            dx = torch.zeros_like(x).index_put_(
                (idx.reshape(-1),), d_xk.reshape(-1, d).to(x.dtype),
                accumulate=True)
        return dx, None, d_param, None, None, None


# ---------------------------------------------------------------------------
# batch_fc
# ---------------------------------------------------------------------------

def batch_fc_plain(xb: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   transpose_weight: bool) -> torch.Tensor:
    """Plain version of :func:`batch_fc`."""
    eq = "sni,soi->sno" if transpose_weight else "sni,sio->sno"
    return torch.einsum(eq, xb, w) + bias[:, None, :]


def batch_fc(xb: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             transpose_weight: bool) -> torch.Tensor:
    """xb [S, N, I] f32 (any strides) × w [S, I, O] (or [S, O, I] with
    ``transpose_weight``) + bias [S, O] → [S, N, O] f32
    (``csrc/batch_fc.cu``)."""
    if xb.device.type == "cpu" and w.device.type == "cpu":
        _build.book(batch_fc, "plain")
        return batch_fc_plain(xb, w, bias, transpose_weight)
    _build.require_cuda("batch_fc", w, bias)
    if xb.device != w.device:
        raise ValueError(f"batch_fc: tensors on {xb.device} and {w.device}")
    if any(t.dtype != torch.float32 for t in (xb, w, bias)):
        raise TypeError("batch_fc: needs float32 x, w and bias")
    s, n, i_dim = xb.shape
    o_dim = w.shape[1] if transpose_weight else w.shape[2]
    want = (s, o_dim, i_dim) if transpose_weight else (s, i_dim, o_dim)
    if w.shape != want or bias.shape != (s, o_dim):
        raise ValueError(f"batch_fc: x {tuple(xb.shape)}, w "
                         f"{tuple(w.shape)}, bias {tuple(bias.shape)}")
    out = torch.empty((s, n, o_dim), dtype=torch.float32, device=w.device)
    if out.numel() == 0:
        return out
    fn = _build.function("batch_fc", "pbx_batch_fc", _BATCH_FC_ARGS)
    _build.check(fn(xb.data_ptr(), *xb.stride(), w.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), s, n, i_dim, o_dim,
                    int(transpose_weight), _build.stream(w)), "batch_fc")
    batch_fc.launches += 1
    _build.book(batch_fc, "cuda")
    return out


batch_fc.launches = 0
batch_fc.label = "batch_fc"


class BatchFcFn(torch.autograd.Function):
    """The forward through ``ops.batch_fc`` in the default or batchcount
    layout; the backward mirrors ``_bfc_bwd`` (pallas_ctr.py)."""

    @staticmethod
    def forward(ctx, x, w, bias, batchcount, transpose_weight, ops):
        ctx.save_for_backward(x, w, bias)
        ctx.batchcount = batchcount
        ctx.transpose_weight = transpose_weight
        if batchcount > 0:
            xb = x.reshape(batchcount, x.shape[0] // batchcount, x.shape[-1])
            out = ops.batch_fc(xb, w, bias, transpose_weight)
            return out.reshape(x.shape[0], -1)
        return ops.batch_fc(x, w, bias, False)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        bc = ctx.batchcount
        if bc > 0:
            ins = x.shape[0] // bc
            xb = x.reshape(bc, ins, x.shape[-1])
            gb = g.reshape(bc, ins, -1)
            wb = w.transpose(1, 2) if ctx.transpose_weight else w
            dx = torch.einsum("bno,bio->bni", gb, wb).reshape(x.shape)
            dwb = torch.einsum("bni,bno->bio", xb, gb)
            dw = dwb.transpose(1, 2) if ctx.transpose_weight else dwb
            db = gb.sum(dim=1)
        else:
            dx = torch.einsum("sno,sio->sni", g, w)
            dw = torch.einsum("sni,sno->sio", x, g)
            db = g.sum(dim=1)
        return (dx.to(x.dtype), dw.to(w.dtype), db.to(bias.dtype), None,
                None, None)


# ---------------------------------------------------------------------------
# cross_norm_hadamard
# ---------------------------------------------------------------------------

def cross_features(x: torch.Tensor, fields_num: int,
                   embed_dim: int) -> torch.Tensor:
    """[B, 2·n·d] → raw cross features [B, n·(3d+1)], per field [a, b,
    a⊙b, a·b] (pre-normalization)."""
    b = x.shape[0]
    n, d = fields_num, embed_dim
    pairs = x.reshape(b, n, 2, d)
    a, bb = pairs[:, :, 0], pairs[:, :, 1]              # [B, n, d]
    had = a * bb
    dot = had.sum(dim=-1, keepdim=True)                 # [B, n, 1]
    return torch.cat([a, bb, had, dot], dim=-1).reshape(b, n * (3 * d + 1))


def cross_norm_plain(x: torch.Tensor, mean: torch.Tensor,
                     scale: torch.Tensor, fields_num: int,
                     embed_dim: int) -> torch.Tensor:
    """Plain version of :func:`cross_norm`."""
    feats = cross_features(x, fields_num, embed_dim)
    return (feats - mean[None, :]) * scale[None, :]


def cross_norm_branch(x_addr: int, out_addr: int, b: int, n: int,
                      d: int) -> int:
    """The kernel of ``csrc/cross_norm.cu`` for these addresses and sizes:
    0 none (an empty output), 1 the tile kernel (row tiles staged in
    shared memory by 16-byte copies: x and out on 16 bytes, a tile of
    ``CROSS_NORM_ROWS`` rows within ``CROSS_NORM_SMEM``), 2 the rows
    kernel (everything else)."""
    if b <= 0 or n <= 0:
        return 0
    w_out = n * (3 * d + 1)
    tile = 4 * (CROSS_NORM_ROWS * (2 * n * d + w_out) + 2 * w_out)
    if (x_addr | out_addr) % 16 == 0 and tile <= CROSS_NORM_SMEM:
        return 1
    return 2


def cross_norm(x: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
               fields_num: int, embed_dim: int) -> torch.Tensor:
    """x [B, 2·n·d] f32, mean/scale [n·(3d+1)] f32 → [B, n·(3d+1)] f32
    (``csrc/cross_norm.cu``, the kernel :func:`cross_norm_branch` picks).
    Every column but the dot is exactly the plain version's; the dot sums
    in another order."""
    if x.device.type == "cpu" and mean.device.type == "cpu":
        _build.book(cross_norm, "plain")
        return cross_norm_plain(x, mean, scale, fields_num, embed_dim)
    _build.require_cuda("cross_norm", x, mean, scale)
    if any(t.dtype != torch.float32 for t in (x, mean, scale)):
        raise TypeError("cross_norm: needs float32 x, mean and scale")
    n, d = fields_num, embed_dim
    w_out = n * (3 * d + 1)
    if (x.dim() != 2 or x.shape[1] != 2 * n * d or mean.shape != (w_out,)
            or scale.shape != (w_out,)):
        raise ValueError(f"cross_norm: x [B, {2 * n * d}] and mean/scale "
                         f"[{w_out}]")
    b = x.shape[0]
    out = torch.empty((b, w_out), dtype=torch.float32, device=x.device)
    branch = cross_norm_branch(x.data_ptr(), out.data_ptr(), b, n, d)
    if branch == 0:
        return out
    fn = _build.function("cross_norm", "pbx_cross_norm_path",
                         _CROSS_NORM_PATH_ARGS)
    _build.check(fn(x.data_ptr(), mean.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), b, n, d, branch, _build.stream(x)),
                 "cross_norm")
    cross_norm.launches += 1
    _build.book(cross_norm, "cuda")
    return out


cross_norm.launches = 0
cross_norm.label = "cross_norm"


class CrossNormFn(torch.autograd.Function):
    """The forward through ``ops.cross_norm``; the backward mirrors
    ``_cn_bwd`` (pallas_ctr.py): dx, and dmean/dscale for the summary's
    cotangent chain (computed only where asked for)."""

    @staticmethod
    def forward(ctx, x, mean, scale, fields_num, embed_dim, ops):
        ctx.save_for_backward(x, mean, scale)
        ctx.dims = (fields_num, embed_dim)
        return ops.cross_norm(x, mean, scale, fields_num, embed_dim)

    @staticmethod
    def backward(ctx, g):
        x, mean, scale = ctx.saved_tensors
        n, d = ctx.dims
        w_out = 3 * d + 1
        b = x.shape[0]
        pairs = x.reshape(b, n, 2, d)
        a, bb = pairs[:, :, 0], pairs[:, :, 1]
        g3 = g.reshape(b, n, w_out)
        ge = g3 * scale.reshape(n, w_out)[None]    # d y / d feats = scale
        ga, gb = ge[..., :d], ge[..., d:2 * d]
        gh, gd = ge[..., 2 * d:3 * d], ge[..., 3 * d:]
        dx = dmean = dscale = None
        if ctx.needs_input_grad[0]:
            da = ga + gh * bb + gd * bb            # dot = Σ a·b ⇒ ∂/∂a = b
            db = gb + gh * a + gd * a
            dx = torch.stack([da, db], dim=2).reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dmean = (-ge.sum(dim=0)).reshape(mean.shape).to(mean.dtype)
        if ctx.needs_input_grad[2]:
            had = a * bb
            feats = torch.cat([a, bb, had, had.sum(dim=-1, keepdim=True)],
                              dim=-1)
            dscale = (g3 * (feats - mean.reshape(n, w_out)[None])).sum(
                dim=0).reshape(scale.shape).to(scale.dtype)
        return dx, dmean, dscale, None, None, None
