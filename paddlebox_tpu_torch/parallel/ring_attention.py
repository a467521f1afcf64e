"""Sequence/context parallelism: ring attention and Ulysses all-to-all —
counterpart of ``paddlebox_tpu/parallel/ring_attention.py``.

- ``ring_attention``: blockwise attention with the K/V blocks rotating
  around the axis by ``ppermute``, merged with the online-softmax
  accumulation (running max and denominator). The full T×T score matrix
  never materializes on one rank.
- ``ulysses_attention``: the all-to-all alternative — reshard
  [B, T/n, H, D] → [B, T, H/n, D], local full attention on a head subset,
  and the inverse all-to-all.

Every rank of the axis calls them on its own contiguous sequence block;
both are differentiable (the collectives' backwards are their
transposes).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from paddlebox_tpu_torch.parallel.collectives import (Axis, all_to_all,
                                                      ppermute)


def _flash_block(q, k, v, scale, mask, o, m, l):
    """One blockwise attention accumulation step (online softmax).

    q [B,Tq,H,D], k/v [B,Tk,H,D]; o [B,Tq,H,D] running numerator,
    m [B,H,Tq] running max, l [B,H,Tq] running denominator.
    mask [Tq,Tk] True = attend, or None.
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask[None, None], s, -math.inf)
    m_blk = torch.amax(s, dim=-1)
    m_new = torch.maximum(m, m_blk)
    # guard fully-masked rows (m_new == -inf): exp(-inf - -inf) = nan,
    # in the forward and in the backward
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
    l_new = l * corr + torch.sum(p, dim=-1)
    o_new = o * corr.transpose(1, 2)[..., None] \
        + torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o_new, m_new, l_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: Axis, causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Context-parallel attention over ``axis``, called by every rank.

    q/k/v: [B, T_local, H, D] — rank i holds positions
    [i*T_local, (i+1)*T_local). Returns [B, T_local, H, D]. K and V
    rotate as ONE packed tensor, one ``ppermute`` a hop: n − 1 rotating
    hops, then a last hop that does not rotate."""
    n = axis.size
    me = axis.rank
    b, t, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    perm = [(i, (i + 1) % n) for i in range(n)]  # pass K/V rightward
    pos = torch.arange(t, device=q.device)
    q_pos = me * t + pos

    o = torch.zeros_like(q)
    m = torch.full((b, h, t), -math.inf, dtype=q.dtype, device=q.device)
    l = torch.zeros((b, h, t), dtype=q.dtype, device=q.device)
    kv = torch.stack([k, v])
    for i in range(n):
        src = (me - i) % n  # whose block we hold at hop i
        mask = (q_pos[:, None] >= (src * t + pos)[None, :]) if causal \
            else None
        o, m, l = _flash_block(q, kv[0], kv[1], scale, mask, o, m, l)
        if i < n - 1:
            kv = ppermute(kv, axis, perm)
    l_t = l.transpose(1, 2)[..., None]  # [B,T,H,1]
    return o / torch.clamp(l_t, min=1e-20)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis: Axis, causal: bool = False,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses style) sequence parallelism: reshard
    sequence-sharded → head-sharded, full local attention, reshard back.
    Requires H % axis size == 0.

    q/k/v: [B, T_local, H, D] → returns [B, T_local, H, D].
    """
    n = axis.size
    b, t, h, d = q.shape
    if h % n != 0:
        raise ValueError(
            f"ulysses_attention reshards heads over the axis: H={h} must "
            f"be divisible by axis size {n} (use ring_attention otherwise)")

    def to_heads(x):  # [B,T/n,H,D] → [B,T,H/n,D]
        return all_to_all(x, axis, 2, 1)

    def to_seq(x):    # [B,T,H/n,D] → [B,T/n,H,D]
        return all_to_all(x, axis, 1, 2)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    if causal:
        ar = torch.arange(t * n, device=q.device)
        s = torch.where((ar[:, None] >= ar[None, :])[None, None], s,
                        -math.inf)
    p = torch.softmax(s, dim=-1)
    oh = torch.einsum("bhqk,bkhd->bqhd", p, vh)
    return to_seq(oh)


def reference_attention(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Single-device full attention — the correctness oracle for both
    parallel formulations."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        t, tk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def make_context_parallel_attention(axis: Axis, kind: str = "ring",
                                    causal: bool = False):
    """``(q, k, v) -> out`` attention over ``axis``, ``kind`` "ring" or
    "ulysses". Unlike the reference, whose jitted function takes the
    global [B, T, H, D] arrays and lets ``shard_map`` split the sequence
    dim, this one takes and returns THIS RANK's contiguous block
    [B, T/n, H, D] (``convert.sequence_block`` cuts it): there is no
    ``shard_map`` to split or assemble the global array."""
    if kind not in ("ring", "ulysses"):
        raise ValueError(f"unknown context-parallel kind {kind!r}")
    fn = ring_attention if kind == "ring" else ulysses_attention

    def attn(q, k, v):
        return fn(q, k, v, axis, causal=causal)

    return attn
