"""rank_attention — per-ad rank-position attention (counterpart of
``paddlebox_tpu/ops/rank_attention.py``).

Reference: rank_attention_op.{cc,cu,h}. ``rank_offset[:, 0]`` is the
instance's own 1-based rank (0 ⇒ invalid); for each k < max_rank the pair
(rank_offset[:, 2k+1], rank_offset[:, 2k+2]) gives the 1-based rank and
the X-row index of the k-th co-shown ad. Output[i] = Σ_k X[idx_k] @
P[(own-1)*max_rank + (rank_k-1)] with RankParam viewed as [max_rank²,
input_dim, out_dim] blocks; invalid entries contribute 0. X gradients
flow only when ``enable_input_bp`` is True (rank_attention_op.cu computes
dX only under EnableInputBp).

The forward is the ``rank_attention`` kernel (``ops/ctr_kernels.py``); the
backward is plain PyTorch, as the JAX package's is jnp.
"""

from __future__ import annotations

import torch

from paddlebox_tpu_torch.ops.ctr_kernels import RankAttentionFn
from paddlebox_tpu_torch.ops.kernels import KERNELS, KernelSet


def rank_attention(x: torch.Tensor, rank_offset: torch.Tensor,
                   rank_param: torch.Tensor, max_rank: int = 3,
                   enable_input_bp: bool = False,
                   ops: KernelSet = KERNELS) -> torch.Tensor:
    """x: [N, D]; rank_offset: int32 [N, 1+2*max_rank]; rank_param:
    [max_rank*max_rank*D, P] (reference layout) or [max_rank*max_rank, D,
    P]. Returns [N, P]."""
    return RankAttentionFn.apply(x, rank_offset, rank_param, max_rank,
                                 enable_input_bp, ops)


def rank_attention2(x: torch.Tensor, rank_offset: torch.Tensor,
                    rank_param: torch.Tensor, max_rank: int = 3,
                    ops: KernelSet = KERNELS) -> torch.Tensor:
    """rank_attention2 (rank_attention_op.cc:179-308): the same attention
    sum, with gradients for RankParam only."""
    return rank_attention(x, rank_offset, rank_param, max_rank,
                          enable_input_bp=False, ops=ops)
