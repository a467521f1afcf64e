"""batch_fc — per-slot batched fully-connected (counterpart of
``paddlebox_tpu/ops/batch_fc.py``).

Reference: batch_fc_op.{cc,cu,h}. Default mode: Input [slot_pairs, ins,
in_dim] × W [slot_pairs, in_dim, out_dim] + Bias [slot_pairs, out_dim];
batchcount mode flattens a [bc*ins, in] input against [bc, in, out]
weights, optionally with ``transpose_weight`` ([bc, out, in] weights).

The forward is the ``batch_fc`` kernel (``ops/ctr_kernels.py``); the
backward is plain PyTorch, as the JAX package's is jnp.
"""

from __future__ import annotations

import torch

from paddlebox_tpu_torch.ops.ctr_kernels import BatchFcFn
from paddlebox_tpu_torch.ops.kernels import KERNELS, KernelSet


def batch_fc(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             batchcount: int = 0, transpose_weight: bool = False,
             ops: KernelSet = KERNELS) -> torch.Tensor:
    if transpose_weight and batchcount <= 0:
        # the reference defines transpose_weight only for the batchcount
        # layout: fail loudly instead of contracting an [S, O, I] weight
        # on the wrong axis
        raise ValueError(
            "batch_fc: transpose_weight requires batchcount > 0")
    return BatchFcFn.apply(x, w, bias, batchcount, transpose_weight, ops)
