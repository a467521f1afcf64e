"""cross_norm_hadamard — cross-network hadamard features with data_norm
normalization (counterpart of ``paddlebox_tpu/ops/cross_norm.py``).

Reference: cross_norm_hadamard_op.{cc,cu}: the input is n field PAIRS of
embed_dim vectors ``[B, 2*n*d]``; per pair the output block of ``3d+1``
columns is [a, b, a⊙b, a·b], each column normalized with data_norm
summary stats (mean = sum/size, scale = sqrt(size/sq_sum)). Output
``[B, n*(3d+1)]``. The summary updates with decay ``summary_decay_rate``
(default 0.9999999).

The forward is the ``cross_norm`` kernel (``ops/ctr_kernels.py``), which
applies mean/scale derived from the summary here, outside it, so the
summary's cotangent chain is plain autograd; the backward is plain
PyTorch. The summary update stays outside the grad, as in the reference.
``sync_stats`` (``cross_norm_update(sync_axis=...)``, the all-reduce of
the batch stats across data-parallel ranks) waits for the sharded path.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from paddlebox_tpu_torch.ops.ctr_kernels import CrossNormFn, cross_features
from paddlebox_tpu_torch.ops.data_norm import (DataNormSummary,
                                               data_norm_mean_scale,
                                               data_norm_update,
                                               init_data_norm_summary)
from paddlebox_tpu_torch.ops.kernels import KERNELS, KernelSet

__all__ = ["cross_features", "cross_norm_hadamard", "cross_norm_update",
           "init_cross_norm_summary"]


def cross_norm_hadamard(x: torch.Tensor, summary: DataNormSummary,
                        fields_num: int, embed_dim: int,
                        epsilon: float = 1e-4,
                        ops: KernelSet = KERNELS) -> torch.Tensor:
    """x [B, 2·n·d] → normalized cross features [B, n·(3d+1)]. Note the
    epsilon: 1e-4 here, where data_norm's default is 1e-7."""
    mean, scale = data_norm_mean_scale(summary, epsilon)
    return CrossNormFn.apply(x, mean, scale, fields_num, embed_dim, ops)


def cross_norm_update(summary: DataNormSummary, x: torch.Tensor,
                      fields_num: int, embed_dim: int,
                      decay: float = 0.9999999,
                      sync_axis: Optional[str] = None) -> DataNormSummary:
    """Fold a batch's cross-feature stats into the summary (outside the
    grad). ``sync_axis`` (the reference's ``sync_stats``) is not ported
    yet and raises."""
    if sync_axis is not None:
        raise NotImplementedError(
            "cross_norm_update(sync_axis=...) waits for the sharded path "
            "(ROADMAP queue 1)")
    with torch.no_grad():
        feats = cross_features(x, fields_num, embed_dim)
        return data_norm_update(summary, feats, decay=decay)


def init_cross_norm_summary(fields_num: int, embed_dim: int,
                            device: Union[str, torch.device] = "cuda"
                            ) -> DataNormSummary:
    return init_data_norm_summary(fields_num * (3 * embed_dim + 1),
                                  device=device)
