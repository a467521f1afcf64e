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
``sync_stats`` (the multi-GPU reduce of the batch stats,
cross_norm_hadamard_op.cu) is ``cross_norm_update(sync_axis=group)``:
the batch count, sum and square sum of every rank of the process group,
summed in rank order before the decayed fold, where the reference
``psum``s over a mesh axis.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch

from paddlebox_tpu_torch.ops.ctr_kernels import CrossNormFn, cross_features
from paddlebox_tpu_torch.ops.data_norm import (DataNormSummary,
                                               data_norm_fold_stats,
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


def _rank_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` in rank order (an
    all-gather, then a fold), on ``t``'s device; gloo moves CPU tensors,
    so a card's ``t`` goes through the host."""
    import torch.distributed as dist
    world = dist.get_world_size(group)
    src = t.contiguous()
    if dist.get_backend(group) == "gloo" and src.device.type == "cuda":
        src = src.cpu()
    out = torch.empty((world,) + tuple(src.shape), dtype=src.dtype,
                      device=src.device)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    acc = out[0]
    for r in range(1, world):
        acc = acc + out[r]
    return acc.to(t.device)


def cross_norm_update(summary: DataNormSummary, x: torch.Tensor,
                      fields_num: int, embed_dim: int,
                      decay: float = 0.9999999,
                      sync_axis: Optional[Any] = None) -> DataNormSummary:
    """Fold a batch's cross-feature stats into the summary (outside the
    grad). ``sync_axis`` (the reference's ``sync_stats``): a
    ``torch.distributed`` process group (``dist.group.WORLD`` for the
    default one); every rank then folds the GLOBAL batch count, sum and
    square sum, so the summaries stay identical across ranks. Collective:
    every rank of the group calls it."""
    if isinstance(sync_axis, str):
        raise TypeError(
            f"sync_axis={sync_axis!r} is a mesh axis name: the port sums "
            "over a torch.distributed process group (dist.group.WORLD, or "
            "a train/multihost.Pod's group)")
    with torch.no_grad():
        feats = cross_features(x, fields_num, embed_dim)
        if sync_axis is None:
            return data_norm_update(summary, feats, decay=decay)
        c = feats.shape[1]
        stats = torch.cat([
            torch.tensor([float(feats.shape[0])], dtype=feats.dtype,
                         device=feats.device),
            feats.sum(dim=0), feats.square().sum(dim=0)])
        tot = _rank_sum(stats, sync_axis)
        # the data_norm fold over the GLOBAL stats: one definition, so
        # the synced and the plain update cannot drift
        return data_norm_fold_stats(summary, tot[0], tot[1:1 + c],
                                    tot[1 + c:], decay=decay)


def init_cross_norm_summary(fields_num: int, embed_dim: int,
                            device: Union[str, torch.device] = "cuda"
                            ) -> DataNormSummary:
    return init_data_norm_summary(fields_num * (3 * embed_dim + 1),
                                  device=device)
