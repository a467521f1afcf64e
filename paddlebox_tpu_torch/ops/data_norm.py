"""data_norm — batch-statistics normalization with running summaries
(counterpart of ``paddlebox_tpu/ops/data_norm.py``).

Per-column summaries {batch_size, batch_sum, batch_square_sum}; the
forward uses ``mean = batch_sum / batch_size`` and ``scale =
sqrt(batch_size / batch_square_sum)`` (data_norm_op.cc means_arr/
scales_arr), y = (x - mean) * scale. ``data_norm_update`` folds a batch
into the summary with the reference's decay (summary = summary * decay +
batch stats) and returns a new summary. ``slot_dim``: skip normalization
for all-zero (no-show) slot blocks. Plain PyTorch: no kernel of the JAX
package computes these.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from paddlebox_tpu_torch.device import resolve_device


class DataNormSummary(NamedTuple):
    batch_size: torch.Tensor        # f32 [C]
    batch_sum: torch.Tensor         # f32 [C]
    batch_square_sum: torch.Tensor  # f32 [C]


def init_data_norm_summary(c: int, init_size: float = 1e4,
                           device: Union[str, torch.device] = "cuda"
                           ) -> DataNormSummary:
    """size=1e4, sum=0, square_sum=1e4 (unit scale), as the reference
    initializes it; on the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    return DataNormSummary(
        batch_size=torch.full((c,), init_size, dtype=torch.float32,
                              device=dev),
        batch_sum=torch.zeros((c,), dtype=torch.float32, device=dev),
        batch_square_sum=torch.full((c,), init_size, dtype=torch.float32,
                                    device=dev))


def data_norm_mean_scale(summary: DataNormSummary, epsilon: float = 1e-7
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one (mean, scale) derivation, shared by :func:`data_norm` and
    the cross_norm kernel's apply (``ops/cross_norm``). Differentiable in
    the summary."""
    mean = summary.batch_sum / summary.batch_size
    scale = torch.sqrt(summary.batch_size
                       / summary.batch_square_sum.clamp_min(epsilon))
    return mean, scale


def data_norm(x: torch.Tensor, summary: DataNormSummary, slot_dim: int = -1,
              epsilon: float = 1e-7) -> torch.Tensor:
    mean, scale = data_norm_mean_scale(summary, epsilon)
    y = (x - mean[None, :]) * scale[None, :]
    if slot_dim > 0:
        # skip normalization for slot blocks whose first column (show) is 0
        b, c = x.shape
        blocks = x.reshape(b, c // slot_dim, slot_dim)
        has_show = blocks[..., 0:1] > epsilon
        y = torch.where(has_show.expand(blocks.shape).reshape(b, c), y, x)
    return y


def data_norm_fold_stats(summary: DataNormSummary, count, s: torch.Tensor,
                         q: torch.Tensor, decay: float = 0.9999999,
                         squared_sum_epsilon: float = 1e-4
                         ) -> DataNormSummary:
    """The one decayed summary fold over precomputed batch stats (count,
    Σx, Σx²); the epsilon is added once per update."""
    return DataNormSummary(
        batch_size=summary.batch_size * decay + count,
        batch_sum=summary.batch_sum * decay + s,
        batch_square_sum=summary.batch_square_sum * decay + q
        + squared_sum_epsilon)


def data_norm_update(summary: DataNormSummary, x: torch.Tensor,
                     decay: float = 0.9999999,
                     squared_sum_epsilon: float = 1e-4) -> DataNormSummary:
    return data_norm_fold_stats(
        summary, x.shape[0], x.sum(dim=0), x.square().sum(dim=0),
        decay=decay, squared_sum_epsilon=squared_sum_epsilon)
