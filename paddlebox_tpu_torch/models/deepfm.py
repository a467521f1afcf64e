"""DeepFM — wide (1st-order) + FM (2nd-order) + deep tower; the same
math as ``paddlebox_tpu/models/deepfm.py``.

``embed_w`` (the 1-dim wide weight per feature) is the FM first-order
term; ``embedx`` (the mf vector) feeds both the FM pairwise term and the
deep tower. The first-order and FM terms and the output layer run in
float32; the hidden layers cast their inputs, weights and biases to
``compute_dtype`` (bf16 by default), as flax's ``Dense(dtype=...)`` does.

Flax infers layer widths at init; here they are explicit:
``num_slots`` S, ``slot_width`` (the pooled width per slot, D_out) and
``dense_dim``. Parameter order matches the flax tree: ``first`` is
``Dense_0``, ``hidden[i]`` is ``Dense_{i+1}``, ``out`` is the last.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class DeepFM(nn.Module):
    def __init__(self, num_slots: int, slot_width: int, dense_dim: int,
                 hidden: Sequence[int] = (400, 400),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 cvm_offset: int = 2) -> None:
        super().__init__()
        self.hidden_sizes = tuple(hidden)
        self.compute_dtype = compute_dtype
        self.cvm_offset = cvm_offset
        self.first = nn.Linear(dense_dim, 1)
        widths = [num_slots * slot_width + dense_dim, *self.hidden_sizes]
        self.hidden = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(widths[:-1], widths[1:]))
        self.out = nn.Linear(widths[-1], 1)

    def forward(self, pooled: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        """pooled [B, S, D_out], dense [B, dense_dim] → logits [B] f32."""
        b = pooled.shape[0]
        co = self.cvm_offset
        pooled = pooled.float()
        dense = dense.float()
        wide = pooled[..., co]           # [B, S] per-slot 1st-order weights
        vecs = pooled[..., co + 1:]      # [B, S, mf] FM factors

        first = wide.sum(dim=1) + self.first(dense)[:, 0]

        # FM second order: 0.5 * Σ_k [(Σ_s v)² - Σ_s v²]
        sum_sq = vecs.sum(dim=1).square()
        sq_sum = vecs.square().sum(dim=1)
        fm = 0.5 * (sum_sq - sq_sum).sum(dim=1)

        # deep tower over [cvm stats + vectors + dense]
        x = torch.cat([pooled.reshape(b, -1), dense], dim=1)
        deep = self.out(relu_tower(x, self.hidden,
                                   self.compute_dtype).float())[:, 0]
        return first + fm + deep


def relu_tower(x: torch.Tensor, layers: Sequence[nn.Linear],
               compute_dtype: torch.dtype) -> torch.Tensor:
    """ReLU(linear) layers with the input, weights and biases cast to
    ``compute_dtype`` (flax's ``Dense(dtype=...)``); returns the last
    activation in ``compute_dtype``."""
    x = x.to(compute_dtype)
    for layer in layers:
        x = F.relu(F.linear(x, layer.weight.to(compute_dtype),
                            layer.bias.to(compute_dtype)))
    return x
