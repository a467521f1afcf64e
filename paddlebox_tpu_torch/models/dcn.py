"""DCN-v2 — the deep & cross network v2; the same math as
``paddlebox_tpu/models/dcn.py``.

Cross layers x_{l+1} = x_0 ⊙ (W_l x_l + b_l) + x_l (the v2 full-matrix
form) over the flattened pooled slots and dense features, beside
(``structure="parallel"``: the logit reads [x_cross, x_deep]) or below
(``"stacked"``: the deep tower reads x_cross) a ReLU tower; everything
but the output layer in ``compute_dtype`` (bf16 by default). Names follow
the flax tree: ``cross[l].dense`` = ``CrossLayer_l/Dense_0``,
``hidden[i]`` = ``Dense_i``, ``out`` the last Dense.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from paddlebox_tpu_torch.models.deepfm import relu_tower


class CrossLayer(nn.Module):
    """x0 ⊙ (W xl + b) + xl in ``compute_dtype``."""

    def __init__(self, width: int,
                 compute_dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dense = nn.Linear(width, width)

    def forward(self, x0: torch.Tensor, xl: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        w = F.linear(xl.to(cd), self.dense.weight.to(cd),
                     self.dense.bias.to(cd))
        return x0.to(cd) * w + xl.to(cd)


class DCNv2(nn.Module):
    def __init__(self, num_slots: int, slot_width: int, dense_dim: int,
                 num_cross_layers: int = 3,
                 hidden: Sequence[int] = (400, 400),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 structure: str = "parallel") -> None:
        super().__init__()
        if structure not in ("parallel", "stacked"):
            raise ValueError(f"unknown DCNv2 structure {structure!r}")
        self.compute_dtype = compute_dtype
        self.structure = structure
        d = num_slots * slot_width + dense_dim
        self.cross = nn.ModuleList(CrossLayer(d, compute_dtype)
                                   for _ in range(num_cross_layers))
        widths = [d, *hidden]
        self.hidden = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(widths[:-1], widths[1:]))
        feat = widths[-1] if structure == "stacked" else d + widths[-1]
        self.out = nn.Linear(feat, 1)

    def forward(self, pooled: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        """pooled [B, S, D], dense [B, dense_dim] → logits [B] f32."""
        x0 = torch.cat([pooled.reshape(pooled.shape[0], -1).float(),
                        dense.float()], dim=1).to(self.compute_dtype)
        xc = x0
        for layer in self.cross:
            xc = layer(x0, xc)
        xd = relu_tower(xc if self.structure == "stacked" else x0,
                        self.hidden, self.compute_dtype)
        feat = xd if self.structure == "stacked" else torch.cat([xc, xd], 1)
        return self.out(feat.float())[:, 0]
