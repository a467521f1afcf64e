"""Wide&Deep — a linear (wide) part and an MLP (deep) part; the same
math as ``paddlebox_tpu/models/wide_deep.py``.

Wide: each slot's pooled ``embed_w`` (the 1-dim per-feature weight,
column ``cvm_offset``) summed per instance, plus a linear layer over the
dense features. Deep: the pooled slots and the dense features through a
ReLU tower (``compute_dtype``, bf16 by default) into one logit. Names
follow the flax tree: ``wide_linear``, ``hidden[i]`` = ``Dense_i``,
``deep_out``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.deepfm import relu_tower


class WideDeep(nn.Module):
    def __init__(self, num_slots: int, slot_width: int, dense_dim: int,
                 hidden: Sequence[int] = (400, 400, 400),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 cvm_offset: int = 2) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.cvm_offset = cvm_offset
        self.wide_linear = nn.Linear(dense_dim, 1)
        widths = [num_slots * slot_width + dense_dim, *hidden]
        self.hidden = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(widths[:-1], widths[1:]))
        self.deep_out = nn.Linear(widths[-1], 1)

    def forward(self, pooled: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        """pooled [B, S, D], dense [B, dense_dim] → logits [B] f32."""
        pooled, dense = pooled.float(), dense.float()
        wide = (pooled[..., self.cvm_offset].sum(dim=1)
                + self.wide_linear(dense)[:, 0])
        x = torch.cat([pooled.reshape(pooled.shape[0], -1), dense], dim=1)
        x = relu_tower(x, self.hidden, self.compute_dtype)
        return wide + self.deep_out(x.float())[:, 0]
