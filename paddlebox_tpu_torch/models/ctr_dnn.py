"""CtrDnn — the PaddleRec classic CTR MLP; the same math as
``paddlebox_tpu/models/ctr_dnn.py``.

The pooled slot embeddings (``fused_seqpool_cvm``'s output, D = cvm
offset + 1 + mf_dim a slot) and the dense features, concatenated, go
through a ReLU tower into one logit. The hidden layers cast their
inputs, weights and biases to ``compute_dtype`` (bf16 by default), as
flax's ``Dense(dtype=...)`` does; the output layer runs in float32.
``hidden[i]`` is the flax tree's ``Dense_i``, ``out`` its last Dense.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.deepfm import relu_tower


class CtrDnn(nn.Module):
    def __init__(self, num_slots: int, slot_width: int, dense_dim: int,
                 hidden: Sequence[int] = (400, 400, 400),
                 compute_dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        widths = [num_slots * slot_width + dense_dim, *hidden]
        self.hidden = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(widths[:-1], widths[1:]))
        self.out = nn.Linear(widths[-1], 1)

    def forward(self, pooled: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        """pooled [B, S, D], dense [B, dense_dim] → logits [B] f32."""
        x = torch.cat([pooled.reshape(pooled.shape[0], -1).float(),
                       dense.float()], dim=1)
        x = relu_tower(x, self.hidden, self.compute_dtype)
        return self.out(x.float())[:, 0]
