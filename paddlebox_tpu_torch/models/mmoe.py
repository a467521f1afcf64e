"""MMoE — the multi-gate mixture-of-experts multi-task CTR tower; the
same math as ``paddlebox_tpu/models/mmoe.py``.

Shared experts (one batched einsum a layer over the expert axis), one
softmax gate, tower and logit head per task, all but the heads in
``compute_dtype`` (bf16 by default). ``MMoE`` returns [B, num_tasks]
logits; ``MMoESingle`` is its task-0 view, which plugs into the
single-label trainers. Names follow the flax tree: ``expert_w{l}`` /
``expert_b{l}`` as they are, ``gates[t]`` = ``gate{t}``,
``towers[t][i]`` = ``tower{t}_{i}``, ``heads[t]`` = ``head{t}``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class MMoE(nn.Module):
    def __init__(self, num_slots: int, slot_width: int, dense_dim: int,
                 num_experts: int = 4, num_tasks: int = 2,
                 expert_hidden: Sequence[int] = (256, 128),
                 tower_hidden: Sequence[int] = (64,),
                 compute_dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.compute_dtype = compute_dtype
        self.num_experts = num_experts
        self.num_layers = len(expert_hidden)
        d_in = num_slots * slot_width + dense_dim
        din = d_in
        for li, width in enumerate(expert_hidden):
            w = torch.empty(num_experts, din, width)
            for e in range(num_experts):
                nn.init.xavier_uniform_(w[e].T)
            self.register_parameter(f"expert_w{li}", nn.Parameter(w))
            self.register_parameter(
                f"expert_b{li}",
                nn.Parameter(torch.zeros(num_experts, 1, width)))
            din = width
        self.gates = nn.ModuleList(nn.Linear(d_in, num_experts)
                                   for _ in range(num_tasks))
        widths = [din, *tower_hidden]
        self.towers = nn.ModuleList(
            nn.ModuleList(nn.Linear(i, o)
                          for i, o in zip(widths[:-1], widths[1:]))
            for _ in range(num_tasks))
        self.heads = nn.ModuleList(nn.Linear(widths[-1], 1)
                                   for _ in range(num_tasks))

    def forward(self, pooled: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        """(pooled [B, S, D], dense [B, Dd]) → logits [B, num_tasks]."""
        cd = self.compute_dtype
        x = torch.cat([pooled.reshape(pooled.shape[0], -1).float(),
                       dense.float()], dim=1).to(cd)
        h = x.expand(self.num_experts, *x.shape)
        for li in range(self.num_layers):
            w = getattr(self, f"expert_w{li}").to(cd)
            b = getattr(self, f"expert_b{li}").to(cd)
            h = F.relu(torch.einsum("ebd,edh->ebh", h, w) + b)
        logits = []
        for gate, tower, head in zip(self.gates, self.towers, self.heads):
            g = torch.softmax(F.linear(x, gate.weight.to(cd),
                                       gate.bias.to(cd)), dim=-1)
            y = torch.einsum("be,ebh->bh", g, h)
            for layer in tower:
                y = F.relu(F.linear(y, layer.weight.to(cd),
                                    layer.bias.to(cd)))
            logits.append(head(y.float()))
        return torch.cat(logits, dim=-1)


class MMoESingle(nn.Module):
    """Task 0 of ``MMoE``: (pooled, dense) → logits [B]."""

    def __init__(self, num_slots: int, slot_width: int, dense_dim: int,
                 num_experts: int = 4, num_tasks: int = 2,
                 expert_hidden: Sequence[int] = (256, 128),
                 tower_hidden: Sequence[int] = (64,),
                 compute_dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.mmoe = MMoE(num_slots, slot_width, dense_dim, num_experts,
                         num_tasks, expert_hidden, tower_hidden,
                         compute_dtype)

    def forward(self, pooled: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        return self.mmoe(pooled, dense)[:, 0]
