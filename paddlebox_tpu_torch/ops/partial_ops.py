"""partial_concat / partial_sum — a column slice of each of N inputs,
concatenated or summed; counterpart of ``paddlebox_tpu/ops/partial_ops.py``.

Reference: paddle/fluid/operators/partial_concat_op.* and
partial_sum_op.*: each input [N, C] contributes columns [start,
start+length) (length -1: to the end; a negative start counts from the
end), the wide / LR parts of CTR models.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _slice(x: torch.Tensor, start: int, length: int) -> torch.Tensor:
    c = x.shape[1]
    s = start if start >= 0 else c + start
    e = c if length < 0 else min(s + length, c)
    return x[:, s:e]


def partial_concat(xs: Sequence[torch.Tensor], start_index: int = 0,
                   length: int = -1) -> torch.Tensor:
    return torch.cat([_slice(x, start_index, length) for x in xs], dim=1)


def partial_sum(xs: Sequence[torch.Tensor], start_index: int = 0,
                length: int = -1) -> torch.Tensor:
    out = _slice(xs[0], start_index, length)
    for x in xs[1:]:
        out = out + _slice(x, start_index, length)
    return out
