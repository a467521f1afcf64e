"""shuffle_batch — in-batch row shuffle for negative sampling;
counterpart of ``paddlebox_tpu/ops/shuffle_batch.py``.

Reference: paddle/fluid/operators/shuffle_batch_op.{cc,h}: the forward
permutes rows (recording ShuffleIdx), the backward routes the grads
through the inverse permutation, which autograd of ``index_select``
gives. The permutation comes from a ``torch.Generator`` (the reference
draws it from a jax key), or is passed in.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def shuffle_batch(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                  perm: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (shuffled x, shuffle_idx): row i of the output is row
    ``shuffle_idx[i]`` of ``x``. ``perm`` fixes the permutation, else it
    is drawn from ``generator``."""
    if perm is None:
        perm = torch.randperm(x.shape[0], generator=generator,
                              device=x.device)
    perm = perm.to(device=x.device, dtype=torch.long)
    return x.index_select(0, perm), perm


def unshuffle_batch(y: torch.Tensor,
                    shuffle_idx: torch.Tensor) -> torch.Tensor:
    """The original row order back (the ShuffleIdx consumer)."""
    return y.index_select(0, torch.argsort(shuffle_idx.long()))
