"""The CTR forward — counterpart of the inference half of
``paddlebox_tpu/train/step.py``: pull → fused_seqpool_cvm → model →
sigmoid, shared by every caller that predicts so the seqpool constants
live in one place.

A batch reaches the device in THREE host→device copies (the reference
packs per-slot tensors into single copies for the same reason): the
unique rows plus two scalars, the per-key ints, and the float block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm
from paddlebox_tpu_torch.ps.table import (PullIndex, TableState, expand_pull,
                                          gather_full_rows, pull_values)


def pack_floats(dense: np.ndarray, label: np.ndarray, show: np.ndarray,
                clk: np.ndarray) -> np.ndarray:
    """THE float-block layout, [B, Dd+3] = [dense | label, show, clk]."""
    return np.concatenate(
        [dense.astype(np.float32, copy=False),
         np.stack([label, show, clk], axis=1)],
        axis=1).astype(np.float32, copy=False)


def unpack_floats(floats: torch.Tensor):
    """(dense, label, show, clk) views of a pack_floats block."""
    floats = floats.float()
    return floats[:, :-3], floats[:, -3], floats[:, -2], floats[:, -1]


class DeviceBatch(NamedTuple):
    """Everything the forward consumes for one batch, on the device."""

    ints_u: torch.Tensor   # int32 [U_pad + 2] = unique_rows ++ [num_keys, pad_segment]
    ints_k: torch.Tensor   # int32 [2, K_pad] = [gather_idx; segments], or
                           #       [1, K_pad] when segments are derivable
    floats: torch.Tensor   # f32 [B, Dd + 3] = [dense | label | show | clk]
    num_keys: int          # host copy of ints_u[-2]

    @property
    def unique_rows(self) -> torch.Tensor:
        return self.ints_u[:-2]

    @property
    def gather_idx(self) -> torch.Tensor:
        return self.ints_k[0]

    @property
    def segments_trivial(self) -> bool:
        return self.ints_k.shape[0] == 1

    @property
    def segments(self) -> torch.Tensor:
        if not self.segments_trivial:
            return self.ints_k[1]
        # trivial layout: segment i == i for real keys, pad bin after
        k_pad = self.ints_k.shape[1]
        i = torch.arange(k_pad, dtype=torch.int32, device=self.ints_k.device)
        return torch.where(i < self.num_keys, i, self.ints_u[-1])

    @property
    def pool_segments(self) -> Optional[torch.Tensor]:
        """Segments for fused_seqpool_cvm — None declares the trivial
        layout (the pool becomes a reshape)."""
        return None if self.segments_trivial else self.segments

    @property
    def dense(self) -> torch.Tensor:
        return unpack_floats(self.floats)[0]

    @property
    def show(self) -> torch.Tensor:
        return unpack_floats(self.floats)[2]


def make_device_batch(batch: SlotBatch, idx: PullIndex,
                      device: torch.device) -> DeviceBatch:
    u_pad = idx.unique_rows.shape[0]
    ints_u = np.empty(u_pad + 2, np.int32)
    ints_u[:u_pad] = idx.unique_rows
    ints_u[u_pad] = batch.num_keys
    ints_u[u_pad + 1] = batch.pad_segment
    if batch.segments_trivial:
        ints_k = np.ascontiguousarray(idx.gather_idx[None, :])
    else:
        ints_k = np.stack([idx.gather_idx, batch.segments.astype(np.int32)])
    floats = pack_floats(batch.dense, batch.label, batch.show, batch.clk)
    return DeviceBatch(ints_u=torch.from_numpy(ints_u).to(device),
                       ints_k=torch.from_numpy(ints_k).to(device),
                       floats=torch.from_numpy(floats).to(device),
                       num_keys=int(batch.num_keys))


def ctr_forward(table: TableState, model: nn.Module, batch: DeviceBatch,
                batch_size: int, num_slots: int, use_cvm: bool = True,
                cvm_offset: int = 2, need_filter: bool = False,
                quant_ratio: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """THE CTR inference path. Returns (pred [B], ins_w [B]) — ins_w
    masks batch-padding instances."""
    vals_u = pull_values(gather_full_rows(table, batch.unique_rows),
                         table.mf_dim)
    values_k = expand_pull(vals_u, batch.gather_idx)
    pooled = fused_seqpool_cvm(
        values_k, batch.pool_segments, batch_size, num_slots, use_cvm,
        cvm_offset, 0.0, need_filter, 0.2, 1.0, 0.96, quant_ratio)
    logits = model(pooled, batch.dense)
    ins_w = (batch.show > 0).float()
    return torch.sigmoid(logits), ins_w
