"""The CTR step — counterpart of ``paddlebox_tpu/train/step.py``.

``ctr_forward`` is the inference path (pull → fused_seqpool_cvm → model
→ sigmoid), shared by serving and eval so the seqpool constants live in
one place. ``TrainStep`` is one training step: pull → forward → BCE loss
→ backward → sparse push (in-table Adagrad + write-back) → dense update
→ AUC, run eagerly and updating the table, the dense params, the
optimizer and the AUC tables in place.

A batch reaches the device in THREE host→device copies (the reference
packs per-slot tensors into single copies for the same reason): the
unique rows plus two scalars, the per-key ints, and the float block.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.metrics import AucState, auc_add_batch
from paddlebox_tpu_torch.ops.kernels import KERNELS, KernelSet
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.table import (PullIndex, TableState, apply_push,
                                          expand_pull, gather_full_rows,
                                          pull_values)

#: the dense optimizer factory: params → optimizer (optax's default
#: ``adam(1e-3)`` has the same update up to rounding)
OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


def default_tx(params: Iterable[nn.Parameter]) -> torch.optim.Optimizer:
    return torch.optim.Adam(params, lr=1e-3, eps=1e-8)


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
    """Everything the step consumes for one batch, on the device."""

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
    def label(self) -> torch.Tensor:
        return unpack_floats(self.floats)[1]

    @property
    def show(self) -> torch.Tensor:
        return unpack_floats(self.floats)[2]

    @property
    def show_clk(self) -> torch.Tensor:
        """f32 [B, 2], the CVM values the pool backward pushes."""
        return self.floats[:, -2:].float()


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


def _expand_pool(vals_u: torch.Tensor, batch: DeviceBatch,
                 batch_size: int, num_slots: int, use_cvm: bool = True,
                 cvm_offset: int = 2, need_filter: bool = False,
                 quant_ratio: int = 0, ops: KernelSet = KERNELS
                 ) -> torch.Tensor:
    """expand_pull → fused_seqpool_cvm over the batch's REAL keys only.

    The reference carries the padded key bucket through (static shapes
    for XLA) and masks the pads with ``key_valid``; the pads pool into a
    discarded bin and get zero grads, so dropping them gives the same
    result with less work. It also matters: every pad key expands from
    the same pad row, and the backward of the expand (an accumulating
    index_put, which sums each row's duplicates in one thread) would
    serialise on those hundreds of thousands of duplicates."""
    nk = batch.num_keys
    segs = batch.pool_segments
    return fused_seqpool_cvm(
        expand_pull(vals_u, batch.gather_idx[:nk]),
        None if segs is None else segs[:nk], batch.show_clk, batch_size,
        num_slots, use_cvm, cvm_offset, 0.0, need_filter, 0.2, 1.0, 0.96,
        quant_ratio, ops=ops)


def ctr_forward(table: TableState, model: nn.Module, batch: DeviceBatch,
                batch_size: int, num_slots: int, use_cvm: bool = True,
                cvm_offset: int = 2, need_filter: bool = False,
                quant_ratio: int = 0, ops: KernelSet = KERNELS
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """THE CTR inference path. Returns (pred [B], ins_w [B]) — ins_w
    masks batch-padding instances."""
    vals_u = pull_values(gather_full_rows(table, batch.unique_rows, ops),
                         table.mf_dim)
    pooled = _expand_pool(vals_u, batch, batch_size, num_slots, use_cvm,
                          cvm_offset, need_filter, quant_ratio, ops)
    logits = model(pooled, batch.dense)
    ins_w = (batch.show > 0).float()
    return torch.sigmoid(logits), ins_w


@dataclasses.dataclass
class StepState:
    """What a step updates, all in place: the device table, the dense
    model and its optimizer, and the AUC tables."""

    table: TableState
    model: nn.Module
    opt: torch.optim.Optimizer
    auc: AucState


class TrainStep:
    """One training step for a sparse optimizer config, after ``_step``
    of the reference, with the seqpool at its defaults (CVM head on,
    cvm_offset 2, no filter, no quantization), as the reference trainer
    runs it."""

    def __init__(self, sgd_cfg: SparseSGDConfig, batch_size: int,
                 num_slots: int, ops: KernelSet = KERNELS) -> None:
        """``ops`` selects the device functions: the kernels, unless a
        check on the card passes ``kernels.PLAIN`` to run the same step
        through the plain versions."""
        self.sgd_cfg = sgd_cfg
        self.batch_size = batch_size
        self.num_slots = num_slots
        self.ops = ops

    def __call__(self, state: StepState, batch: DeviceBatch,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One step; ``generator`` draws the lazy-mf init values. Returns
        the loss and the per-instance predictions (device tensors:
        reading them syncs)."""
        b = self.batch_size
        model = state.model
        ins_w = (batch.show > 0).float()        # mask tail padding
        label = batch.label
        # ONE gather serves both the pull values and the push optimizer
        # state (the whole row is read once)
        rows_full = gather_full_rows(state.table, batch.unique_rows,
                                     self.ops)
        vals_u = pull_values(rows_full, state.table.mf_dim)
        vals_u.requires_grad_(True)
        pooled = _expand_pool(vals_u, batch, b, self.num_slots,
                              ops=self.ops)
        logits = model(pooled, batch.dense)
        ls = F.binary_cross_entropy_with_logits(logits, label,
                                                reduction="none")
        loss = (ls * ins_w).sum() / ins_w.sum().clamp_min(1.0)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        # sparse push: autograd through expand_pull already merged the
        # per-key grads into per-unique-row grads. Embed grads are scaled
        # by -batch_size as in PushCopy (box_wrapper.cu:368-372: the
        # in-table adagrad ADDS ratio*g/g_show)
        g_vals_u = vals_u.grad
        g_vals_u[:, 2:] *= -1.0 * b
        apply_push(state.table, batch.unique_rows, g_vals_u, self.sgd_cfg,
                   generator=generator, rows_full=rows_full, ops=self.ops)
        state.opt.step()
        pred = torch.sigmoid(logits.detach())
        auc_add_batch(state.auc, pred, label, ins_w)
        return {"loss": loss.detach(), "pred": pred}

    def eval(self, table: TableState, model: nn.Module, auc: AucState,
             batch: DeviceBatch) -> torch.Tensor:
        """Forward-only: the AUC accumulates, nothing trains. Returns
        pred [B]."""
        with torch.no_grad():
            pred, ins_w = ctr_forward(table, model, batch, self.batch_size,
                                      self.num_slots, ops=self.ops)
            auc_add_batch(auc, pred, batch.label, ins_w)
        return pred
