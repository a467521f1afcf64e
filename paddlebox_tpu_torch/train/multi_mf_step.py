"""The multi-mf step and trainer (per-slot embedding dims) — the port of
``paddlebox_tpu/train/multi_mf_step.py``.

One step per batch, ``TrainStep``'s with C dim classes: per class
``gather_full_rows`` → ``pull_values`` → the pool over the class's S_c
slots (``fused_seqpool_cvm``: kernel ``pool_cvm`` forward,
``segment_gather`` in the backward), then the pooled blocks concatenate
in CANONICAL slot order (``SlotClassMap.slot_route``: global slot s reads
rank ``slot_rank[s]`` of class ``class_of_slot[s]``) into the flat
[B, W] input of the dense model (the pull_gpups_sparse + seqpool +
concat contract with per-slot widths, feature_value.h:42-185) → BCE →
backward → per class the ``-batch_size`` embed-grad scale and
``apply_push`` (kernel ``scatter_add_update``) → the dense optimizer →
AUC. The model takes (flat [B, W], dense [B, Dd]); ``CtrDnn(1, W, Dd)``
is one.

Random numbers: class c's lazy-mf draws at global step t come from
``seeded_generator(device, seed + 1, t * C + c)`` (``class_generators``),
the port's ``Trainer`` stream (seed + 1, t) spread over the C classes;
the reference folds the class into the step's key. The two agree only
through ``mf_initial_range == 0``.

The resident pass (``MultiMfResidentPass``) stages per class
``ints_u [nb, U_c+2]`` and ``ints_k [nb, r, K_c]`` plus one shared float
block as plain int32/float32 (the reference's layout; no bit-packed
wire) and runs the same step over each staged batch's views, so it
equals ``train_pass`` over the same batches bit for bit.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddlebox_tpu_torch.device import seeded_generator
from paddlebox_tpu_torch.metrics import (AucState, auc_add_batch,
                                         auc_compute, init_auc_state)
from paddlebox_tpu_torch.ops.kernels import KERNELS, KernelSet
from paddlebox_tpu_torch.ps.multi_mf import MultiMfEmbeddingTable
from paddlebox_tpu_torch.ps.table import (TableState, apply_push,
                                          fill_oob_pads, gather_full_rows,
                                          pull_values)
from paddlebox_tpu_torch.train.step import (DeviceBatch, OptimizerFactory,
                                            _expand_pool, default_tx,
                                            make_device_batch, pack_floats)
from paddlebox_tpu_torch.train.trainer import (PREFETCH_DEPTH, NanInfError,
                                               StageTimers)
from paddlebox_tpu_torch.utils.prefetch import prefetch_iter

log = logging.getLogger(__name__)


def class_generators(device: torch.device, seed: int, step: int,
                     num_classes: int) -> List[torch.Generator]:
    """The lazy-mf generators of global step ``step``, one per dim class
    (see the module docstring)."""
    return [seeded_generator(device, seed + 1, step * num_classes + c)
            for c in range(num_classes)]


def canonical_concat(parts: Sequence[torch.Tensor],
                     route: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The per-class pooled blocks [B, S_c, D_c] → [B, W] in canonical
    slot order: global slot s is ``parts[c][:, r]`` for ``route[s] ==
    (c, r)``. Under autograd each slice's grad reaches only its class's
    block."""
    return torch.cat([parts[c][:, r, :] for c, r in route], dim=1)


def multi_mf_pool(vals_list: Sequence[torch.Tensor],
                  devs: Sequence[DeviceBatch], batch_size: int,
                  class_slots: Sequence[int],
                  route: Sequence[Tuple[int, int]], use_cvm: bool = True,
                  cvm_offset: int = 2, ops: KernelSet = KERNELS
                  ) -> torch.Tensor:
    """Each class's unique-row pull values [U_c, 3+d_c] pooled over its
    slots, then concatenated in canonical slot order → [B, W]. The class
    sub-batches share the floats, so every class's pool reads the same
    show/clk head; each reads its own key count and S_c."""
    parts = [_expand_pool(v, dev, batch_size, class_slots[c], use_cvm,
                          cvm_offset, ops=ops)
             for c, (v, dev) in enumerate(zip(vals_list, devs))]
    return canonical_concat(parts, route)


def multi_mf_forward(states: Sequence[TableState], model: nn.Module,
                     devs: Sequence[DeviceBatch], batch_size: int,
                     class_slots: Sequence[int],
                     route: Sequence[Tuple[int, int]], use_cvm: bool = True,
                     cvm_offset: int = 2, ops: KernelSet = KERNELS
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """THE multi-mf inference path (serving and eval). Returns (pred
    [B], ins_w [B])."""
    vals = [pull_values(gather_full_rows(st, dev.unique_rows, ops),
                        st.mf_dim) for st, dev in zip(states, devs)]
    flat = multi_mf_pool(vals, devs, batch_size, class_slots, route,
                         use_cvm, cvm_offset, ops)
    d0 = devs[0]
    logits = model(flat, d0.dense)
    return torch.sigmoid(logits), (d0.show > 0).float()


@dataclasses.dataclass
class MultiMfStepState:
    """What a multi-mf step updates, all in place: the class tables'
    device states, the dense model and its optimizer, and the AUC
    tables."""

    tables: List[TableState]
    model: nn.Module
    opt: torch.optim.Optimizer
    auc: AucState


class MultiMfTrainStep:
    """One multi-class CTR step over a ``MultiMfEmbeddingTable``."""

    def __init__(self, table: MultiMfEmbeddingTable, batch_size: int,
                 use_cvm: bool = True, cvm_offset: int = 2,
                 ops: KernelSet = KERNELS) -> None:
        """``ops`` selects the device functions: the kernels, unless a
        check on the card passes ``kernels.PLAIN``."""
        self.cfgs = [t.cfg for t in table.tables]
        self.batch_size = batch_size
        self.use_cvm = use_cvm
        self.cvm_offset = cvm_offset
        self.ops = ops
        self.dims = list(table.dims)
        self.class_slots = [len(s) for s in table.class_slots]
        # canonical reassembly order: (class, rank) per global slot
        self.route = table.slot_route()

    def __call__(self, state: MultiMfStepState, devs: Sequence[DeviceBatch],
                 generators: Sequence[torch.Generator],
                 draw_rows: Optional[Sequence[int]] = None
                 ) -> Dict[str, torch.Tensor]:
        """One step; ``generators`` (``class_generators``) draw each
        class's lazy-mf values, for its first ``draw_rows[c]`` unique rows
        (its real ones: on the card a draw's values depend on its size,
        and the streaming and resident batches pad U differently).
        Returns the loss and the predictions (device tensors)."""
        b = self.batch_size
        d0 = devs[0]
        ins_w = (d0.show > 0).float()
        label = d0.label
        # ONE gather a class serves both its pull and its push
        rows_fulls = [gather_full_rows(st, dev.unique_rows, self.ops)
                      for st, dev in zip(state.tables, devs)]
        vals = [pull_values(rf, st.mf_dim).requires_grad_(True)
                for rf, st in zip(rows_fulls, state.tables)]
        flat = multi_mf_pool(vals, devs, b, self.class_slots, self.route,
                             self.use_cvm, self.cvm_offset, self.ops)
        logits = state.model(flat, d0.dense)
        ls = F.binary_cross_entropy_with_logits(logits, label,
                                                reduction="none")
        loss = (ls * ins_w).sum() / ins_w.sum().clamp_min(1.0)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        for c, (st, dev, rf, v) in enumerate(
                zip(state.tables, devs, rows_fulls, vals)):
            g = v.grad if v.grad is not None else torch.zeros_like(v)
            # PushCopy's scale (box_wrapper.cu:368-372), per class
            g[:, 2:] *= -1.0 * b
            apply_push(st, dev.unique_rows, g, self.cfgs[c],
                       generator=generators[c], rows_full=rf, ops=self.ops,
                       draw_rows=None if draw_rows is None else draw_rows[c])
        state.opt.step()
        pred = torch.sigmoid(logits.detach())
        auc_add_batch(state.auc, pred, label, ins_w)
        return {"loss": loss.detach(), "pred": pred}

def class_device_batches(cbs, device: torch.device) -> List[DeviceBatch]:
    """The ``ClassBatch``es of one batch on ``device``: the float block
    copied once, with class 0, and shared by the others."""
    devs: List[DeviceBatch] = []
    for cb in cbs:
        devs.append(make_device_batch(
            cb.batch, cb.index, device,
            floats=devs[0].floats if devs else None))
    return devs


class MultiMfTrainer:
    """Streaming trainer over a ``MultiMfEmbeddingTable`` (the
    BoxPSTrainer role for mixed-dim tables); ``Trainer``'s pass
    contract."""

    def __init__(self, model: nn.Module, table: MultiMfEmbeddingTable,
                 desc, tx: Optional[OptimizerFactory] = None,
                 use_cvm: bool = True, seed: int = 0,
                 prefetch: int = PREFETCH_DEPTH,
                 check_nan_inf: bool = False,
                 ops: KernelSet = KERNELS) -> None:
        """``model`` (params set, input width ``table.pooled_width()`` +
        the dense dim) moves to the table's device. ``tx`` builds the
        dense optimizer (default: Adam, lr 1e-3)."""
        self.table = table
        self.desc = desc
        self.device = table.device
        self.model = model.to(self.device)
        self.step_fn = MultiMfTrainStep(table, desc.batch_size,
                                        use_cvm=use_cvm, ops=ops)
        self.state = MultiMfStepState(
            tables=[t.state for t in table.tables], model=self.model,
            opt=(tx or default_tx)(self.model.parameters()),
            auc=init_auc_state(device=self.device))
        self.seed = seed
        self.global_step = 0
        self.prefetch = prefetch
        self.check_nan_inf = check_nan_inf
        self.stage_timers = StageTimers()

    def generators(self, step: int) -> List[torch.Generator]:
        return class_generators(self.device, self.seed, step,
                                self.table.num_classes)

    def _prefetch_iter(self, batches):
        st = self.stage_timers

        def do_prep(b):
            with st.stage("prepare"):
                return b, self.table.prepare(b)

        def do_h2d(t):
            with st.stage("h2d"):
                return (t[0], class_device_batches(t[1], self.device),
                        [cb.index.num_unique for cb in t[1]])

        prepared = prefetch_iter(batches, do_prep, capacity=self.prefetch)
        return prefetch_iter(prepared, do_h2d, capacity=self.prefetch)

    def _check_loss(self, loss: torch.Tensor) -> None:
        if self.check_nan_inf:
            v = float(loss)
            if math.isnan(v) or math.isinf(v):
                raise NanInfError(f"nan/inf loss at step {self.global_step}")

    def _result(self, nb: int, n_ex: int, elapsed: float,
                last_loss: float) -> Dict[str, float]:
        out = auc_compute(self.state.auc).as_dict()
        out.update(batches=nb, examples=n_ex, elapsed_sec=elapsed,
                   examples_per_sec=n_ex / max(elapsed, 1e-9),
                   last_loss=last_loss)
        return out

    def train_pass(self, dataset, log_prefix: str = "") -> Dict[str, float]:
        """One pass (prepare and the host→device copies on two chained
        producer threads). Returns the accumulated AUC result, the pass's
        batches and examples, wall seconds, examples/s and last loss."""
        self.stage_timers.reset()
        t0 = time.perf_counter()
        nb = n_ex = 0
        stats = None
        for batch, devs, draws in self._prefetch_iter(dataset.batches()):
            n_ex += int((batch.show > 0).sum())
            self.global_step += 1
            with self.stage_timers.stage("step"):
                stats = self.step_fn(self.state, devs,
                                     self.generators(self.global_step),
                                     draws)
            nb += 1
            self._check_loss(stats["loss"])
        last = float(stats["loss"]) if stats is not None else float("nan")
        elapsed = time.perf_counter() - t0
        self.sync_table()
        out = self._result(nb, n_ex, elapsed, last)
        log.info("%smulti-mf pass done: %d batches, %.0f ex/s, auc=%.4f",
                 log_prefix, nb, out["examples_per_sec"], out["auc"])
        return out

    def reset_metrics(self) -> None:
        self.state.auc = init_auc_state(device=self.device)

    def sync_table(self) -> None:
        """Point the class tables at the trained states (the step writes
        them in place, so this matters only after one was replaced)."""
        for t, st in zip(self.table.tables, self.state.tables):
            t.state = st

    # ---- the device-resident pass ----
    def build_resident_pass(self, dataset) -> "MultiMfResidentPass":
        return MultiMfResidentPass.build(dataset, self.table)

    def train_pass_resident(self, pass_or_dataset,
                            log_prefix: str = "") -> Dict[str, float]:
        """The whole pass staged on the device first (built here when a
        dataset is given, timed as "build"), then one step per staged
        batch with no per-step host work; equal to ``train_pass`` over
        the same batches bit for bit."""
        self.stage_timers.reset()
        st = self.stage_timers
        t0 = time.perf_counter()
        if isinstance(pass_or_dataset, MultiMfResidentPass):
            rp = pass_or_dataset
        else:
            with st.stage("build"):
                rp = self.build_resident_pass(pass_or_dataset)
        with st.stage("step"):
            rp.upload(self.device)
            losses = []
            for i in range(rp.num_batches):
                stats = self.step_fn(
                    self.state, rp.views(i),
                    self.generators(self.global_step + i + 1),
                    rp.num_unique[i])
                losses.append(stats["loss"])
            last = float(losses[-1])
        if self.check_nan_inf and not bool(
                torch.isfinite(torch.stack(losses)).all()):
            raise NanInfError(f"nan/inf loss in the resident pass after "
                              f"step {self.global_step}")
        rp.mark_trained_rows(self.table)
        self.global_step += rp.num_batches
        elapsed = time.perf_counter() - t0
        self.sync_table()
        out = self._result(rp.num_batches, rp.num_records, elapsed, last)
        log.info("%smulti-mf resident pass: %d batches, %.0f ex/s, "
                 "auc=%.4f", log_prefix, rp.num_batches,
                 out["examples_per_sec"], out["auc"])
        return out


class MultiMfResidentPass:
    """One pass's per-class batch streams stacked on a leading step axis:
    per class ``ints_u [nb, U_c+2]`` (unique rows, then num_keys and the
    pad segment) and ``ints_k [nb, r, K_c]`` (gather_idx, and segments
    unless every batch is trivial), plus ONE shared float block
    ``[nb, B, Dd+3]`` (class sub-batches share their floats)."""

    def __init__(self, class_ints: List[Tuple[np.ndarray, np.ndarray]],
                 floats: np.ndarray, num_records: int,
                 num_unique: List[List[int]]) -> None:
        self.class_ints = class_ints      # [(iu, ik)] per class, host
        self.floats = floats
        self.num_records = num_records
        self.num_unique = num_unique      # [batch][class] real unique rows
        self.dev: Optional[Tuple[list, torch.Tensor]] = None

    @property
    def num_batches(self) -> int:
        return self.floats.shape[0]

    @classmethod
    def build(cls, dataset, table: MultiMfEmbeddingTable
              ) -> "MultiMfResidentPass":
        per_class: List[List] = [[] for _ in range(table.num_classes)]
        floats = []
        n_rec = 0
        for b in dataset.batches():
            n_rec += int((b.show > 0).sum())
            floats.append(pack_floats(b.dense, b.label, b.show, b.clk))
            for c, cb in enumerate(table.prepare(b)):
                per_class[c].append(cb)
        if not floats:
            raise ValueError("empty pass")
        nb = len(floats)
        class_ints = []
        for c, cbs in enumerate(per_class):
            cap = table.tables[c].capacity
            u_max = max(cb.index.unique_rows.shape[0] for cb in cbs)
            k_max = max(cb.index.gather_idx.shape[0] for cb in cbs)
            trivial = all(cb.batch.segments_trivial for cb in cbs)
            iu = np.empty((nb, u_max + 2), np.int32)
            ik = np.empty((nb, 1 if trivial else 2, k_max), np.int32)
            for i, cb in enumerate(cbs):
                idx, sb = cb.index, cb.batch
                u = idx.num_unique
                iu[i, :idx.unique_rows.shape[0]] = idx.unique_rows
                fill_oob_pads(iu[i, :u_max], u, cap)
                iu[i, u_max] = sb.num_keys
                iu[i, u_max + 1] = sb.pad_segment
                ik[i, 0, :idx.gather_idx.shape[0]] = idx.gather_idx
                ik[i, 0, idx.gather_idx.shape[0]:] = u
                if not trivial:
                    k = min(sb.segments.shape[0], k_max)
                    ik[i, 1, :k] = sb.segments[:k]
                    ik[i, 1, k:] = sb.pad_segment
            class_ints.append((iu, ik))
        num_unique = [[per_class[c][i].index.num_unique
                       for c in range(table.num_classes)]
                      for i in range(nb)]
        return cls(class_ints, np.stack(floats), n_rec, num_unique)

    def upload(self, device: Union[str, torch.device]) -> None:
        """Stage the pass on ``device`` (once)."""
        if self.dev is not None:
            return
        self.dev = ([(torch.from_numpy(iu).to(device),
                      torch.from_numpy(ik).to(device))
                     for iu, ik in self.class_ints],
                    torch.from_numpy(self.floats).to(device))

    def views(self, i: int) -> List[DeviceBatch]:
        """Batch ``i``'s per-class device batches: views of the staged
        tensors, the key counts read from the host copy."""
        wires, floats = self.dev
        return [DeviceBatch(ints_u=iu[i], ints_k=ik[i], floats=floats[i],
                            num_keys=int(hu[i, -2]))
                for (iu, ik), (hu, _) in zip(wires, self.class_ints)]

    def mark_trained_rows(self, table: MultiMfEmbeddingTable) -> None:
        """Re-mark this pass's rows touched AFTER training: a delta save
        landing between build (prepare marks at build time) and training
        clears the flags and would otherwise drop the pass's updates from
        the next delta."""
        for c, (iu, _ik) in enumerate(self.class_ints):
            t = table.tables[c]
            rows = np.unique(iu[:, :-2])  # the last 2 columns are meta
            rows = rows[(rows >= 0) & (rows < t.capacity)]
            with t.host_lock:
                t._touched[rows] = True
