"""Trainer: the per-pass training loop with host/device pipelining
(counterpart of ``paddlebox_tpu/train/trainer.py``, single device).

``train_pass``: two chained producer threads do the host side of every
batch, dedup and row assignment (``EmbeddingTable.prepare``) and the
host→device copy, so the main thread only runs the steps.
``train_pass_resident``: the whole pass is assigned rows in bulk, packed
and staged on the device first (``train/device_pass.py``), then the
steps run over the staged batches. Checkpointing, dumps, preemption,
streaming, the preloaded multi-pass driver and the metric registry are
not ported yet.
"""

from __future__ import annotations

import logging
import math
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple, Union)

import torch
from torch import nn

from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.data.dataset import InMemoryDataset
from paddlebox_tpu_torch.data.schema import DataFeedDesc
from paddlebox_tpu_torch.device import resolve_device, seeded_generator
from paddlebox_tpu_torch.metrics import auc_compute, init_auc_state
from paddlebox_tpu_torch.ps.table import EmbeddingTable, PullIndex
from paddlebox_tpu_torch.train.device_pass import (ResidentPass,
                                                   ResidentPassRunner)
from paddlebox_tpu_torch.train.step import (DeviceBatch, OptimizerFactory,
                                            StepState, TrainStep, default_tx,
                                            make_device_batch)
from paddlebox_tpu_torch.utils.prefetch import prefetch_iter

log = logging.getLogger(__name__)

PREFETCH_DEPTH = 4       # batches each prefetch stage runs ahead
LOG_PERIOD_STEPS = 100   # the loss is read (a sync) and logged this often


class NanInfError(RuntimeError):
    pass


class StageTimers:
    """Host seconds per pipeline stage for one pass: prepare, h2d and
    step for ``train_pass`` (prepare and h2d run on the prefetch
    threads), build and step for ``train_pass_resident``."""

    def __init__(self) -> None:
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    def reset(self) -> None:
        self.seconds.clear()

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name].append(time.perf_counter() - t0)


class Trainer:
    """Single-device trainer."""

    def __init__(self, model: nn.Module, table: EmbeddingTable,
                 desc: DataFeedDesc, tx: Optional[OptimizerFactory] = None,
                 seed: int = 0, check_nan_inf: bool = False,
                 device: Union[str, torch.device] = "cuda") -> None:
        """``model`` (the port's DeepFM, params already set — e.g. from
        ``convert.deepfm_state_dict_from_flax``) moves to ``device``,
        which must be the table's. ``tx`` builds the dense optimizer from
        the params (default: Adam, lr 1e-3). ``check_nan_inf`` reads the
        loss after every step (a sync) and raises on NaN/inf; otherwise
        it is read every ``LOG_PERIOD_STEPS`` steps."""
        self.device = resolve_device(device)
        if table.device != self.device:
            raise ValueError(f"table on {table.device}, trainer on "
                             f"{self.device}")
        self.table = table
        self.desc = desc
        self.model = model.to(self.device)
        self.step_fn = TrainStep(table.cfg, desc.batch_size,
                                 len(desc.sparse_slots))
        self.state = StepState(
            table=table.state, model=self.model,
            opt=(tx or default_tx)(self.model.parameters()),
            auc=init_auc_state(device=self.device))
        self.seed = seed
        self.check_nan_inf = check_nan_inf
        self.global_step = 0
        self.stage_timers = StageTimers()
        # resident pass runners by (key_capacity, trivial segments)
        self._resident_runners: Dict[Tuple[int, bool],
                                     ResidentPassRunner] = {}

    def step_generator(self, step: int) -> torch.Generator:
        """The generator of global step ``step``, seeded from
        (seed + 1, step) so that a run can be repeated."""
        return seeded_generator(self.device, self.seed + 1, step)

    # ---- host-side prefetch: dedup + row assign, then H2D ----
    def _prefetch_iter(self, batches: Iterable[SlotBatch],
                       prepare: Optional[Callable[[SlotBatch], PullIndex]]
                       = None) -> Iterator[Tuple[SlotBatch, DeviceBatch]]:
        prep = prepare or self.table.prepare
        st = self.stage_timers

        def do_prep(b):
            with st.stage("prepare"):
                return b, prep(b)

        def do_h2d(t):
            with st.stage("h2d"):
                return t[0], make_device_batch(t[0], t[1], self.device)

        prepared = prefetch_iter(batches, do_prep, capacity=PREFETCH_DEPTH)
        return prefetch_iter(prepared, do_h2d, capacity=PREFETCH_DEPTH)

    def _check_loss(self, loss: torch.Tensor, nb: int) -> None:
        if not (self.check_nan_inf or nb % LOG_PERIOD_STEPS == 0):
            return
        value = float(loss)
        if math.isnan(value) or math.isinf(value):
            raise NanInfError(f"nan/inf loss at step {self.global_step}")
        if nb % LOG_PERIOD_STEPS == 0:
            log.info("pass step %d loss=%.5f", self.global_step, value)

    def train_pass(self, dataset: InMemoryDataset,
                   log_prefix: str = "") -> Dict[str, float]:
        """One pass over the dataset (train_from_dataset). Returns the
        AUC result of the accumulated tables (cumulative across passes
        until ``reset_metrics``), the pass's batches and examples, its
        wall seconds and examples/s, and the last loss."""
        self.stage_timers.reset()
        t0 = time.perf_counter()
        nb = n_ex = 0
        stats = None
        st = self.stage_timers
        for batch, dev in self._prefetch_iter(dataset.batches()):
            n_ex += int((batch.show > 0).sum())
            self.global_step += 1
            gen = self.step_generator(self.global_step)
            with st.stage("step"):
                stats = self.step_fn(self.state, dev, gen)
            nb += 1
            self._check_loss(stats["loss"], nb)
        last_loss = (float(stats["loss"]) if stats is not None
                     else float("nan"))
        elapsed = time.perf_counter() - t0
        self.sync_table()
        out = auc_compute(self.state.auc).as_dict()
        out.update(batches=nb, examples=n_ex, elapsed_sec=elapsed,
                   examples_per_sec=n_ex / max(elapsed, 1e-9),
                   last_loss=last_loss)
        log.info("%spass done: %d batches, %.0f ex/s, auc=%.4f",
                 log_prefix, nb, out["examples_per_sec"], out["auc"])
        return out

    def train_pass_resident(self, pass_or_dataset: Union[InMemoryDataset,
                                                         ResidentPass],
                            log_prefix: str = "") -> Dict[str, float]:
        """One pass in device-resident mode (``train/device_pass.py``):
        the pass's rows are assigned in bulk and its batches staged on
        the device before the first step, so the steps take no per-batch
        host work. Takes a dataset (built and uploaded here, timed as
        the "build" stage) or a prebuilt ``ResidentPass``. Returns what
        ``train_pass`` returns."""
        self.stage_timers.reset()
        st = self.stage_timers
        t0 = time.perf_counter()
        if isinstance(pass_or_dataset, ResidentPass):
            rp = pass_or_dataset
        else:
            with st.stage("build"):
                rp = ResidentPass.build(pass_or_dataset, self.table)
        trivial = rp.segs is None
        key = (rp.key_capacity, trivial)
        runner = self._resident_runners.get(key)
        if runner is None:
            runner = ResidentPassRunner(self.step_fn, trivial)
            self._resident_runners[key] = runner
        with st.stage("step"):
            losses = runner.run_pass(self.state, rp, self.seed,
                                     self.global_step)
            last_loss = float(losses[-1])
        if self.check_nan_inf and not bool(
                torch.isfinite(torch.stack(losses)).all()):
            raise NanInfError(f"nan/inf loss in the resident pass after "
                              f"step {self.global_step}")
        rp.mark_trained_rows(self.table)
        self.global_step += rp.num_batches
        elapsed = time.perf_counter() - t0
        self.sync_table()
        out = auc_compute(self.state.auc).as_dict()
        out.update(batches=rp.num_batches, examples=rp.num_records,
                   elapsed_sec=elapsed,
                   examples_per_sec=rp.num_records / max(elapsed, 1e-9),
                   last_loss=last_loss)
        log.info("%sresident pass done: %d batches, %.0f ex/s, auc=%.4f",
                 log_prefix, rp.num_batches, out["examples_per_sec"],
                 out["auc"])
        return out

    def eval_pass(self, dataset: InMemoryDataset,
                  log_prefix: str = "") -> Dict[str, float]:
        """Forward-only pass: AUC on the current params and table, no
        updates, no index growth."""
        auc = init_auc_state(device=self.device)
        self.stage_timers.reset()
        t0 = time.perf_counter()
        nb = 0
        self.model.eval()
        try:
            for _, dev in self._prefetch_iter(
                    dataset.batches(), prepare=self.table.prepare_eval):
                with self.stage_timers.stage("step"):
                    self.step_fn.eval(self.state.table, self.model, auc,
                                      dev)
                nb += 1
        finally:
            self.model.train()
        res = auc_compute(auc)
        elapsed = time.perf_counter() - t0
        out = res.as_dict()
        out.update(batches=nb, elapsed_sec=elapsed,
                   examples_per_sec=res.ins_num / max(elapsed, 1e-9))
        log.info("%seval pass: %d batches, auc=%.4f", log_prefix, nb,
                 res.auc)
        return out

    def sync_table(self) -> None:
        """Point the table facade at the trained state (for save and
        load). The step writes the state in place, so this only matters
        after something replaced one of the two."""
        self.table.state = self.state.table

    def reset_metrics(self) -> None:
        self.state.auc = init_auc_state(device=self.device)
