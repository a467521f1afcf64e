"""Trainer: the per-pass training loop with host/device pipelining
(counterpart of ``paddlebox_tpu/train/trainer.py``, single device).

``train_pass``: two chained producer threads do the host side of every
batch, dedup and row assignment (``EmbeddingTable.prepare``) and the
host→device copy, so the main thread only runs the steps.
``train_pass_resident``: the whole pass is assigned rows in bulk, packed
and staged on the device first (``train/device_pass.py``), then the
steps run over the staged batches; ``train_passes_resident`` drives
several through the depth-N ``PassPreloader``, building pass k+1 while
pass k trains. ``run_pass`` wraps ``train_pass`` with the checkpoint
side (``train/checkpoint.py``): periodic and emergency cursor
checkpoints, resume from a cursor, bounded retry from the last
checkpoint, the NaN rollback to the last pass boundary and the graceful
stop (``resilience/preemption.py``). Streaming is not ported yet.
"""

from __future__ import annotations

import logging
import math
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    Mapping, Optional, Tuple, Union)

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.data.dataset import InMemoryDataset
from paddlebox_tpu_torch.data.schema import DataFeedDesc
from paddlebox_tpu_torch.device import resolve_device, seeded_generator
from paddlebox_tpu_torch.metrics import (AucState, MetricRegistry,
                                         auc_compute, init_auc_state)
from paddlebox_tpu_torch.ps.table import EmbeddingTable, PullIndex
from paddlebox_tpu_torch.resilience import faults, preemption
from paddlebox_tpu_torch.resilience.preemption import PreemptedError
from paddlebox_tpu_torch.resilience.retry import is_retryable
from paddlebox_tpu_torch.train.device_pass import (PassPreloader,
                                                   ResidentPass,
                                                   ResidentPassRunner)
from paddlebox_tpu_torch.train.step import (DeviceBatch, OptimizerFactory,
                                            StepState, TrainStep, default_tx,
                                            make_device_batch)
from paddlebox_tpu_torch.utils.dump import DumpConfig, DumpWriter, dump_param
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
        # resident pass runners by (key_capacity, trivial segments, wire,
        # arena chunk bits)
        self._resident_runners: Dict[Tuple[int, bool, str, Optional[int]],
                                     ResidentPassRunner] = {}
        # the metric variants fed every batch (AddAucMonitor)
        self.metrics = MetricRegistry()
        self._dump_cfg: Optional[DumpConfig] = None
        self._pass_seq = 0
        # the flag-selected fault plan (no-op without FLAGS.fault_plan)
        faults.install_from_flags()
        # SIGTERM/SIGINT become a stop flag the pass loop honours at
        # batch boundaries
        if FLAGS.graceful_shutdown:
            preemption.install_signal_handlers()

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

    def set_dump(self, cfg: Optional[DumpConfig]) -> None:
        """Per-sample prediction dump for later passes (dump_fields,
        boxps_worker.cc:1595); None turns it off."""
        self._dump_cfg = cfg

    def dump_param(self, path: str) -> int:
        """Named dense-parameter dump (DumpParam, boxps_worker.cc:1633)."""
        return dump_param(self.model, path)

    def train_pass(self, dataset: InMemoryDataset, log_prefix: str = "",
                   checkpoint=None, start_cursor: Optional[dict] = None
                   ) -> Dict[str, float]:
        """One pass over the dataset (train_from_dataset). Returns the
        AUC result of the accumulated tables (cumulative across passes
        until ``reset_metrics``), the pass's batches and examples, its
        wall seconds and examples/s, and the last loss.

        With a ``checkpoint`` (CheckpointManager) and a dataset whose
        batch order is fixed: a cursor checkpoint every
        ``FLAGS.ckpt_every_batches`` batches, and on a stop request
        (polled at every batch boundary) an emergency cursor checkpoint,
        the resume marker and ``PreemptedError``. ``start_cursor`` (from
        ``CheckpointManager.load_cursor``) skips the batches a preempted
        pass already trained."""
        self.stage_timers.reset()
        t0 = time.perf_counter()
        nb = n_ex = 0
        stats = None
        st = self.stage_timers
        dump_writer = (DumpWriter(self._dump_cfg)
                       if self._dump_cfg is not None else None)
        skip = 0
        if start_cursor is not None:
            skip = int(start_cursor.get("batch_index", 0))
            log.info("%sresuming pass from cursor: skipping %d "
                     "already-trained batches (step %d)", log_prefix,
                     skip, self.global_step)
        cursor_ok = (checkpoint is not None
                     and getattr(dataset, "supports_cursor_resume", False))
        every = FLAGS.ckpt_every_batches if cursor_ok else 0
        last_save = (-1, None)  # (batch_index, path) of the newest save
        for batch, dev in self._prefetch_iter(
                dataset.batches(start_batch=skip) if skip
                else dataset.batches()):
            n_ex += int((batch.show > 0).sum())
            self.global_step += 1
            gen = self.step_generator(self.global_step)
            with st.stage("step"):
                stats = self.step_fn(self.state, dev, gen)
            nb += 1
            if len(self.metrics):
                with st.stage("metrics"):
                    self.metrics.add_batch(
                        stats["pred"], batch.label,
                        (batch.show > 0).astype(np.float32),
                        uid=batch.uid, rank=batch.rank,
                        cmatch=batch.cmatch)
            if dump_writer is not None and nb % self._dump_cfg.interval == 0:
                dump_writer.add_batch(
                    batch.ins_ids,
                    {"pred": stats["pred"], "label": batch.label,
                     "show": batch.show, "clk": batch.clk},
                    int((batch.show > 0).sum()))
            self._check_loss(stats["loss"], nb)
            # ---- batch boundary: periodic cursor checkpoint, stop poll
            if every > 0 and nb % every == 0:
                last_save = (skip + nb,
                             self._save_inpass(checkpoint, dataset,
                                               skip + nb))
            if preemption.stop_requested():
                if dump_writer is not None:
                    dump_writer.close()
                self._preempt(checkpoint if cursor_ok else None, dataset,
                              skip + nb, last_save, log_prefix)
        last_loss = (float(stats["loss"]) if stats is not None
                     else float("nan"))
        if dump_writer is not None:
            dump_writer.close()
        elapsed = time.perf_counter() - t0
        self.sync_table()
        if cursor_ok and (last_save[0] >= 0 or skip > 0):
            # the pass finished after writing (or resuming from) a
            # mid-pass cursor checkpoint: publish a pass-boundary one, so
            # the newest restorable state does not resume into a pass
            # that already finished
            try:
                checkpoint.save(self, delta=checkpoint.has_base())
            except ValueError:
                # the cadence hit the pass length and the save at this
                # step is the first BASE: a delta re-save over it is
                # refused, so supersede it with a fresh base
                checkpoint.save(self, delta=False)
        self._pass_seq += 1
        out = auc_compute(self.state.auc).as_dict()
        out.update(batches=nb, examples=n_ex, elapsed_sec=elapsed,
                   examples_per_sec=n_ex / max(elapsed, 1e-9),
                   last_loss=last_loss)
        log.info("%spass done: %d batches, %.0f ex/s, auc=%.4f",
                 log_prefix, nb, out["examples_per_sec"], out["auc"])
        return out

    def _preempt(self, checkpoint, dataset, batch_index: int,
                 last_save: Tuple[int, Optional[str]],
                 log_prefix: str) -> None:
        """The stop poll fired after the step of ``batch_index``: write
        the emergency checkpoint (unless the periodic save just wrote
        this boundary) and the resume marker, then raise
        ``PreemptedError``."""
        path = None
        if checkpoint is not None:
            path = (last_save[1] if last_save[0] == batch_index
                    else self._save_inpass(checkpoint, dataset,
                                           batch_index))
            preemption.write_resume_marker(
                checkpoint.root, step=int(self.global_step),
                batch_index=batch_index, reason=preemption.stop_reason())
        else:
            log.warning("%sstop requested but no checkpoint manager / "
                        "fixed-order dataset — exiting WITHOUT an "
                        "emergency checkpoint (the pass will replay)",
                        log_prefix)
        raise PreemptedError(
            f"preempted ({preemption.stop_reason()}) at batch "
            f"{batch_index}, step {self.global_step}"
            + ("" if path is None else f"; emergency checkpoint {path}"),
            step=int(self.global_step), batch_index=batch_index,
            checkpoint_path=path)

    # ---- mid-pass resume cursor ----
    def _pass_cursor(self, dataset, batch_index: int) -> dict:
        """The resume cursor of an in-pass checkpoint (schema v2 without
        the stream block): the file-list identity and quarantine pin the
        data, ``global_step`` pins the trainer position and the per-step
        generator (``step_generator``); the AUC and metric accumulators
        ride the checkpoint itself."""
        return {
            "version": 2,
            "pass_seq": int(self._pass_seq) + 1,
            "fingerprint": dataset.filelist_fingerprint(),
            "files_consumed": len(getattr(dataset, "filelist", [])),
            "batch_index": int(batch_index),
            "global_step": int(self.global_step),
            "rng_fold": int(self.global_step),
            "quarantined_files": sorted(
                p for p, _ in getattr(dataset, "quarantined_files", [])),
        }

    def _save_inpass(self, checkpoint, dataset, batch_index: int) -> str:
        """A mid-pass checkpoint (a delta once a base exists) with the
        resume cursor and the metric snapshot."""
        return checkpoint.save(
            self, delta=checkpoint.has_base(),
            cursor=self._pass_cursor(dataset, batch_index),
            metrics=self.metrics if len(self.metrics) else None)

    def _boundary_save(self, checkpoint) -> str:
        """A pass-boundary checkpoint of the current state; a no-op when
        this step is already on disk (a re-save would refuse as a delta
        over a base)."""
        if checkpoint.latest_step() == int(self.global_step):
            return checkpoint._dir(int(self.global_step))
        return checkpoint.save(self, delta=checkpoint.has_base())

    def _adopt_cursor(self, checkpoint, dataset,
                      step: Optional[int] = None) -> Optional[dict]:
        """The cursor at the trainer's CURRENT position, validated
        against this dataset: the cursor to resume from, or None for a
        full pass. A cursor whose data identity does not match (another
        file list or quarantine, a dataset whose order is not fixed, or
        a windowed-stream cursor) would splice two batch streams, so the
        trainer rolls BACK to the latest pass-boundary checkpoint
        instead."""
        cur = checkpoint.load_cursor(step)
        if cur is None:
            return None
        if int(cur.get("global_step", -1)) != int(self.global_step):
            return None  # the cursor belongs to another position
        reason = None
        if isinstance(cur.get("stream"), dict):
            reason = ("cursor belongs to a windowed stream, which this "
                      "dataset is not")
        elif not getattr(dataset, "supports_cursor_resume", False):
            reason = ("dataset batch order is not deterministic "
                      "(supports_cursor_resume is False)")
        elif (cur.get("fingerprint") != dataset.filelist_fingerprint()
              or sorted(cur.get("quarantined_files", []))
              != sorted(p for p, _ in dataset.quarantined_files)):
            reason = "fingerprint/quarantine changed"
        if reason is not None:
            boundary = checkpoint.latest_boundary_step()
            if boundary is None:
                # replaying a "full" pass from mid-pass state would
                # train the consumed prefix twice
                raise RuntimeError(
                    f"mid-pass cursor cannot be resumed ({reason}) and "
                    "no pass-boundary checkpoint exists to roll back "
                    "to — restart from scratch or restore the original "
                    "file list / deterministic load settings")
            log.warning("mid-pass cursor at step %s cannot be resumed "
                        "(%s) — rolling back to pass-boundary step %s",
                        self.global_step, reason, boundary)
            checkpoint.restore(self, step=boundary)
            return None
        mr = checkpoint.load_metrics(step)
        if mr is not None:
            self.metrics = mr
        preemption.clear_resume_marker(checkpoint.root)
        return cur

    def _reject_cursor_state(self, checkpoint) -> None:
        """Resident-mode guard: a resident pass has no mid-pass entry,
        so a trainer sitting on a MID-PASS cursor checkpoint rolls back
        to the pass boundary, or refuses."""
        cur = checkpoint.load_cursor()
        if cur is None or int(cur.get("global_step", -1)) \
                != int(self.global_step):
            return
        boundary = checkpoint.latest_boundary_step()
        if boundary is None:
            raise RuntimeError(
                "trainer state is mid-pass (cursor checkpoint) but "
                "resident passes cannot resume mid-pass, and no "
                "pass-boundary checkpoint exists to roll back to — "
                "finish the pass with train_pass first")
        log.warning("mid-pass cursor at step %s cannot feed a resident "
                    "pass — rolling back to pass-boundary step %s",
                    self.global_step, boundary)
        checkpoint.restore(self, step=boundary)

    def run_pass(self, dataset: InMemoryDataset, checkpoint=None,
                 log_prefix: str = "", resident: bool = False,
                 max_retries: Optional[int] = None) -> Dict[str, float]:
        """``train_pass`` with bounded retry from the last checkpoint and
        cursor-aware recovery.

        A pass that dies on a recoverable error (transient IO, an
        injected fault) is retried up to ``FLAGS.pass_retry_limit``
        (``max_retries``) times; with a ``checkpoint`` each retry first
        rolls back to the last checkpoint and, when that one carries a
        cursor matching this dataset, replays only the batches after it.
        A freshly restored trainer sitting on a cursor checkpoint resumes
        the interrupted pass the same way. A ``NanInfError`` is
        recoverable only with a pass-boundary checkpoint to roll back to
        (mid-pass snapshots may hold the poison). ``PreemptedError`` is
        never retried. A resident pass has no batch boundary: the stop
        flag is honoured before every attempt."""
        limit = (FLAGS.pass_retry_limit if max_retries is None
                 else max_retries)
        attempt = 0
        start_cursor = None
        if checkpoint is not None:
            if resident:
                self._reject_cursor_state(checkpoint)
            else:
                start_cursor = self._adopt_cursor(checkpoint, dataset)
        while True:
            try:
                if preemption.stop_pending():
                    # graceful stop between passes: without an adopted
                    # cursor the state sits at a pass boundary, so
                    # snapshot it; with one, the mid-pass checkpoint on
                    # disk already covers it
                    path = None
                    if checkpoint is not None:
                        if start_cursor is None:
                            path = self._boundary_save(checkpoint)
                        preemption.write_resume_marker(
                            checkpoint.root, step=int(self.global_step),
                            reason=preemption.stop_reason())
                    raise PreemptedError(
                        f"preempted ({preemption.stop_reason()}) before "
                        f"pass dispatch at step {self.global_step}",
                        step=int(self.global_step), checkpoint_path=path)
                faults.inject("trainer.pass", attempt=attempt)
                if resident:
                    return self.train_pass_resident(dataset, log_prefix)
                return self.train_pass(dataset, log_prefix,
                                       checkpoint=checkpoint,
                                       start_cursor=start_cursor)
            except PreemptedError:
                raise
            except Exception as e:
                recoverable = (is_retryable(e)
                               or (isinstance(e, NanInfError)
                                   and checkpoint is not None
                                   and checkpoint.latest_boundary_step()
                                   is not None))
                if attempt >= limit or not recoverable:
                    raise
                attempt += 1
                if checkpoint is None:
                    log.warning("%spass failed (%r) — no checkpoint "
                                "manager, retrying from current state "
                                "(%d/%d)", log_prefix, e, attempt, limit)
                    continue
                if isinstance(e, NanInfError):
                    # mid-pass snapshots are suspect: roll all the way
                    # back to the clean boundary
                    restored = checkpoint.restore(
                        self, step=checkpoint.latest_boundary_step())
                    start_cursor = self._adopt_cursor(checkpoint, dataset,
                                                      restored)
                elif resident:
                    restored = checkpoint.restore(self)
                    self._reject_cursor_state(checkpoint)
                    start_cursor = None
                else:
                    restored = checkpoint.restore(self)
                    start_cursor = self._adopt_cursor(checkpoint, dataset,
                                                      restored)
                log.warning(
                    "%spass failed (%r) — rolled back to step %s%s, "
                    "retry %d/%d", log_prefix, e, restored,
                    ("" if start_cursor is None else
                     f" (cursor: batch {start_cursor.get('batch_index')})"),
                    attempt, limit)

    def _feed_registry_resident(self, rp: ResidentPass,
                                preds: torch.Tensor) -> None:
        """The post-pass metric registry feed: the per-batch
        AddAucMonitor calls of ``train_pass``, replayed from the pass's
        predictions (ONE device→host copy) and the columnar side
        channels."""
        sd = rp.side
        bs = sd["batch_size"]
        r = sd["num_records"]
        preds_h = preds.cpu().numpy()
        for i in range(rp.num_batches):
            a, b = i * bs, min((i + 1) * bs, r)
            m = b - a  # >= 1: nb is ceil(r / bs)
            ins_w = (sd["show"][a:b] > 0).astype(np.float32)
            self.metrics.add_batch(
                preds_h[i, :m], sd["label"][a:b], ins_w,
                uid=None if sd["uid"] is None else sd["uid"][a:b],
                rank=None if sd["rank"] is None else sd["rank"][a:b],
                cmatch=(None if sd["cmatch"] is None
                        else sd["cmatch"][a:b]))

    def train_pass_resident(self, pass_or_dataset: Union[InMemoryDataset,
                                                         ResidentPass],
                            log_prefix: str = "") -> Dict[str, float]:
        """One pass in device-resident mode (``train/device_pass.py``):
        the pass's rows are assigned in bulk and its batches staged on
        the device before the first step, so the steps take no per-batch
        host work. Takes a dataset (built and uploaded here, timed as
        the "build" stage) or a prebuilt ``ResidentPass`` (from
        ``ResidentPass.build_streamed`` or a ``PassPreloader``). Returns
        what ``train_pass`` returns.

        The metric registry is fed after the pass from the predictions
        and the dataset's columnar side channels (a pass from the record
        front has none: the registry is skipped, with a warning). A dump
        needs every batch on the host, which this mode gives up: with
        one configured, a dataset falls back to ``train_pass`` and a
        prebuilt pass raises ``ValueError``."""
        if self._dump_cfg is not None:
            if isinstance(pass_or_dataset, ResidentPass):
                raise ValueError(
                    "dump is configured (set_dump) but a prebuilt "
                    "ResidentPass has no host-side batches to dump — pass "
                    "the dataset, or set_dump(None)")
            log.warning("dump configured: falling back to train_pass for "
                        "this pass")
            return self.train_pass(pass_or_dataset, log_prefix)
        want_metrics = len(self.metrics) > 0
        self.stage_timers.reset()
        st = self.stage_timers
        t0 = time.perf_counter()
        if isinstance(pass_or_dataset, ResidentPass):
            rp = pass_or_dataset
        else:
            with st.stage("build"):
                rp = ResidentPass.build(pass_or_dataset, self.table)
        trivial = rp.segs is None
        key = (rp.key_capacity, trivial, rp.wire, rp.chunk_bits)
        runner = self._resident_runners.get(key)
        if runner is None:
            runner = ResidentPassRunner(self.step_fn, trivial, wire=rp.wire,
                                        chunk_bits=rp.chunk_bits)
            self._resident_runners[key] = runner
        collect = want_metrics and rp.side is not None
        with st.stage("step"):
            out = runner.run_pass(self.state, rp, self.seed,
                                  self.global_step, collect_preds=collect)
            losses, preds = out if collect else (out, None)
            last_loss = float(losses[-1])
        if self.check_nan_inf and not bool(
                torch.isfinite(torch.stack(losses)).all()):
            raise NanInfError(f"nan/inf loss in the resident pass after "
                              f"step {self.global_step}")
        rp.mark_trained_rows(self.table)
        if want_metrics:
            if rp.side is None:
                log.warning("registry metrics need columnar side channels; "
                            "this pass was built from a non-columnar "
                            "dataset: use train_pass for metric variants")
            else:
                with st.stage("metrics"):
                    self._feed_registry_resident(rp, preds)
        self.global_step += rp.num_batches
        elapsed = time.perf_counter() - t0
        self.sync_table()
        out = auc_compute(self.state.auc).as_dict()
        out.update(batches=rp.num_batches, examples=rp.num_records,
                   elapsed_sec=elapsed,
                   examples_per_sec=rp.num_records / max(elapsed, 1e-9),
                   last_loss=last_loss)
        if self.check_nan_inf and math.isnan(out.get("auc", 0.0)):
            raise NanInfError(f"nan metrics after the resident pass at "
                              f"step {self.global_step}")
        log.info("%sresident pass done: %d batches, %.0f ex/s, auc=%.4f",
                 log_prefix, rp.num_batches, out["examples_per_sec"],
                 out["auc"])
        return out

    def train_passes_resident(self, datasets: Iterable[InMemoryDataset],
                              depth: Optional[int] = None,
                              floats_dtype=np.float32, checkpoint=None,
                              log_prefix: str = "") -> List[Dict[str, float]]:
        """Train resident passes through the depth-N ``PassPreloader``
        (``FLAGS.preload_depth`` unless ``depth``): the builds of passes
        k+1..k+depth run on the pipeline's worker while pass k trains.
        ``floats_dtype``: ``np.float32``, ``torch.bfloat16`` or "q8".
        Returns the per-pass results, each with ``preload_wait_sec``: the
        seconds the trainer blocked waiting for that pass to be staged
        (the pipeline's prologue stall).

        Preemption-safe at PASS granularity: the stop flag is checked
        before every pass; on a stop the preloader drains first (no
        preload copy in flight during the checkpoint), the popped pass's
        copies are waited out, a boundary checkpoint and the resume
        marker are written when a ``checkpoint`` manager is given, and
        ``PreemptedError`` raises."""
        pre = PassPreloader(iter(datasets), self.table,
                            floats_dtype=floats_dtype, depth=depth)
        pre.start_next()
        results = []
        try:
            while True:
                t0 = time.perf_counter()
                rp = pre.wait()
                waited = time.perf_counter() - t0
                # a stop with an empty queue also lands here (the worker
                # aborts its build and wait() returns None): it must
                # still raise, not return as if complete
                if rp is None and not preemption.stop_pending():
                    break
                if preemption.stop_pending():
                    pre.drain()
                    if rp is not None:
                        rp.settle()  # popped before drain() could see it
                    path = None
                    if checkpoint is not None:
                        path = self._boundary_save(checkpoint)
                        preemption.write_resume_marker(
                            checkpoint.root, step=int(self.global_step),
                            reason=preemption.stop_reason())
                    raise PreemptedError(
                        f"preempted ({preemption.stop_reason()}) before "
                        f"resident pass dispatch at step "
                        f"{self.global_step}",
                        step=int(self.global_step), checkpoint_path=path)
                pre.start_next()
                out = self.train_pass_resident(rp, log_prefix=log_prefix)
                out["preload_wait_sec"] = waited
                results.append(out)
        finally:
            pre.drain()
        return results

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

    # ---- checkpoint glue (dense + sparse) ----
    def dense_snapshot(self) -> Dict[str, Any]:
        """The dense state a checkpoint stores (``dense.pt``): the model
        and optimizer ``state_dict``s and the AUC tables, as CPU copies
        of plain tensors and numbers."""
        auc = self.state.auc
        return {"model": _to_cpu(self.model.state_dict()),
                "opt": _to_cpu(self.state.opt.state_dict()),
                "auc": {"buckets": auc.buckets.detach().cpu().clone(),
                        "sums": auc.sums.detach().cpu().clone()}}

    def restore_state(self, model_sd: Mapping[str, torch.Tensor],
                      opt_sd: Mapping[str, Any],
                      auc: Optional[Mapping[str, torch.Tensor]],
                      step: int) -> None:
        """Rebind the dense and metric state after a checkpoint restore
        (the table was already loaded); CheckpointManager's hook.
        ``auc`` None keeps the current tables."""
        self.model.load_state_dict(model_sd)
        self.state.opt.load_state_dict(opt_sd)
        if auc is not None:
            self.state.auc = AucState(auc["buckets"].to(self.device),
                                      auc["sums"].to(self.device))
        self.state.table = self.table.state
        self.global_step = int(step)

    def save(self, prefix: str) -> None:
        """``prefix.sparse.npz`` (save_base) and ``prefix.dense.pt`` (the
        model and optimizer state)."""
        self.sync_table()
        self.table.save_base(prefix + ".sparse.npz")
        snap = self.dense_snapshot()
        torch.save({"model": snap["model"], "opt": snap["opt"]},
                   prefix + ".dense.pt")

    def load(self, prefix: str) -> None:
        """The inverse of ``save``; the AUC tables are kept."""
        from paddlebox_tpu_torch.train.checkpoint import read_dense_file
        self.table.load(prefix + ".sparse.npz")
        dense = read_dense_file(prefix + ".dense.pt")
        self.restore_state(dense["model"], dense["opt"], None,
                           self.global_step)


def _to_cpu(obj):
    """A copy of a nest of dicts/lists/tuples with every tensor cloned to
    the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj
