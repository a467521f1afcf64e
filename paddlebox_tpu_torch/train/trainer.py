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
stop (``resilience/preemption.py``). ``train_stream`` is the always-on
mode: a windowed ``QueueDataset`` (``FLAGS.stream_window_files``) trained
one window per ``run_pass``, with stream-boundary checkpoints whose v2
cursor (completed files, open window) lets a restarted process skip the
completed files and replay the open window.

The reference's hub counters and events of the stream loop
(``pbox_stream_*``, ``stream_window``, ``stream_idle``,
``cursor_resume``) are not ported yet (ROADMAP queue 1 item 13); their
call sites say so.
"""

from __future__ import annotations

import logging
import math
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    Mapping, Optional, Sequence, Tuple, Union)

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.data.dataset import (Dataset, InMemoryDataset,
                                              chain_digest)
from paddlebox_tpu_torch.data.schema import DataFeedDesc
from paddlebox_tpu_torch.device import resolve_device, seeded_generator
from paddlebox_tpu_torch.metrics import (AucState, MetricRegistry,
                                         auc_compute, init_auc_state)
from paddlebox_tpu_torch.ps.table import EmbeddingTable, PullIndex
from paddlebox_tpu_torch.resilience import faults, preemption
from paddlebox_tpu_torch.resilience.preemption import PreemptedError
from paddlebox_tpu_torch.resilience.retry import RetryPolicy, is_retryable
from paddlebox_tpu_torch.train.device_pass import (PassPreloader,
                                                   ResidentPass,
                                                   ResidentPassRunner)
from paddlebox_tpu_torch.train.dense_modes import (build_lr_scales,
                                                   lr_map_transform)
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
                 device: Union[str, torch.device] = "cuda",
                 lr_map: Optional[dict] = None,
                 lr_map_base: float = 1.0) -> None:
        """``model`` (a ``models.MODEL_REGISTRY`` model taking (pooled,
        dense), params already set — e.g. from ``convert.
        deepfm_state_dict_from_flax``) moves to ``device``, which must be
        the table's. ``tx`` builds the dense optimizer from the params
        (default: Adam, lr 1e-3). ``check_nan_inf`` reads the loss after
        every step (a sync) and raises on NaN/inf; otherwise it is read
        every ``LOG_PERIOD_STEPS`` steps. ``lr_map``: per-param dense lr
        overrides, name (``dense_modes.lr_pattern_matches``) → lr
        against ``lr_map_base`` (the optimizer's lr); each matched
        param's update scales by lr / lr_map_base after the optimizer's
        step, so 0.0 freezes it (box_wrapper.cc:1303-1335)."""
        self.device = resolve_device(device)
        if table.device != self.device:
            raise ValueError(f"table on {table.device}, trainer on "
                             f"{self.device}")
        self.table = table
        self.desc = desc
        self.model = model.to(self.device)
        self.step_fn = TrainStep(table.cfg, desc.batch_size,
                                 len(desc.sparse_slots))
        tx = tx or default_tx
        if lr_map:
            scales = build_lr_scales(self.model, lr_map, lr_map_base)
            tx = lr_map_transform(
                tx, [scales[k] for k, _ in self.model.named_parameters()])
        self.state = StepState(
            table=table.state, model=self.model,
            opt=tx(self.model.parameters()),
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
        # optional per-batch hook, called AFTER the step's state update
        # with the host SlotBatch — streaming record accounting and the
        # at-least-once checks key off it
        self.on_batch_trained: Optional[Callable[[SlotBatch], None]] = None
        # per-window hook of train_stream: called AFTER a window's
        # accounting and BEFORE the boundary-save decision, with the
        # completed window index and the dataset — never mid-pass
        self.on_window_complete: Optional[Callable[[int, object],
                                                   None]] = None
        # set (by the hook) to publish a boundary checkpoint at THIS
        # window boundary regardless of the stream_ckpt_every_windows
        # cadence
        self.stream_save_now = False
        # set to force the next stream-boundary save to a BASE (a shrink
        # decays EVERY row without marking it touched, so a delta would
        # miss it). Cleared only after a save actually lands.
        self.stream_force_base = False
        # elastic membership poll: called at every completed window
        # boundary, AFTER on_window_complete and BEFORE the save
        # decision. A truthy decision publishes a boundary checkpoint and
        # returns from train_stream (a coordinated stop at a completed
        # boundary, never mid-pass)
        self.stream_membership: Optional[Callable[[], object]] = None

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

    def train_pass(self, dataset: Dataset, log_prefix: str = "",
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
        pass already trained. A windowed stream's dataset is told after
        every trained batch (``note_batches_consumed``), so a window only
        completes once its last batch trained."""
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
        # consumption feedback for windowed streams: fold a window into
        # the completed set only once its last batch has TRAINED (the
        # reader group runs ahead of training)
        note_consumed = getattr(dataset, "note_batches_consumed", None)
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
            if note_consumed is not None:
                note_consumed(nb)
            if self.on_batch_trained is not None:
                self.on_batch_trained(batch)
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
        if note_consumed is not None:
            # the loop has fully drained the generator, so every window
            # mark is set by now — fold the tail window the in-loop note
            # may have raced (its mark lands when the producer thread
            # resumes past the final yield)
            note_consumed(nb)
        streaming = (getattr(dataset, "stream_cursor_state", None)
                     is not None and getattr(dataset, "windowed", False))
        if cursor_ok and (last_save[0] >= 0 or skip > 0
                          or (streaming and start_cursor is not None)):
            # the pass finished after writing (or resuming from) a
            # mid-pass cursor checkpoint: publish a pass-boundary one, so
            # the newest restorable state does not resume into a pass
            # that already finished. For a windowed stream the boundary
            # checkpoint still carries the STREAM cursor (completed
            # files, empty open window) — losing the completed-file set
            # here would retrain the whole stream on the next restart.
            kw = {}
            if streaming:
                kw = dict(cursor=self._boundary_cursor(dataset),
                          clear_touched=True,
                          metrics=(self.metrics if len(self.metrics)
                                   else None))
            try:
                checkpoint.save(self, delta=checkpoint.has_base(), **kw)
            except ValueError:
                # the cadence hit the pass length and the save at this
                # step is the first BASE: a delta re-save over it is
                # refused, so supersede it with a fresh base
                checkpoint.save(self, delta=False, **kw)
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
        """The resume cursor of an in-pass checkpoint (schema v2): the
        file-list identity and quarantine pin the data, ``global_step``
        pins the trainer position and the per-step generator
        (``step_generator``); the AUC and metric accumulators ride the
        checkpoint itself. A windowed streaming dataset adds a ``stream``
        block (completed files + open window,
        ``QueueDataset.stream_cursor_state``): resume then skips
        completed files and replays the open window at-least-once
        instead of splicing by batch index. The keys are the
        reference's, so either package resumes the other's cursor."""
        cur = {
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
        state_fn = getattr(dataset, "stream_cursor_state", None)
        if state_fn is not None:
            st = state_fn(int(batch_index))
            if st is not None:
                cur["stream"] = st
        return cur

    def _boundary_cursor(self, dataset) -> Optional[dict]:
        """The cursor a BETWEEN-PASS checkpoint of a windowed streaming
        dataset must carry (completed files, empty open window) so a
        restart skips every consumed file; None for other datasets
        (their boundary checkpoints stay cursor-free)."""
        state_fn = getattr(dataset, "stream_cursor_state", None)
        if state_fn is None or not getattr(dataset, "windowed", False):
            return None
        return self._pass_cursor(dataset, 0)

    def _save_inpass(self, checkpoint, dataset, batch_index: int) -> str:
        """A mid-pass checkpoint (a delta once a base exists) with the
        resume cursor and the metric snapshot."""
        return checkpoint.save(
            self, delta=checkpoint.has_base(),
            cursor=self._pass_cursor(dataset, batch_index),
            metrics=self.metrics if len(self.metrics) else None)

    def _adopt_cursor(self, checkpoint, dataset,
                      step: Optional[int] = None) -> Optional[dict]:
        """The cursor at the trainer's CURRENT position, validated
        against this dataset: the cursor to resume from, or None for a
        full pass. A cursor whose data identity does not match (another
        file list or quarantine, a dataset whose order is not fixed, a
        stream cursor on a dataset that is not a windowed stream or whose
        filelist no longer extends the cursor's consumption order) would
        splice two batch streams, so the trainer rolls BACK to the latest
        pass-boundary checkpoint instead."""
        cur = checkpoint.load_cursor(step)
        if cur is None:
            return None
        if int(cur.get("global_step", -1)) != int(self.global_step):
            return None  # the cursor belongs to another position
        reason = None
        stream = cur.get("stream")
        stream = stream if isinstance(stream, dict) else None
        if stream is not None:
            # v2 STREAM cursor: resume is by file window, not batch
            # index — validate that the current filelist still extends
            # the cursor's consumption order (completed files then the
            # open window, quarantined files excluded on both sides)
            if (getattr(dataset, "adopt_stream_cursor", None) is None
                    or not getattr(dataset, "windowed", False)):
                reason = ("cursor belongs to a windowed stream but this "
                          "dataset is not a windowed QueueDataset "
                          "(FLAGS.stream_window_files)")
            else:
                quar = set(cur.get("quarantined_files", []))
                fold = stream.get("files_folded") or {}
                nfold = int(fold.get("count", 0) or 0)
                expect = [str(f) for f in
                          list(stream.get("files_completed", []))
                          + list(stream.get("window_files", []))
                          if str(f) not in quar]
                avail = [f for f in dataset.filelist if f not in quar]
                if nfold and (len(avail) < nfold or chain_digest(
                        "", avail[:nfold]) != fold.get("sha256")):
                    reason = ("stream folded-history fingerprint "
                              "mismatch — the filelist's leading files "
                              "no longer reproduce the cursor's "
                              "compacted consumption prefix")
                elif avail[nfold:nfold + len(expect)] != expect:
                    reason = ("stream file prefix changed — the "
                              "filelist no longer extends the cursor's "
                              "consumption order")
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
        if stream is not None:
            fold = stream.get("files_folded") or {}
            nfold = int(fold.get("count", 0) or 0)
            completed = [str(f) for f in stream.get("files_completed", [])]
            dsc = getattr(dataset, "files_completed", None)
            # with a folded history the cursor names only the tail — the
            # folded prefix was fingerprint-checked above, so the dataset
            # sits at the cursor iff lengths line up and the named tail
            # matches
            if (not stream.get("window_files") and dsc is not None
                    and len(dsc) == nfold + len(completed)
                    and dsc[nfold:] == completed):
                # in-process continuation at a stream BOUNDARY: the
                # dataset already sits exactly where the cursor points
                # (the previous window's boundary save) — nothing to
                # adopt. Still consume a leftover resume marker (a
                # restart whose kill landed before anything trained
                # matches this branch too).
                preemption.clear_resume_marker(checkpoint.root)
                return None
            # skip completed files, replay the open window from its
            # start (at-least-once), and carry the quarantine decisions
            # forward; batch_index is forced to 0 — there is no batch
            # splice in a thread-interleaved stream
            dataset.adopt_stream_cursor(
                stream, quarantined=cur.get("quarantined_files", []))
            cur = dict(cur, batch_index=0)
        mr = checkpoint.load_metrics(step)
        if mr is not None:
            self.metrics = mr
        preemption.clear_resume_marker(checkpoint.root)
        # telemetry (ROADMAP queue 1 item 13): pbox_cursor_resumes_total
        # and the cursor_resume event
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

    def run_pass(self, dataset: Dataset, checkpoint=None,
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
                    # snapshot it (a windowed stream's carries its
                    # boundary cursor, so the restart skips every
                    # consumed file); with one, the mid-pass checkpoint
                    # on disk already covers it
                    path = None
                    if checkpoint is not None:
                        if start_cursor is None:
                            path = self._stream_boundary_save(dataset,
                                                              checkpoint)
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
                    # back to the clean boundary. A STREAM boundary still
                    # carries its stream cursor — adopt it so the
                    # dataset's completed-file view matches the restored
                    # state (a no-op for batch cursors: boundary
                    # checkpoints have none)
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

    # ---- continuous streaming ingest ----
    def train_stream(self, dataset, checkpoint=None, *,
                     filelist_fn: Optional[Callable[[], Sequence]] = None,
                     max_windows: Optional[int] = None,
                     max_idle_polls: Optional[int] = None,
                     log_prefix: str = "") -> Dict[str, float]:
        """Always-on streaming loop: train arriving files through a
        windowed ``QueueDataset`` (``FLAGS.stream_window_files``), one
        window per pass, until the source dries up or a bound is hit.

        - **Arrivals**: ``filelist_fn()`` is polled for the current file
          list each iteration (new files append in poll order); with no
          ``filelist_fn`` the dataset's static filelist is drained and
          the loop ends. Empty polls back off on the seeded
          ``RetryPolicy`` schedule (site ``stream.poll`` — deterministic
          per ``FLAGS.seed``); arrivals reset the backoff.
          ``max_idle_polls`` bounds consecutive empty polls (None = poll
          forever).
        - **Checkpoints**: a stream-boundary checkpoint (v2 cursor:
          completed files, empty open window) publishes every
          ``FLAGS.stream_ckpt_every_windows`` completed windows, so a
          hard kill replays at most that many windows.
        - **Preemption** honours the full ``run_pass`` contract: a stop
          mid-window raises ``PreemptedError`` after an emergency
          checkpoint whose stream cursor marks the open window; a
          restarted process (``CheckpointManager.restore`` then
          ``train_stream`` again) skips completed files and replays the
          open window AT-LEAST-ONCE — identical to the uninterrupted run
          at the last common window boundary. Stops during the idle
          loop snapshot a boundary cursor the same way.

        Returns the totals: windows, files, batches, examples,
        replayed_files, idle_polls (and the last window's auc and
        last_loss)."""
        if not getattr(dataset, "windowed", False):
            raise ValueError(
                "train_stream needs a windowed QueueDataset — set "
                "FLAGS.stream_window_files > 0 (the unbounded "
                "unwindowed stream cannot checkpoint/resume)")
        known: List[str] = [str(f) for f in dataset.filelist]
        # resume: seed the dataset's stream position and the known-file
        # order from the newest stream cursor, so the first window pass
        # reconstructs the cursor's consumption order exactly
        if checkpoint is not None and not dataset.files_completed:
            cur = checkpoint.load_cursor()
            stream = (cur or {}).get("stream")
            if isinstance(stream, dict):
                if int(cur.get("global_step", -1)) != int(self.global_step):
                    raise RuntimeError(
                        f"stream cursor at step {cur.get('global_step')} "
                        f"does not match trainer step {self.global_step}"
                        " — restore the checkpoint first "
                        "(CheckpointManager.restore) or point at a fresh "
                        "checkpoint root")
                dataset.adopt_stream_cursor(
                    stream, quarantined=cur.get("quarantined_files", []))
                # the dataset expanded any folded (compacted) history
                # back to names from its filelist — read the prefix from
                # it, not from the cursor's (tail-only) block
                prefix = (list(dataset.files_completed)
                          + [str(f) for f in stream.get("window_files",
                                                        [])])
                seen = set(prefix)
                known = prefix + [f for f in known if f not in seen]
                # telemetry (ROADMAP queue 1 item 13): a boundary resume
                # counts in pbox_cursor_resumes_total here
        totals: Dict[str, float] = {"windows": 0, "files": 0, "batches": 0,
                                    "examples": 0, "replayed_files": 0,
                                    "idle_polls": 0}
        try:
            self._stream_loop(dataset, checkpoint, filelist_fn,
                              max_windows, max_idle_polls, log_prefix,
                              known, totals)
        finally:
            # each window pass narrowed the filelist to its consumption
            # order — restore the full known list on EVERY exit
            # (preemption included) so a later train_stream call or
            # pending_files() probe still sees the whole stream
            dataset.set_filelist(known)
        log.info("%sstream done: %d windows, %d files (%d replayed), "
                 "%d batches", log_prefix, totals["windows"],
                 totals["files"], totals["replayed_files"],
                 totals["batches"])
        return totals

    def _stream_loop(self, dataset, checkpoint, filelist_fn,
                     max_windows: Optional[int],
                     max_idle_polls: Optional[int], log_prefix: str,
                     known: List[str], totals: Dict[str, float]) -> None:
        wsize = FLAGS.stream_window_files
        since_ckpt = 0
        idle_run = 0
        backoff: Iterator[float] = iter(())  # armed lazily
        while True:
            if max_windows is not None and totals["windows"] >= max_windows:
                break
            if preemption.stop_pending():
                # idle/between-window stop: the poll loop must honour it
                # without pending work, and the snapshot must carry the
                # stream boundary cursor
                self._stream_stop(dataset, checkpoint)
            if filelist_fn is not None:
                have = set(known)
                known.extend(str(f) for f in filelist_fn()
                             if str(f) not in have)
            dataset.set_filelist(known)
            pending = dataset.pending_files()
            # telemetry (ROADMAP queue 1 item 13): the
            # pbox_stream_lag_files gauge, max(0, len(pending) - wsize)
            if not pending:
                if filelist_fn is None:
                    break
                idle_run += 1
                totals["idle_polls"] += 1
                if max_idle_polls is not None and idle_run > max_idle_polls:
                    break
                delay = next(backoff, None)
                if delay is None:
                    # (re)arm the seeded schedule; cap attempts high —
                    # the schedule plateaus at retry_max_delay_sec
                    backoff = RetryPolicy.from_flags(
                        site="stream.poll", max_attempts=1 << 20).delays()
                    delay = next(backoff)
                # telemetry (ROADMAP queue 1 item 13):
                # pbox_stream_idle_polls_total and the stream_idle event
                self._stream_sleep(delay)
                continue
            idle_run = 0
            backoff = iter(())
            window = pending[:wsize]
            # the pass's filelist is exactly the consumption order the
            # cursor records: completed files then this window (files
            # quarantined earlier are excluded from both)
            dataset.set_filelist(dataset.files_completed + window)
            widx = totals["windows"]
            rep0 = int(getattr(dataset, "files_replayed", 0))
            out = self.run_pass(dataset, checkpoint=checkpoint,
                                log_prefix=f"{log_prefix}stream w{widx}: ")
            # files_replayed is cumulative on the dataset — book the
            # per-window delta
            replayed = int(getattr(dataset, "files_replayed", 0)) - rep0
            # files CONSUMED, not dispatched: a window file quarantined
            # during this pass never trained
            quarantined = {p for p, _ in
                           getattr(dataset, "quarantined_files", [])}
            consumed = [f for f in window if f not in quarantined]
            totals["windows"] += 1
            totals["files"] += len(consumed)
            totals["batches"] += int(out.get("batches", 0))
            totals["examples"] += int(out.get("examples", 0))
            totals["replayed_files"] += replayed
            totals.update({k: out[k] for k in ("auc", "last_loss")
                           if k in out})
            since_ckpt += 1
            # telemetry (ROADMAP queue 1 item 13):
            # pbox_stream_windows_total, pbox_stream_files_total and the
            # stream_window event
            if self.on_window_complete is not None:
                # boundary work (shrink scheduling, health bookkeeping) —
                # between passes by construction, and BEFORE the save
                # decision so its stream_save_now/stream_force_base
                # requests take effect at THIS boundary
                self.on_window_complete(int(widx), dataset)
            if self.stream_membership is not None:
                decision = self.stream_membership()
                if decision:
                    # scale event at a COMPLETED boundary: persist the
                    # boundary and hand control back to the launcher
                    if checkpoint is not None:
                        self._stream_boundary_save(dataset, checkpoint)
                    totals["membership"] = decision
                    log.warning("stream stop at window %d boundary for "
                                "membership change: %s", widx, decision)
                    return
            if checkpoint is not None and (
                    since_ckpt >= max(1, FLAGS.stream_ckpt_every_windows)
                    or self.stream_save_now):
                self._stream_boundary_save(dataset, checkpoint)
                since_ckpt = 0
                self.stream_save_now = False

    def _stream_boundary_save(self, dataset, checkpoint) -> str:
        """Publish a boundary checkpoint: for a windowed stream it
        carries the stream cursor (completed files, empty open window);
        for any other dataset (or None) ``_boundary_cursor`` is None and
        this is a plain cursor-free boundary save. A no-op when this step
        is already on disk (e.g. the window pass published a boundary
        after a mid-pass save or a cursor resume — a re-save would refuse
        as a delta over a base)."""
        if checkpoint.latest_step() == int(self.global_step):
            # a pending stream_force_base stays pending through this
            # dedup: the next boundary that saves captures it
            return checkpoint._dir(int(self.global_step))
        cursor = self._boundary_cursor(dataset)
        path = checkpoint.save(
            self,
            delta=checkpoint.has_base() and not self.stream_force_base,
            cursor=cursor,
            clear_touched=True if cursor is not None else None,
            metrics=self.metrics if len(self.metrics) else None)
        self.stream_force_base = False
        if cursor is not None:
            # this boundary checkpoint now records every completed file
            # BY NAME — fold them into the compact count+fingerprint
            # form so later cursors stay O(files since this boundary)
            dataset.fold_completed_history()
        return path

    def _stream_stop(self, dataset, checkpoint) -> None:
        """Graceful stop from the stream loop (idle poll / between
        windows): snapshot a stream-boundary checkpoint, write the
        resume marker, raise — the run_pass preemption contract."""
        path = None
        if checkpoint is not None:
            path = self._stream_boundary_save(dataset, checkpoint)
            preemption.write_resume_marker(
                checkpoint.root, step=int(self.global_step),
                reason=preemption.stop_reason())
        raise PreemptedError(
            f"preempted ({preemption.stop_reason()}) in the stream loop at "
            f"step {self.global_step}",
            step=int(self.global_step), checkpoint_path=path)

    @staticmethod
    def _stream_sleep(sec: float) -> None:
        """Stop-aware sleep: wakes early when a graceful stop arrives so
        the grace window is not burned idling."""
        deadline = time.monotonic() + sec
        while True:
            if preemption.stop_pending():
                return
            left = deadline - time.monotonic()
            if left <= 0:
                return
            time.sleep(min(0.05, left))

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
                        path = self._stream_boundary_save(None, checkpoint)
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

    def eval_pass(self, dataset: Dataset,
                  log_prefix: str = "") -> Dict[str, float]:
        """Forward-only pass: AUC on the current params and table, no
        updates, no index growth. The registered metric variants are fed
        every batch, as ``train_pass`` feeds them (the test-phase
        metrics)."""
        auc = init_auc_state(device=self.device)
        self.stage_timers.reset()
        t0 = time.perf_counter()
        nb = 0
        self.model.eval()
        try:
            for batch, dev in self._prefetch_iter(
                    dataset.batches(), prepare=self.table.prepare_eval):
                with self.stage_timers.stage("step"):
                    pred = self.step_fn.eval(self.state.table, self.model,
                                             auc, dev)
                if len(self.metrics):
                    with self.stage_timers.stage("metrics"):
                        self.metrics.add_batch(
                            pred, batch.label,
                            (batch.show > 0).astype(np.float32),
                            uid=batch.uid, rank=batch.rank,
                            cmatch=batch.cmatch)
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

    def fence_table(self) -> None:
        """Drain the table's asynchronous end_pass write-back
        (``ps/epilogue``) and raise the first failure; a no-op for a
        table without one. Not called at pass boundaries (that would
        serialize the overlap): checkpoint capture and host-tier reads
        fence by themselves."""
        fence = getattr(self.table, "fence", None)
        if fence is not None:
            fence()

    def adopt_table(self) -> None:
        """Point the step state at the table's state (the pass lifecycle
        calls it after begin_pass; a ``PassScopedTable`` updates its
        window in place, so this matters only where the state was
        replaced)."""
        self.state.table = self.table.state

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
