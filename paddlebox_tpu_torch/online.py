"""Always-on online learning: one supervised train -> publish -> serve
daemon (the port's copy of ``paddlebox_tpu/online.py``).

``OnlineLearner`` composes pieces the port already holds alone into the
production shape PaddleBox runs:

- **train**: ``Trainer.train_stream`` windows over arriving files
  (``FLAGS.stream_window_files``), with the full preemption contract: a
  SIGTERM mid-window writes an emergency boundary checkpoint and
  ``RESUME.json``; a restarted daemon resumes the open window
  at-least-once.
- **publish**: stream-boundary checkpoints publish into the
  ``ArtifactStore`` of the ``CheckpointManager`` as lineage-linked
  versions (the base/delta feed).
- **serve**: a ``serving.ReloadLoop`` adopts published versions into an
  immutable snapshot while training goes on (verify before swap,
  degrade, never crash).
- **feature lifecycle**: every ``FLAGS.shrink_every_windows`` completed
  windows (the dataset's monotone ``windows_completed`` clock, so the
  cadence survives preemption and resume) a shrink cycle ages the model:
  ``table.shrink`` decays show/clk/delta_score and drops rows below the
  threshold through whatever tier stack the table owns. The cycle's
  decisions ride the boundary cursor (``Trainer.lifecycle``), and the
  next boundary checkpoint is forced to a BASE save: a delta cannot
  carry a whole-table decay.

The **supervisor loop** classifies leg failures on the RetryPolicy split
(site ``online.supervise``): transient failures restore the last
consistent checkpoint and retry on the seeded backoff (mode
``degraded`` while retrying); deterministic ones degrade loudly, to
``serve_only`` when training died but serving answers, to
``train_only`` when serving died. A failed shrink cycle (site
``online.shrink``) retries transients and otherwise skips the cycle
loudly (``pbox_online_shrink_skipped_total`` and a ``shrink_skipped``
flight-recorder trigger) without stalling training.

``/healthz`` carries the daemon's verdict in the hub's ``online`` block
(``TelemetryHub.set_online_probe``): ``{mode, windows_completed,
files_backlog, last_publish_ts, last_shrink_ts, shrunk_rows_total,
...}``.

``python -m paddlebox_tpu_torch.tools.onlinelearn`` is the launcher;
``python -m paddlebox_tpu_torch.tools.online_check`` gates the
composition.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: daemon modes, most to least capable
MODES = ("full", "train_only", "serve_only", "degraded")


class OnlineLearner:
    """Supervised always-on train→publish→serve daemon (ONE process).

    Parameters
    ----------
    trainer:
        The ``train.Trainer`` (its table is what shrink cycles age).
    dataset_fn:
        Zero-arg factory for a FRESH windowed ``QueueDataset`` — called
        per train-leg attempt so a supervised restart re-adopts the
        stream cursor exactly like a process restart would.
    checkpoint:
        ``CheckpointManager`` (publishes boundary artifacts when it was
        given an ``ArtifactStore``).
    serving / store:
        Optional ``serving.ServingModel`` + the ``ArtifactStore`` its
        reload loop polls. Both or neither; without them the daemon
        runs mode ``train_only``.
    filelist_fn / max_windows / max_idle_polls:
        Passed through to ``Trainer.train_stream`` (``max_windows``
        counts across supervised restarts, not per attempt).
    shrink_every_windows:
        Override for ``FLAGS.shrink_every_windows`` (0 = aging off).
    """

    def __init__(self, trainer, dataset_fn: Callable[[], object],
                 checkpoint, *, serving=None, store=None,
                 filelist_fn: Optional[Callable[[], List[str]]] = None,
                 max_windows: Optional[int] = None,
                 max_idle_polls: Optional[int] = None,
                 reload_poll_sec: Optional[float] = None,
                 shrink_every_windows: Optional[int] = None) -> None:
        if (serving is None) != (store is None):
            raise ValueError("serving and store come together: the "
                             "serve leg adopts published versions from "
                             "the store")
        self.trainer = trainer
        self.dataset_fn = dataset_fn
        self.checkpoint = checkpoint
        self.serving = serving
        self.store = store
        self.filelist_fn = filelist_fn
        self.max_windows = max_windows
        self.max_idle_polls = max_idle_polls
        self.reload_poll_sec = reload_poll_sec
        self.shrink_every = (FLAGS.shrink_every_windows
                             if shrink_every_windows is None
                             else int(shrink_every_windows))
        self._lock = threading.Lock()
        # supervisor-owned base mode; online_status() refines it to
        # "degraded" while a transient retry backoff is in flight
        self._mode_base = "full" if serving is not None else "train_only"
        self._retrying = False
        self._loop = None            # serving.ReloadLoop
        self._windows_this_run = 0   # daemon-level window budget clock
        self._backlog = 0
        self._last_publish_step: Optional[int] = None
        self.last_publish_ts: Optional[float] = None
        self.last_shrink_ts: Optional[float] = None
        self._last_shrink_window = 0
        self.shrink_cycles = 0
        self.shrunk_rows_total = 0
        self.shrink_skipped_total = 0
        self.leg_failures = 0
        self.totals: Dict[str, float] = {}

    # ---- status / healthz ----------------------------------------------
    def online_status(self) -> Dict:
        """The /healthz ``online`` block (hub.set_online_probe). Safe
        from any thread; never raises on a half-started daemon."""
        with self._lock:
            mode = self._mode_base
            if self._retrying:
                mode = "degraded"
            elif mode == "full" and self.serving is not None:
                try:
                    sst = self.serving.serving_status()
                    if sst.get("stale"):
                        # training healthy but the snapshot stopped
                        # advancing — the composed verdict degrades
                        mode = "degraded"
                except Exception:
                    pass
            wc = self._dataset_windows()
            return {
                "mode": mode,
                "windows_completed": wc,
                "files_backlog": int(self._backlog),
                "last_publish_ts": self.last_publish_ts,
                "last_shrink_ts": self.last_shrink_ts,
                "shrunk_rows_total": int(self.shrunk_rows_total),
                "shrink_cycles": int(self.shrink_cycles),
                "shrink_skipped_total": int(self.shrink_skipped_total),
                "windows_since_shrink": (
                    max(0, wc - self._last_shrink_window)
                    if self.shrink_every > 0 else 0),
                "leg_failures": int(self.leg_failures),
                "serving": self.serving is not None,
            }

    def _dataset_windows(self) -> int:
        ds = getattr(self, "_dataset", None)
        return int(getattr(ds, "windows_completed", 0) or 0)

    # ---- lifecycle bookkeeping -----------------------------------------
    def _seed_from_cursor(self) -> None:
        """Resume the shrink cadence + counters from the newest
        checkpoint cursor's lifecycle block — a restarted daemon must
        not re-age (or forget it aged) the rows the checkpoint already
        captured."""
        try:
            cur = self.checkpoint.load_cursor() if self.checkpoint \
                else None
        except Exception:
            cur = None
        lc = (cur or {}).get("lifecycle")
        if not lc:
            return
        with self._lock:
            self.trainer.lifecycle = dict(lc)
            self.shrink_cycles = int(lc.get("cycles", 0) or 0)
            self.shrunk_rows_total = int(
                lc.get("shrunk_rows_total", 0) or 0)
            self._last_shrink_window = int(
                lc.get("last_shrink_window", 0) or 0)
        log.info("online: resumed lifecycle state — %d cycles, %d rows "
                 "shrunk, last at window %d", self.shrink_cycles,
                 self.shrunk_rows_total, self._last_shrink_window)

    def _live_rows(self) -> int:
        """Live logical rows across the table's tier stack (device
        window / host RAM / SSD — whichever the table owns)."""
        t = self.trainer.table
        host = getattr(t, "host", None)
        if host is not None:
            ssd = getattr(host, "ssd", None)
            return len(host) + (len(ssd) if ssd is not None else 0)
        hosts = getattr(t, "hosts", None)
        if hosts:
            n = 0
            for h in hosts:
                n += len(h)
                if getattr(h, "ssd", None) is not None:
                    n += len(h.ssd)
            return n
        return int(t.feature_count)

    # ---- per-window hook (runs on the training thread) -----------------
    def _on_window(self, widx: int, dataset) -> None:
        from paddlebox_tpu_torch.obs.hub import get_hub
        hub = get_hub()
        self._dataset = dataset
        with self._lock:
            self._windows_this_run += 1
            try:
                self._backlog = len(dataset.pending_files())
            except Exception:
                pass
        # publish observation: the boundary save of window N-1 landed
        # before this hook ran — a step advance means a publish
        if self.checkpoint is not None:
            st = self.checkpoint.latest_step()
            if st is not None and st != self._last_publish_step:
                with self._lock:
                    self._last_publish_step = st
                    self.last_publish_ts = time.time()
        # serve-leg liveness: the reload loop's thread must be running
        if self._loop is not None and self._mode_base == "full":
            th = getattr(self._loop, "_thread", None)
            if th is not None and not th.is_alive():
                self._degrade("serve", RuntimeError(
                    "reload loop thread died"), to_mode="train_only")
        wc = int(getattr(dataset, "windows_completed", 0) or 0)
        if self.shrink_every > 0:
            hub.gauge("pbox_online_windows_since_shrink",
                      "completed windows since the last shrink cycle "
                      "(shrink-overdue alert input)").set(
                          max(0, wc - self._last_shrink_window))
            if wc - self._last_shrink_window >= self.shrink_every:
                self._shrink_cycle(wc)

    def _shrink_cycle(self, window: int) -> None:
        """One feature-lifecycle cycle at a window boundary: fence +
        age the table (whole tier stack), record the decision in the
        boundary cursor, and force the next boundary save to a BASE —
        published at THIS boundary (stream_save_now). Transient
        failures retry on the seeded ``online.shrink`` policy; a hard
        failure skips the cycle loudly without stalling training."""
        from paddlebox_tpu_torch.obs import flightrec
        from paddlebox_tpu_torch.obs.hub import get_hub
        from paddlebox_tpu_torch.resilience import faults
        from paddlebox_tpu_torch.resilience.retry import RetryPolicy
        hub = get_hub()
        t0 = time.perf_counter()
        # the step state owns the freshest device rows: sync the table
        # before aging, re-adopt its state after
        self.trainer.sync_table()

        def attempt() -> int:
            faults.inject("online.shrink", window=window)
            return int(self.trainer.table.shrink())

        try:
            freed = RetryPolicy.from_flags(
                site="online.shrink").call(attempt)
        except Exception as e:
            # deterministic failure or retries exhausted: SKIP this
            # cycle loudly; training continues, the cadence re-fires
            # shrink_every windows from now
            with self._lock:
                self.shrink_skipped_total += 1
                self._last_shrink_window = window
            hub.counter("pbox_online_shrink_skipped_total",
                        "shrink cycles skipped after a hard/exhausted "
                        "failure").inc()
            if hub.active:
                hub.emit("online_shrink_skipped", window=window,
                         error=repr(e))
            flightrec.trigger("shrink_skipped", reason=repr(e),
                              window=window)
            log.error("online: shrink cycle at window %d SKIPPED (%r) "
                      "— training continues, next attempt in %d "
                      "windows", window, e, self.shrink_every)
            self.trainer.adopt_table()
            return
        self.trainer.adopt_table()
        live = self._live_rows()
        now = time.time()
        with self._lock:
            self.shrink_cycles += 1
            self.shrunk_rows_total += freed
            self._last_shrink_window = window
            self.last_shrink_ts = now
            # the decisions ride every subsequent cursor: a restore
            # replays to the same live-key set and the daemon resumes
            # its cadence from it
            self.trainer.lifecycle = {
                "version": 1,
                "cycles": int(self.shrink_cycles),
                "last_shrink_window": int(window),
                "shrunk_rows_total": int(self.shrunk_rows_total),
                "live_rows": int(live),
                "decay": float(FLAGS.show_click_decay_rate),
                "delete_threshold": float(FLAGS.shrink_delete_threshold),
            }
        # a delta save cannot carry a whole-table decay — force a BASE,
        # and publish it at THIS boundary so no training lands between
        # the shrink and its persisted snapshot
        self.trainer.stream_force_base = True
        self.trainer.stream_save_now = True
        hub.counter("pbox_online_shrink_cycles_total",
                    "completed feature-lifecycle shrink cycles").inc()
        hub.counter("pbox_online_shrunk_rows_total",
                    "rows dropped by shrink cycles").inc(freed)
        if hub.active:
            hub.emit("online_shrink", window=window, freed=int(freed),
                     live_rows=int(live),
                     elapsed_sec=round(time.perf_counter() - t0, 4))
        log.info("online: shrink cycle %d at window %d freed %d rows "
                 "(%d live) in %.3fs", self.shrink_cycles, window,
                 freed, live, time.perf_counter() - t0)

    # ---- legs ----------------------------------------------------------
    def _start_serving(self) -> None:
        if self.serving is None:
            return
        from paddlebox_tpu_torch.resilience import faults
        from paddlebox_tpu_torch.serving import ReloadLoop
        try:
            faults.inject("online.supervise", leg="serve")
            self.serving.register_health()
            self._loop = ReloadLoop(self.serving, self.store,
                                    poll_sec=self.reload_poll_sec)
            self._loop.poll_once()  # adopt an existing tip before the
            self._loop.start()      # first query, if one is published
        except Exception as e:
            self._degrade("serve", e, to_mode="train_only")

    def _stop_serving(self) -> None:
        if self._loop is not None:
            try:
                self._loop.stop()
            except Exception:
                log.warning("online: reload loop stop failed",
                            exc_info=True)
            self._loop = None

    def _serving_answering(self) -> bool:
        if self.serving is None:
            return False
        try:
            return self.serving.serving_status().get("adopted") \
                is not None
        except Exception:
            return False

    def _train_leg(self) -> Dict[str, float]:
        ds = self.dataset_fn()
        self._dataset = ds
        mw = None
        if self.max_windows is not None:
            mw = max(0, self.max_windows - self._windows_this_run)
            if mw == 0:
                return dict(self.totals)
        return self.trainer.train_stream(
            ds, self.checkpoint, filelist_fn=self.filelist_fn,
            max_windows=mw, max_idle_polls=self.max_idle_polls,
            log_prefix="online ")

    def _restore_for_retry(self) -> None:
        """Roll the trainer back to the last consistent checkpoint
        before re-entering the train leg — the in-process equivalent of
        a supervised process restart (the fresh dataset re-adopts the
        stream cursor inside train_stream)."""
        if self.checkpoint is None \
                or self.checkpoint.latest_step() is None:
            return
        try:
            self.checkpoint.restore(self.trainer)
        except Exception:
            log.error("online: rollback restore failed — retrying the "
                      "train leg on live state", exc_info=True)

    def _degrade(self, leg: str, exc: BaseException,
                 to_mode: str) -> None:
        from paddlebox_tpu_torch.obs import flightrec
        from paddlebox_tpu_torch.obs.hub import get_hub
        hub = get_hub()
        with self._lock:
            self.leg_failures += 1
            self._mode_base = to_mode
        hub.counter("pbox_online_leg_failures_total",
                    "supervised leg failures by leg/disposition").inc(
                        leg=leg, disposition="degrade")
        if hub.active:
            hub.emit("online_degrade", leg=leg, mode=to_mode,
                     error=repr(exc))
        flightrec.trigger("online_degrade", reason=repr(exc), leg=leg,
                          mode=to_mode)
        log.error("online: %s leg failed DETERMINISTICALLY (%r) — "
                  "degrading to %s (the daemon stays up)", leg, exc,
                  to_mode)

    @staticmethod
    def _stop_aware_sleep(sec: float) -> None:
        from paddlebox_tpu_torch.resilience import preemption
        deadline = time.monotonic() + sec
        while not preemption.stop_pending():
            left = deadline - time.monotonic()
            if left <= 0:
                return
            time.sleep(min(0.05, left))

    def _serve_idle(self) -> None:
        """serve_only steady state: the reload loop keeps adopting,
        the supervisor just waits for a stop (bounded runs return
        immediately — tests must not idle forever)."""
        from paddlebox_tpu_torch.resilience import preemption
        if self.max_windows is not None \
                or self.max_idle_polls is not None:
            return
        while not preemption.stop_pending():
            time.sleep(0.05)

    # ---- the supervisor ------------------------------------------------
    def run(self) -> Dict[str, float]:
        """Run the daemon until the source dries up (bounded runs) or a
        graceful stop arrives (``PreemptedError`` propagates to the
        launcher, which exits ``EXIT_RESUME``). Returns the train-leg
        totals. Transient leg failures retry on the seeded
        ``online.supervise`` policy; deterministic ones degrade — this
        method raises only for preemption or a failure with nothing
        left to supervise."""
        from paddlebox_tpu_torch.obs.hub import get_hub
        from paddlebox_tpu_torch.resilience import faults, preemption
        from paddlebox_tpu_torch.resilience.retry import (RetryPolicy,
                                                    is_retryable)
        if FLAGS.graceful_shutdown:
            preemption.install_signal_handlers()
        hub = get_hub()
        hub.set_online_probe(self.online_status)
        self._seed_from_cursor()
        self._start_serving()
        self.trainer.on_window_complete = self._on_window
        policy = RetryPolicy.from_flags(site="online.supervise")
        backoff = None
        fail_window = -1
        try:
            while True:
                if self._mode_base == "serve_only":
                    self._serve_idle()
                    if preemption.stop_pending():
                        if self.checkpoint is not None:
                            # no training state to snapshot (the train
                            # leg is dead) — but the restart contract
                            # still wants the marker so the launcher
                            # relaunches with resume semantics
                            preemption.write_resume_marker(
                                self.checkpoint.root,
                                step=int(self.trainer.global_step),
                                reason=preemption.stop_reason())
                        raise preemption.PreemptedError(
                            f"preempted "
                            f"({preemption.stop_reason()}) while "
                            "serve_only",
                            step=int(self.trainer.global_step))
                    break
                try:
                    faults.inject("online.supervise", leg="train",
                                  mode=self._mode_base)
                    self.totals = self._train_leg()
                    with self._lock:
                        self._retrying = False
                    break  # source drained / window budget hit
                except preemption.PreemptedError:
                    raise  # graceful shutdown — launcher's contract
                except Exception as e:
                    with self._lock:
                        self.leg_failures += 1
                    if self._windows_this_run > fail_window:
                        backoff = None  # progress since last failure
                    fail_window = self._windows_this_run
                    delay = None
                    if is_retryable(e):
                        if backoff is None:
                            backoff = policy.delays()
                        delay = next(backoff, None)
                    if delay is None:
                        # deterministic, or transient retries exhausted
                        if self._serving_answering():
                            self._degrade("train", e,
                                          to_mode="serve_only")
                            continue
                        log.error("online: train leg failed with no "
                                  "serving leg to fall back to — "
                                  "daemon dies: %r", e)
                        raise
                    with self._lock:
                        self._retrying = True
                    hub.counter(
                        "pbox_online_leg_failures_total",
                        "supervised leg failures by leg/disposition"
                    ).inc(leg="train", disposition="retry")
                    if hub.active:
                        hub.emit("online_leg_retry", leg="train",
                                 delay_sec=round(delay, 4),
                                 error=repr(e))
                    log.warning("online: train leg failed transiently "
                                "(%r) — retrying in %.3fs", e, delay)
                    self._stop_aware_sleep(delay)
                    self._restore_for_retry()
        finally:
            self.trainer.on_window_complete = None
            self._stop_serving()
            hub.set_online_probe(None)
        return dict(self.totals)
