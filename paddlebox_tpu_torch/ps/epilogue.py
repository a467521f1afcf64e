"""The asynchronous pass epilogue and the pipeline hang deadline — from
``paddlebox_tpu/ps/epilogue.py``.

The ``EndPass`` dump of the card's window to the host tier leaves the
critical path: ``end_pass`` of a pass-window table (``ps/pass_table.py``,
``ps/tiered.py``) gathers the pass's touched rows on the training
stream, copies them into pinned host memory without blocking and
records a CUDA event, then hands the host-store write-back to
``PassEpilogue``, one worker thread that runs its jobs strictly in
submission order and waits on each job's event before it reads the
rows. Pass N+1 trains while pass N drains.

Contract:

- ``submit(fn)`` enqueues one job and returns; a held failure of an
  earlier job raises first.
- ``fence()`` blocks until every submitted job has run, then raises the
  first failure once, as ``EndPassWritebackError``. Every host-tier read
  and lifecycle op fences (``HostStore.read_barrier``).
- ``wait_with_deadline`` is the one timed wait of every pipeline wait
  (this fence and ``train/device_pass.PassPreloader.wait``): with
  ``FLAGS.pipeline_wait_timeout_sec`` it raises ``PipelineHangError``
  naming the stuck stage instead of blocking forever.

Telemetry (``obs/``): the worker runs on the ``epilogue.lane`` trace
lane, each job in an ``endpass.writeback`` span linked to its submitter;
with the hub active the queue-depth gauge, the write-back and fence-wait
counters and the overlap gauge mirror ``stats()``. A hang books
``pbox_pipeline_hangs_total{stage}`` and fires the ``pipeline_hang``
flight-recorder trigger (``note_hang``) before it raises.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Deque, Dict, Optional, Tuple

from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.obs import flightrec, trace
from paddlebox_tpu_torch.obs.hub import active_hub, get_hub

log = logging.getLogger(__name__)


class EndPassWritebackError(RuntimeError):
    """An asynchronous end-pass write-back failed. Raised at the first
    fence after the failure (host reads, the next stage fetch, save /
    shrink / checkpoint capture, or the next end_pass submit): the failed
    pass's touched rows did NOT reach the host tier; recover by restoring
    a checkpoint, never by continuing."""


class PipelineHangError(RuntimeError):
    """A pipeline wait made NO progress for
    ``FLAGS.pipeline_wait_timeout_sec``: a worker is wedged (stuck IO, a
    deadlocked device copy). The message names the stuck stage and its
    queue state; raised INSTEAD of blocking forever. Progress is seen at
    whole-job granularity (a build completing resets the deadline), so a
    pipeline whose every job beats the deadline never trips it, but one
    job slower than the deadline does: set the timeout above the slowest
    single build."""


def hang_timeout() -> float:
    """The hang deadline of every pipeline wait, in seconds (0 = none)."""
    return float(FLAGS.pipeline_wait_timeout_sec)


def note_hang(stage: str) -> None:
    """A pipeline wait hit the hang deadline: book
    ``pbox_pipeline_hangs_total{stage}`` and fire the ``pipeline_hang``
    flight-recorder trigger (the bundle's live thread stacks name the
    wedged worker the error cannot see)."""
    try:
        get_hub().counter(
            "pbox_pipeline_hangs_total",
            "pipeline waits aborted by the hang deadline").inc(
                stage=stage)
    except Exception:
        log.debug("hang telemetry emit failed", exc_info=True)
    flightrec.trigger("pipeline_hang", reason=f"stage {stage}",
                      stage=stage)


def wait_with_deadline(cv: threading.Condition, done: Callable[[], bool],
                       progress: Callable[[], object], stage: str,
                       message: Callable[[], str]) -> None:
    """The timed condition wait with the hang deadline. Call with ``cv``
    HELD; returns once ``done()`` is true. With
    ``FLAGS.pipeline_wait_timeout_sec > 0``, an unchanged ``progress()``
    value for that long books the hang for ``stage`` (``note_hang``) and
    raises ``PipelineHangError`` with ``message()``, which names the
    stuck stage."""
    hang = hang_timeout()
    deadline = (time.monotonic() + hang) if hang > 0 else None
    last = progress()
    while not done():
        if deadline is None:
            cv.wait()
            continue
        cv.wait(min(0.2, hang))
        cur = progress()
        if cur != last:  # progress resets the clock
            last = cur
            deadline = time.monotonic() + hang
        elif time.monotonic() > deadline:
            note_hang(stage)
            raise PipelineHangError(message())


def fence_under_pressure(lock: threading.Lock, fence: Callable[[], None],
                         pressure: Callable[[], bool]) -> float:
    """The fence-outside-the-lock discipline of begin-boundary eviction,
    shared by the pass-window tables. Call with ``lock`` HELD. While
    ``pressure()`` holds and the epilogue has not been fenced yet:
    release the lock, ``fence()``, reacquire, re-check. The fence never
    runs under a lock the epilogue worker itself takes (``_evict_ahead``
    takes ``host_lock``), and the re-check under the same lock hold as
    the promote that follows means pressure that appears in between (a
    concurrent plan assign) fences again instead of evicting unfenced.
    Returns the fence-wait seconds; on return the lock is held and either
    ``pressure()`` is false or the fence ran."""
    fence_sec = 0.0
    fenced = False
    while not fenced and pressure():
        lock.release()
        try:
            t0 = time.perf_counter()
            fence()
            fence_sec += time.perf_counter() - t0
            fenced = True
        finally:
            lock.acquire()
    return fence_sec


class PassEpilogue:
    """One background worker serializing end-pass write-backs."""

    def __init__(self, name: str = "endpass") -> None:
        self.name = name
        self._cv = threading.Condition(threading.Lock())
        self._jobs: Deque[Tuple[Callable[[], None], str, int]] = \
            collections.deque()
        self._submitted = 0
        self._done = 0
        self._running = False   # a drainer thread is live
        self._error: Optional[BaseException] = None
        self.jobs_run = 0
        self.total_writeback_sec = 0.0
        self.total_fence_wait_sec = 0.0
        # fence waits on the MAIN thread only (the pipeline's critical
        # path): a worker thread fencing before its host fetch waits
        # too, but that wait itself overlaps training
        self.critical_fence_wait_sec = 0.0
        self.last_writeback_sec = 0.0

    def submit(self, fn: Callable[[], None], label: str = "",
               link_from: int = 0) -> None:
        """Enqueue a write-back job and return. Raises an earlier job's
        held failure first (training on after a lost write-back would
        compound the damage silently). ``link_from`` names the
        submitter's trace span: the job's ``endpass.writeback`` span
        links back to it."""
        with self._cv:
            self._raise_pending_locked()
            self._jobs.append((fn, label, link_from))
            self._submitted += 1
            depth = len(self._jobs)
            if not self._running:
                self._running = True
                threading.Thread(target=self._drain, daemon=True,
                                 name=f"pbx-{self.name}").start()
        self._mirror_depth(depth)

    def _drain(self) -> None:
        trace.set_lane(trace.LANE_EPILOGUE)
        while True:
            with self._cv:
                if not self._jobs:
                    self._running = False
                    self._cv.notify_all()
                    return
                fn, label, link = self._jobs.popleft()
            t0 = time.perf_counter()
            try:
                with trace.span("endpass.writeback", link_from=link,
                                job=label or self.name):
                    fn()
            except BaseException as e:  # held for the next fence
                log.error("async end_pass write-back failed (%s): %r",
                          label or self.name, e)
                with self._cv:
                    if self._error is None:
                        self._error = e
            dur = time.perf_counter() - t0
            with self._cv:
                self._done += 1
                self.jobs_run += 1
                self.last_writeback_sec = dur
                self.total_writeback_sec += dur
                depth = len(self._jobs)
                self._cv.notify_all()
            self._mirror_job(dur, depth)

    @property
    def pending(self) -> int:
        with self._cv:
            return self._submitted - self._done

    def fence(self) -> None:
        """Wait for every submitted write-back to land, then raise the
        first failure (once). One lock round trip when nothing is queued.
        With ``FLAGS.pipeline_wait_timeout_sec > 0`` a wait that makes no
        progress for that long raises ``PipelineHangError`` naming the
        stage ``endpass.writeback``."""
        t0 = time.perf_counter()
        critical = threading.current_thread() is threading.main_thread()
        with self._cv:
            if self._done >= self._submitted and self._error is None:
                return
            try:
                wait_with_deadline(
                    self._cv,
                    done=lambda: self._done >= self._submitted,
                    progress=lambda: self._done,
                    stage="endpass.writeback",
                    message=lambda: (
                        f"end-pass epilogue fence hung: stage "
                        f"'endpass.writeback' ({self.name}) made no "
                        f"progress for {hang_timeout():.1f}s — "
                        f"{self._submitted - self._done} job(s) "
                        f"outstanding (submitted={self._submitted}, "
                        f"done={self._done}, queued={len(self._jobs)}, "
                        f"worker_running={self._running}, "
                        f"last_writeback_sec="
                        f"{self.last_writeback_sec:.3f})"))
            finally:
                # a hang still counts as fence wait: the wait counters
                # must add up to the wall time
                waited = time.perf_counter() - t0
                self.total_fence_wait_sec += waited
                if critical:
                    self.critical_fence_wait_sec += waited
            err = self._take_error_locked()
        if waited > 1e-4:
            self._mirror_fence(waited)
        if err is not None:
            raise err

    def _take_error_locked(self) -> Optional[BaseException]:
        err, self._error = self._error, None
        if err is None:
            return None
        if isinstance(err, EndPassWritebackError):
            return err
        out = EndPassWritebackError(
            f"async end_pass write-back failed ({self.name}): {err!r} — "
            "the pass's touched rows did not reach the host tier")
        out.__cause__ = err
        return out

    def _raise_pending_locked(self) -> None:
        err = self._take_error_locked()
        if err is not None:
            raise err

    def stats(self) -> Dict[str, float]:
        """Cumulative accounting; ``overlap_sec`` = write-back seconds
        that never blocked the main thread (write-back minus the main
        thread's fence waits, at least 0): the seconds the asynchronous
        epilogue took off the pass's critical path."""
        with self._cv:
            return {
                "pending": self._submitted - self._done,
                "jobs_run": self.jobs_run,
                "writeback_sec": self.total_writeback_sec,
                "fence_wait_sec": self.total_fence_wait_sec,
                "critical_fence_wait_sec": self.critical_fence_wait_sec,
                "last_writeback_sec": self.last_writeback_sec,
                "overlap_sec": max(
                    0.0, self.total_writeback_sec
                    - self.critical_fence_wait_sec),
            }

    # ---- telemetry ----
    def _mirror_depth(self, depth: int) -> None:
        hub = active_hub()
        if hub is not None:
            hub.gauge("pbox_endpass_queue_depth",
                      "end-pass write-back jobs queued").set(depth)

    def _mirror_job(self, dur: float, depth: int) -> None:
        hub = active_hub()
        if hub is None:
            return
        hub.counter("pbox_endpass_writebacks_total",
                    "async end-pass write-back jobs completed").inc()
        hub.counter("pbox_endpass_writeback_seconds_total",
                    "seconds spent in end-pass write-back jobs").inc(dur)
        hub.gauge("pbox_endpass_queue_depth",
                  "end-pass write-back jobs queued").set(depth)
        self._mirror_overlap(hub)

    def _mirror_fence(self, waited: float) -> None:
        hub = active_hub()
        if hub is None:
            return
        hub.counter("pbox_endpass_fence_wait_seconds_total",
                    "seconds callers blocked on the epilogue fence"
                    ).inc(waited)
        # a critical fence just consumed overlap: refresh the gauge so it
        # tracks stats()
        self._mirror_overlap(hub)

    def _mirror_overlap(self, hub) -> None:
        with self._cv:
            overlap = max(0.0, self.total_writeback_sec
                          - self.critical_fence_wait_sec)
        hub.gauge("pbox_endpass_overlap_sec",
                  "cumulative end-pass write-back seconds overlapped "
                  "with the next pass (writeback - fence waits)"
                  ).set(overlap)
