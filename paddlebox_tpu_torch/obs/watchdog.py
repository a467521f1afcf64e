"""Multihost heartbeat + straggler watchdog.
(Copy of ``paddlebox_tpu/obs/watchdog.py``.)

A multi-controller pod (train/multihost.py) fails ugliest when ONE
process slows down: every collective stalls, and nothing says which
host. Each process publishes ``(step, wall_ts)`` heartbeats into a
shared store; a watchdog thread compares the mesh and flags any process
whose step counter falls behind the front-runner by more than
``step_lag`` steps or whose heartbeat goes stale past
``heartbeat_timeout``. Detection logs + emits a ``straggler`` telemetry
event; with ``abort_after`` set, a stall that persists past the
deadline makes the NEXT ``beat()`` raise ``StragglerTimeout`` in the
training thread — the safe place to abort, since raising inside the
monitor thread would vanish.

Stores: ``LocalHeartbeatStore`` (in-process — tests, single-host
multi-device) and ``DirHeartbeatStore`` (one JSON file per process in a
shared directory — NFS/FUSE mounts on real pods; atomic
write-then-rename so readers never see a torn file).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from paddlebox_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class StragglerTimeout(RuntimeError):
    """Raised by ``beat()`` after a stall outlives ``abort_after``."""


class StragglerReport(NamedTuple):
    process: int
    step: int          # -1: never heartbeat
    behind: int        # steps behind the front-runner
    age_sec: float     # seconds since the process's last heartbeat
    reason: str        # "step_lag" | "stale" | "missing"


class LocalHeartbeatStore:
    """In-process store (tests / single-host)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._beats: Dict[int, Tuple[int, float]] = {}

    def publish(self, process: int, step: int, ts: float) -> None:
        with self._lock:
            self._beats[process] = (step, ts)

    def read(self) -> Dict[int, Tuple[int, float]]:
        with self._lock:
            return dict(self._beats)


class DirHeartbeatStore:
    """One ``hb_<process>.json`` per process in a shared directory.
    Reusing a directory across runs is safe: the watchdog's ``check``
    ignores ranks beyond the current mesh and beats older than its own
    start (minus the timeout), so prior-run leftovers never report."""

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(path, exist_ok=True)

    def publish(self, process: int, step: int, ts: float) -> None:
        from paddlebox_tpu_torch.utils.fsio import atomic_write_json
        # no fsync: heartbeats are ephemeral liveness signals — a beat
        # lost to a crash is exactly what the watchdog detects anyway
        atomic_write_json(os.path.join(self.path, f"hb_{process}.json"),
                          {"process": process, "step": step, "ts": ts},
                          fsync=False)

    def read(self) -> Dict[int, Tuple[int, float]]:
        out: Dict[int, Tuple[int, float]] = {}
        try:
            names = os.listdir(self.path)
        except OSError:
            return out
        for n in names:
            if not (n.startswith("hb_") and n.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.path, n)) as fh:
                    d = json.load(fh)
                out[int(d["process"])] = (int(d["step"]), float(d["ts"]))
            except (OSError, ValueError, KeyError):
                continue  # torn/foreign file — next poll sees the rename
        return out


def requeue_pass_action(handler: Callable[[List[StragglerReport]], None],
                        name: str = "requeue_pass"):
    """Escalation action factory: hand the stalled pass back to a
    scheduler/launcher callback (e.g. re-enqueue the pass spec so a
    healthy rank set re-runs it)."""
    def action(wd: "StragglerWatchdog", reports, stalled_for: float):
        handler(reports)
    action.escalation_name = name
    return action


def shrink_and_continue_action(evict_fn: Callable[[List[StragglerReport]],
                                                  None],
                               name: str = "shrink_and_continue"):
    """Escalation action factory — the rung BETWEEN requeue and abort
    (docs/RESILIENCE.md §Elastic membership): hand the wedged ranks to
    ``evict_fn``, which deregisters their elastic leases
    (``ElasticManager.evict_host``) so the next boundary membership poll
    confirms the death immediately (eviction bypasses the dead-check
    hysteresis) and the survivors re-shard and continue. A hung host
    costs one rollback-to-boundary instead of the job.

    ``evict_fn`` runs on the MONITOR thread; lease deletion is a KV op,
    safe under concurrent training — the re-shard itself happens at the
    training loop's next pass boundary, never here."""
    def action(wd: "StragglerWatchdog", reports, stalled_for: float):
        evict_fn(reports)
    action.escalation_name = name
    return action


def abort_with_checkpoint_action(save_fn: Callable[[], object],
                                 name: str = "abort_with_checkpoint"):
    """Escalation action factory: snapshot state (``save_fn``) and THEN
    arm the abort, so the StragglerTimeout the training thread sees on
    its next ``beat()`` loses no progress.

    ``save_fn`` runs on the MONITOR thread while the local training
    thread may still be mid-pass (e.g. when a *remote* rank is the
    straggler) — it must be safe under concurrent training: either
    snapshot pass-boundary state only (a CheckpointManager save of the
    last synced table is), or set a flag the training loop consumes at
    its next safe point rather than touching live trainer state."""
    def action(wd: "StragglerWatchdog", reports, stalled_for: float):
        try:
            save_fn()
        except Exception:
            log.error("escalation checkpoint save failed — aborting "
                      "without a fresh snapshot", exc_info=True)
        wd.arm_abort(reports, stalled_for)
    action.escalation_name = name
    return action


class StragglerWatchdog:
    def __init__(
        self,
        store,
        process_index: int,
        num_processes: int,
        step_lag: int = 100,
        heartbeat_timeout: float = 60.0,
        poll_interval: float = 5.0,
        abort_after: Optional[float] = None,
        on_straggler: Optional[Callable[[List[StragglerReport]], None]]
        = None,
        clock: Callable[[], float] = time.time,
        hub=None,
        escalations: Optional[List[Tuple[float, Callable]]] = None,
    ) -> None:
        """``clock`` is injectable so tests simulate stalls without
        sleeping; heartbeats carry this clock's timestamps, so every
        process of one job must use the same clock source.

        ``escalations`` is a ladder of ``(after_sec, action)`` rungs:
        once a stall has persisted ``after_sec`` seconds, ``action(wd,
        reports, stalled_for)`` fires (once per stall episode). Built-in
        actions: :func:`requeue_pass_action`,
        :func:`abort_with_checkpoint_action`, and :meth:`arm_abort`
        (what the legacy ``abort_after=`` shorthand installs). Every
        detection already logs + emits the ``straggler`` event, so the
        ladder only needs the *reactions*."""
        self.store = store
        self.process_index = process_index
        self.num_processes = num_processes
        self.step_lag = step_lag
        self.heartbeat_timeout = heartbeat_timeout
        self.poll_interval = poll_interval
        self.abort_after = abort_after
        self.on_straggler = on_straggler
        self.clock = clock
        self._hub = hub
        self._start_ts = clock()
        self._stall_since: Optional[float] = None
        self._abort_exc: Optional[StragglerTimeout] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.last_report: List[StragglerReport] = []
        self.escalations: List[Tuple[float, Callable]] = sorted(
            escalations or [], key=lambda e: e[0])
        if abort_after is not None:
            # legacy shorthand == top rung of the ladder
            def _abort(wd, reports, stalled):
                wd.arm_abort(reports, stalled)
            _abort.escalation_name = "abort"
            self.escalations.append((abort_after, _abort))
            self.escalations.sort(key=lambda e: e[0])
        self._fired_rungs: set = set()

    def _get_hub(self):
        if self._hub is None:
            from paddlebox_tpu_torch.obs.hub import get_hub
            self._hub = get_hub()
        return self._hub

    # ---- producer side -------------------------------------------------
    def beat(self, step: int) -> None:
        """Publish this process's progress; call once per step-window or
        pass. Raises ``StragglerTimeout`` if the monitor armed an abort."""
        if self._abort_exc is not None:
            raise self._abort_exc
        self.store.publish(self.process_index, int(step), self.clock())
        hub = self._get_hub()
        if hub.active:
            hub.gauge("pbox_multihost_step",
                      "last heartbeat step per process").set(
                          int(step), process=self.process_index)

    # ---- monitor side --------------------------------------------------
    def check(self) -> List[StragglerReport]:
        """One detection sweep (pure given the store + clock — the unit
        the tests drive directly). Empty list == healthy mesh."""
        now = self.clock()
        beats = self.store.read()
        # restart hygiene: a reused heartbeat dir holds files from prior
        # runs — ranks beyond this mesh (elastic downsize) or beats that
        # predate this watchdog by more than the timeout. They must not
        # define the front-runner or report as stale: a restarted job
        # would otherwise chase a step count that only existed in the
        # old run's leftovers (and abort_after would kill it healthy).
        # A rank whose only file is pre-run leftover shows up as
        # "missing" after the grace window instead.
        fresh_floor = self._start_ts - self.heartbeat_timeout
        beats = {p: (s, t) for p, (s, t) in beats.items()
                 if p < self.num_processes and t >= fresh_floor}
        reports: List[StragglerReport] = []
        front = max((s for s, _ in beats.values()), default=0)
        for p in range(self.num_processes):
            if p not in beats:
                # a process that never published is only a straggler
                # once the mesh has had time to come up
                if beats and now - self._start_ts > self.heartbeat_timeout:
                    reports.append(StragglerReport(
                        p, -1, front, now - self._start_ts, "missing"))
                continue
            step, ts = beats[p]
            age = now - ts
            if front - step > self.step_lag:
                reports.append(StragglerReport(
                    p, step, front - step, age, "step_lag"))
            elif age > self.heartbeat_timeout:
                reports.append(StragglerReport(
                    p, step, front - step, age, "stale"))
        self.last_report = reports
        return reports

    def arm_abort(self, reports: List[StragglerReport],
                  stalled_for: float) -> None:
        """Final escalation rung: the training thread's NEXT ``beat()``
        raises StragglerTimeout (the safe place to abort — raising in
        the monitor thread would vanish). Idempotent."""
        if self._abort_exc is not None:
            return
        desc = "; ".join(
            f"proc {r.process}: {r.reason} (step={r.step}, "
            f"behind={r.behind}, age={r.age_sec:.1f}s)" for r in reports)
        self._abort_exc = StragglerTimeout(
            f"mesh stalled {stalled_for:.1f}s: {desc}")
        log.error("straggler watchdog: abort armed — next beat() "
                  "raises StragglerTimeout")
        hub = self._get_hub()
        if hub.active:
            hub.emit("straggler_abort",
                     stalled_for_sec=round(stalled_for, 3))

    def _handle(self, reports: List[StragglerReport]) -> None:
        now = self.clock()
        if not reports:
            self._stall_since = None
            self._fired_rungs.clear()  # next stall re-climbs the ladder
            return
        if self._stall_since is None:
            self._stall_since = now
        stalled_for = now - self._stall_since
        desc = "; ".join(
            f"proc {r.process}: {r.reason} (step={r.step}, "
            f"behind={r.behind}, age={r.age_sec:.1f}s)" for r in reports)
        log.warning("straggler watchdog: %s (stalled %.1fs)", desc,
                    stalled_for)
        hub = self._get_hub()
        if hub.active:
            hub.counter("pbox_straggler_events_total",
                        "straggler detections").inc()
            hub.emit("straggler", stalled_for_sec=round(stalled_for, 3),
                     stragglers=[r._asdict() for r in reports])
        if self.on_straggler is not None:
            self.on_straggler(reports)
        # climb the escalation ladder: each rung fires once per stall
        for i, (after_sec, action) in enumerate(self.escalations):
            if i in self._fired_rungs or stalled_for < after_sec:
                continue
            self._fired_rungs.add(i)
            name = getattr(action, "escalation_name",
                           getattr(action, "__name__", f"rung{i}"))
            log.warning("straggler escalation %r fired "
                        "(stalled %.1fs >= %.1fs)", name, stalled_for,
                        after_sec)
            if hub.active:
                hub.counter("pbox_straggler_escalations_total",
                            "escalation rungs fired").inc(action=name)
                hub.emit("straggler_escalation", action=name,
                         after_sec=after_sec,
                         stalled_for_sec=round(stalled_for, 3))
            try:
                # black-box seam (obs/flightrec): capture the mesh
                # state as each escalation rung fires, before the
                # action (abort/restart) mutates it
                from paddlebox_tpu_torch.obs import flightrec
                flightrec.trigger(
                    "watchdog_escalation", reason=name, action=name,
                    after_sec=after_sec,
                    stalled_for_sec=round(stalled_for, 3))
            except Exception:
                log.debug("flightrec trigger failed", exc_info=True)
            try:
                action(self, reports, stalled_for)
            except Exception:
                log.error("straggler escalation %r failed", name,
                          exc_info=True)

    def poll_once(self) -> List[StragglerReport]:
        """check() + alerting/abort arming — one monitor iteration."""
        reports = self.check()
        self._handle(reports)
        return reports

    def start(self) -> "StragglerWatchdog":
        """Run the monitor loop in a daemon thread."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.poll_interval):
                try:
                    self.poll_once()
                except Exception:
                    log.warning("straggler watchdog poll failed",
                                exc_info=True)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="pbox-straggler-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
