"""Profiling tiers: stage timers, per-pass sync report, device tracing
(counterpart of ``paddlebox_tpu/utils/profiler.py``).

Reference (SURVEY.md §5.1): (a) per-stage ``platform::Timer`` aggregation
printed after each pass (``PrintSyncTimer``, fleet/box_wrapper.cc:1182;
``DeviceBoxData`` timers box_wrapper.h:394-403); (b) worker profile mode
timing every op by name (``TrainFilesWithProfiler``,
boxps_worker.cc:1358-1387); (c) the full chrome-trace profiler
(platform/profiler/ + chrometracing_logger.cc).

Mapping: (a) → ``StageTimers`` (named pause/resume timers + one-line
pass report); (b) → per-step timing at the step's granularity, finer
slicing from tier c; (c) → ``trace()``: a ``torch.profiler`` window
with CPU and CUDA activities that writes a chrome trace, whose CUDA
kernel events carry the port's kernel symbols. The reference's
``trace()`` writes a ``jax.profiler`` XPlane instead (a deliberate
difference). ``StageTimers`` also keeps each stage call's seconds
(``seconds``), which the port's trainers report as medians.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Dict, Iterator, List, Optional

from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.utils.logging import get_logger
from paddlebox_tpu_torch.utils.timer import Timer

log = get_logger(__name__)


class ChromeTraceWriter:
    """Host-side chrome://tracing ("Perfetto") event log — the
    ``chrometracing_logger.cc`` role for OUR runtime stages (pass build,
    upload, train, shuffle, checkpoint...). Device-side HLO timing comes
    from ``trace()`` (torch.profiler) — this covers the host orchestration the
    device trace does not label.

    Thread-safe; events carry the recording thread id so overlapped
    preload/train lanes render as separate tracks. The buffer is CAPPED
    (``max_events``, default 1M ≈ 200MB of JSON): stages fire per batch,
    and an uncapped log would grow without bound over a long job —
    events past the cap are counted and reported, not stored."""

    def __init__(self, max_events: int = 1_000_000) -> None:
        self._events: List[dict] = []
        self._max = max_events
        self.dropped = 0
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def _append(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= self._max:
                self.dropped += 1
                return
            self._events.append(ev)

    @contextlib.contextmanager
    def event(self, name: str, **args) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            self._append({
                "name": name, "ph": "X", "pid": 0,
                "tid": threading.get_ident() & 0xFFFF,
                "ts": (start - self._t0) * 1e6,
                "dur": (end - start) * 1e6,
                **({"args": args} if args else {}),
            })

    def complete(self, name: str, start_s: float, dur_s: float,
                 tid: Optional[int] = None, **args) -> None:
        """Record an already-timed span (the obs hub's span-sink entry:
        ``start_s`` is a perf_counter reading from this process).
        ``tid`` overrides the row the span renders on — the lane-trace
        sink (obs/trace.ChromeLaneTraceSink) assigns one stable tid per
        pipeline lane instead of the raw OS thread id."""
        self._append({
            "name": name, "ph": "X", "pid": 0,
            "tid": (threading.get_ident() & 0xFFFF
                    if tid is None else tid),
            "ts": (start_s - self._t0) * 1e6,
            "dur": dur_s * 1e6,
            **({"args": args} if args else {}),
        })

    def thread_meta(self, tid: int, name: str,
                    sort_index: Optional[int] = None) -> None:
        """Label (and optionally order) a tid row — Chrome's
        ``thread_name`` / ``thread_sort_index`` metadata events, so
        lane rows render with their lane names instead of bare ids.
        Metadata bypasses the event cap (a dropped label would mislabel
        every span on the row)."""
        with self._lock:
            self._events.append({
                "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                "args": {"name": name}})
            if sort_index is not None:
                self._events.append({
                    "name": "thread_sort_index", "ph": "M", "pid": 0,
                    "tid": tid, "args": {"sort_index": sort_index}})

    def flow(self, flow_id: int, phase: str, ts_s: float, tid: int,
             name: str = "flow", cat: str = "flow") -> None:
        """Flow event: ``phase`` "s" starts an arrow, "f" binds its end
        ("bp":"e" = bind to the ENCLOSING slice's start) — the
        cross-lane causality arrows of the pass trace (a build span on
        ``preload.worker`` flowing into its consume span on ``main``)."""
        ev = {"name": name, "cat": cat, "ph": phase, "id": flow_id,
              "pid": 0, "tid": tid, "ts": (ts_s - self._t0) * 1e6}
        if phase == "f":
            ev["bp"] = "e"
        self._append(ev)

    def instant(self, name: str, **args) -> None:
        self._append({
            "name": name, "ph": "i", "pid": 0, "s": "g",
            "tid": threading.get_ident() & 0xFFFF,
            "ts": (time.perf_counter() - self._t0) * 1e6,
            **({"args": args} if args else {}),
        })

    def save(self, path: str) -> int:
        """Write chrome://tracing JSON; returns the event count."""
        with self._lock:
            evs = list(self._events)
            dropped = self.dropped
        with open(path, "w") as fh:
            json.dump({"traceEvents": evs,
                       "displayTimeUnit": "ms"}, fh)
        if dropped:
            log.warning("chrome trace: %d events past max_events dropped",
                        dropped)
        log.info("chrome trace: %d events -> %s", len(evs), path)
        return len(evs)


_CHROME: Optional[ChromeTraceWriter] = None


def set_chrome_trace(writer: Optional[ChromeTraceWriter]) -> None:
    """Install a process-wide writer; StageTimers.stage() then records
    every stage as a trace event too."""
    global _CHROME
    _CHROME = writer


def chrome_trace() -> Optional[ChromeTraceWriter]:
    return _CHROME


class StageTimers:
    """Named stage timers with a PrintSyncTimer-style report.
    ``seconds`` holds each ``stage()`` call's host seconds per stage
    name (since the last ``reset``)."""

    def __init__(self) -> None:
        self._timers: Dict[str, Timer] = {}
        self.seconds: Dict[str, List[float]] = {}

    def __getitem__(self, name: str) -> Timer:
        t = self._timers.get(name)
        if t is None:
            t = self._timers[name] = Timer()
        return t

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[Timer]:
        t = self[name]
        t.resume()
        w = _CHROME  # snapshot: set_chrome_trace may race from other threads
        t0 = time.perf_counter()
        try:
            if w is not None:
                with w.event(name):
                    yield t
            else:
                yield t
        finally:
            self.seconds.setdefault(name, []).append(
                time.perf_counter() - t0)
            t.pause()

    def report(self, prefix: str = "") -> str:
        """One line per pass: 'stage=1.23s(xN)' (box_wrapper.cc:1182)."""
        parts = [
            f"{k}={t.elapsed_sec():.3f}s(x{t.count()})"
            for k, t in sorted(self._timers.items())
        ]
        line = f"{prefix}timers: " + " ".join(parts) if parts else "timers: -"
        log.info("%s", line)
        return line

    def reset(self) -> None:
        for t in self._timers.values():
            t.reset()
        self.seconds.clear()

    def as_dict(self) -> Dict[str, float]:
        return {k: t.elapsed_sec() for k, t in self._timers.items()}

    def counts(self) -> Dict[str, int]:
        return {k: t.count() for k, t in self._timers.items()}


TRACE_FILE = "trace.json"
#: small kernels launched on the card while the profiler warms up, before
#: its window opens. Late in a long process a trace opened cold lost the
#: first ~55 device events of its window (the first kernels of the step
#: it was meant to show); events of the warm-up fall before the window
#: and stay out of the trace
WARMUP_LAUNCHES = 256


def _warm_device(torch) -> None:
    """Launch :data:`WARMUP_LAUNCHES` one-element kernels on the current
    card and wait for them."""
    x = torch.zeros(1, device="cuda")
    for _ in range(WARMUP_LAUNCHES):
        x.add_(1.0)
    torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[Optional[object]]:
    """Device trace window (tier c): a ``torch.profiler.profile`` with
    the CPU activity, and the CUDA one when a card is present, whose
    chrome trace lands at ``<logdir>/trace.json`` on exit. The profiler
    starts in its warm-up state (device tracing on, nothing kept), runs
    :func:`_warm_device` on the card, and opens its recording window
    just before it yields, so the trace holds every device event of the
    body and none of the warm-up. Yields the profiler (``key_averages()``
    reads it), or None: a no-op unless ``FLAGS.profile`` or an explicit
    ``logdir`` is given (the flag's directory is
    ``paddlebox_tpu_torch_trace`` under the temp dir)."""
    target = logdir or (os.path.join(tempfile.gettempdir(),
                                      "paddlebox_tpu_torch_trace")
                        if FLAGS.profile else None)
    if target is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(target, exist_ok=True)
    prof = profile(activities=activities,
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.__enter__()
    try:
        if cuda:
            _warm_device(torch)
        prof.step()
        yield prof
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(target, TRACE_FILE)
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)
