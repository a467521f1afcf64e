"""Anomaly flight recorder — the always-on black box.
(Copy of ``paddlebox_tpu/obs/flightrec.py``.)

A bounded in-memory ring of the most recent telemetry (events, spans,
critical-path blocks) plus a trigger registry. When an anomaly fires —
a NaN rollback, a refused serving reload, a ``PipelineHangError``, a
watchdog escalation, an SLO breach from the alert engine, or an
explicit ``hub.dump_blackbox(reason)`` — the recorder atomically
publishes ONE self-contained postmortem bundle: the ring contents, a
``snapshot()`` of every instrument, the last-N critical-path blocks,
the resolved FLAGS, live thread stacks (``sys._current_frames``) and
the run/pass identity, via the same write-tmp → fsync → ``os.replace``
discipline as the artifact layer (``utils.fsio.atomic_write_json``).

Hot-loop contract (same as ``trace.py``): with no recorder installed,
``trigger()`` is one module-global read; the ring itself only receives
records while it is registered as a hub sink, which only happens when
``FLAGS.flightrec_dir`` is set — default-off runs stay bit-identical.
Per-trigger debounce collapses anomaly storms into one bundle per
window, and a retention cap bounds the on-disk footprint.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

from paddlebox_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: bundle schema version (bump on layout changes; consumers check it)
BUNDLE_SCHEMA = 1

#: the trigger catalog (docs/OBSERVABILITY.md §Flight recorder). Names
#: outside this set are rejected — a typo'd trigger must fail loudly in
#: tests, not silently produce an unknown bundle family.
TRIGGERS = ("nan_rollback", "reload_degrade", "pipeline_hang",
            "watchdog_escalation", "slo_breach", "manual",
            "shrink_skipped", "online_degrade", "membership_change")

#: critical-path blocks retained for the bundle (newest last)
KEEP_CRITICAL_PATH = 16


class FlightRecorder:
    """Ring buffer + trigger registry + atomic bundle publisher.

    Registers on the hub as a dual (event + span) sink; ``emit`` /
    ``span_full`` appends are lock-light (one deque append under the
    GIL — no explicit lock on the record path)."""

    def __init__(self, out_dir: str, ring_events: int = 512,
                 debounce_sec: float = 60.0, keep: int = 16) -> None:
        self.out_dir = out_dir
        self.debounce_sec = float(debounce_sec)
        self.keep = int(keep)
        self._ring: collections.deque = collections.deque(
            maxlen=max(int(ring_events), 1))
        self._cp: collections.deque = collections.deque(
            maxlen=KEEP_CRITICAL_PATH)
        # trigger bookkeeping under one small lock (trigger paths are
        # cold — they fire on anomalies, never per event)
        self._lock = threading.Lock()
        self._last_fire: Dict[str, float] = {}
        self._seq = 0
        os.makedirs(out_dir, exist_ok=True)

    # ---- sink surface (the ring) ---------------------------------------
    def emit(self, event: Dict) -> None:
        """Event-sink surface: record every hub event; stash the pass
        events' critical-path blocks separately so the bundle carries
        them even after the ring wrapped."""
        self._ring.append({"rec": "event", **event})
        cp = event.get("critical_path")
        if cp:
            self._cp.append({"pass_seq": event.get("pass_seq"),
                             "seq": event.get("seq"), **cp})

    def span_full(self, rec: Dict) -> None:
        """Rich span-sink surface (obs/trace fan-out)."""
        self._ring.append({"rec": "span", **rec})

    def span(self, name: str, start_s: float, dur_s: float,
             attrs: Optional[Dict] = None) -> None:
        """Plain span-sink surface (hub.span fan-out)."""
        self._ring.append({"rec": "span", "name": name, "t0": start_s,
                           "dur": dur_s, **(attrs or {})})

    def close(self) -> None:
        pass

    # ---- triggers ------------------------------------------------------
    def trigger(self, name: str, reason: str = "",
                **ctx) -> Optional[str]:
        """Fire trigger ``name``: publish one postmortem bundle unless
        the per-trigger debounce window is still open. Returns the
        bundle path (None when debounced or the publish failed — a
        failing black box must never compound the anomaly it records).
        """
        if name not in TRIGGERS:
            raise ValueError(f"unknown flight-recorder trigger {name!r} "
                             f"(catalog: {TRIGGERS})")
        now = time.monotonic()
        with self._lock:
            last = self._last_fire.get(name)
            if last is not None and now - last < self.debounce_sec:
                self._book("pbox_flightrec_suppressed_total",
                           "debounced flight-recorder triggers", name)
                return None
            self._last_fire[name] = now
            self._seq += 1
            seq = self._seq
        try:
            path = self._publish(seq, name, reason, ctx)
        except Exception:
            log.error("flight recorder bundle publish failed (%s)",
                      name, exc_info=True)
            return None
        self._book("pbox_flightrec_bundles_total",
                   "postmortem bundles published", name)
        try:
            from paddlebox_tpu_torch.obs.hub import get_hub
            hub = get_hub()
            if hub.active:
                hub.emit("blackbox_dump", trigger=name, reason=reason,
                         path=path)
        except Exception:
            log.debug("blackbox_dump event emit failed", exc_info=True)
        log.error("flight recorder: trigger %r (%s) → %s", name,
                  reason or "-", path)
        return path

    @staticmethod
    def _book(counter: str, help: str, name: str) -> None:
        try:
            from paddlebox_tpu_torch.obs.hub import get_hub
            get_hub().counter(counter, help).inc(trigger=name)
        except Exception:
            log.debug("flightrec counter failed", exc_info=True)

    # ---- bundle assembly -----------------------------------------------
    def _publish(self, seq: int, name: str, reason: str,
                 ctx: Dict) -> str:
        from paddlebox_tpu_torch.config import FLAGS
        from paddlebox_tpu_torch.obs.hub import get_hub
        from paddlebox_tpu_torch.utils.fsio import atomic_write_json
        hub = get_hub()
        bundle = {
            "schema": BUNDLE_SCHEMA,
            "trigger": name,
            "reason": reason,
            "ctx": {k: _jsonable(v) for k, v in ctx.items()},
            "ts": time.time(),
            "run": hub.run_id,
            "health": hub.health(),        # run/pass ids + uptime
            "ring": [dict(r) for r in list(self._ring)],
            "instruments": hub.snapshot(),
            "critical_path": list(self._cp),
            "flags": {k: _jsonable(v) for k, v in
                      dataclasses.asdict(FLAGS).items()},
            "threads": self._thread_stacks(),
        }
        path = os.path.join(self.out_dir,
                            f"blackbox-{seq:05d}-{name}.json")
        atomic_write_json(path, bundle)
        self._retain()
        return path

    @staticmethod
    def _thread_stacks() -> Dict[str, Dict]:
        names = {t.ident: t.name for t in threading.enumerate()}
        out: Dict[str, Dict] = {}
        for tid, frame in sys._current_frames().items():
            out[str(tid)] = {
                "name": names.get(tid, "?"),
                "stack": [ln.rstrip("\n") for ln in
                          traceback.format_stack(frame)],
            }
        return out

    def _retain(self) -> None:
        """Keep the newest ``keep`` bundles (bundle names embed a
        monotone sequence number, so lexical order IS age order)."""
        if self.keep <= 0:
            return
        try:
            bundles = sorted(f for f in os.listdir(self.out_dir)
                             if f.startswith("blackbox-")
                             and f.endswith(".json"))
            for stale in bundles[:-self.keep]:
                os.unlink(os.path.join(self.out_dir, stale))
        except OSError:
            log.debug("bundle retention sweep failed", exc_info=True)

    def bundles(self) -> List[str]:
        """Bundle paths on disk, oldest first."""
        return [os.path.join(self.out_dir, f)
                for f in sorted(os.listdir(self.out_dir))
                if f.startswith("blackbox-") and f.endswith(".json")]


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)


# ---- module-level registry (the one-global-read inert path) ------------
_RECORDER: Optional[FlightRecorder] = None
_configured_dir: Optional[str] = None


def get_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def install_recorder(rec: Optional[FlightRecorder],
                     attach: bool = True) -> Optional[FlightRecorder]:
    """Install ``rec`` as the process flight recorder (None uninstalls)
    and register/deregister it as a hub sink. The previous recorder (if
    any) is detached from the hub."""
    global _RECORDER, _configured_dir
    from paddlebox_tpu_torch.obs.hub import get_hub
    hub = get_hub()
    if _RECORDER is not None:
        hub.remove_sink(_RECORDER)
    _RECORDER = rec
    if rec is None:
        _configured_dir = None
    elif attach:
        hub.add_sink(rec, kind="both")
    return rec


def configure_from_flags() -> Optional[FlightRecorder]:
    """Install a recorder when ``FLAGS.flightrec_dir`` is set
    (idempotent per dir; called from ``obs.hub.configure_from_flags``).
    """
    global _configured_dir
    from paddlebox_tpu_torch.config import FLAGS
    d = FLAGS.flightrec_dir
    if not d:
        return _RECORDER
    if d == _configured_dir and _RECORDER is not None:
        return _RECORDER
    rec = FlightRecorder(d, ring_events=FLAGS.flightrec_ring_events,
                         debounce_sec=FLAGS.flightrec_debounce_sec,
                         keep=FLAGS.flightrec_keep)
    install_recorder(rec)
    _configured_dir = d
    return rec


def trigger(name: str, reason: str = "", **ctx) -> Optional[str]:
    """Fire a flight-recorder trigger. With no recorder installed this
    is one module-global read — the seams (trainer NaN rollback,
    serving reload degrade, pipeline hang, watchdog escalation, alert
    engine) call it unconditionally."""
    rec = _RECORDER
    if rec is None:
        return None
    try:
        return rec.trigger(name, reason=reason, **ctx)
    except Exception:
        # a broken black box must never take the recovering run down
        log.error("flight recorder trigger %r failed", name,
                  exc_info=True)
        return None
