"""Event/span sinks for the TelemetryHub.
(Copy of ``paddlebox_tpu/obs/sinks.py``.)

Event sinks receive one dict per emitted event (pass summaries,
watchdog alerts, warmup outcomes...); span sinks receive completed
timed spans. ``JsonlSink`` is the structured-log backend (one JSON
object per line, flushed per event — events fire at pass granularity,
not per batch, so durability beats buffering); ``MemorySink`` backs
tests; ``ChromeSpanSink`` adapts the existing
``utils.profiler.ChromeTraceWriter`` so hub spans land in the same
chrome://tracing timeline as StageTimers stages.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional


class JsonlSink:
    """Append one JSON line per event to ``path``.

    With ``max_bytes > 0`` the live segment rotates logrotate-style
    once it reaches that size: ``path`` → ``path.1``, older segments
    shift to ``path.2`` … ``path.<keep>``, anything beyond ``keep`` is
    dropped — an always-on daemon's event log stays bounded at roughly
    ``(keep + 1) * max_bytes``. ``tools/telemetry_report.py`` reads a
    rotated set back oldest-first automatically."""

    def __init__(self, path: str, truncate: bool = False,
                 max_bytes: int = 0, keep: int = 3) -> None:
        self.path = path
        self.max_bytes = int(max_bytes)
        self.keep = max(int(keep), 1)
        self._lock = threading.Lock()
        self._fh = open(path, "w" if truncate else "a")

    def emit(self, event: Dict) -> None:
        line = json.dumps(event, default=str)
        with self._lock:
            if self._fh.closed:
                return
            self._fh.write(line + "\n")
            self._fh.flush()
            if self.max_bytes > 0 \
                    and self._fh.tell() >= self.max_bytes:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Shift ``path.i`` → ``path.i+1`` (dropping past ``keep``),
        move the live file to ``path.1`` and reopen fresh. Rename
        failures leave the sink appending to the live file — rotation
        is best-effort, losing events is not an option."""
        try:
            self._fh.close()
            last = f"{self.path}.{self.keep}"
            if os.path.exists(last):
                os.unlink(last)
            for i in range(self.keep - 1, 0, -1):
                seg = f"{self.path}.{i}"
                if os.path.exists(seg):
                    os.replace(seg, f"{self.path}.{i + 1}")
            os.replace(self.path, f"{self.path}.1")
        except OSError:
            pass
        self._fh = open(self.path, "a")

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()


class MemorySink:
    """In-process event buffer (tests, REPL inspection)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.events: List[Dict] = []

    def emit(self, event: Dict) -> None:
        with self._lock:
            self.events.append(event)

    def close(self) -> None:
        pass


class ChromeSpanSink:
    """Span sink → ChromeTraceWriter: hub spans render as X events on
    the same host-orchestration timeline as StageTimers stages. Pass an
    explicit writer, or None to follow whatever writer is installed via
    ``utils.profiler.set_chrome_trace`` at span time."""

    def __init__(self, writer=None) -> None:
        self._writer = writer

    def span(self, name: str, start_s: float, dur_s: float,
             attrs: Optional[Dict] = None) -> None:
        w = self._writer
        if w is None:
            from paddlebox_tpu_torch.utils.profiler import chrome_trace
            w = chrome_trace()
        if w is not None:
            w.complete(name, start_s, dur_s, **(attrs or {}))

    def close(self) -> None:
        pass
