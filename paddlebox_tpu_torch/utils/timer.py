"""Pause/resume wall timers used across pipeline stages (copy of
``paddlebox_tpu/utils/timer.py``).

Reference: paddle/fluid/platform/timer.h:31 (``platform::Timer``) — the same
Start/Pause/Resume/ElapsedSec contract used by every pass stage and by
``DeviceBoxData`` per-device timers (fleet/box_wrapper.h:394-403).
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._elapsed = 0.0
        self._start: float | None = None
        self._count = 0

    def start(self) -> None:
        self._elapsed = 0.0
        self._count = 0
        self._start = time.perf_counter()

    def pause(self) -> None:
        if self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None
            self._count += 1

    def resume(self) -> None:
        if self._start is None:
            self._start = time.perf_counter()

    def elapsed_sec(self) -> float:
        live = time.perf_counter() - self._start if self._start is not None else 0.0
        return self._elapsed + live

    def elapsed_ms(self) -> float:
        return self.elapsed_sec() * 1e3

    def elapsed_us(self) -> float:
        return self.elapsed_sec() * 1e6

    def count(self) -> int:
        return self._count

    def __enter__(self) -> "Timer":
        self.resume()
        return self

    def __exit__(self, *exc: object) -> None:
        self.pause()
