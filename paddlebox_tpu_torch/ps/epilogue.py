"""The pipeline hang deadline — from ``paddlebox_tpu/ps/epilogue.py``.

Only ``PipelineHangError``, ``hang_timeout`` and ``wait_with_deadline``
are ported: the pass preloader's ``wait`` (``train/device_pass.py``)
uses them. The asynchronous end-pass write-back (``PassEpilogue``) and
its fence belong to the tiered store and wait for it (ROADMAP queue 1,
item 10); the hang counter and the flight-recorder trigger wait for the
observability layer (item 13).
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from paddlebox_tpu_torch.config import FLAGS


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


def wait_with_deadline(cv: threading.Condition, done: Callable[[], bool],
                       progress: Callable[[], object],
                       message: Callable[[], str]) -> None:
    """The timed condition wait with the hang deadline. Call with ``cv``
    HELD; returns once ``done()`` is true. With
    ``FLAGS.pipeline_wait_timeout_sec > 0``, an unchanged ``progress()``
    value for that long raises ``PipelineHangError`` with ``message()``,
    which names the stuck stage."""
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
            raise PipelineHangError(message())
