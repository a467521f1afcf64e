"""RetryPolicy — exponential backoff with seeded jitter for IO seams
(copy of ``paddlebox_tpu/resilience/retry.py`` without the telemetry
counters).

- Bounded: an attempt cap and a wall-clock deadline; a flaky seam
  degrades a run, it never wedges one.
- Deterministic: jitter comes from a ``random.Random`` seeded from
  ``(seed, site)``, so two runs with the same seed sleep the same delays.
- Classified: only transient failures retry. ``TransientError`` (and the
  injected-fault subclass), ``OSError`` and subprocess timeouts are
  transient by default; programming errors never are.

Usage::

    policy = RetryPolicy.from_flags(site="checkpoint.io")
    out = policy.call(read_meta, path)
"""

from __future__ import annotations

import dataclasses
import logging
import random
import subprocess
import time
from typing import Callable, Optional, Tuple, Type

log = logging.getLogger(__name__)


class TransientError(RuntimeError):
    """A failure worth retrying: transient IO trouble, not a programming
    error. Subclassed by ``TransientInjectedError`` (resilience/faults)."""


class RetryExhausted(RuntimeError):
    """Raised when a policy gives up; ``__cause__`` is the last error."""

    def __init__(self, msg: str, attempts: int,
                 last: BaseException) -> None:
        super().__init__(msg)
        self.attempts = attempts
        self.last = last


#: exception types retryable by default at every seam
DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    TransientError, OSError, subprocess.TimeoutExpired, TimeoutError)

#: deterministic filesystem outcomes: retrying cannot change them, so they
#: propagate on the first attempt even where OSError is retryable
NON_TRANSIENT_OS: Tuple[Type[BaseException], ...] = (
    FileNotFoundError, NotADirectoryError, IsADirectoryError,
    FileExistsError, PermissionError)


def is_retryable(exc: BaseException,
                 retryable: Tuple[Type[BaseException], ...]
                 = DEFAULT_RETRYABLE) -> bool:
    """True when ``exc`` is classified transient (worth a retry)."""
    if isinstance(exc, NON_TRANSIENT_OS):
        return False
    return isinstance(exc, retryable)


@dataclasses.dataclass
class RetryPolicy:
    """Attempt k (1-based) sleeps ``min(max_delay, base_delay * 2**(k-1))``
    scaled by a seeded jitter factor in ``[1-jitter, 1+jitter]``.
    ``max_attempts`` counts tries (1 = no retry); ``deadline`` bounds the
    wall time one ``call`` spends across tries and sleeps."""

    site: str = ""
    max_attempts: int = 4
    base_delay: float = 0.05
    max_delay: float = 2.0
    deadline: Optional[float] = 30.0
    jitter: float = 0.25
    seed: int = 0
    retryable: Tuple[Type[BaseException], ...] = DEFAULT_RETRYABLE
    # optional override: classify(exc) -> bool decides retryability
    classify: Optional[Callable[[BaseException], bool]] = None
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic

    @classmethod
    def from_flags(cls, site: str = "", **overrides) -> "RetryPolicy":
        """Policy from the process-wide ``FLAGS.retry_*`` knobs."""
        from paddlebox_tpu_torch.config import FLAGS
        kw = dict(site=site,
                  max_attempts=FLAGS.retry_max_attempts,
                  base_delay=FLAGS.retry_base_delay_sec,
                  max_delay=FLAGS.retry_max_delay_sec,
                  deadline=(FLAGS.retry_deadline_sec
                            if FLAGS.retry_deadline_sec > 0 else None),
                  jitter=FLAGS.retry_jitter)
        kw.update(overrides)
        return cls(**kw)

    def delays(self):
        """The deterministic backoff schedule, one delay per retry."""
        rng = random.Random(f"{self.seed}:{self.site}")
        for k in range(1, max(1, self.max_attempts)):
            # the exponent clamp keeps a long schedule from overflowing
            # float(); min() has plateaued at max_delay long before
            d = min(self.max_delay,
                    self.base_delay * (2.0 ** min(k - 1, 64)))
            if self.jitter > 0:
                d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
            yield max(0.0, d)

    def _is_retryable(self, exc: BaseException) -> bool:
        if self.classify is not None:
            return bool(self.classify(exc))
        return is_retryable(exc, self.retryable)

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` under this policy. Non-retryable
        errors propagate untouched on the first attempt; exhausting the
        policy raises ``RetryExhausted`` with the last error chained."""
        start = self.clock()
        attempts = 0
        last: Optional[BaseException] = None
        schedule = self.delays()
        while True:
            attempts += 1
            try:
                return fn(*args, **kwargs)
            except BaseException as e:
                if not self._is_retryable(e):
                    raise
                last = e
            delay = next(schedule, None)
            elapsed = self.clock() - start
            over_deadline = (self.deadline is not None
                             and elapsed + (delay or 0.0) > self.deadline)
            if delay is None or over_deadline:
                why = "deadline" if over_deadline else "attempts"
                raise RetryExhausted(
                    f"{self.site or 'retry'}: gave up after {attempts} "
                    f"attempt(s) ({why} exhausted, {elapsed:.2f}s): "
                    f"{last!r}", attempts, last) from last
            log.warning("%s: attempt %d failed (%r) — retrying in %.3fs",
                        self.site or "retry", attempts, last, delay)
            self.sleep(delay)

    def wrap(self, fn: Callable) -> Callable:
        """Decorator form of :meth:`call`."""
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped
