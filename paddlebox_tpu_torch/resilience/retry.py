"""RetryPolicy — exponential backoff with seeded jitter for IO seams
(copy of ``paddlebox_tpu/resilience/retry.py``).

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
    error. Subclassed by ``TransientCommandError`` (utils/file_mgr) and
    ``TransientInjectedError`` (resilience/faults)."""


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
                  jitter=FLAGS.retry_jitter,
                  seed=FLAGS.seed)
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
            self._note_retry(attempts, delay, last)
            self.sleep(delay)

    def _note_retry(self, attempt: int, delay: float,
                    exc: BaseException) -> None:
        """Log the retry and book ``pbox_retry_attempts_total{site}``
        (plus a ``retry`` event when a sink is attached)."""
        log.warning("%s: attempt %d failed (%r) — retrying in %.3fs",
                    self.site or "retry", attempt, exc, delay)
        try:
            from paddlebox_tpu_torch.obs.hub import get_hub
            hub = get_hub()
            hub.counter("pbox_retry_attempts_total",
                        "IO retries per seam").inc(site=self.site or "?")
            if hub.active:
                hub.emit("retry", site=self.site, attempt=attempt,
                         delay_sec=round(delay, 4), error=repr(exc))
        except Exception:  # telemetry must never take the retry down
            log.debug("retry telemetry emit failed", exc_info=True)

    def wrap(self, fn: Callable) -> Callable:
        """Decorator form of :meth:`call`."""
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped


def retry_counters() -> dict:
    """Snapshot of the resilience counters (the ``resilience`` block the
    per-pass telemetry event carries — obs/hub.emit_pass_event)."""
    from paddlebox_tpu_torch.obs.hub import get_hub
    hub = get_hub()

    def total(name: str) -> float:
        return sum(v for _, v in hub.counter(name).series())

    return {
        "retry_attempts": total("pbox_retry_attempts_total"),
        "files_quarantined": total("pbox_files_quarantined_total"),
        "records_poisoned": total("pbox_records_poisoned_total"),
        "faults_injected": total("pbox_faults_injected_total"),
        "pass_retries": total("pbox_pass_retries_total"),
    }
