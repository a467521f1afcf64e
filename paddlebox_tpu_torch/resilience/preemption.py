"""Graceful preemption: stop flag, signal handlers and the resume marker
(copy of ``paddlebox_tpu/resilience/preemption.py``).

1. :func:`install_signal_handlers` turns SIGTERM/SIGINT into a
   process-wide stop flag (``request_stop`` is the programmatic seam).
2. ``Trainer.train_pass`` polls :func:`stop_requested` at every batch
   boundary, finishes the step in flight, writes an emergency checkpoint
   with a resume cursor and raises :class:`PreemptedError`, which
   ``Trainer.run_pass`` never retries.
3. A resume marker (``RESUME.json`` beside the checkpoints) and the exit
   code :data:`EXIT_RESUME` (75, ``EX_TEMPFAIL``) tell the launcher to
   restart and resume.

A ``fail`` fault at ``preempt.signal`` is a simulated SIGTERM: the poll
turns it into ``request_stop``, so ``preempt.signal:fail:nth=K`` stops
the loop at exactly the K-th batch boundary.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
from typing import Dict, Optional

from paddlebox_tpu_torch.resilience import faults
from paddlebox_tpu_torch.utils.fsio import atomic_write_json, read_json

log = logging.getLogger(__name__)

#: exit code for "preempted, restart and resume" (EX_TEMPFAIL)
EXIT_RESUME = 75

#: marker file written beside the checkpoints on a graceful shutdown
RESUME_MARKER = "RESUME.json"


class PreemptedError(RuntimeError):
    """Raised at a batch boundary after a stop request. Not a failure:
    ``Trainer.run_pass`` re-raises it untouched and the launcher exits
    :data:`EXIT_RESUME`. Carries the resume position."""

    def __init__(self, msg: str, step: Optional[int] = None,
                 batch_index: Optional[int] = None,
                 checkpoint_path: Optional[str] = None) -> None:
        super().__init__(msg)
        self.step = step
        self.batch_index = batch_index
        self.checkpoint_path = checkpoint_path

    @property
    def checkpointed(self) -> bool:
        return self.checkpoint_path is not None


_STOP = threading.Event()
_LOCK = threading.Lock()
_REASON: Optional[str] = None
_INSTALLED: Dict[int, object] = {}  # signum -> previous handler
#: set by the signal handler only, as a plain assignment: the handler
#: runs between bytecodes and may interrupt code holding _LOCK or the
#: logging lock, so it takes no lock. The next poll drains it.
_SIG_PENDING: Optional[str] = None


def request_stop(reason: str = "request_stop") -> None:
    """Arm the stop flag (idempotent: the first reason wins)."""
    global _REASON
    with _LOCK:
        first = not _STOP.is_set()
        if first:
            _REASON = reason
        _STOP.set()
    if not first:
        return
    log.warning("stop requested (%s): training will halt at the next "
                "batch boundary with an emergency checkpoint", reason)
    try:
        from paddlebox_tpu_torch.obs.hub import get_hub
        hub = get_hub()
        hub.counter("pbox_preempt_requests_total",
                    "graceful-shutdown requests received").inc()
        if hub.active:
            hub.emit("preempt_requested", reason=reason)
    except Exception:
        log.debug("preempt telemetry emit failed", exc_info=True)


def _drain_signal() -> None:
    """Promote a signal the handler recorded into a full stop request,
    from normal thread context."""
    global _SIG_PENDING
    reason = _SIG_PENDING
    if reason is not None:
        _SIG_PENDING = None
        request_stop(reason)


def stop_requested() -> bool:
    """The batch-boundary poll, and the ``preempt.signal`` seam: an
    injected ``fail`` here becomes a stop request, never an exception
    (every ``exc=`` variant, the plain ``OSError`` one included)."""
    _drain_signal()
    try:
        faults.inject("preempt.signal")
    except (faults.InjectedFault, OSError) as e:
        request_stop(f"injected:{e}")
    return _STOP.is_set()


def stop_pending() -> bool:
    """The flag WITHOUT the seam, for polls that are not batch
    boundaries (``run_pass`` between passes), so ``nth=K`` still counts
    batch boundaries."""
    _drain_signal()
    return _STOP.is_set()


def stop_reason() -> Optional[str]:
    return _REASON


def clear_stop() -> None:
    """Reset the flag (an in-process restart; tests)."""
    global _REASON, _SIG_PENDING
    with _LOCK:
        _STOP.clear()
        _REASON = None
        _SIG_PENDING = None


def _handler(signum, frame) -> None:
    """Lock-free: only records the signal; the next poll does the
    work."""
    global _SIG_PENDING
    if (_STOP.is_set() or _SIG_PENDING is not None) \
            and signum == signal.SIGINT:
        # a second ctrl-C means "now"
        raise KeyboardInterrupt
    _SIG_PENDING = f"signal:{signal.Signals(signum).name}"


def install_signal_handlers(signums=(signal.SIGTERM,
                                     signal.SIGINT)) -> bool:
    """Route SIGTERM/SIGINT into the stop flag. Idempotent; returns False
    off the main thread instead of raising. ``Trainer`` calls it when
    ``FLAGS.graceful_shutdown`` is set."""
    try:
        for s in signums:
            if s not in _INSTALLED:
                _INSTALLED[s] = signal.signal(s, _handler)
        return True
    except ValueError:
        log.warning("signal handlers need the main thread — graceful "
                    "shutdown will rely on request_stop() only")
        return False


def uninstall_signal_handlers() -> None:
    for s, prev in list(_INSTALLED.items()):
        try:
            signal.signal(s, prev)
        except (ValueError, TypeError):
            pass
        del _INSTALLED[s]


# ---- resume marker -----------------------------------------------------
def write_resume_marker(root: str, **info) -> str:
    """Atomically publish ``RESUME.json`` under the checkpoint root;
    ``info`` usually carries step, batch_index and reason."""
    os.makedirs(root, exist_ok=True)
    return atomic_write_json(os.path.join(root, RESUME_MARKER),
                             dict(info, exit_code=EXIT_RESUME))


def read_resume_marker(root: str) -> Optional[dict]:
    return read_json(os.path.join(root, RESUME_MARKER))


def clear_resume_marker(root: str) -> bool:
    """Consume the marker (the resumed run, once it adopted the cursor).
    True if a marker was removed."""
    try:
        os.unlink(os.path.join(root, RESUME_MARKER))
        return True
    except OSError:
        return False
