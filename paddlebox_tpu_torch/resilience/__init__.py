"""Resilience layer of the port: retry with seeded backoff
(:mod:`.retry`), deterministic fault injection (:mod:`.faults`) and
graceful preemption (:mod:`.preemption`). Copies of the reference's
host-only modules; the restore consensus waits for the multi-host
port."""

from paddlebox_tpu_torch.resilience.retry import (RetryExhausted,
                                                  RetryPolicy,
                                                  TransientError,
                                                  is_retryable)
from paddlebox_tpu_torch.resilience.faults import (FaultPlan, FaultSpec,
                                                   InjectedCrash,
                                                   InjectedFault,
                                                   TransientInjectedError,
                                                   active_plan, clear_plan,
                                                   inject, install_plan,
                                                   installed)
from paddlebox_tpu_torch.resilience.preemption import (
    EXIT_RESUME, PreemptedError, clear_stop, install_signal_handlers,
    request_stop, stop_requested)

__all__ = [
    "RetryPolicy", "RetryExhausted", "TransientError", "is_retryable",
    "FaultPlan", "FaultSpec", "InjectedFault", "InjectedCrash",
    "TransientInjectedError", "inject", "install_plan", "clear_plan",
    "active_plan", "installed",
    "PreemptedError", "EXIT_RESUME", "request_stop", "stop_requested",
    "clear_stop", "install_signal_handlers",
]
