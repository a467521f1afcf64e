"""Resilience layer of the port: retry with seeded backoff
(:mod:`.retry`), deterministic fault injection (:mod:`.faults`),
graceful preemption (:mod:`.preemption`) and the shared-dir consensus
of multihost-consistent recovery (:mod:`.consensus`: every process
restores the same agreed step and drops the same quarantined files).
Copies of the reference's host-only modules."""

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
from paddlebox_tpu_torch.resilience.consensus import (
    ConsensusTimeout, DirConsensusStore, RestoreConsensus,
    consensus_restore, sync_shared_quarantine)

__all__ = [
    "RetryPolicy", "RetryExhausted", "TransientError", "is_retryable",
    "FaultPlan", "FaultSpec", "InjectedFault", "InjectedCrash",
    "TransientInjectedError", "inject", "install_plan", "clear_plan",
    "active_plan", "installed",
    "PreemptedError", "EXIT_RESUME", "request_stop", "stop_requested",
    "clear_stop", "install_signal_handlers",
    "RestoreConsensus", "DirConsensusStore", "ConsensusTimeout",
    "consensus_restore", "sync_shared_quarantine",
]
