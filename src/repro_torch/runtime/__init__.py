"""Runtime: continuous batching, the training supervisor, fault injection
and retry."""

from .faults import (Fault, FaultPlan, HostTimeoutError,
                     InjectedDeterministicFault, InjectedFault, RetryPolicy,
                     fault_scope, trip)
from .supervisor import StepStats, Supervisor, TransientError

__all__ = ["Batcher", "Request", "StepStats", "Supervisor", "TransientError",
           "Fault", "FaultPlan", "HostTimeoutError", "InjectedFault",
           "InjectedDeterministicFault", "RetryPolicy", "fault_scope",
           "trip"]


def __getattr__(name):
    # the batcher pulls in the model and graph builders: import it lazily
    if name in ("Batcher", "Request"):
        from . import batcher
        return getattr(batcher, name)
    raise AttributeError(name)
