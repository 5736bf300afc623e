"""Fault injection, retry, and graceful degradation.

Copy of ``csvplus_tpu/resilience``:

* :mod:`.faults` — seeded deterministic fault injection at the serving
  tier's and the executor's boundaries (``CSVPLUS_FAULTS`` env or
  in-process plans); one global None-check per site when disarmed.
* :mod:`.retry` — the transient/data/fatal taxonomy and the one
  deadline-aware bounded-retry primitive (decorrelated jitter, spans).
* :mod:`.degrade` — the circuit breaker and the host-fallback lookup
  oracle the serving tier degrades onto (rows equal to the device
  path's).
"""

from .degrade import CircuitBreaker, HostLookupOracle
from .faults import (
    FaultPlan,
    FaultSpec,
    InjectedDeviceError,
    InjectedFatalError,
    InjectedIOError,
    InjectedWorkerCrash,
    inject,
    plan_from_env,
)
from .retry import RetryPolicy, ServerCrashed, call_with_retry, classify

__all__ = [
    "CircuitBreaker",
    "FaultPlan",
    "FaultSpec",
    "HostLookupOracle",
    "InjectedDeviceError",
    "InjectedFatalError",
    "InjectedIOError",
    "InjectedWorkerCrash",
    "RetryPolicy",
    "ServerCrashed",
    "call_with_retry",
    "classify",
    "inject",
    "plan_from_env",
]
