"""Typed error taxonomy + deadline-aware bounded retry.

Copy of ``csvplus_tpu/resilience/retry.py``; a CUDA allocator failure
(``torch.cuda.OutOfMemoryError``) is the transient class the
reference's RESOURCE_EXHAUSTED marker names.  The reference's other
runtime status strings are not matched: torch raises none of them.

The taxonomy (:func:`classify`) splits failures into three kinds that
decide recovery policy everywhere the tree recovers:

* ``transient`` — device-side hiccups (the CUDA allocator running out
  of memory, injected device errors / worker crashes).  Retrying is
  sound: the input did not cause the failure.
* ``data`` — the reference library's own error family
  (:class:`~csvplus_tpu_torch.errors.CsvPlusError`: row-annotated source
  errors, deadline/overload admission errors, plan rejections) plus
  OSError/ValueError shapes.  Retrying re-fails identically; these
  surface typed to the caller, per the reference contract.
* ``fatal`` — everything else.  Never retried, never degraded-around;
  the dispatcher hardening converts one into
  :class:`ServerCrashed` for every pending future rather than hanging.

:func:`call_with_retry` is the one retry primitive: bounded attempts,
decorrelated-jitter backoff (seeded, lock-guarded rng), a ``time_left``
hook so a retry never sleeps past the request's remaining
``deadline_s`` budget, and a ``retry:backoff`` span recorded in any
active trace.  It retries ONLY transient failures.  Retries re-execute
cached executables: nothing is re-admitted or rebuilt.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

from ..errors import CsvPlusError
from .faults import (
    InjectedDeviceError,
    InjectedFatalError,
    InjectedWorkerCrash,
)

__all__ = [
    "DATA",
    "FATAL",
    "TRANSIENT",
    "RetryPolicy",
    "ServerCrashed",
    "call_with_retry",
    "classify",
]

TRANSIENT = "transient"
DATA = "data"
FATAL = "fatal"


class ServerCrashed(CsvPlusError):
    """The serving dispatcher died.  Every pending future and every
    subsequent submit fails fast with this error instead of hanging;
    the original failure rides along as ``cause``."""

    def __init__(self, cause: BaseException):
        self.cause = cause
        super().__init__(
            f"serving dispatcher crashed: {type(cause).__name__}: {cause}"
        )


def classify(err: BaseException) -> str:
    """Map an exception to ``transient`` / ``data`` / ``fatal``."""
    if isinstance(err, (InjectedDeviceError, InjectedWorkerCrash)):
        return TRANSIENT
    if isinstance(err, (InjectedFatalError, ServerCrashed)):
        return FATAL
    if isinstance(err, CsvPlusError):
        # DataSourceError, DeadlineExceeded, ServerOverloaded,
        # PlanRejected, InjectedIOError...: the input/request is wrong,
        # retrying re-fails identically
        return DATA
    if isinstance(err, (OSError, ValueError, KeyError, TypeError)):
        return DATA
    if type(err).__name__ == "OutOfMemoryError":  # torch.cuda's allocator failure
        return TRANSIENT
    # a CUDA runtime error (an illegal address, a launch failure) leaves
    # the context unusable: retrying cannot help
    return FATAL


class RetryPolicy:
    """Bounded attempts + decorrelated-jitter backoff.

    ``next_backoff`` follows the decorrelated-jitter recurrence
    ``sleep = min(cap, uniform(base, prev * 3))`` (AWS architecture
    blog shape): successive sleeps wander upward with jitter so
    coordinated retries decorrelate, capped to keep the worst case
    bounded.  The rng is seeded for deterministic chaos runs and
    lock-guarded (the policy object is shared across threads).
    """

    __slots__ = ("max_attempts", "base_s", "cap_s", "_rng", "_lock")

    def __init__(
        self,
        max_attempts: int = 3,
        base_s: float = 0.0005,
        cap_s: float = 0.02,
        seed: int = 0,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def next_backoff(self, prev_s: float) -> float:
        with self._lock:
            u = self._rng.uniform(self.base_s, max(self.base_s, prev_s * 3.0))
        return min(self.cap_s, u)


def call_with_retry(
    fn: Callable,
    *,
    policy: Optional[RetryPolicy] = None,
    time_left: Optional[Callable[[], Optional[float]]] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    site: str = "retry",
):
    """Call *fn*, retrying TRANSIENT failures up to the policy bound.

    Non-transient failures re-raise immediately.  Before each retry the
    remaining deadline budget (``time_left()``, seconds; None =
    unbounded) is checked — a backoff that cannot fit re-raises instead
    of sleeping past the deadline.  Each retry invokes *on_retry*
    (metrics/breaker accounting) and records a ``retry:backoff`` span
    in any active trace, so retried requests are visible in span trees.
    """
    pol = policy if policy is not None else RetryPolicy()
    sleep_s = pol.base_s
    attempt = 1
    while True:
        try:
            return fn()
        except Exception as err:
            kind = classify(err)
            if kind != TRANSIENT or attempt >= pol.max_attempts:
                if kind == FATAL:
                    # a fatal classification is a terminal path — dump
                    # the flight ring alongside the dispatcher-crash
                    # and views:refresh dumps (never raises)
                    from ..obs import flight as _flight

                    _flight.note(
                        "fatal", site=site, error=type(err).__name__,
                        attempt=attempt,
                    )
                    try:
                        _flight.dump(f"fatal:{site}", err)
                    except Exception as dump_err:
                        import sys

                        sys.stderr.write(
                            f"csvplus-flight: fatal-path dump failed "
                            f"({type(dump_err).__name__}: {dump_err})\n"
                        )
                raise
            sleep_s = pol.next_backoff(sleep_s)
            if time_left is not None:
                remaining = time_left()
                if remaining is not None and remaining <= sleep_s:
                    raise
            if on_retry is not None:
                on_retry(attempt, err)
            from ..obs.span import tracer

            with tracer.span(
                "retry:backoff",
                site=site,
                attempt=attempt,
                error=type(err).__name__,
            ):
                time.sleep(sleep_s)
            attempt += 1
