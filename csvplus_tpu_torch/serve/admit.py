"""Admission control for the serving tier (copy of
``csvplus_tpu/serve/admit.py``).

A server that queues without bound converts overload into unbounded
latency and memory; the serving tier instead sheds at admission.  Two
typed errors (both :class:`~csvplus_tpu_torch.errors.CsvPlusError` subclasses
so callers can catch the library-wide base):

* :class:`ServerOverloaded` — raised by ``submit`` when the pending
  queue is at its bound (``max_pending``, default 8192).  The
  request was NEVER enqueued; the caller owns retry policy.
* :class:`DeadlineExceeded` — delivered as a request's *result* when its
  deadline passed before dispatch.  Deadlines are checked at drain time,
  before the batched device call, so an expired request never consumes
  lookup work (its slot in the batch is simply dropped).
"""

from __future__ import annotations

import time
from typing import Optional

from ..errors import CsvPlusError

#: Default bound on the pending-request queue (overridden per server).
DEFAULT_QUEUE_BOUND = 8192


class ServerOverloaded(CsvPlusError):
    """Request rejected at admission: the pending queue is at its bound."""

    def __init__(self, pending: int, bound: int):
        self.pending = int(pending)
        self.bound = int(bound)
        super().__init__(
            f"server overloaded: {self.pending} pending requests at "
            f"bound {self.bound} — request shed, not enqueued"
        )


class DeadlineExceeded(CsvPlusError):
    """Request expired before dispatch: its deadline passed while queued."""

    def __init__(self, waited_s: float, deadline_s: float):
        self.waited_s = float(waited_s)
        self.deadline_s = float(deadline_s)
        super().__init__(
            f"deadline exceeded: waited {self.waited_s * 1e3:.2f}ms of a "
            f"{self.deadline_s * 1e3:.2f}ms budget before dispatch"
        )


class AdmissionController:
    """Bounded-queue admission + pre-dispatch deadline policy.

    Stateless beyond its configuration: the server owns the queue and
    passes the observed depth in, so admission needs no lock of its own
    (the caller already holds the queue lock when it asks).
    """

    def __init__(self, max_pending: Optional[int] = None):
        self.max_pending = int(
            DEFAULT_QUEUE_BOUND if max_pending is None else max_pending
        )

    def admit(self, depth: int) -> None:
        """Raise :class:`ServerOverloaded` when the queue is full.

        *depth* is the pending count BEFORE the new request; admission
        succeeds while ``depth < max_pending``.
        """
        if depth >= self.max_pending:
            raise ServerOverloaded(depth, self.max_pending)

    @staticmethod
    def deadline_error(
        t_submit: float, deadline_s: Optional[float], now: Optional[float] = None
    ) -> Optional[DeadlineExceeded]:
        """The expiry error for a request submitted at *t_submit* with a
        relative *deadline_s* budget, or ``None`` while still live."""
        if deadline_s is None:
            return None
        waited = (time.perf_counter() if now is None else now) - t_submit
        if waited > deadline_s:
            return DeadlineExceeded(waited, deadline_s)
        return None
