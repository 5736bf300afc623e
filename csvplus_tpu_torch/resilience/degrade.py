"""Graceful degradation: circuit breaker + host-fallback oracle.

Copy of ``csvplus_tpu/resilience/degrade.py``.

When the device lookup path fails repeatedly (consecutive transient
failures past the breaker threshold), the serving tier flips to a
HOST fallback that computes the same answers on decoded host rows —
bitwise-identical by the repo's standing host/device parity contract —
instead of failing requests.  A half-open probe periodically retries
the device path and closes the breaker on success.

States (:class:`CircuitBreaker`):

* ``closed`` — primary (device) path; consecutive failures count up.
* ``open`` — fallback only; after ``cooldown_s`` the next route
  becomes a half-open probe.
* ``half-open`` — exactly one probe rides the primary path at a time;
  success closes the breaker, failure re-opens it (fresh cooldown).

All breaker state mutates under its own lock (``route`` /
``on_success`` / ``on_failure`` may be called from any thread).
"""

from __future__ import annotations

import threading
import time
from typing import Dict

__all__ = ["CLOSED", "HALF_OPEN", "OPEN", "CircuitBreaker", "HostLookupOracle"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing."""

    def __init__(
        self,
        threshold: int = 3,
        cooldown_s: float = 0.05,
        clock=time.perf_counter,
    ):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self._opened_total = 0

    def route(self) -> str:
        """Pick ``"primary"`` or ``"fallback"`` for the next unit of
        work; flips OPEN to HALF_OPEN (one probe at a time) once the
        cooldown has elapsed."""
        with self._lock:
            if self._state == CLOSED:
                return "primary"
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.cooldown_s:
                    return "fallback"
                self._state = HALF_OPEN
                self._probing = True
                return "primary"
            if self._probing:
                return "fallback"
            self._probing = True
            return "primary"

    def on_success(self) -> None:
        """The routed primary work succeeded: reset and close."""
        with self._lock:
            self._failures = 0
            self._probing = False
            self._state = CLOSED

    def on_failure(self) -> None:
        """The routed primary work failed (counting retries): trip when
        the consecutive-failure threshold is reached, or immediately
        when a half-open probe fails."""
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._state == HALF_OPEN or self._failures >= self.threshold:
                if self._state != OPEN:
                    self._opened_total += 1
                self._state = OPEN
                self._opened_at = self._clock()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> Dict:
        """JSON-safe breaker accounting for metrics/chaos artifacts."""
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "opened_total": self._opened_total,
            }


class HostLookupOracle:
    """Bitwise-identical host fallback for the coalesced lookup path.

    Lazily builds its OWN host-backed ``IndexImpl`` from the device
    table's decoded rows rather than materializing the registered
    impl: touching ``impl.rows`` would PERMANENTLY flip the primary
    impl's ``bounds_many`` onto its host branch (the device path is
    gated on ``_rows is None``), which would defeat half-open recovery.
    Host/device lookup parity is already test-enforced, so fallback
    results are bitwise-equal to the device path's.

    The one-time decode rides a device→host transfer of the already
    resident table; the breaker guards the exec/search path, not the
    transfer fabric, so this is the right degradation boundary.

    Unlike the reference, the oracle serves only tables of at most
    ``POINT_MIRROR_MAX_KEYS`` cells (:attr:`available`): above that the
    decode would build every row as host objects (tens of GB for a
    50M-row table) just when the card is short of memory, so the server
    lets such a batch fail with its own error instead.
    """

    def __init__(self, impl):
        self._impl = impl
        self._host = None
        self._lock = threading.Lock()

    @property
    def available(self) -> bool:
        """True when the fallback may serve this index: it is host-backed
        already, or its device table holds at most
        ``POINT_MIRROR_MAX_KEYS`` cells (the decode tier's own gate)."""
        impl = self._impl
        if impl.dev is None or impl._rows is not None:
            return True
        from ..ops.join import DeviceIndex

        table = impl.dev.table
        return table.nrows * max(len(table.columns), 1) <= DeviceIndex.POINT_MIRROR_MAX_KEYS

    def _host_impl(self):
        host = self._host
        if host is None:
            with self._lock:
                if self._host is None:
                    impl = self._impl
                    if impl.dev is None or impl._rows is not None:
                        # already host-backed: its bounds_many IS the
                        # host path, reuse it directly
                        self._host = impl
                    else:
                        from ..index import IndexImpl

                        self._host = IndexImpl(
                            impl.dev.table.to_rows(), impl.columns
                        )
                host = self._host
        return host

    def bounds_many(self, probes):
        return self._host_impl().bounds_many(probes)

    def rows_for_bounds(self, bounds):
        return self._host_impl().rows_for_bounds(bounds)
