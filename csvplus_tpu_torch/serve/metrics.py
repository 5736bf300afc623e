"""Serving metrics: counters, batch histogram, latency reservoir.

Copy of ``csvplus_tpu/serve/metrics.py``; the snapshot has the
reference's keys.  The per-index write cells are fed by the server's
writes, the per-view cells by each live view's refresh and reads
(:meth:`ServingMetrics.on_view_refresh`, :meth:`ServingMetrics.on_view_read`).

The serving tier's observability surface, built on the
:mod:`csvplus_tpu_torch.utils.observe` conventions: cheap always-on counters
here (a served request must not pay telemetry's record-keeping), with
every dispatch cycle ALSO mirrored into the process-global ``telemetry``
singleton as a ``serve:dispatch`` stage when the caller has enabled it —
so serving cycles land in the same per-stage table as ingest and join
stages (``merged_stages`` accumulates their ``_s`` extras).

Everything is exportable as one JSON-safe ``snapshot()`` dict
(``chip_smoke.py`` prints the serving phase's).

Thread model: a :class:`ServingMetrics` instance is a monitor — every
mutating method takes the instance lock.  Writers are the dispatcher
thread (batch/tick/latency) and submitting caller threads (enqueue/shed),
so lock scope is a few integer bumps, never a device call.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional

#: Bounded latency-sample pool: 4096 samples keep the p99 estimate
#: stable while keeping snapshots O(1)-ish.
RESERVOIR_CAP = 4096

#: ``snapshot()`` shape version.  The Prometheus exposition mapping
#: (``csvplus_tpu_torch.obs.metrics.serve_samples``) consumes the
#: snapshot dict — bump this when top-level or per-index/per-view cell
#: keys change.
SNAPSHOT_SCHEMA_VERSION = 1


class LatencyReservoir:
    """Bounded uniform reservoir of latency samples (seconds).

    Algorithm-R replacement with a SEEDED rng: two runs over the same
    request stream produce the same p50/p99.  Not internally locked — owned and guarded by
    :class:`ServingMetrics`.
    """

    __slots__ = ("_samples", "_count", "_cap", "_rng")

    def __init__(self, cap: int = RESERVOIR_CAP, seed: int = 0):
        self._samples: List[float] = []
        self._count = 0
        self._cap = int(cap)
        self._rng = random.Random(seed)

    def record(self, seconds: float) -> None:
        self._count += 1
        if len(self._samples) < self._cap:
            self._samples.append(seconds)
        else:
            j = self._rng.randrange(self._count)
            if j < self._cap:
                self._samples[j] = seconds

    @property
    def count(self) -> int:
        return self._count

    def quantile(self, q: float) -> Optional[float]:
        """The *q*-quantile (0..1) of the sampled latencies, or ``None``
        when nothing was recorded.  Nearest-rank on the sorted pool."""
        if not self._samples:
            return None
        s = sorted(self._samples)
        rank = min(len(s) - 1, max(0, int(q * len(s))))
        return s[rank]

    def snapshot(self) -> Dict[str, object]:
        return {
            "count": self._count,
            "p50_ms": _ms(self.quantile(0.50)),
            "p90_ms": _ms(self.quantile(0.90)),
            "p99_ms": _ms(self.quantile(0.99)),
            "max_ms": _ms(max(self._samples) if self._samples else None),
        }


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else round(seconds * 1e3, 4)


def _new_index_cell() -> Dict[str, object]:
    """A fresh per-index counter cell (created under the monitor lock
    on first touch of each index name)."""
    return {
        "lookups": 0,
        "append_reqs": 0,
        "delete_reqs": 0,
        "rows_appended": 0,
        # read-amplification observed by the serving tier: per-tier
        # bounds passes paid / skipped via fence+filter pruning
        # (MutableIndex.bounds_many counters, zero forever on
        # immutable indexes)
        "tiers_probed": 0,
        "tiers_pruned": 0,
        "deltas_live": 0,
        "compactions": 0,
        "compacted_deltas": 0,
        "compacted_rows": 0,
        "compact_seconds_total": 0.0,
        "last_compact_ms": None,
        # durable-ack accounting (zero forever on non-durable indexes)
        "wal_records": 0,
        "wal_bytes": 0,
        "wal_fsyncs": 0,
        "recovered_records": 0,
    }


def _new_view_cell() -> Dict[str, object]:
    """A fresh per-view counter cell (one cell per registered
    materialized view, created under the monitor lock on first touch)."""
    return {
        "refreshes": 0,        # refresh passes that applied >= 1 event
        "events": 0,           # tier events applied (appends + tombs)
        "rows_probed": 0,      # view rows produced by incremental probes
        "rows_retracted": 0,   # view rows masked by tombstone events
        "failures": 0,         # refresh passes that raised (and retried)
        "reads": 0,            # view.read() calls answered
        "rows_read": 0,        # rows those reads returned
        "epoch": 0,            # latest published snapshot epoch
    }


class BatchHistogram:
    """Power-of-two histogram of dispatch batch sizes.

    Bucket ``k`` counts batches with ``2**(k-1) < size <= 2**k`` (bucket
    0 = single-request batches) — the shape that answers "is coalescing
    actually happening" at a glance.  Guarded by the owning monitor.
    """

    __slots__ = ("_buckets", "_total_requests", "_batches", "_max")

    def __init__(self):
        self._buckets: Dict[int, int] = {}
        self._total_requests = 0
        self._batches = 0
        self._max = 0

    def record(self, size: int) -> None:
        if size <= 0:
            return
        k = (size - 1).bit_length()
        self._buckets[k] = self._buckets.get(k, 0) + 1
        self._total_requests += size
        self._batches += 1
        self._max = max(self._max, size)

    @property
    def mean(self) -> Optional[float]:
        if not self._batches:
            return None
        return self._total_requests / self._batches

    def snapshot(self) -> Dict[str, object]:
        mean = self.mean
        return {
            "batches": self._batches,
            "requests": self._total_requests,
            "mean": None if mean is None else round(mean, 2),
            "max": self._max,
            # JSON keys as upper bounds: {"1": n, "2": n, "4": n, ...}
            "by_size_le": {str(1 << k): v for k, v in sorted(self._buckets.items())},
        }


class ServingMetrics:
    """Monitor aggregating every serving counter plus the reservoirs.

    ``queue_wait`` samples submit→dispatch time (what admission's
    deadline checks bound); ``latency`` samples submit→completion (what
    a caller actually observes).
    """

    def __init__(self, reservoir_seed: int = 0):
        self._lock = threading.Lock()
        self.ticks = 0  # dispatcher drain cycles, incl. empty ones
        self.enqueued = 0  # requests admitted to the queue
        self.completed = 0  # results delivered (ok or error)
        self.shed = 0  # rejected with ServerOverloaded at admission
        self.expired = 0  # completed with DeadlineExceeded before dispatch
        self.failed = 0  # completed with any other error
        self.retried = 0  # transient-failure retries of dispatched work
        self.degraded = 0  # requests served via the host-fallback path
        self.callback_errors = 0  # completion callbacks that raised
        self.queue_depth_last = 0  # depth observed at the latest drain
        self.queue_depth_max = 0
        self.batches = BatchHistogram()
        self.latency = LatencyReservoir(seed=reservoir_seed)
        self.queue_wait = LatencyReservoir(seed=reservoir_seed + 1)
        # per-index split (multi-index routing + the storage write
        # path): name -> counter cell, created on first touch
        self._by_index: Dict[str, Dict[str, object]] = {}
        # per-view split (live materialized views), same shape
        self._by_view: Dict[str, Dict[str, object]] = {}

    # -- dispatcher-side ---------------------------------------------------

    def on_tick(self, queue_depth: int) -> None:
        with self._lock:
            self.ticks += 1
            self.queue_depth_last = queue_depth
            if queue_depth > self.queue_depth_max:
                self.queue_depth_max = queue_depth

    def on_batch(self, size: int) -> None:
        with self._lock:
            self.batches.record(size)

    def on_retry(self, n: int = 1) -> None:
        """A transient failure on dispatched work is being retried."""
        with self._lock:
            self.retried += n

    def on_degraded(self, n: int = 1) -> None:
        """*n* requests were served by the host-fallback (degraded)
        path instead of the primary device path."""
        with self._lock:
            self.degraded += n

    def on_callback_error(self) -> None:
        """A caller's completion callback raised (the request itself
        completed; the callback failure is counted, never dropped)."""
        with self._lock:
            self.callback_errors += 1

    def on_complete(
        self, latency_s: float, wait_s: float, outcome: str = "ok"
    ) -> None:
        """Record one delivered result.  *outcome* is ``"ok"``,
        ``"expired"`` or ``"failed"``."""
        self.on_complete_batch([(latency_s, wait_s, outcome)])

    def on_complete_batch(self, samples) -> None:
        """Record a whole dispatch cycle's deliveries in ONE lock round
        — at 100K+ lookups/s a per-request lock acquisition is a
        measurable slice of the per-key budget.  *samples* is a sequence
        of ``(latency_s, wait_s, outcome, ...)`` tuples — trailing
        fields (request kind, route, error type) belong to the tail
        sampler and are ignored here."""
        with self._lock:
            for latency_s, wait_s, outcome, *_rest in samples:
                self.completed += 1
                if outcome == "expired":
                    self.expired += 1
                elif outcome == "failed":
                    self.failed += 1
                self.latency.record(latency_s)
                self.queue_wait.record(wait_s)

    # -- per-index (multi-index routing + storage write path) --------------

    def on_index_batch(
        self,
        name: str,
        *,
        lookups: int = 0,
        append_reqs: int = 0,
        delete_reqs: int = 0,
        rows_appended: int = 0,
        tiers_probed: Optional[int] = None,
        tiers_pruned: Optional[int] = None,
        deltas_live: Optional[int] = None,
        wal: Optional[Dict[str, int]] = None,
    ) -> None:
        """One dispatch cycle's traffic against one named index — a
        single lock round per (cycle, index) pair.  *wal* is the
        cycle's durable-ack delta (``wal_sync()``'s return value:
        records/bytes/fsyncs made durable before the cycle's append
        futures completed); folding it here keeps the one-round
        rule even on durable indexes.  ``tiers_probed``/``tiers_pruned``
        are the cycle's read-amplification counters off the same
        batch's ``MultiBounds`` — same single round."""
        with self._lock:
            cell = self._by_index.setdefault(name, _new_index_cell())
            cell["lookups"] += lookups
            cell["append_reqs"] += append_reqs
            cell["delete_reqs"] += delete_reqs
            cell["rows_appended"] += rows_appended
            if tiers_probed is not None:
                cell["tiers_probed"] += int(tiers_probed)
            if tiers_pruned is not None:
                cell["tiers_pruned"] += int(tiers_pruned)
            if deltas_live is not None:
                cell["deltas_live"] = int(deltas_live)
            if wal is not None:
                cell["wal_records"] += int(wal.get("records", 0))
                cell["wal_bytes"] += int(wal.get("bytes", 0))
                cell["wal_fsyncs"] += int(wal.get("fsyncs", 0))

    def on_recovered(self, name: str, records: int) -> None:
        """WAL records replayed when a recovered durable index was
        registered (once per registration, not per cycle)."""
        with self._lock:
            cell = self._by_index.setdefault(name, _new_index_cell())
            cell["recovered_records"] += int(records)

    def on_compact(
        self,
        name: str,
        deltas: int,
        rows: int,
        seconds: float,
        *,
        deltas_live: int = 0,
    ) -> None:
        """One completed compaction pass against one named index."""
        with self._lock:
            cell = self._by_index.setdefault(name, _new_index_cell())
            cell["compactions"] += 1
            cell["compacted_deltas"] += int(deltas)
            cell["compacted_rows"] += int(rows)
            cell["compact_seconds_total"] += float(seconds)
            cell["last_compact_ms"] = round(float(seconds) * 1e3, 4)
            cell["deltas_live"] = int(deltas_live)

    # -- per-view (live materialized views) ----------------------------------

    def on_view_refresh(
        self,
        name: str,
        *,
        events: int = 0,
        rows_probed: int = 0,
        rows_retracted: int = 0,
        failures: int = 0,
        epoch: Optional[int] = None,
    ) -> None:
        """One view refresh pass — a single lock round per (cycle,
        view) pair, same discipline as :meth:`on_index_batch`.  A
        successful pass reports the events it applied and the rows it
        probed/retracted; a failed pass reports ``failures=1`` (the
        prior snapshot stayed live and the events remain queued)."""
        with self._lock:
            cell = self._by_view.setdefault(name, _new_view_cell())
            if events:
                cell["refreshes"] += 1
            cell["events"] += int(events)
            cell["rows_probed"] += int(rows_probed)
            cell["rows_retracted"] += int(rows_retracted)
            cell["failures"] += int(failures)
            if epoch is not None:
                cell["epoch"] = int(epoch)

    def on_view_read(self, name: str, *, rows: int = 0) -> None:
        """One ``view.read()`` answered from the epoch-pinned snapshot
        (caller's thread — reads never queue through the dispatcher)."""
        with self._lock:
            cell = self._by_view.setdefault(name, _new_view_cell())
            cell["reads"] += 1
            cell["rows_read"] += int(rows)

    # -- submit-side -------------------------------------------------------

    def on_enqueue(self) -> None:
        with self._lock:
            self.enqueued += 1

    def on_shed(self) -> None:
        with self._lock:
            self.shed += 1

    # -- export ------------------------------------------------------------

    def snapshot(self, plancache=None) -> Dict[str, object]:
        """One JSON-safe dict of every counter; pass the server's
        :class:`~csvplus_tpu_torch.serve.plancache.PlanCache` to embed its
        hit/miss/evict stats under ``"plancache"``."""
        with self._lock:
            out: Dict[str, object] = {
                "schema_version": SNAPSHOT_SCHEMA_VERSION,
                "ticks": self.ticks,
                "enqueued": self.enqueued,
                "completed": self.completed,
                "shed": self.shed,
                "expired": self.expired,
                "failed": self.failed,
                "retried": self.retried,
                "degraded": self.degraded,
                "callback_errors": self.callback_errors,
                "queue_depth_last": self.queue_depth_last,
                "queue_depth_max": self.queue_depth_max,
                "batch": self.batches.snapshot(),
                "latency": self.latency.snapshot(),
                "queue_wait": self.queue_wait.snapshot(),
                "by_index": {
                    name: {
                        k: (round(v, 6) if isinstance(v, float) else v)
                        for k, v in cell.items()
                    }
                    for name, cell in sorted(self._by_index.items())
                },
                "by_view": {
                    name: {
                        k: (round(v, 6) if isinstance(v, float) else v)
                        for k, v in cell.items()
                    }
                    for name, cell in sorted(self._by_view.items())
                },
            }
        if plancache is not None:
            out["plancache"] = plancache.stats()
        return out

    def observe_dispatch(self, nreq: int, seconds: float) -> None:
        """Mirror one dispatch cycle into the process-global telemetry
        (no-op unless the caller enabled it), using the same stage
        conventions as ingest/join so ``merged_stages`` folds serving
        into the one per-stage table."""
        from ..utils.observe import telemetry

        if telemetry.enabled:
            telemetry.add_stage(
                "serve:dispatch", rows_in=nreq, rows_out=nreq, seconds=seconds
            )
            telemetry.count("serve.dispatched", nreq)
