"""Serving: the point-lookup server, admission control, serving metrics
and the verified-plan executable cache.

* :mod:`.coalesce` — :class:`LookupServer`: concurrent callers submit
  single point-lookup probes (or plan queries); one dispatcher thread
  drains the pending queue into ONE batched ``find_rows_many`` call per
  cycle and index and scatters per-key results back to caller futures.
* :mod:`.plancache` — :class:`PlanCache`: plan-IR queries are verified
  once per structural shape, and their executables reused.
* :mod:`.admit` — bounded pending queue with typed
  :class:`ServerOverloaded` load shedding and per-request deadlines.
* :mod:`.metrics` — :class:`ServingMetrics`: queue depth, batch-size
  histogram, coalesce ticks, latency reservoir, as a JSON snapshot.

Failure handling (retry, circuit-breaker degradation onto the host
oracle, typed :class:`ServerCrashed`) comes from
:mod:`csvplus_tpu_torch.resilience`.  The reference's write surface and
live views wait for the ``storage`` and ``views`` slices (``ROADMAP.md``).
"""

from ..resilience.retry import ServerCrashed
from .admit import AdmissionController, DeadlineExceeded, ServerOverloaded
from .coalesce import DEFAULT_INDEX, LookupServer
from .metrics import BatchHistogram, LatencyReservoir, ServingMetrics
from .plancache import PlanCache, PlanRejected, plan_cache_key

__all__ = [
    "AdmissionController",
    "BatchHistogram",
    "DEFAULT_INDEX",
    "DeadlineExceeded",
    "LatencyReservoir",
    "LookupServer",
    "PlanCache",
    "PlanRejected",
    "ServerCrashed",
    "ServerOverloaded",
    "ServingMetrics",
    "plan_cache_key",
]
