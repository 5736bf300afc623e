"""Space-Saving top-K heavy-hitter sketch over observed keys.

A copy of ``csvplus_tpu/obs/sketch.py``, with the text report
(:func:`skew_report`) behind ``python -m csvplus_tpu_torch.obs skew``.
The build side of every join offers a bounded sample of its sorted keys into one of these
(:mod:`.joinskew`), and the cost model (``analysis/cost.py``) reads the
tracked shares to price joins and predicates.  :class:`SpaceSaving`
implements the Metwally/Agrawal/El Abbadi stream-summary sketch: at
most *k* tracked keys, each with a count and an over-estimation error
bound.  Guarantees:

* any key whose true frequency exceeds ``observed / k`` is present;
* for a tracked key, ``count - err <= true count <= count``;
* with fewer than *k* distinct keys the counts are EXACT (err 0).

Evicting the minimum-count entry goes through a lazy min-heap of
``(count, key)`` tuples (stale entries skipped on pop, heap rebuilt when
it outgrows the live set), so ``offer`` is amortized O(log k).

Thread model: a monitor — ``offer``/``offer_many``/``offer_counts``
take the instance lock; the batch forms are one lock round per batch.
"""

from __future__ import annotations

import heapq
import threading
from typing import Dict, Hashable, Iterable, List, Optional, Tuple

__all__ = ["SpaceSaving", "skew_report"]


def _json_key(key: Hashable) -> object:
    """JSON-safe rendering of a tracked key: scalars pass through,
    tuples (composite index keys) become lists, anything else is
    stringified."""
    if isinstance(key, (str, int, float, bool)) or key is None:
        return key
    if isinstance(key, tuple):
        return [_json_key(p) for p in key]
    return str(key)


class SpaceSaving:
    """Bounded top-K frequency sketch (Space-Saving / stream-summary)."""

    __slots__ = ("k", "_lock", "_counts", "_errs", "_heap", "_observed")

    def __init__(self, k: int = 32):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = int(k)
        self._lock = threading.Lock()
        self._counts: Dict[Hashable, int] = {}
        self._errs: Dict[Hashable, int] = {}
        # lazy min-heap of (count, key); entries go stale when a key's
        # count moves on — popped entries are validated against _counts
        self._heap: List[Tuple[int, Hashable]] = []
        self._observed = 0

    # -- ingest ------------------------------------------------------------

    def offer(self, key: Hashable, n: int = 1) -> None:
        """Count one observation of *key* (*n* occurrences)."""
        with self._lock:
            self._offer_locked(key, n)

    def offer_many(self, keys: Iterable[Hashable]) -> None:
        """Count a batch of observations in ONE lock round — the same
        per-dispatch-cycle discipline as ``ServingMetrics``.  Duplicate
        keys in the batch (the normal case under a Zipf workload) are
        aggregated OUTSIDE the lock first, so a hot key costs one
        counter update per batch, not one per occurrence."""
        agg: Dict[Hashable, int] = {}
        for key in keys:
            agg[key] = agg.get(key, 0) + 1
        with self._lock:
            for key, n in agg.items():
                self._offer_locked(key, n)

    def offer_counts(self, keys: Iterable[Hashable], counts: Iterable[int]) -> None:
        """Count PRE-AGGREGATED ``(key, count)`` pairs in one lock round
        — the partitioned join planner's entry point: a strided device
        sample lands as ``np.unique(..., return_counts=True)`` output
        and feeds straight in.  Numpy scalars are unwrapped to native
        ints/strs outside the lock so tracked keys (and their exported
        snapshots) stay JSON-clean and hash-stable across callers."""
        pairs = [
            (key.item() if hasattr(key, "item") else key, int(n))
            for key, n in zip(keys, counts)
        ]
        with self._lock:
            for key, n in pairs:
                if n > 0:
                    self._offer_locked(key, n)

    def _offer_locked(self, key: Hashable, n: int) -> None:
        self._observed += n
        counts = self._counts
        c = counts.get(key)
        if c is not None:
            counts[key] = c + n
            heapq.heappush(self._heap, (c + n, key))
            return
        if len(counts) < self.k:
            counts[key] = n
            self._errs[key] = 0
            heapq.heappush(self._heap, (n, key))
            return
        # evict the true minimum: pop stale heap entries until one
        # matches its key's live count
        heap = self._heap
        while heap:
            mc, mk = heap[0]
            if counts.get(mk) == mc:
                break
            heapq.heappop(heap)
        mc, mk = heapq.heappop(heap)
        del counts[mk]
        del self._errs[mk]
        counts[key] = mc + n
        self._errs[key] = mc
        heapq.heappush(heap, (mc + n, key))
        if len(heap) > 8 * self.k:
            # rebuild from live entries so stale tuples cannot grow
            # the heap without bound
            self._heap = [(v, kk) for kk, v in counts.items()]
            heapq.heapify(self._heap)

    # -- export ------------------------------------------------------------

    @property
    def observed(self) -> int:
        with self._lock:
            return self._observed

    def topk(self, n: Optional[int] = None) -> List[Tuple[Hashable, int, int]]:
        """The tracked keys as ``(key, count, err)`` sorted by count
        descending (count ties broken by key repr for determinism)."""
        with self._lock:
            items = [
                (key, c, self._errs[key]) for key, c in self._counts.items()
            ]
        items.sort(key=lambda t: (-t[1], repr(t[0])))
        return items if n is None else items[:n]

    def snapshot(self, n: Optional[int] = None) -> Dict[str, object]:
        """JSON-safe export: ``{k, observed, top: [{key, count, err}]}``.
        ``count/observed`` is the estimated frequency share; a key is a
        guaranteed heavy hitter when ``(count - err) / observed``
        already clears the caller's threshold."""
        top = self.topk(n)
        with self._lock:
            observed = self._observed
        return {
            "k": self.k,
            "observed": observed,
            "top": [
                {"key": _json_key(key), "count": c, "err": e}
                for key, c, e in top
            ],
        }


def skew_report(snapshot: Dict[str, object], *, top: int = 10) -> str:
    """Render one sketch snapshot as an aligned text table with
    frequency shares and the guaranteed-lower-bound share — the body of
    ``python -m csvplus_tpu_torch.obs skew``."""
    observed = int(snapshot.get("observed", 0) or 0)
    rows = list(snapshot.get("top", []))[:top]
    lines = [f"observed={observed} tracked<=k={snapshot.get('k')}"]
    if not rows:
        lines.append("  (no keys observed)")
        return "\n".join(lines)
    width = max(len(str(r["key"])) for r in rows)
    lines.append(
        f"  {'key':<{width}}  {'count':>10}  {'err':>8}  "
        f"{'share':>7}  {'min_share':>9}"
    )
    for r in rows:
        c, e = int(r["count"]), int(r["err"])
        share = c / observed if observed else 0.0
        floor = (c - e) / observed if observed else 0.0
        lines.append(
            f"  {str(r['key']):<{width}}  {c:>10}  {e:>8}  "
            f"{share:>6.2%}  {floor:>8.2%}"
        )
    return "\n".join(lines)
