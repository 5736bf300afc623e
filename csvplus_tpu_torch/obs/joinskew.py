"""Process-global join evidence: build-side key sketches and the fused
joins' counters.

A copy of ``csvplus_tpu/obs/joinskew.py``.  Every device index offers a
strided sample of its sorted build keys once, on its first probe
(``ops/join.DeviceIndex.offer_build_sample``), into the sketch under its
key label; ``analysis/cost.py`` reads :meth:`JoinSkewStats.build_sketches`
when no sketches are passed, so join order and fusion decisions follow
the same evidence as in the reference.  ``on_join`` counts the
partitioned probe's routing split (``parallel/pjoin.py``: hot keys
detected, rows answered by the broadcast tier, rows that crossed the
exchange), and ``on_multiway`` / ``on_fused`` the single-pass multiway
joins and fused probe passes that ran; the metrics plane exports them as
the ``csvplus_join_*`` families.

It is process-global because joins run on pipelines that never attach a
serving tier.  Thread model: a monitor; every registry mutation sits
under the registry lock, and sketch ingestion goes through the sketch's
own lock (``SpaceSaving.offer_counts``).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Hashable

from .sketch import SpaceSaving

__all__ = ["JoinSkewStats", "joinskew"]


class JoinSkewStats:
    """Per-index-label join routing counters + build-side key sketches."""

    def __init__(self, sketch_k: int = 32):
        self.sketch_k = int(sketch_k)
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[str, int]] = {}
        self._build_sketches: Dict[str, SpaceSaving] = {}

    # -- ingest ------------------------------------------------------------

    def on_join(
        self,
        label: str,
        hot_keys: int,
        rows_broadcast: int,
        rows_repartitioned: int,
    ) -> None:
        """Fold one partitioned-probe execution's routing split into the
        label's counters; one lock round per join.  A label may already
        hold only another family's keys, so every key has an absent
        default."""
        with self._lock:
            c = self._counters.get(label)
            if c is None:
                c = self._counters[label] = {}
            c["joins"] = c.get("joins", 0) + 1
            c["hot_keys_detected"] = c.get("hot_keys_detected", 0) + int(hot_keys)
            c["rows_broadcast"] = c.get("rows_broadcast", 0) + int(rows_broadcast)
            c["rows_repartitioned"] = (
                c.get("rows_repartitioned", 0) + int(rows_repartitioned)
            )

    def on_multiway(
        self,
        label: str,
        dims: int,
        rows_in: int,
        rows_out: int,
        intermediate_rows_avoided: int,
    ) -> None:
        """Fold one single-pass multiway join execution into the label's
        counters: evidence that the fused operator engaged and how large
        the cascade intermediate it avoided would have been.  One lock
        round per join."""
        with self._lock:
            c = self._counters.get(label)
            if c is None:
                c = self._counters[label] = {}
            c["multiway_joins"] = c.get("multiway_joins", 0) + 1
            c["multiway_dims"] = c.get("multiway_dims", 0) + int(dims)
            c["multiway_rows_in"] = c.get("multiway_rows_in", 0) + int(rows_in)
            c["multiway_rows_out"] = (
                c.get("multiway_rows_out", 0) + int(rows_out)
            )
            c["multiway_intermediate_rows_avoided"] = (
                c.get("multiway_intermediate_rows_avoided", 0)
                + int(intermediate_rows_avoided)
            )

    def on_fused(
        self,
        label: str,
        dims: int,
        rows_full: int,
        rows_selected: int,
        rows_out: int,
    ) -> None:
        """Fold one fused probe-pass execution into the label's counters:
        evidence that a FusedProbe engaged, how many fact rows the absorbed filters cut
        before the fan-out (*rows_full* entering vs *rows_selected*
        probed), and how many rows it emitted.  One lock round, keys
        disjoint from the other families."""
        with self._lock:
            c = self._counters.get(label)
            if c is None:
                c = self._counters[label] = {}
            c["fused_probes"] = c.get("fused_probes", 0) + 1
            c["fused_dims"] = c.get("fused_dims", 0) + int(dims)
            c["fused_rows_full"] = c.get("fused_rows_full", 0) + int(rows_full)
            c["fused_rows_selected"] = (
                c.get("fused_rows_selected", 0) + int(rows_selected)
            )
            c["fused_rows_out"] = c.get("fused_rows_out", 0) + int(rows_out)

    def build_sketch(self, label: str) -> SpaceSaving:
        """Get-or-create the label's build-side sketch."""
        with self._lock:
            sk = self._build_sketches.get(label)
            if sk is None:
                sk = self._build_sketches[label] = SpaceSaving(self.sketch_k)
            return sk

    def offer_build(
        self, label: str, keys: Iterable[Hashable], counts: Iterable[int]
    ) -> None:
        """A build-side key sample (decoded values + sample counts) into
        the label's sketch.  Aggregation already happened at sampling
        time (``np.unique``), so this is one sketch lock round."""
        self.build_sketch(label).offer_counts(keys, counts)

    # -- export ------------------------------------------------------------

    def counters_snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {label: dict(c) for label, c in self._counters.items()}

    def build_sketches(self) -> Dict[str, SpaceSaving]:
        """A point-in-time copy of the label->sketch map (the sketches
        themselves are shared monitors, safe to snapshot() concurrently)."""
        with self._lock:
            return dict(self._build_sketches)

    def reset(self) -> None:
        """Tests only: drop all counters and sketches."""
        with self._lock:
            self._counters.clear()
            self._build_sketches.clear()


joinskew = JoinSkewStats()
