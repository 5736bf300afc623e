"""Live materialized views over mutable indexes.

Port of ``csvplus_tpu/views/view.py``.  A :class:`MaterializedView`
registers one verifier-accepted plan chain whose Scan leaf is a
:class:`~csvplus_tpu_torch.storage.lsm.MutableIndex` source and keeps the
result continuously fresh WITHOUT ever recomputing from scratch.  The
machinery mirrors the LSM structure one level up; the view's state is
itself tiered:

* **Segments.**  One :class:`_Segment` per applied source tier: the
  plan's output rows for THAT tier only, in the tier's sorted order,
  with a per-row ``alive`` mask.  The view's contents are the stable
  key-merge of all segments in tier order, exactly the order a
  from-scratch execution over the fully-compacted source produces,
  because every gated op is row-linear and order-preserving
  (:mod:`.rules`) and the source's merged order is (key, tier,
  within-tier position).
* **Delta application.**  An append tier event executes the registered
  plan RE-ROOTED onto the tier's small sorted table
  (:func:`reroot_plan`) through the serving plan cache: the structural
  cache key ignores table identity and length, so every tier after the
  first warm-hits the verified executable (no lowering again at fixed
  batch shapes).  This per-tier execution is the view's device work; a
  ``Filter`` in the plan launches the mask kernel on the tier's rows.  A
  tombstone event retracts by source key on the host: per segment older
  than the tombstone, a bisect over the segment's sorted keys flips the
  matching ``alive`` bits on a COPIED mask.  Delete-then-reappend
  resurrects naturally: the re-append arrives as a newer segment the
  older tombstone never touches.
* **Epoch-pinned snapshots.**  All segment state lives in an immutable
  :class:`ViewSnapshot` swapped atomically per applied event; readers
  pin it with one attribute read and never take the refresh lock.  A
  crashed refresh (the ``views:refresh`` fault site fires at the top of
  every pass) leaves the prior snapshot live and the unapplied events
  queued; the next refresh retries them in order.
* **Compaction independence.**  Source compactions fire no tier
  events: they rewrite physical tiers, not the logical stream, so the
  view's segment state stays a faithful replay of the acked stream.

**Device.**  The view's device is its source's (:attr:`MutableIndex.
device`); for a source with none (a host base with no
``ingest_device``) it is the *device* the caller passes, else
``"cuda"``, which raises where no card is present.  A tier with no
device table of its own is columnarized onto that device; device work
(the per-tier execution, :meth:`recompute`) runs under
``torch.cuda.device`` of it, so a dispatcher thread refreshes on the
source's card.

The hard contract: after EVERY applied batch,
:meth:`MaterializedView.checksums` (positional per-column checksums over
the merged contents) equals the same checksums over a from-scratch
execution of the registered plan (:meth:`MaterializedView.recompute`).
"""

from __future__ import annotations

import bisect
import contextlib
import threading
from collections import deque
from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import plan as P
from ..obs import flight as _flight
from ..obs.span import tracer
from ..resilience import faults
from ..row import Row
from ..columnar.table import DeviceTable, resolve_device
from ..storage.lsm import tier_rows
from ..utils.checksum import checksum_device_table, checksum_host_rows
from ..utils.observe import telemetry
from .rules import check_view_plan

__all__ = ["MaterializedView", "ViewSnapshot", "reroot_plan"]


def reroot_plan(root: P.PlanNode, table) -> P.PlanNode:
    """The same stage chain over a different Scan table.

    Plans are frozen single-child chains, so rerooting is a fold of
    ``dataclasses.replace`` along :func:`~csvplus_tpu_torch.plan.linearize`:
    every stage keeps its predicate/expr/build-side identity, only the
    leaf moves.  The plan cache's structural key is identical for every
    reroot over a same-schema table, which is what makes per-tier
    execution verify-once and lower-once."""
    chain = P.linearize(root)
    node: P.PlanNode = P.Scan(table)
    for stage in chain[1:]:
        node = replace(stage, child=node)
    return node


def _tier_table(index, device):
    """A tier's sorted DeviceTable: the index's own device copy when it
    has one; otherwise the sorted host rows columnarized onto *device*
    (never via ``impl.rows``, which would flip a device-lazy impl onto
    its host branch for good)."""
    impl = index._impl
    if impl.dev is not None:
        return impl.dev.table
    return DeviceTable.from_rows(tier_rows(impl), device)


class _Segment:
    """One applied source tier's plan output: rows in the tier's sorted
    order, their source-key tuples (sorted, so retraction and point
    reads bisect), and a per-row liveness mask.  ``rows`` and ``keys``
    are shared across snapshots forever; ``alive`` is copy-on-retract:
    a published segment never mutates."""

    __slots__ = ("seq", "rows", "keys", "alive")

    def __init__(self, seq: int, rows: List[Row], keys: List[Tuple[str, ...]],
                 alive: Optional[np.ndarray] = None):
        self.seq = seq
        self.rows = rows
        self.keys = keys
        self.alive = (
            alive if alive is not None else np.ones(len(rows), dtype=bool)
        )

    def live_count(self) -> int:
        return int(self.alive.sum())

    def retracted(self, dead: frozenset) -> Tuple["_Segment", int]:
        """(successor segment, rows newly retracted) for a tombstone
        key set; ``self`` when nothing matched."""
        hits: List[int] = []
        for key in dead:
            lo = bisect.bisect_left(self.keys, key)
            hi = bisect.bisect_right(self.keys, key)
            if hi > lo:
                hits.extend(range(lo, hi))
        if not hits:
            return self, 0
        alive = self.alive.copy()
        flipped = int(alive[hits].sum())
        alive[hits] = False
        return _Segment(self.seq, self.rows, self.keys, alive), flipped


class ViewSnapshot:
    """Immutable view contents at one epoch.

    The merged row list is materialized lazily (first
    :meth:`rows`/:meth:`checksums` call) and cached under a
    double-checked lock; the read/refresh hot paths never pay it."""

    __slots__ = ("epoch", "applied_seq", "segments", "columns",
                 "_merged", "_mlock")

    def __init__(self, epoch: int, applied_seq: int,
                 segments: Tuple[_Segment, ...], columns: Sequence[str]):
        self.epoch = epoch
        self.applied_seq = applied_seq
        self.segments = segments
        self.columns = tuple(columns)
        self._merged: Optional[List[Row]] = None
        self._mlock = threading.Lock()

    @property
    def nrows(self) -> int:
        return sum(seg.live_count() for seg in self.segments)

    def rows(self) -> List[Row]:
        """The merged contents in from-scratch order: a stable sort by
        source key over the segments' live rows in segment order,
        (key, tier, within-tier position), the same refinement the
        source's compacted rebuild uses.  Cached per snapshot; callers
        must treat the list and its rows as read-only."""
        if self._merged is None:
            with self._mlock:
                if self._merged is None:
                    items: List[Tuple[Tuple[str, ...], Row]] = []
                    for seg in self.segments:
                        keys, rows = seg.keys, seg.rows
                        for i in np.flatnonzero(seg.alive):
                            items.append((keys[i], rows[i]))
                    items.sort(key=lambda kv: kv[0])  # stable: ties keep
                    self._merged = [r for _, r in items]  # (tier, pos)
        return self._merged

    def checksums(self) -> Dict[str, int]:
        """Positional per-column checksums: the parity currency
        (identical to :func:`~csvplus_tpu_torch.storage.lsm.index_checksums`
        over a from-scratch execution's rows)."""
        return checksum_host_rows(self.rows(), list(self.columns),
                                  positional=True)


class MaterializedView:
    """One registered plan, kept live against its mutable source.

    Construction gates the plan (:func:`.rules.check_view_plan`, then
    static verification via the plan cache's admission), subscribes to
    the source's tier-swap events, and builds the initial snapshot by
    replaying the subscription's pinned tier set.  ``refresh`` serializes
    on the refresh lock and swaps immutable snapshots; ``read`` pins a
    snapshot with one attribute read and takes no lock at all."""

    def __init__(self, name: str, root: P.PlanNode, source, *,
                 plancache=None, metrics=None, device=None):
        from ..serve.plancache import PlanCache

        self.name = name
        self.source = source
        self._root = root
        self._key_columns = list(source.columns)
        check_view_plan(root, self._key_columns, source.mode)
        self._plancache = plancache if plancache is not None else PlanCache()
        self._metrics = metrics
        src_device = getattr(source, "device", None)
        self._device = resolve_device(
            src_device if src_device is not None
            else (device if device is not None else "cuda")
        )
        self._lock = threading.Lock()   # serializes refresh passes
        self._qlock = threading.Lock()  # guards the pending event queue
        self._pending: deque = deque()
        self._columns: Optional[Tuple[str, ...]] = None
        ts = source.subscribe(self._on_tier_event)
        try:
            # initial snapshot: the pinned tier set replayed as the
            # event stream it is: a tier's tombstones shadow everything
            # accumulated so far, THEN its rows append (a partially
            # merged tier carrying both appended after its deletes)
            with self._scope():
                seg, self._columns = self._build_segment(0, ts.base)
                segments: Tuple[_Segment, ...] = (seg,)
                applied = 0
                for d in ts.deltas:
                    if d.tombs:
                        segments = tuple(
                            seg.retracted(d.tomb_set)[0] for seg in segments
                        )
                    if d.index is not None:
                        seg, _ = self._build_segment(d.seq, d.index)
                        segments = segments + (seg,)
                    applied = d.seq
            self._snapshot = ViewSnapshot(0, applied, segments, self._columns)
        except BaseException:
            source.unsubscribe(self._on_tier_event)
            raise

    @property
    def device(self):
        """The torch device the view executes its plan on (see the
        module docstring)."""
        return self._device

    def _scope(self):
        """``torch.cuda.device`` of the view's card for the calling
        thread (torch's current device is per thread); a no-op context
        on the CPU."""
        import torch

        if self._device.type == "cuda":
            return torch.cuda.device(self._device)
        return contextlib.nullcontext()

    # -- event intake (runs under the SOURCE's writer lock) ----------------

    def _on_tier_event(self, event) -> None:
        """O(1) enqueue, per the subscribe contract; the refresh pass
        applies queued events in delivery (= tier) order."""
        with self._qlock:
            self._pending.append(event)

    @property
    def pending(self) -> int:
        with self._qlock:
            return len(self._pending)

    # -- refresh -----------------------------------------------------------

    def refresh(self) -> int:
        """Apply every queued tier event, one epoch-pinned snapshot
        swap per event; returns how many were applied.  An exception
        anywhere (the ``views:refresh`` fault site fires first) leaves
        the prior snapshot live and the failing event, plus everything
        after it, queued for the next pass."""
        with self._lock:
            faults.inject("views:refresh")
            applied = rows_probed = rows_retracted = 0
            with tracer.span("view:refresh", view=self.name) as sp, self._scope():
                while True:
                    with self._qlock:
                        event = self._pending[0] if self._pending else None
                    if event is None:
                        break
                    succ, n = self._apply(event)
                    self._snapshot = succ
                    if event[0] == "rows":
                        rows_probed += n
                    else:
                        rows_retracted += n
                    with self._qlock:
                        self._pending.popleft()
                    applied += 1
                sp["events"] = applied
            snap = self._snapshot
            if self._metrics is not None and applied:
                self._metrics.on_view_refresh(
                    self.name, events=applied, rows_probed=rows_probed,
                    rows_retracted=rows_retracted, epoch=snap.epoch,
                )
            if applied:
                # view maintenance in the flight timeline, between the
                # cycle's writes and its lookups
                _flight.note(
                    "views:refresh", view=self.name, events=applied,
                    epoch=snap.epoch,
                )
            return applied

    def _apply(self, event) -> Tuple[ViewSnapshot, int]:
        """(successor snapshot, rows probed/retracted) for one tier
        event against the current snapshot; pure w.r.t. ``self``: the
        caller (``refresh``, holding the refresh lock) publishes it."""
        kind, seq, payload = event
        snap = self._snapshot
        if kind == "rows":
            # the incremental probe: the registered plan over ONLY the
            # new tier's rows, through the warm plan-cache executable
            with tracer.span("view:probe", view=self.name, seq=seq):
                with telemetry.stage("view:probe", len(payload._impl)):
                    seg, _ = self._build_segment(seq, payload)
            return ViewSnapshot(
                snap.epoch + 1, seq, snap.segments + (seg,), snap.columns
            ), len(seg.rows)
        # tombstone retraction: flip matching rows in every OLDER
        # segment (copy-on-write masks; published snapshots never see it)
        dead = frozenset(payload)
        with tracer.span("view:retract", view=self.name, seq=seq):
            with telemetry.stage("view:retract", len(dead)):
                flipped = 0
                segments = []
                for seg in snap.segments:
                    if seg.seq < seq:
                        seg, n = seg.retracted(dead)
                        flipped += n
                    segments.append(seg)
        return ViewSnapshot(
            snap.epoch + 1, seq, tuple(segments), snap.columns
        ), flipped

    def _build_segment(self, seq: int, tier_index):
        """(segment, output columns) for the plan over one tier; pure
        w.r.t. ``self``."""
        out = self._plancache.execute(
            reroot_plan(self._root, _tier_table(tier_index, self._device))
        )
        rows = out.to_rows()
        kc = self._key_columns
        keys = [tuple(r[c] for c in kc) for r in rows]
        return _Segment(seq, rows, keys), tuple(out.columns)

    # -- reads (no lock on this path) --------------------------------------

    def snapshot(self) -> ViewSnapshot:
        """Pin the current epoch (one atomic attribute read)."""
        return self._snapshot

    def read(self, *key) -> List[Row]:
        """All live view rows whose source key matches *key* (full or
        prefix), in view order: host bisects over the pinned snapshot's
        per-segment sorted keys.  Returned rows are copies; mutate
        freely."""
        if len(key) == 1 and not isinstance(key[0], str):
            probe = tuple(key[0])
        else:
            probe = tuple(key)
        k = len(probe)
        snap = self._snapshot
        items: List[Tuple[Tuple[str, ...], Row]] = []
        for seg in snap.segments:
            keys = seg.keys
            i = bisect.bisect_left(keys, probe)
            while i < len(keys) and keys[i][:k] == probe:
                if seg.alive[i]:
                    items.append((keys[i], seg.rows[i]))
                i += 1
        # stable by key: prefix probes spanning several keys come back
        # in the same (key, tier, position) order the merged view has
        items.sort(key=lambda kv: kv[0])
        if self._metrics is not None:
            self._metrics.on_view_read(self.name, rows=len(items))
        return [Row(r) for _, r in items]

    def rows(self) -> List[Row]:
        """The full merged contents (copies), in from-scratch order."""
        return [Row(r) for r in self._snapshot.rows()]

    def checksums(self) -> Dict[str, int]:
        """Positional per-column checksums of the live contents."""
        return self._snapshot.checksums()

    @property
    def epoch(self) -> int:
        return self._snapshot.epoch

    @property
    def columns(self) -> Tuple[str, ...]:
        return tuple(self._columns or ())

    # -- the from-scratch reference ----------------------------------------

    def recompute(self):
        """Execute the registered plan from scratch over the source's
        fully-merged logical stream; returns the result DeviceTable (on
        the view's device).  The parity harness's ground truth."""
        with self._scope():
            return self._plancache.execute(
                reroot_plan(
                    self._root,
                    _tier_table(self.source.to_index(), self._device),
                )
            )

    def recompute_checksums(self) -> Dict[str, int]:
        """Positional checksums of :meth:`recompute`, which must equal
        :meth:`checksums` after every applied batch (the hard contract).
        Computed on the result's device; the same numbers as hashing its
        host rows."""
        out = self.recompute()
        names = list(self._columns or out.columns)
        with self._scope():
            sums = checksum_device_table(
                out, [c for c in names if c in out.columns], positional=True,
            )
        return {c: sums.get(c, 0) for c in names}  # an absent column sums to 0

    def stats(self) -> Dict[str, object]:
        """JSON-safe accounting for metrics snapshots and bench
        artifacts."""
        snap = self._snapshot
        return {
            "epoch": snap.epoch,
            "applied_seq": snap.applied_seq,
            "segments": len(snap.segments),
            "rows": snap.nrows,
            "pending": self.pending,
        }
