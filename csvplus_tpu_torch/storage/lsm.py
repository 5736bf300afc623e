"""LSM tier sets: delta tiers, tombstones, epoch snapshots, durability.

Port of ``csvplus_tpu/storage/lsm.py``.  The tiers are the port's own
indexes (device-lazy on the card, or host-backed); every read, write,
merge and recovery gives what the reference gives, and a durable
directory written by either package opens in the other.

Layout
------

A :class:`MutableIndex` is a **base** tier (an ordinary sorted
:class:`~csvplus_tpu_torch.index.Index`) plus a tuple of **delta** tiers.  A
delta tier holds a small sorted Index built from one append batch
through the existing encode path (``DeviceTable`` columnarization or
the staged streamed-ingest pipeline for ``append_csv``), a set of
**tombstone** keys written by :meth:`MutableIndex.delete`, or — after a
partial (leveled) merge — both.  The logical row stream is the
concatenation base → delta0 → delta1 → … in append order; every read
answers as if that stream had been indexed from scratch after applying
each delete at its stream position.

Visibility (``mode``)
---------------------

* ``"append"`` (default) — multiset appends: all tiers are visible,
  equal keys interleave in (key, tier, within-tier position) order —
  bitwise-identical to a from-scratch **stable** rebuild of the
  logical stream, because each tier is itself a stable sort of its
  batch.
* ``"upsert"`` — newest-wins: a key present in a newer tier shadows
  every older tier's rows for that key (whole key groups, so one
  append batch may still hold duplicates).  Equal to rebuilding after
  dropping each row whose full key reappears in any LATER tier.

Tombstones shadow in BOTH modes: a tombstone at tier position *p*
erases every matching full key in tiers strictly older than *p* (rows
appended after the delete are visible again).  A full merge into the
base drops tombstones permanently; a partial merge carries the
surviving tombstone set on the merged tier (it must keep shadowing
out-of-range older tiers).

Durability
----------

Pass ``directory=`` at construction (or use :meth:`MutableIndex.open`)
and every append/delete writes one checksummed record to a segmented
write-ahead log (:mod:`~csvplus_tpu_torch.storage.wal`) BEFORE the tier
becomes visible, fsynced per ``CSVPLUS_WAL_SYNC`` (``always`` |
``batch`` | ``off``).  Full compactions checkpoint: the merged base
persists via the versioned ``Index.write_to`` format, the WAL seals its
active segment, and ``MANIFEST.json`` swaps atomically
(:mod:`~csvplus_tpu_torch.storage.manifest`); applied segments are then
dropped.  :meth:`open` recovers by loading the manifest's base and
replaying only WAL records newer than its ``applied_lsn``, truncating a
torn final record — recovered state is bitwise-equal
(:func:`index_checksums`) to replaying the acked logical stream into a
fresh index.

Concurrency (the epoch rule)
----------------------------

All tier-list state lives in one immutable :class:`TierSet`; readers
pin it with a single attribute read (``self._tiers`` — atomic under
the GIL) and never take a lock on the probe hot path.  Writers
(``append_*`` / ``delete`` / ``compact_once`` / ``compact_step``)
build a NEW TierSet and swap it under ``self._lock``.  The compactor
merges OUTSIDE the lock against its pinned snapshot and swaps only the
merged range, so appends landing mid-merge survive as the new tier
list's tail.  ``append_rows``, ``delete``, ``compact_once``,
``compact_step``, ``wal_sync``, ``bounds_many`` and the
:class:`ReadAmpTracker` entries may run on any thread: every
shared-state mutation below them sits under a lock.  Device work on a
thread other than the caller's (the compactor, the server's dispatcher)
runs under ``torch.cuda.device`` of the index's device, since torch's
current device is per thread.

Read pruning (lazy)
-------------------

Each row tier carries a :class:`~csvplus_tpu_torch.storage.prune.TierPruner`
(min/max key fences + a seeded Bloom filter); every :meth:`bounds_many`
batch consults the TierSet's :class:`~csvplus_tpu_torch.storage.prune.PruneDirectory`
on the host to shortlist tiers BEFORE any per-tier bounds pass.  Delta
summaries build LAZILY on the first probe after a swap (cached on the
DeltaTier, shared across epochs), so the append path no longer pays
the O(n) fence+filter scan per sealed batch.  Pruning is one-sided, so
results are bitwise-identical with it on or off
(``CSVPLUS_LSM_PRUNE=0`` disables it).  Checkpoints persist the merged
base's summaries as a ``prune-%08d.flt`` sidecar named in the
manifest, so recovery reloads them without a rescan.

Tier-swap listeners
-------------------

:meth:`MutableIndex.subscribe` registers a callback that fires on
every append (``("rows", seq, index)``) and delete
(``("tombs", seq, keys)``) tier swap — the live materialized views'
delta feed (the reference's ``views`` package; the port's waits for its
slice).  Callbacks run UNDER the writer
lock immediately after the swap, so delivery order is exactly tier
order with no gaps relative to the TierSet returned at subscription;
the contract is that a listener is O(1) enqueue-only, never raises,
and never calls back into the index.  Compactions fire no events:
they rewrite physical tiers, not the logical stream.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from ..index import Index, create_index, load_index
from ..obs import flight as _flight
from ..resilience import faults
from ..row import Row
from ..source import take_rows
from ..utils.env import env_int
from ..utils.observe import telemetry
from .prune import (
    PruneDirectory,
    TierPruner,
    build_pruner,
    load_pruner,
    prune_enabled,
    write_pruner,
)

__all__ = [
    "DeltaTier",
    "MutableIndex",
    "ReadAmpTracker",
    "TierSet",
    "index_checksums",
    "rebuild_reference",
    "tier_rows",
]

_MODES = ("append", "upsert")


class DeltaTier:
    """One append batch and/or tombstone set at one stream position.

    ``index`` is the batch's small sorted Index (None for a pure
    tombstone tier); ``tombs`` is a sorted tuple of full-width key
    tuples that shadow every strictly OLDER tier (never this tier's own
    rows — after a partial merge a tier carries both, and its rows were
    appended after its deletes)."""

    __slots__ = ("seq", "index", "tombs", "tomb_set", "pruner",
                 "_pruner_built", "_plock")

    def __init__(self, seq: int, index: Optional[Index],
                 tombs: Sequence[Tuple[str, ...]] = (),
                 pruner: Optional[TierPruner] = None):
        self.seq = seq
        self.index = index
        self.tombs: Tuple[Tuple[str, ...], ...] = tuple(
            sorted(set(tuple(k) for k in tombs))
        )
        self.tomb_set: FrozenSet[Tuple[str, ...]] = frozenset(self.tombs)
        # fences + fingerprint filter for this tier's rows (prune.py);
        # None for pure tombstone tiers or when pruning is disabled.
        # Tombstones themselves are NEVER pruned — shadowing reads the
        # tomb_set directly, so a pruned row tier cannot un-shadow
        # anything.
        #
        # Freshly appended tiers arrive WITHOUT a pruner (the write-side
        # tax fix): the O(n) fence+filter scan is deferred to the first
        # probe via ensure_pruner, and the built summary is cached HERE
        # — the tier object survives TierSet swaps, so successor epochs
        # reuse it and each sealed batch pays the scan at most once.
        self.pruner = pruner
        self._pruner_built = pruner is not None or index is None
        self._plock = threading.Lock()

    def ensure_pruner(self, key_columns: Sequence[str]) -> Optional[TierPruner]:
        """The tier's pruner, building it on first demand (double-
        checked under the per-tier lock — the IndexImpl lazy-build
        idiom, so concurrent first probes scan once)."""
        if self._pruner_built:
            return self.pruner
        with self._plock:
            if not self._pruner_built:
                self.pruner = build_pruner(self.index._impl, key_columns)
                self._pruner_built = True
        return self.pruner

    @property
    def nrows(self) -> int:
        return 0 if self.index is None else len(self.index._impl)

    def __repr__(self) -> str:  # debugging aid only
        return (
            f"DeltaTier(seq={self.seq}, nrows={self.nrows}, "
            f"tombs={len(self.tombs)})"
        )


class TierSet:
    """Immutable snapshot of the tier list at one epoch.

    Readers that captured a TierSet keep answering from it even while
    a writer swaps in a successor — the old tiers stay alive (and
    correct) for as long as any reader holds them.
    """

    __slots__ = ("epoch", "base", "deltas", "base_pruner", "prune_dir",
                 "row_tiers", "positions", "tombs_by_age", "tomb_newest",
                 "key_columns", "_pd_built", "_pd_lock")

    def __init__(self, epoch: int, base: Index, deltas: Tuple[DeltaTier, ...],
                 base_pruner: Optional[TierPruner] = None):
        self.epoch = epoch
        self.base = base
        self.deltas = deltas
        self.base_pruner = base_pruner
        self.key_columns = tuple(base._impl.columns)
        # read-path projections, computed ONCE per swap: rebuilding
        # these per lookup costs one Python pass over every delta —
        # measurable at 100+ tiers even when pruning skips them all
        self.row_tiers = (base,) + tuple(
            d.index for d in deltas if d.index is not None
        )
        self.positions = (0,) + tuple(
            p + 1 for p, d in enumerate(deltas) if d.index is not None
        )
        self.tombs_by_age = tuple(
            (p + 1, d.tomb_set) for p, d in enumerate(deltas) if d.tombs
        )
        # merged newest-tombstone-per-key map: the full-width probe
        # shadow test becomes one dict hit instead of a membership test
        # against every tombstone tier
        newest: Dict[Tuple[str, ...], int] = {}
        for p, tset in self.tombs_by_age:
            for key in tset:
                newest[key] = p  # tombs_by_age ascends: last write wins
        self.tomb_newest = newest
        # the read path's prune directory is built LAZILY on the first
        # probe: appends do not pay the O(n)
        # fence+filter scan per sealed delta — the first bounds_many
        # after a swap does, once, with each per-tier summary cached on
        # the DeltaTier itself so successor epochs reuse it.  Pruning
        # engages only when a base pruner exists (CSVPLUS_LSM_PRUNE on
        # at seal time); with it off prune_dir stays None forever.
        self.prune_dir = None
        self._pd_built = base_pruner is None
        self._pd_lock = threading.Lock()

    def prune_directory(self) -> Optional[PruneDirectory]:
        """The epoch's prune directory, aggregated on first demand.

        Double-checked under the per-TierSet lock (the IndexImpl
        lazy-build idiom): concurrent first probes
        build once; every later probe is the same single attribute read
        the eager path had.  Missing delta summaries are built through
        :meth:`DeltaTier.ensure_pruner`, which caches them on the tier
        object — shared across epochs, so each sealed batch is scanned
        at most once over its whole lifetime."""
        if self._pd_built:
            return self.prune_dir
        with self._pd_lock:
            if not self._pd_built:
                prs = [self.base_pruner] + [
                    d.ensure_pruner(self.key_columns)
                    for d in self.deltas if d.index is not None
                ]
                if all(p is not None for p in prs):
                    self.prune_dir = PruneDirectory(prs, len(self.key_columns))
                self._pd_built = True
        return self.prune_dir

    def indexes(self) -> Tuple[Index, ...]:
        """All ROW tiers oldest→newest (base first; pure tombstone
        tiers carry no rows and are skipped)."""
        return self.row_tiers


class MultiBounds:
    """Pinned tier set + per-row-tier bounds for one probe batch.

    Opaque handle between :meth:`MutableIndex.bounds_many` and
    :meth:`MutableIndex.rows_for_bounds` — pinning the TierSet here
    keeps the two phases epoch-consistent even when the compactor
    swaps between them (the serving tier calls them separately).
    ``positions`` maps each bounds row back to its tier-stream position
    (base = 0, delta *i* = *i*+1) so tombstone shadowing can compare
    ages across row and tombstone tiers."""

    __slots__ = ("tiers", "per_tier", "probes", "row_tiers", "positions",
                 "tiers_probed", "tiers_pruned")

    def __init__(self, tiers: TierSet, per_tier, probes, row_tiers, positions):
        self.tiers = tiers
        self.per_tier = per_tier
        self.probes = probes
        self.row_tiers = row_tiers
        self.positions = positions
        # (probe, tier) bounds passes actually paid / skipped via
        # fences+filters for this batch — the serving tier forwards
        # these into its per-index metrics cells
        self.tiers_probed = 0
        self.tiers_pruned = 0


class ReadAmpTracker:
    """Observed read amplification: (probe, tier) bounds passes per
    lookup, with a resettable window the read-amp-aware Compactor
    polls.  ``on_lookup_batch`` and ``take_window`` may run on any
    thread — all state mutates under ``_lock`` (one lock round
    per probe BATCH, off the per-probe fast path)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._probes_total = 0
        self._tier_probes_total = 0
        self._pruned_total = 0
        self._win_probes = 0
        self._win_tier_probes = 0

    def on_lookup_batch(self, n_probes: int, tiers_probed: int,
                        tiers_pruned: int) -> None:
        with self._lock:
            self._probes_total += n_probes
            self._tier_probes_total += tiers_probed
            self._pruned_total += tiers_pruned
            self._win_probes += n_probes
            self._win_tier_probes += tiers_probed

    def take_window(self) -> Optional[float]:
        """Mean tiers probed per lookup since the last call (None when
        no lookups landed) — and reset the window."""
        with self._lock:
            p = self._win_probes
            tp = self._win_tier_probes
            self._win_probes = 0
            self._win_tier_probes = 0
        return (tp / p) if p else None

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            p = self._probes_total
            tp = self._tier_probes_total
            pr = self._pruned_total
        return {
            "probes": p,
            "tier_probes": tp,
            "tiers_pruned": pr,
            "mean_tiers_probed": round(tp / p, 3) if p else None,
        }


def tier_rows(impl) -> List[Row]:
    """Decode one tier's sorted rows WITHOUT flipping a device-lazy
    impl onto its host branch: touching ``impl.rows`` would cache host
    rows and permanently reroute ``bounds_many`` off the device path
    (the same trap HostLookupOracle documents)."""
    if impl._rows is None and impl.dev is not None:
        return impl.dev.table.to_rows()
    return impl.rows


def _logical_streams(ts: TierSet) -> List[List[Row]]:
    return [tier_rows(ix._impl) for ix in ts.indexes()]


def _upsert_filter(streams: List[List[Row]], key_cols: Sequence[str]) -> List[List[Row]]:
    """Drop every row whose full key appears in any LATER tier — the
    newest-wins rebuild rule, computed key-by-key on host rows
    (deliberately independent of the packed-key merge in compact.py so
    the parity harness cross-checks two implementations)."""
    newest: Dict[tuple, int] = {}
    for t, rows in enumerate(streams):
        for r in rows:
            newest[tuple(r[c] for c in key_cols)] = t
    return [
        [r for r in rows if newest[tuple(r[c] for c in key_cols)] == t]
        for t, rows in enumerate(streams)
    ]


def rebuild_reference(mindex: "MutableIndex", ts: Optional[TierSet] = None) -> Index:
    """From-scratch rebuild of the pinned tier set's logical stream —
    the parity harness's ground truth.  Replays tier events in order
    (a tier's tombstones erase matching keys from everything
    accumulated so far, THEN its rows append), applies the upsert
    newest-wins rule to the survivors, and routes through the HOST
    ``create_index`` build (stable Python sort over Row dicts) — a
    completely separate code path from the compactor's packed
    searchsorted merge, so agreement is meaningful."""
    ts = ts if ts is not None else mindex.tiers()
    cols = mindex.columns
    streams: List[List[Row]] = [tier_rows(ts.base._impl)]
    for d in ts.deltas:
        if d.tombs:
            dead = d.tomb_set
            streams = [
                [r for r in rows if tuple(r[c] for c in cols) not in dead]
                for rows in streams
            ]
        if d.index is not None:
            streams.append(tier_rows(d.index._impl))
        else:
            streams.append([])
    if mindex.mode == "upsert":
        streams = _upsert_filter(streams, cols)
    rows = [Row(r) for s in streams for r in s]
    return create_index(take_rows(rows), cols)


def index_checksums(index: Index, columns: Optional[Sequence[str]] = None) -> Dict[str, int]:
    """Positional per-column checksums over an index's sorted rows —
    the differential-harness currency (utils/checksum.py), order-
    sensitive so tier-merge bugs that permute equal keys still trip."""
    from ..utils.checksum import checksum_host_rows

    rows = tier_rows(index._impl)
    if columns is None:
        seen = set()
        columns = []
        for r in rows:
            for c in r:
                if c not in seen:
                    seen.add(c)
                    columns.append(c)
        columns = sorted(columns)
    return checksum_host_rows(rows, columns, positional=True)


class MutableIndex:
    """LSM-style mutable index over the immutable lookup engine.

    Implements the lookup-impl protocol the serving tier consumes
    (``columns`` / ``bounds_many`` / ``rows_for_bounds`` /
    ``find_rows_many``) plus the write surface (``append_rows`` /
    ``append_table`` / ``append_csv`` / ``delete`` / ``compact_once``
    / ``compact_step``), so a ``LookupServer`` can register one
    directly.  With ``directory=`` the write surface is durable (WAL +
    manifest, see the module docstring); ``wal_sync()`` is the serving
    tier's per-cycle ack barrier.
    """

    # lookup-protocol compatibility: the host-fallback oracle checks
    # ``impl.dev`` to decide whether it may reuse the impl directly —
    # a MutableIndex IS its own host-correct fallback
    dev = None

    def __init__(self, base: Index, *, mode: str = "append", ingest_device=None,
                 directory: Optional[str] = None, wal_sync: Optional[str] = None,
                 _manifest: Optional[Dict[str, object]] = None):
        if not isinstance(base, Index):
            raise TypeError("MutableIndex wraps an existing Index as its base tier")
        if mode not in _MODES:
            raise ValueError(f"unknown MutableIndex mode {mode!r} (use append|upsert)")
        self.mode = mode
        self._columns = list(base._impl.columns)
        impl = base._impl
        self._device = (
            impl.dev.table.device if impl.dev is not None else ingest_device
        )
        self._lock = threading.Lock()
        # serializes whole compaction passes (snapshot -> merge -> swap):
        # the swap-range invariant assumes at most one in-flight merge
        self._compact_lock = threading.Lock()
        # fences + fingerprint filters (prune.py): CSVPLUS_LSM_PRUNE
        # gates the whole subsystem.  A recovered index reloads the
        # checkpointed base's sidecar (named in the manifest) instead
        # of rescanning; a missing or corrupt sidecar degrades to the
        # rebuild scan — slower startup, never wrong answers.
        self._prune = prune_enabled()
        self._readamp = ReadAmpTracker()
        # optional build-side key-skew sketch: when the
        # telemetry plane installs a SpaceSaving here, every sealed
        # delta's keys are offered — heavy-hitter evidence for the
        # skew-aware join work.  None = zero overhead.
        self.key_sketch = None
        # tier-swap listeners (the views delta feed) — a tuple swapped
        # whole under self._lock so delivery iterates immutable state
        self._listeners: Tuple = ()
        base_pruner: Optional[TierPruner] = None
        if self._prune:
            side = None if _manifest is None else _manifest.get("prune")
            if directory is not None and side:
                try:
                    base_pruner = load_pruner(
                        os.path.join(directory, str(side)),
                        expect_nrows=len(base._impl),
                    )
                except Exception:
                    base_pruner = None  # rebuild by scan below
            if base_pruner is None:
                base_pruner = build_pruner(base._impl, self._columns)
        self._tiers = TierSet(0, base, (), base_pruner=base_pruner)
        self._next_seq = 1
        self._compactions = 0
        self._compact_seconds = 0.0
        # durability state (all None/0 for a memory-only index)
        self._dir = directory
        self._wal = None
        self._ckpt = 0
        self._applied_lsn = 0
        self._base_file: Optional[str] = None
        self.recovered_records = 0
        self.recovery_info: Optional[Dict[str, object]] = None
        if directory is None:
            return
        from . import manifest as mf
        from .wal import Wal

        if _manifest is None:
            # fresh durable directory: persist the base, start the WAL,
            # publish the first manifest — all durable before any ack
            os.makedirs(directory, exist_ok=True)
            if os.path.exists(os.path.join(directory, mf.MANIFEST_NAME)):
                raise mf.ManifestError(
                    f"{directory}: already a durable MutableIndex directory "
                    f"(use MutableIndex.open)"
                )
            self._ckpt = 1
            self._base_file = f"base-{self._ckpt:08d}.idx"
            path = os.path.join(directory, self._base_file)
            base.write_to(path)
            fd = os.open(path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            self._wal = Wal.create(directory, sync=wal_sync,
                                   columns=self._columns)
            prune_name = None
            if base_pruner is not None:
                prune_name = f"prune-{self._ckpt:08d}.flt"
                write_pruner(
                    os.path.join(directory, prune_name), base_pruner
                )
            mf.write_manifest(directory, mf.manifest_doc(
                mode=self.mode, key_columns=self._columns,
                checkpoint=self._ckpt, base=self._base_file, applied_lsn=0,
                segments=self._wal.segment_names(), prune=prune_name,
            ))
        else:
            # recovery: replay the WAL tail newer than the manifest's
            # applied_lsn through the SAME delta-encode path appends ride
            man = _manifest
            self._ckpt = int(man["checkpoint"])  # type: ignore[arg-type]
            self._applied_lsn = int(man["applied_lsn"])  # type: ignore[arg-type]
            self._base_file = str(man["base"])
            self._next_seq = self._applied_lsn + 1
            wal, replay, info = Wal.open(
                directory, self._applied_lsn, sync=wal_sync,
                columns=self._columns,
            )
            self._wal = wal
            for doc in replay:
                lsn = int(doc["lsn"])
                if doc.get("op") == "del":
                    delta = DeltaTier(lsn, None, (tuple(doc["key"]),))
                else:
                    rows = [Row(r) for r in doc["rows"]]
                    idx = self._build_delta_index(rows)
                    # no seal-time pruner: the first probe builds it
                    # (same lazy rule as the live append path)
                    delta = DeltaTier(lsn, idx)
                ts = self._tiers
                self._tiers = TierSet(ts.epoch + 1, ts.base,
                                      ts.deltas + (delta,),
                                      base_pruner=ts.base_pruner)
                self._next_seq = lsn + 1
            self.recovered_records = len(replay)
            self.recovery_info = info
            mf.remove_stale(directory, man)

    @classmethod
    def create(cls, src, columns: Sequence[str], *, mode: str = "append",
               ingest_device=None, directory: Optional[str] = None,
               wal_sync: Optional[str] = None) -> "MutableIndex":
        """Build the base tier with ``create_index`` and wrap it
        (durably when *directory* is given)."""
        return cls(create_index(src, columns), mode=mode,
                   ingest_device=ingest_device, directory=directory,
                   wal_sync=wal_sync)

    @classmethod
    def open(cls, directory: str, *, ingest_device=None,
             wal_sync: Optional[str] = None) -> "MutableIndex":
        """Recover a durable MutableIndex: load the manifest's base
        tier, replay the unsealed WAL tail (truncating a torn final
        record), and sweep crash leftovers.  The recovered state is
        bitwise-equal to replaying the acked logical stream into a
        fresh index.  A columnar base loads onto *ingest_device*
        (``"cuda"`` when None, as ``load_index``)."""
        from . import manifest as mf

        man = mf.read_manifest(directory)
        base = load_index(os.path.join(directory, str(man["base"])), ingest_device)
        if list(man["key_columns"]) != list(base._impl.columns):
            raise mf.ManifestError(
                f"{directory}: manifest key columns {man['key_columns']!r} "
                f"disagree with base tier columns {base._impl.columns!r}"
            )
        return cls(base, mode=str(man["mode"]), ingest_device=ingest_device,
                   directory=directory, wal_sync=wal_sync, _manifest=man)

    # -- lookup-impl protocol ----------------------------------------------

    @property
    def _impl(self) -> "MutableIndex":
        # LookupServer unwraps ``index._impl``; a MutableIndex is its
        # own impl (bounds_many/rows_for_bounds below span all tiers)
        return self

    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    @property
    def device(self):
        """The device the tiers are built on (the base's, else the
        ``ingest_device`` given), or None for a host-only index."""
        return self._device

    def _scope(self):
        """``torch.cuda.device`` of the index's card for device work on
        the calling thread (torch's current device is per thread); a
        no-op context on the CPU or for a host-only index."""
        import torch

        dev = self._device
        if dev is not None and torch.device(dev).type == "cuda":
            return torch.cuda.device(torch.device(dev))
        return contextlib.nullcontext()

    @property
    def epoch(self) -> int:
        return self._tiers.epoch

    @property
    def delta_count(self) -> int:
        return len(self._tiers.deltas)

    @property
    def durable(self) -> bool:
        return self._wal is not None

    @property
    def readamp(self) -> ReadAmpTracker:
        """Observed read-amplification counters (the read-amp-aware
        Compactor polls ``readamp.take_window()``)."""
        return self._readamp

    def tiers(self) -> TierSet:
        """Pin the current tier-set epoch (one atomic read)."""
        return self._tiers

    def subscribe(self, callback) -> TierSet:
        """Register a tier-swap listener and return the TierSet pinned
        at registration — every later append/delete fires exactly one
        event after it, so replaying the pinned set then applying
        events in delivery order reconstructs the logical stream with
        no gap and no duplicate (the views subsystem's feed).

        Events are ``("rows", seq, index)`` for an append tier and
        ``("tombs", seq, keys)`` for a tombstone tier (*keys* a tuple
        of full-width key tuples).  The callback runs UNDER the writer
        lock: it must be O(1) enqueue-only, must not raise, and must
        not call back into this index."""
        with self._lock:
            self._listeners = self._listeners + (callback,)
            return self._tiers

    def unsubscribe(self, callback) -> None:
        """Remove a tier-swap listener (no-op when absent); events
        already delivered stay delivered."""
        with self._lock:
            self._listeners = tuple(
                cb for cb in self._listeners if cb is not callback
            )

    def __len__(self) -> int:
        ts = self._tiers
        return sum(len(ix._impl) for ix in ts.indexes())

    def snapshot(self) -> Dict[str, object]:
        """JSON-safe accounting for metrics."""
        ts = self._tiers
        with self._lock:
            compactions = self._compactions
            compact_s = self._compact_seconds
            ckpt = self._ckpt
            applied = self._applied_lsn
        out = {
            "mode": self.mode,
            "epoch": ts.epoch,
            "base_rows": len(ts.base._impl),
            "deltas": len(ts.deltas),
            "delta_rows": sum(d.nrows for d in ts.deltas),
            "tombstones": sum(len(d.tombs) for d in ts.deltas),
            "compactions": compactions,
            "compact_seconds_total": round(compact_s, 6),
        }
        out["prune"] = dict(self._readamp.snapshot())
        # base_pruner presence (not prune_dir, which builds lazily on
        # the first probe) is what decides whether probes can prune
        out["prune"]["enabled"] = bool(
            self._prune and ts.base_pruner is not None
        )
        if self._wal is not None:
            out["wal"] = self._wal.stats()
            out["checkpoint"] = ckpt
            out["applied_lsn"] = applied
            out["recovered_records"] = self.recovered_records
        return out

    # -- reads (no lock on this path) --------------------------------------

    def bounds_many(self, probes: Sequence[Sequence[str]]) -> MultiBounds:
        """Per-tier bounds for the whole probe batch, pinned to one
        epoch.  Tombstone tiers hold no rows — they join at merge time
        via the pinned TierSet.

        Read-path pruning: before ANY per-tier
        bounds pass, the pinned TierSet's :class:`PruneDirectory`
        answers every (probe, tier) fence+filter test in one host numpy
        pass and the bounds passes run only against the shortlist —
        batched probes prune per-key against the shortlist union, so a
        tier pays a bounds pass only for the probes it may actually
        contain.  Pruning is one-sided (a skipped (probe, tier) pair is
        PROVEN empty and reads back as the same ``(0, 0)`` the bounds
        pass would have returned), so results are bitwise-identical
        with pruning on or off; false positives cost one redundant
        bounds pass.  Host numpy only — nothing here can recompile."""
        norm = [(p,) if isinstance(p, str) else tuple(p) for p in probes]
        width = len(self._columns)
        for p in norm:
            if len(p) > width:
                raise ValueError("too many columns in Index.find()")
        ts = self._tiers
        row_tiers = ts.row_tiers
        positions = ts.positions
        n_tiers = len(row_tiers)
        pd = ts.prune_directory()
        pruned = 0
        if pd is not None and norm and n_tiers > 1:
            t0 = time.perf_counter()
            n_b = len(norm)
            # tiers no probe survived drop out of the MultiBounds
            # entirely: they would contribute only (0, 0) bounds, and
            # carrying them would make rows_for_bounds pay one Python
            # visit per pruned tier per probe — the cold-tier tax this
            # pass exists to kill.  positions keep the ORIGINAL tier
            # epochs, so tombstone age masks and upsert newest-wins
            # ordering are unaffected by the renumbering.
            kept_rt = []
            kept_pos = []
            per_tier = []
            probed = 0
            if n_b == 1:
                # the serving single-probe shape: every surviving tier
                # needs the full (1-probe) bounds pass — no pass
                # matrix, no per-tier count bookkeeping
                for t in pd.shortlist(norm[0]):
                    per_tier.append(row_tiers[t]._impl.bounds_many(norm))
                    kept_rt.append(row_tiers[t])
                    kept_pos.append(positions[t])
                probed = len(kept_rt)
            else:
                keep = pd.pass_matrix(norm)
                counts = keep.sum(axis=0, dtype=np.int64).tolist()
                empty = [(0, 0)] * n_b
                for t, c in enumerate(counts):
                    if not c:
                        continue
                    ix = row_tiers[t]
                    if c == n_b:
                        sub = ix._impl.bounds_many(norm)
                    else:
                        sel = np.flatnonzero(keep[:, t])
                        part = ix._impl.bounds_many(
                            [norm[int(i)] for i in sel]
                        )
                        sub = list(empty)
                        for k, i in enumerate(sel):
                            sub[int(i)] = part[k]
                    per_tier.append(sub)
                    kept_rt.append(ix)
                    kept_pos.append(positions[t])
                    probed += c
            row_tiers = kept_rt
            positions = kept_pos
            pruned = n_b * n_tiers - probed
            if telemetry.enabled:
                telemetry.add_stage(
                    "storage:prune", n_b * n_tiers, probed,
                    time.perf_counter() - t0, tiers=n_tiers,
                )
        else:
            per_tier = [ix._impl.bounds_many(norm) for ix in row_tiers]
            probed = n_tiers * len(norm)
        self._readamp.on_lookup_batch(len(norm), probed, pruned)
        mb = MultiBounds(ts, per_tier, norm, row_tiers, positions)
        mb.tiers_probed = probed
        mb.tiers_pruned = pruned
        return mb

    def rows_for_bounds(self, mb: MultiBounds) -> List[List[Row]]:
        """Merge per-tier bounds into per-probe row blocks with ONE
        amortized gather-decode per tier (each tier's matched ranges
        decode together through its ``rows_for_bounds``).

        Fast paths: a probe matched by a single tier returns that
        tier's block directly; a full-width probe needs no key-level
        merge (all rows share one key — tombstones mask whole tiers by
        age, ``append`` concatenates survivors in tier order,
        ``upsert`` decodes only the newest matching tier).  Only
        PREFIX probes overlapping a live tombstone pay the host
        key-merge."""
        ts = mb.tiers
        row_tiers = mb.row_tiers
        positions = mb.positions
        per_tier = mb.per_tier
        n_tiers = len(row_tiers)
        n_probes = len(mb.probes)
        width = len(self._columns)
        upsert = self.mode == "upsert"
        tombs = ts.tombs_by_age
        eff: List[List[Tuple[int, int]]] = [
            [(0, 0)] * n_probes for _ in range(n_tiers)
        ]
        plan: List[Tuple[str, Tuple[int, ...]]] = [("none", ())] * n_probes
        for i in range(n_probes):
            live = [
                t for t in range(n_tiers) if per_tier[t][i][1] > per_tier[t][i][0]
            ]
            if not live:
                continue
            probe = mb.probes[i]
            full = len(probe) == width
            if tombs and full:
                # whole-tier age mask: the newest tombstone holding this
                # exact key erases every strictly older tier's rows
                shadow = ts.tomb_newest.get(probe, -1)
                if shadow >= 0:
                    live = [t for t in live if positions[t] >= shadow]
                    if not live:
                        continue
            elif tombs and any(tp > positions[live[0]] for tp, _ in tombs):
                # prefix probe with a tombstone newer than some matched
                # tier: individual keys may be shadowed — host key-merge
                for t in live:
                    eff[t][i] = per_tier[t][i]
                plan[i] = ("merge", tuple(live))
                continue
            if len(live) == 1 or (upsert and full):
                t = live[-1] if upsert else live[0]
                # single visible tier (or newest-wins point probe):
                # decode exactly one tier's range, shadowed rows never
                # leave the device/mirror
                eff[t][i] = per_tier[t][i]
                plan[i] = ("one", (t,))
            else:
                for t in live:
                    eff[t][i] = per_tier[t][i]
                kind = "concat" if full else "merge"
                plan[i] = (kind, tuple(live))
        decoded: List[Optional[List[List[Row]]]] = [None] * n_tiers
        for t in range(n_tiers):
            if any(hi > lo for lo, hi in eff[t]):
                decoded[t] = row_tiers[t]._impl.rows_for_bounds(eff[t])
        out: List[List[Row]] = []
        for i in range(n_probes):
            kind, live = plan[i]
            if kind == "none":
                out.append([])
            elif kind == "one":
                out.append(decoded[live[0]][i])
            elif kind == "concat":
                # full-width probe: every matched row carries the same
                # key, so tier order IS the rebuild's stable order
                rows: List[Row] = []
                for t in live:
                    rows.extend(decoded[t][i])
                out.append(rows)
            else:
                out.append(
                    _merge_blocks(
                        [(positions[t], decoded[t][i]) for t in live],
                        self._columns,
                        upsert,
                        tombs,
                    )
                )
        return out

    def find_rows_many(self, probes: Sequence[Sequence[str]]) -> List[List[Row]]:
        return self.rows_for_bounds(self.bounds_many(probes))

    def find_rows(self, values: Sequence[str]) -> List[Row]:
        return self.find_rows_many([values])[0]

    def has(self, values: Sequence[str]) -> bool:
        return bool(self.find_rows_many([values])[0])

    # -- writes (any thread) -----------------------------------------------

    def _build_delta_index(self, rows: List[Row]) -> Index:
        """One batch through the standard per-tier encode path — shared
        by the live append surface and WAL replay so a recovered tier
        is built exactly like the acked one was."""
        from ..columnar.ingest import source_from_table
        from ..columnar.table import DeviceTable

        with self._scope():
            table = DeviceTable.from_rows(rows, self._device or "cuda")
            return create_index(source_from_table(table), self._columns)

    def _make_pruner(self, idx: Index) -> Optional[TierPruner]:
        """Fences + filter for a freshly sealed tier (None when pruning
        is disabled).  Runs at seal time, outside any reader path."""
        if not self._prune:
            return None
        return build_pruner(idx._impl, self._columns)

    def append_rows(self, rows: Sequence) -> int:
        """Append a batch of rows as one new delta tier.

        The batch columnarizes through ``DeviceTable.from_rows`` and
        the device ``create_index`` build — the same per-tier encode
        path every index rides — then lands as a sorted delta.  On a
        durable index the batch's WAL record is written (and under
        ``CSVPLUS_WAL_SYNC=always`` fsynced) BEFORE the tier becomes
        visible; a WAL failure acks nothing and changes nothing."""
        rows = [r if isinstance(r, Row) else Row(r) for r in rows]
        if not rows:
            return 0
        idx = self._build_delta_index(rows)
        self._push_delta(idx, [dict(r) for r in rows])
        return len(rows)

    def append_table(self, table) -> int:
        """Append an already-columnarized DeviceTable as one delta."""
        from ..columnar.ingest import source_from_table

        if table.nrows == 0:
            return 0
        with self._scope():
            idx = create_index(source_from_table(table), self._columns)
        self._push_delta(idx, None)
        return table.nrows

    def append_csv(self, path: str, *, device: Optional[str] = None) -> int:
        """Append a CSV file through the ingest tiers
        (``columnar/ingest.py``, K workers via ``CSVPLUS_INGEST_WORKERS``
        on the streamed tier) — bitwise-identical deltas regardless of
        worker count, per the standing ingest contract.  The file goes to
        *device*, else to the index's own device (:attr:`device`: its
        base's, else the ``ingest_device`` given), else ``"cuda"``, as
        :meth:`append_rows` places its batches; the reference defaults to
        ``"cpu"`` here.  The reference's ``shards=`` (a row-sharded mesh)
        waits for the port's multi-GPU slice."""
        from ..reader import from_file

        src = from_file(path).on_device(
            device if device is not None else (self._device or "cuda"))
        with self._scope():
            idx = create_index(src, self._columns)
        n = len(idx._impl)
        if n == 0:
            return 0
        self._push_delta(idx, None)
        return n

    def delete(self, key: Sequence[str]) -> None:
        """Tombstone one full-width key: every currently visible row
        with this exact key disappears (in both visibility modes); rows
        appended afterwards are visible again.  Tombstones drop
        permanently at the next full merge.  Durable indexes write the
        tombstone's WAL record before it takes effect."""
        norm = (key,) if isinstance(key, str) else tuple(key)
        if len(norm) != len(self._columns):
            raise ValueError(
                f"delete() needs a full-width key ({len(self._columns)} "
                f"columns, got {len(norm)})"
            )
        sk = self.key_sketch
        if sk is not None:
            # a tombstone seal is build-side key traffic too
            sk.offer(norm[0] if len(norm) == 1 else norm)
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            if self._wal is not None:
                self._wal.append_record(
                    seq, {"lsn": seq, "op": "del", "key": list(norm)}
                )
            ts = self._tiers
            self._tiers = TierSet(
                ts.epoch + 1, ts.base,
                ts.deltas + (DeltaTier(seq, None, (norm,)),),
                base_pruner=ts.base_pruner,
            )
            for cb in self._listeners:
                cb(("tombs", seq, (norm,)))

    def wal_sync(self) -> Dict[str, int]:
        """Force buffered WAL records durable (the ``batch`` policy's
        ack barrier; cheap no-op shapes otherwise) and return the
        cycle-delta counters {records, bytes, fsyncs}.  The serving
        tier calls this once per dispatch cycle BEFORE completing
        append futures — the ack-after-fsync ordering."""
        w = self._wal
        if w is None:
            return {"records": 0, "bytes": 0, "fsyncs": 0}
        w.sync_now()
        return w.stats_delta()

    def close(self) -> None:
        """Flush and close the WAL (memory-only indexes: no-op)."""
        if self._wal is not None:
            self._wal.close()

    def _push_delta(self, idx: Index, wal_rows: Optional[List[Dict]]) -> None:
        if wal_rows is None and self._wal is not None:
            # append_table/append_csv: log the tier's own sorted rows
            # (replaying a stable sort of already-sorted rows rebuilds
            # the identical tier)
            wal_rows = [dict(r) for r in tier_rows(idx._impl)]
        sk = self.key_sketch
        if sk is not None:
            # build-side skew evidence, offered OUTSIDE the writer lock
            # (the sketch is its own monitor; order is immaterial)
            cols = self._columns
            rows = wal_rows if wal_rows is not None else tier_rows(idx._impl)
            if len(cols) == 1:
                col = cols[0]
                sk.offer_many(r.get(col) for r in rows)
            else:
                sk.offer_many(tuple(r.get(c) for c in cols) for r in rows)
        # no seal-time summary build: the first probe after the swap
        # pays the O(n) fence+filter scan once, via
        # DeltaTier.ensure_pruner — the write path stays scan-free
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            if self._wal is not None:
                self._wal.append_record(
                    seq, {"lsn": seq, "op": "rows", "rows": wal_rows}
                )
            ts = self._tiers
            delta = DeltaTier(seq, idx)
            self._tiers = TierSet(ts.epoch + 1, ts.base, ts.deltas + (delta,),
                                  base_pruner=ts.base_pruner)
            for cb in self._listeners:
                cb(("rows", seq, idx))
        _flight.note(
            "storage:seal", seq=seq, rows=len(idx._impl),
            deltas=len(ts.deltas) + 1,
        )

    # -- compaction --------------------------------------------------------

    def compact_once(self) -> Optional[Dict[str, object]]:
        """Merge ALL current deltas into the base and swap the merged
        tier set in atomically (tombstones apply and then drop for
        good).  Returns merge stats, or None when there was nothing to
        compact.  On a durable index a successful full merge
        checkpoints (new base file + sealed WAL + manifest swap).

        Crash safety: the fault-injection site ``storage:compact``
        fires once on entry and once just before the swap; an
        exception at either point (or anywhere in the merge) leaves
        ``self._tiers`` untouched — the pre-compaction tier set stays
        live and a retry starts clean.  A crash DURING the checkpoint
        (after the in-memory swap) leaves the durable state stale but
        consistent: recovery replays the original WAL records and
        reaches the same logical stream.  Appends racing the merge are
        preserved: only the pinned snapshot's deltas are folded in,
        newer deltas carry over as the new tail."""
        faults.inject("storage:compact")
        with self._compact_lock, self._scope():
            ts = self._tiers
            if not ts.deltas:
                return None
            return self._compact_full(ts)

    def compact_step(self, *, ratio: Optional[int] = None) -> Optional[Dict[str, object]]:
        """One pass of the size-ratio leveling policy: fold the oldest
        run of ≥ *ratio* same-level deltas into one merged delta (a
        PARTIAL merge — bounded write amplification, base untouched,
        no checkpoint), or escalate to a full merge once the delta
        mass reaches 1/*ratio* of the base.  Returns the pass's stats
        (``kind`` = ``partial`` | ``full``), or None when the policy
        finds nothing due.  *ratio* defaults to ``CSVPLUS_LSM_RATIO``
        (4)."""
        if ratio is None:
            ratio = env_int("CSVPLUS_LSM_RATIO", 4)
        if ratio < 2:
            raise ValueError("compact_step ratio must be >= 2")
        faults.inject("storage:compact")
        with self._compact_lock, self._scope():
            ts = self._tiers
            from .compact import plan_compaction

            sel = plan_compaction(ts, ratio)
            if sel is None:
                return None
            kind, span = sel
            if kind == "full":
                return self._compact_full(ts)
            i, j = span
            return self._compact_partial(ts, i, j)

    def _compact_full(self, ts: TierSet) -> Dict[str, object]:
        """Full fold (caller holds ``_compact_lock``)."""
        from .compact import merge_units, units_of

        n_in = sum(len(ix._impl) for ix in ts.indexes())
        t0 = time.perf_counter()
        with telemetry.stage("storage:compact", n_in) as _t:
            merged, _ = merge_units(
                units_of(ts), self._columns, self.mode, drop_tombstones=True
            )
            _t["deltas"] = len(ts.deltas)
            # the pre-swap crash window: a compactor death AFTER the
            # merge but BEFORE the swap must also leave the old tier
            # set intact
            faults.inject("storage:compact")
            pruner = self._make_pruner(merged)  # outside the lock
            seconds = time.perf_counter() - t0
            with self._lock:
                cur = self._tiers
                self._tiers = TierSet(
                    cur.epoch + 1, merged, cur.deltas[len(ts.deltas):],
                    base_pruner=pruner,
                )
                self._compactions += 1
                self._compact_seconds += seconds
            _t["rows_out"] = len(merged._impl)
        if self._wal is not None:
            self._checkpoint(merged, ts.deltas[-1].seq, pruner)
        _flight.note(
            "storage:compact", mode="full", deltas=len(ts.deltas),
            rows_out=len(merged._impl), seconds=round(seconds, 6),
        )
        return {
            "kind": "full",
            "deltas": len(ts.deltas),
            "rows_in": n_in,
            "rows_out": len(merged._impl),
            "seconds": seconds,
            "epoch": self._tiers.epoch,
        }

    def _compact_partial(self, ts: TierSet, i: int, j: int) -> Dict[str, object]:
        """Merge the contiguous delta run [i, j) into ONE delta tier
        (caller holds ``_compact_lock``).  In-range shadowing applies
        (upsert dead groups and tombstoned rows drop); surviving
        tombstones ride the merged tier so out-of-range older tiers
        stay shadowed.  The base and the manifest are untouched —
        recovery replays the ORIGINAL records and reaches the same
        logical stream."""
        from .compact import delta_units, merge_units

        run = ts.deltas[i:j]
        n_in = sum(d.nrows for d in run)
        t0 = time.perf_counter()
        with telemetry.stage("storage:compact", n_in) as _t:
            merged, tombs = merge_units(
                delta_units(run), self._columns, self.mode,
                drop_tombstones=False,
            )
            _t["deltas"] = len(run)
            _t["kind"] = "partial"
            faults.inject("storage:compact")
            seconds = time.perf_counter() - t0
            n_out = len(merged._impl)
            pruner = self._make_pruner(merged) if n_out else None
            with self._lock:
                cur = self._tiers
                # appends only extend the tail and merges serialize on
                # _compact_lock, so cur.deltas[i:j] is still `run`
                if n_out or tombs:
                    new = (
                        DeltaTier(run[-1].seq, merged if n_out else None,
                                  tombs, pruner=pruner),
                    )
                else:
                    new = ()
                self._tiers = TierSet(
                    cur.epoch + 1, cur.base,
                    cur.deltas[:i] + new + cur.deltas[j:],
                    base_pruner=cur.base_pruner,
                )
                self._compactions += 1
                self._compact_seconds += seconds
            _t["rows_out"] = n_out
        _flight.note(
            "storage:compact", mode="partial", deltas=len(run),
            rows_out=n_out, seconds=round(seconds, 6),
        )
        return {
            "kind": "partial",
            "deltas": len(run),
            "rows_in": n_in,
            "rows_out": n_out,
            "seconds": seconds,
            "epoch": self._tiers.epoch,
        }

    def _checkpoint(self, merged: Index, applied_lsn: int,
                    pruner: Optional[TierPruner] = None) -> None:
        """Publish a full merge durably: persist the merged base
        (versioned ``write_to`` format) and its prune sidecar, seal
        the active WAL segment, swap the manifest atomically, then
        drop applied segments and stale files.  ``storage:manifest-swap``
        fires in the pre-rename (hit 0) and post-rename/pre-drop
        (hit 1) windows; ``storage:prune-sidecar`` fires before (hit 0)
        and after (hit 1) the sidecar write — a crash in ANY of these
        leaves the previous manifest live (orphaned base/sidecar files
        are swept on the next checkpoint) and recovers to the same
        logical stream."""
        from . import manifest as mf

        directory = self._dir
        with self._lock:
            ck = self._ckpt + 1
        base_name = f"base-{ck:08d}.idx"
        final = os.path.join(directory, base_name)
        tmp = final + ".tmp"
        merged.write_to(tmp)
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, final)
        prune_name = None
        if pruner is not None:
            prune_name = f"prune-{ck:08d}.flt"
            faults.inject("storage:prune-sidecar")
            write_pruner(os.path.join(directory, prune_name), pruner)
            faults.inject("storage:prune-sidecar")
        self._wal.seal_active()
        faults.inject("storage:manifest-swap")
        doc = mf.manifest_doc(
            mode=self.mode, key_columns=self._columns, checkpoint=ck,
            base=base_name, applied_lsn=int(applied_lsn),
            segments=self._wal.segment_names(), prune=prune_name,
        )
        mf.write_manifest(directory, doc)
        faults.inject("storage:manifest-swap")
        with self._lock:
            self._ckpt = ck
            self._applied_lsn = int(applied_lsn)
            self._base_file = base_name
        self._wal.drop_applied(int(applied_lsn))
        mf.remove_stale(directory, doc)
        _flight.note(
            "storage:checkpoint", checkpoint=ck,
            applied_lsn=int(applied_lsn), base=base_name,
        )

    def to_index(self) -> Index:
        """A frozen Index equal to fully compacting the CURRENT tier
        set, without swapping it in (the concurrent-read tests' frozen
        equivalent)."""
        from .compact import merge_units, units_of

        ts = self._tiers
        if not ts.deltas:
            return ts.base
        with self._scope():
            merged, _ = merge_units(
                units_of(ts), self._columns, self.mode, drop_tombstones=True
            )
        return merged


def _merge_blocks(
    tagged: List[Tuple[int, List[Row]]],
    key_cols: Sequence[str],
    upsert: bool,
    tombs: Sequence[Tuple[int, FrozenSet[tuple]]] = (),
) -> List[Row]:
    """Key-level merge of per-tier row blocks for one PREFIX probe.

    Each block is sorted by full key (it came out of a sorted tier) and
    tagged with its tier-stream position; a tombstone at position *tp*
    erases matching keys from strictly older blocks.  The rebuild's
    order for the surviving union is (key, tier, within-tier position),
    which a stable sort by key alone reproduces because the input list
    is built tier-by-tier in position order."""
    if tombs:
        filtered: List[Tuple[int, List[Row]]] = []
        for pos, rows in tagged:
            newer = [tset for tp, tset in tombs if tp > pos]
            if newer:
                rows = [
                    r for r in rows
                    if not any(
                        tuple(r[c] for c in key_cols) in tset for tset in newer
                    )
                ]
            filtered.append((pos, rows))
        tagged = filtered
    if upsert:
        newest: Dict[tuple, int] = {}
        for t, rows in tagged:
            for r in rows:
                newest[tuple(r[c] for c in key_cols)] = t
        tagged = [
            (t, [r for r in rows if newest[tuple(r[c] for c in key_cols)] == t])
            for t, rows in tagged
        ]
    items: List[Tuple[tuple, Row]] = []
    for t, rows in tagged:
        for r in rows:
            items.append((tuple(r[c] for c in key_cols), r))
    items.sort(key=lambda it: it[0])  # stable: ties keep (tier, pos) order
    return [r for _, r in items]
