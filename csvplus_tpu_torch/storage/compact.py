"""Tier compaction: stable multi-way merge, leveling, the compactor.

Port of ``csvplus_tpu/storage/compact.py``: the same numpy merge, with
each merged column's codes placed on the index's device by one
``torch.from_numpy(...).to(device)`` upload.

The merge is grounded in the cache-efficient sorting design of the
Data-Parallel Graphics (DPG) line (arxiv cs/0308004): instead of a
naive k-way heap merge (one cache-hostile pointer chase per row), every
pass below is a **vectorized sequential sweep** over sorted arrays —
``np.union1d`` for the dictionary unions, one translation gather per
tier per column, and one ``np.searchsorted`` per tier pair to place
rows.  For tier *t*'s row *i* (packed key *k*), the merged position is

    pos = i + Σ_{u<t} searchsorted_right(keys_u, k)
            + Σ_{u>t} searchsorted_left(keys_u, k)

which reproduces the STABLE order of sorting the concatenated logical
stream (older tiers win ties), so the merged index is bitwise-equal to
a from-scratch rebuild — the parity contract the differential harness
enforces at every compaction step.  Tombstones ride the same packed
comparison: a tombstone unit's keys pack into the union code space and
two searchsorted probes mask every strictly OLDER unit's matching rows.
The final materialization is one permuted concat per column, landed on
the device with a single upload (no kernel is built or loaded: a
compaction leaves the :mod:`~csvplus_tpu_torch.obs.recompile` counts
where they were).  When shadowing dropped rows, each column's union
dictionary is pruned to the codes the survivors actually reference, so a
merged base carries no dictionary entry that only dead groups used.

Tiers that cannot ride the packed path (host-only tiers, typed
``IntColumn`` columns, non-bytes dictionaries, or a >62-bit union key
space with upsert shadowing or tombstones in play) fall back to a
host-row merge that is correct by construction (the same event replay
``rebuild_reference`` performs, then a stable sort).

Leveling (:func:`plan_compaction`) gives sustained append load bounded
write amplification: instead of folding ALL deltas into the base every
pass, same-sized delta runs fold into one another (size-ratio levels,
default ``CSVPLUS_LSM_RATIO=4``) and only a delta mass within one ratio
of the base triggers the full fold.  Each level merge is the same
snapshot-swap + searchsorted path — no kernel built or loaded.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..index import Index, IndexImpl
from ..row import Row
from ..utils.env import env_float
from ..utils.observe import telemetry
from .lsm import DeltaTier, MutableIndex, TierSet, _upsert_filter, tier_rows

__all__ = ["Compactor", "merge_tiers", "merge_units", "plan_compaction"]

# a merge unit is (impl-or-None, tombstone key tuple): one tier's rows
# and/or deletes at one stream position, oldest -> newest
Unit = Tuple[Optional[object], Tuple[Tuple[str, ...], ...]]


def units_of(ts: TierSet) -> List[Unit]:
    """Full tier set as merge units (base first, no base tombstones)."""
    return [(ts.base._impl, ())] + delta_units(ts.deltas)


def delta_units(deltas: Sequence[DeltaTier]) -> List[Unit]:
    return [
        ((d.index._impl if d.index is not None else None), d.tombs)
        for d in deltas
    ]


def merge_tiers(
    tiers: Sequence[Index], key_columns: Sequence[str], mode: str = "append"
) -> Index:
    """Merge sorted *tiers* (oldest→newest) into one sorted Index,
    bitwise-equal to rebuilding from the concatenated logical rows.
    (Tombstone-free compatibility wrapper around :func:`merge_units`.)"""
    merged, _ = merge_units(
        [(t._impl, ()) for t in tiers], key_columns, mode,
        drop_tombstones=True,
    )
    return merged


def merge_units(
    units: Sequence[Unit],
    key_columns: Sequence[str],
    mode: str = "append",
    *,
    drop_tombstones: bool,
) -> Tuple[Index, Tuple[Tuple[str, ...], ...]]:
    """Merge *units* (oldest→newest) into one sorted Index plus the
    surviving tombstone set.

    A unit's tombstones erase matching full keys from every strictly
    OLDER unit (its own rows were appended after its deletes and stay).
    ``drop_tombstones=True`` is the full merge into the base — nothing
    older remains, so tombstones are spent and the survivors are ``()``.
    ``drop_tombstones=False`` is a partial (level) merge — every unit
    tombstone survives onto the merged tier, because tiers older than
    the merged range still need shadowing."""
    key_columns = list(key_columns)
    units = list(units)
    n_total = sum(
        len(impl) for impl, _ in units if impl is not None  # type: ignore[arg-type]
    )
    with telemetry.stage("storage:merge", n_total) as _t:
        merged = _merge_device(units, key_columns, mode)
        _t["path"] = "device" if merged is not None else "host"
        _t["tiers"] = len(units)
        if merged is None:
            merged = _merge_host(units, key_columns, mode)
        _t["rows_out"] = len(merged._impl)
    if drop_tombstones:
        survivors: Tuple[Tuple[str, ...], ...] = ()
    else:
        survivors = tuple(
            sorted(set(k for _, tombs in units for k in tombs))
        )
    return merged, survivors


def _translate_host(col, union: np.ndarray, n: int) -> np.ndarray:
    """One tier column's codes in the union dictionary's code space —
    a host translation gather over the cached code mirror (negative
    codes pass through: -1 absent stays -1)."""
    codes = col.codes_host()
    if codes.shape[0] != n:
        codes = codes[:n]
    codes = codes.astype(np.int64)
    d = col.dictionary
    if d.size == 0:
        return codes  # no real values: every code is already negative
    trans = np.searchsorted(union, d).astype(np.int64)
    return np.where(codes >= 0, trans[np.clip(codes, 0, d.size - 1)], codes)


def _pack_tomb_keys(
    tombs: Sequence[Tuple[str, ...]],
    key_unions: List[np.ndarray],
    shifts: List[int],
) -> np.ndarray:
    """Tombstone keys in the packed union code space, sorted.  A key
    value absent from its column's union matches no in-range row and is
    simply skipped here (the tombstone itself still survives a partial
    merge for out-of-range shadowing)."""
    out: List[int] = []
    for key in tombs:
        packed = 0
        present = True
        for v, u, sh in zip(key, key_unions, shifts):
            b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            code = int(np.searchsorted(u, b))
            if code >= u.size or u[code] != b:
                present = False
                break
            packed |= code << sh
        if present:
            out.append(packed)
    return np.array(sorted(out), dtype=np.int64)


def _merge_device(
    units: List[Unit], key_columns: List[str], mode: str
) -> Optional[Index]:
    """The packed searchsorted merge; None when any tier/column cannot
    ride it (the caller then takes the host-row path)."""
    import torch

    from ..columnar.table import DeviceTable, StringColumn
    from ..ops.join import DeviceIndex, _bits_for

    row_pos: List[int] = []
    tables = []
    for p, (impl, _) in enumerate(units):
        if impl is None:
            continue
        if impl.dev is None:
            return None
        row_pos.append(p)
        tables.append(impl.dev.table)
    tomb_units = [(p, tombs) for p, (_, tombs) in enumerate(units) if tombs]
    if not tables:
        # nothing but tombstones: the merged tier carries no rows
        return Index(IndexImpl([], key_columns))
    for t in tables:
        for c in t.columns.values():
            if not isinstance(c, StringColumn):
                return None  # typed columns merge on the host path
    names: List[str] = []
    seen = set()
    for t in tables:
        for n in t.columns:
            if n not in seen:
                seen.add(n)
                names.append(n)
    n_rows = [t.nrows for t in tables]
    n_tiers = len(tables)

    # union dictionary per column: one sorted-union pass each.  (A
    # device-lane dictionary settles to its host form here, as in the
    # reference.)
    unions: Dict[str, np.ndarray] = {}
    for name in names:
        dicts = [
            np.asarray(t.columns[name].dictionary)
            for t in tables
            if name in t.columns
        ]
        if any(d.dtype.kind != "S" for d in dicts):
            return None  # non-bytes dictionary: host path
        u = dicts[0]
        for d in dicts[1:]:
            u = np.union1d(u, d)
        unions[name] = u

    key_unions = [unions[c] for c in key_columns]
    bits = [_bits_for(u.size) for u in key_unions]
    packed: Optional[List[np.ndarray]] = None
    shifts: List[int] = []
    if sum(bits) <= 62:
        acc = 0
        for b in reversed(bits):
            shifts.insert(0, acc)
            acc += b
        packed = []
        for t in range(n_tiers):
            k = np.zeros(n_rows[t], dtype=np.int64)
            for c, u, sh in zip(key_columns, key_unions, shifts):
                # key cells are never absent (create_index validated),
                # so the translated codes are all >= 0 and pack cleanly
                k |= _translate_host(tables[t].columns[c], u, n_rows[t]) << sh
            packed.append(k)
    elif mode == "upsert" or tomb_units:
        return None  # per-key shadowing needs the packed comparison

    keep: Optional[List[np.ndarray]] = None
    if mode == "upsert":
        # newest-wins: drop tier t's row when its key appears in ANY
        # newer tier — two searchsorted sweeps per (t, newer) pair
        keep = [np.ones(n_rows[t], dtype=bool) for t in range(n_tiers)]
        for t in range(n_tiers):
            for u_t in range(t + 1, n_tiers):
                lo = np.searchsorted(packed[u_t], packed[t], side="left")
                hi = np.searchsorted(packed[u_t], packed[t], side="right")
                keep[t] &= hi == lo
    if tomb_units and packed is not None:
        # a tombstone unit at position q masks matching rows in every
        # strictly older row unit — same two-probe membership sweep
        if keep is None:
            keep = [np.ones(n_rows[t], dtype=bool) for t in range(n_tiers)]
        for q, tombs in tomb_units:
            tk = _pack_tomb_keys(tombs, key_unions, shifts)
            if tk.size == 0:
                continue
            for t in range(n_tiers):
                if row_pos[t] >= q:
                    continue
                lo = np.searchsorted(tk, packed[t], side="left")
                hi = np.searchsorted(tk, packed[t], side="right")
                keep[t] &= hi == lo

    if packed is not None:
        kept = [
            packed[t][keep[t]] if keep is not None else packed[t]
            for t in range(n_tiers)
        ]
        total = sum(k.size for k in kept)
        g = np.empty(total, dtype=np.int64)
        off = 0
        for t in range(n_tiers):
            pos = np.arange(kept[t].size, dtype=np.int64)
            for u_t in range(n_tiers):
                if u_t == t:
                    continue
                side = "right" if u_t < t else "left"
                pos += np.searchsorted(kept[u_t], kept[t], side=side)
            if keep is not None:
                src = np.flatnonzero(keep[t]).astype(np.int64) + off
            else:
                src = np.arange(n_rows[t], dtype=np.int64) + off
            g[pos] = src
            off += n_rows[t]
    else:
        # >62-bit union key space, pure append, no tombstones: stable
        # lexsort over the translated key-code matrix — same order
        cat_keys = [
            np.concatenate(
                [
                    _translate_host(tables[t].columns[c], u, n_rows[t])
                    for t in range(n_tiers)
                ]
            )
            for c, u in zip(key_columns, key_unions)
        ]
        g = np.lexsort(tuple(reversed(cat_keys)))
        total = int(g.size)

    if total == 0:
        # mirror create_index: an empty result is a host-backed empty
        # index (no device build over zero rows)
        return Index(IndexImpl([], key_columns))

    # rows were dropped (upsert shadowing / tombstones): union
    # dictionary entries only dead rows referenced must not ride into
    # the merged tier — prune to the codes the survivors reference,
    # order-preserving so sortedness and the code order both hold
    prune = keep is not None
    device = tables[0].device
    cols: Dict[str, StringColumn] = {}
    for name in names:
        u = unions[name]
        parts = []
        for t in range(n_tiers):
            col = tables[t].columns.get(name)
            if col is None:
                parts.append(np.full(n_rows[t], -1, dtype=np.int64))
            else:
                parts.append(_translate_host(col, u, n_rows[t]))
        cg = np.concatenate(parts)[g]
        if prune and u.size:
            used = np.unique(cg[cg >= 0])
            if used.size < u.size:
                cg = np.where(cg >= 0, np.searchsorted(used, cg), cg)
                u = u[used]
        cols[name] = StringColumn(
            u, torch.from_numpy(cg.astype(np.int32)).to(device)
        )
    out_table = DeviceTable(cols, int(total), device)
    dev = DeviceIndex.build(out_table, key_columns)
    return Index(IndexImpl(None, key_columns, dev=dev))


def _merge_host(units: List[Unit], key_columns: List[str], mode: str) -> Index:
    """Correct-by-construction fallback: replay tier events in order
    (a unit's tombstones erase matching keys from everything older,
    then its rows append), apply newest-wins, stable host sort —
    create_index's own ordering over the surviving logical stream."""
    streams: List[List[Row]] = []
    for impl, tombs in units:
        if tombs:
            dead = set(tombs)
            streams = [
                [
                    r for r in rows
                    if tuple(r[c] for c in key_columns) not in dead
                ]
                for rows in streams
            ]
        streams.append(tier_rows(impl) if impl is not None else [])
    if mode == "upsert":
        streams = _upsert_filter(streams, key_columns)
    rows = [Row(r) for s in streams for r in s]
    rows.sort(key=lambda r: tuple(r[c] for c in key_columns))  # stable
    return Index(IndexImpl(rows, key_columns))


def _tier_level(nrows: int, ratio: int) -> int:
    """Size-ratio level: how many times *nrows* divides by *ratio*
    (level 0 = a fresh append batch, each level up is ~ratio× larger)."""
    lvl = 0
    n = int(nrows)
    while n >= ratio:
        n //= ratio
        lvl += 1
    return lvl


def plan_compaction(
    ts: TierSet, ratio: int
) -> Optional[Tuple[str, Tuple[int, int]]]:
    """The size-ratio leveling policy's next move for *ts*, or None.

    Returns ``("full", (0, len(deltas)))`` when the total delta row
    mass is within one *ratio* of the base (folding everything in is
    then amortized), else ``("partial", (i, j))`` for the OLDEST
    contiguous run of at least *ratio* same-level row tiers (pure
    tombstone tiers are levelless and absorb into any run; a run of
    ≥ 2 tombstone-only tiers folds on its own).  Each delta is merged
    O(log_ratio(n)) times before reaching the base — bounded write
    amplification under sustained append load."""
    deltas = ts.deltas
    if not deltas:
        return None
    total = sum(d.nrows for d in deltas)
    if total * ratio >= max(len(ts.base._impl), 1):
        return ("full", (0, len(deltas)))

    start = 0
    cur_lvl: Optional[int] = None  # run's row-tier level (None: tombs only)
    count = 0  # row tiers in the current run
    for idx, d in enumerate(deltas):
        lvl = None if d.index is None else _tier_level(d.nrows, ratio)
        extends = (
            idx == start
            or lvl is None
            or cur_lvl is None
            or lvl == cur_lvl
        )
        if not extends:
            if count >= ratio or (count == 0 and idx - start >= 2):
                return ("partial", (start, idx))
            start = idx
            cur_lvl = None
            count = 0
        if lvl is not None:
            if cur_lvl is None:
                cur_lvl = lvl
            count += 1
    end = len(deltas)
    if count >= ratio or (count == 0 and end - start >= 2):
        return ("partial", (start, end))
    return None


class Compactor:
    """Background compaction thread over one :class:`MutableIndex`.

    ``policy="full"`` folds every delta into the base each pass;
    ``policy="leveled"`` runs the size-ratio policy —
    :meth:`MutableIndex.compact_step` — for bounded write amplification
    under sustained appends; ``policy="readamp"`` schedules
    from OBSERVED read amplification: each pass drains the index's
    :class:`~csvplus_tpu_torch.storage.lsm.ReadAmpTracker` window and
    compacts only while the mean tiers-probed-per-lookup exceeds
    ``readamp_target`` (default ``CSVPLUS_LSM_READAMP_TARGET`` = 4.0)
    — a leveled step first, escalating to a full fold when the ratio
    policy finds nothing due but lookups still pay too many tiers.
    With fences+filters pruning most tiers, a cold tier that no lookup
    ever touches never forces a merge — compaction work tracks what
    readers actually pay, not raw tier counts.

    ``_compact_loop`` runs on the compactor's own thread: all Compactor
    state mutates under ``self._lock``; the index's own swap discipline
    (and its device scope) lives in :meth:`MutableIndex.compact_once`.  A failed pass (including an
    injected ``storage:compact`` fault) leaves the tier set untouched
    and is retried on the next interval — compaction is idempotent
    from any crash point before the swap.
    """

    def __init__(
        self,
        index: MutableIndex,
        *,
        min_deltas: int = 1,
        interval_s: float = 0.02,
        metrics=None,
        index_name: str = "default",
        policy: str = "full",
        ratio: Optional[int] = None,
        readamp_target: Optional[float] = None,
    ):
        if min_deltas < 1:
            raise ValueError("min_deltas must be >= 1")
        if policy not in ("full", "leveled", "readamp"):
            raise ValueError(f"unknown Compactor policy {policy!r}")
        self.index = index
        self.min_deltas = int(min_deltas)
        self.interval_s = float(interval_s)
        self.policy = policy
        self.ratio = ratio
        if readamp_target is None:
            readamp_target = env_float("CSVPLUS_LSM_READAMP_TARGET", 4.0)
        self.readamp_target = float(readamp_target)
        if self.readamp_target < 1.0:
            raise ValueError("readamp_target must be >= 1.0")
        self.last_readamp: Optional[float] = None
        self._metrics = metrics
        self._name = index_name
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.compactions = 0
        self.failures = 0
        self.last_error: Optional[BaseException] = None
        self.last_stats: Optional[Dict[str, object]] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Compactor":
        if self._thread is not None:
            return self
        self._stop.clear()
        t = threading.Thread(
            target=self._compact_loop, name="csvplus-storage-compact", daemon=True
        )
        self._thread = t
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "Compactor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- one pass ----------------------------------------------------------

    def run_once(self) -> Optional[Dict[str, object]]:
        """One compaction pass (also the unit tests' direct entry).
        Exceptions propagate to the caller; the loop catches them."""
        if self.policy == "readamp":
            stats = self._readamp_pass()
        elif self.policy == "leveled":
            stats = self.index.compact_step(ratio=self.ratio)
        else:
            stats = self.index.compact_once()
        if stats is not None:
            with self._lock:
                self.compactions += 1
                self.last_stats = stats
            m = self._metrics
            if m is not None:
                m.on_compact(
                    self._name,
                    int(stats["deltas"]),
                    int(stats["rows_out"]),
                    float(stats["seconds"]),
                    deltas_live=self.index.delta_count,
                )
        return stats

    def _readamp_pass(self) -> Optional[Dict[str, object]]:
        """One read-amp-driven pass: drain the observation window; when
        the mean tiers-probed exceeds the target, run one leveled step
        (bounded write amplification), escalating to a full fold when
        the size-ratio policy has nothing due but readers still pay.
        No lookups since the last pass -> no evidence -> no work."""
        mean = self.index.readamp.take_window()
        if mean is not None:
            with self._lock:
                self.last_readamp = mean
        if mean is None or mean <= self.readamp_target:
            return None
        stats = self.index.compact_step(ratio=self.ratio)
        if stats is None:
            stats = self.index.compact_once()
        return stats

    def _compact_loop(self) -> None:
        while not self._stop.is_set():
            try:
                if self.index.delta_count >= self.min_deltas:
                    self.run_once()
            except Exception as err:
                # retryable by design: every crash point before the
                # swap leaves the pre-compaction tier set live, so the
                # next interval simply tries again — record and report
                with self._lock:
                    self.failures += 1
                    self.last_error = err
                sys.stderr.write(
                    f"csvplus-storage: compaction pass failed "
                    f"({type(err).__name__}: {err}); tier set unchanged, "
                    f"retrying next interval\n"
                )
            self._stop.wait(self.interval_s)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "policy": self.policy,
                "readamp_target": self.readamp_target,
                "last_readamp": (
                    round(self.last_readamp, 3)
                    if self.last_readamp is not None
                    else None
                ),
                "compactions": self.compactions,
                "failures": self.failures,
                "last_error": (
                    None
                    if self.last_error is None
                    else f"{type(self.last_error).__name__}: {self.last_error}"
                ),
                "last_stats": dict(self.last_stats) if self.last_stats else None,
            }
