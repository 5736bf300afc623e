"""Index: a sorted, materialized collection of Rows with O(log n) search.

Port of ``csvplus_tpu/index.py`` (the reference's index,
csvplus.go:610-920): building, the unique check, ``find``, the batched
``find_many``, ``sub_index``, ``resolve_duplicates`` and ``on_device``.
Persistence (``write_to``, ``load_index``) is not ported yet.

Semantics kept: building an index materializes the source and checks
every row has all key columns, with the reference's message; ``find``
takes a prefix of the key values; a host index sorts stably by the key
columns (byte order, which Python's str order equals for UTF-8).

An index built from a device-planned source is **device-resident and
lazy**: the sort runs over dictionary codes on the device
(:mod:`.ops.sort`), the unique check is one adjacent-equality reduction,
``find``/``find_many`` search the packed keys and decode only the
matching ranges, and host rows are decoded only when a host-only
operation needs them.

Lookups run through ONE engine: ``find`` is ``find_many`` of one probe,
and ``find_many`` is :meth:`IndexImpl.bounds_many` (one vectorized
search per key tier, :meth:`~.ops.join.DeviceIndex.point_bounds_many`)
then :meth:`IndexImpl.rows_for_bounds` (one decode over the union of the
matched ranges: from host mirrors of the columns while the table holds
at most ``POINT_MIRROR_MAX_KEYS`` cells, else one device gather per
batch).  On a device index every result carries a
:class:`~.plan.Lookup` plan, so a stage applied to it lowers to the
device.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .errors import CsvPlusError, DataSourceError
from .row import Row, all_columns_unique, equal_rows
from .source import DataSource, RowFunc, iterate, take_rows

Resolver = Union[str, Callable[[List[Row]], Optional[Row]]]


class IndexImpl:
    """Sorted rows + key column list (reference ``indexImpl``,
    csvplus.go:785-788).  ``rows`` may be lazily backed by a sorted
    device table (``dev``), decoded on first host access."""

    def __init__(self, rows: Optional[List[Row]], columns: Sequence[str], dev=None):
        self._rows = rows
        self.columns = list(columns)
        self._keys: Optional[List[Tuple[str, ...]]] = None
        self._probe_map: Optional[Dict[Tuple[str, ...], Tuple[int, int]]] = None
        self.dev = dev  # ops.join.DeviceIndex over the sorted columnar copy
        # serializes the lazy builds (rows, key cache, probe map) under
        # concurrent readers: the serving tier's threads would each pay
        # the O(n) build.  Reentrant because keys -> rows nest.  Reads
        # are safe concurrently; a writer mutating the index (rows
        # setter, sort, dedup) under readers is a caller error.
        self._lock = threading.RLock()

    @property
    def is_lazy(self) -> bool:
        return self._rows is None

    @property
    def rows(self) -> List[Row]:
        if self._rows is None:
            with self._lock:
                if self._rows is None:
                    self._rows = self.dev.table.to_rows()
        return self._rows

    @rows.setter
    def rows(self, value: List[Row]) -> None:
        self._rows = value
        self._keys = None
        self._probe_map = None

    def __len__(self) -> int:
        if self._rows is None and self.dev is not None:
            return self.dev.table.nrows
        return len(self.rows)

    @property
    def keys(self) -> List[Tuple[str, ...]]:
        """Per-row key tuples, built lazily (once, under the lock)."""
        if self._keys is None:
            with self._lock:
                if self._keys is None:
                    cols = self.columns
                    self._keys = [tuple(r[c] for c in cols) for r in self.rows]
        return self._keys

    def sort(self) -> None:
        """Stable sort of the rows by the key columns (csvplus.go:794-807)."""
        cols = self.columns
        self.rows = sorted(self.rows, key=lambda r: tuple(r[c] for c in cols))

    def bounds(self, values: Sequence[str]) -> Tuple[int, int]:
        """[lower, upper) range of rows whose key prefix equals *values*."""
        if len(values) > len(self.columns):
            raise ValueError("too many columns in Index.find()")
        if self._rows is None and self.dev is not None and self.dev.supported:
            return self.dev.point_bounds(list(values))
        if not values:
            return 0, len(self.rows)
        k = len(values)
        v = tuple(values)
        if k == len(self.columns):
            return self._ensure_probe_map().get(v, (0, 0))
        keys = self.keys
        lower = bisect.bisect_left(keys, v, key=lambda kt: kt[:k])
        upper = bisect.bisect_right(keys, v, lo=lower, key=lambda kt: kt[:k])
        return lower, upper

    def _ensure_probe_map(self) -> Dict[Tuple[str, ...], Tuple[int, int]]:
        """Full-width key tuple -> [lower, upper), one O(n) sweep (once,
        under the lock)."""
        pm = self._probe_map
        if pm is None:
            with self._lock:
                pm = self._probe_map
                if pm is None:
                    pm = {}
                    keys = self.keys
                    i, n = 0, len(keys)
                    while i < n:
                        j = i + 1
                        while j < n and keys[j] == keys[i]:
                            j += 1
                        pm[keys[i]] = (i, j)
                        i = j
                    self._probe_map = pm
        return pm

    def bounds_many(self, probes: Sequence[Sequence[str]]) -> List[Tuple[int, int]]:
        """Batched :meth:`bounds` — the search half of the lookup engine.

        A device-lazy index takes ONE vectorized pass over the packed
        keys (``DeviceIndex.point_bounds_many``).  A host index answers
        full-width probes from the probe map and sweeps each prefix
        width in sorted probe order, so the bisect window only narrows.
        """
        for p in probes:
            if len(p) > len(self.columns):
                raise ValueError("too many columns in Index.find()")
        if self._rows is None and self.dev is not None and self.dev.supported:
            return self.dev.point_bounds_many(probes)
        n = len(self.rows)
        full = len(self.columns)
        out: List[Optional[Tuple[int, int]]] = [None] * len(probes)
        by_k: Dict[int, List[int]] = {}
        for i, p in enumerate(probes):
            k = len(p)
            if k == 0:
                out[i] = (0, n)
            elif k == full:
                out[i] = self._ensure_probe_map().get(tuple(p), (0, 0))
            else:
                by_k.setdefault(k, []).append(i)
        if by_k:
            keys = self.keys
            for k, idxs in by_k.items():
                idxs.sort(key=lambda i: tuple(probes[i]))
                lo = 0
                prev: Optional[Tuple[str, ...]] = None
                prev_bounds = (0, 0)
                for i in idxs:
                    v = tuple(probes[i])
                    if v == prev:
                        out[i] = prev_bounds  # a duplicate probe
                        continue
                    lower = bisect.bisect_left(keys, v, lo=lo, key=lambda kt: kt[:k])
                    upper = bisect.bisect_right(keys, v, lo=lower, key=lambda kt: kt[:k])
                    out[i] = prev_bounds = (lower, upper)
                    prev, lo = v, lower
        return out  # type: ignore[return-value]

    def find_rows(self, values: Sequence[str]) -> List[Row]:
        """Row range matching the key prefix (csvplus.go:870-891), through
        the batched engine; a device-lazy index decodes only that range."""
        return self.find_rows_many([values])[0]

    def find_rows_many(self, probes: Sequence[Sequence[str]]) -> List[List[Row]]:
        """Batched :meth:`find_rows`: every bound in one pass
        (:meth:`bounds_many`), then one decode over the union of the
        matched ranges (:meth:`rows_for_bounds`)."""
        return self.rows_for_bounds(self.bounds_many(probes))

    def rows_for_bounds(self, bounds: Sequence[Tuple[int, int]]) -> List[List[Row]]:
        """One row block per [lower, upper) range.

        A device-lazy index decodes the matched ranges together: from
        host mirrors of its columns (LRU-cached,
        ``DeviceTable.rows_from_mirror_many``) while the table holds at
        most ``POINT_MIRROR_MAX_KEYS`` cells, else with ONE device gather
        and decode for the whole batch."""
        if self._rows is None and self.dev is not None:
            from .ops.join import DeviceIndex

            table = self.dev.table
            # gate on CELLS, not rows: the mirror downloads every column
            cells = table.nrows * max(len(table.columns), 1)
            if cells <= DeviceIndex.POINT_MIRROR_MAX_KEYS:
                return table.rows_from_mirror_many(bounds)
            out: List[List[Row]] = [[] for _ in bounds]
            hit = [(i, int(lo), int(hi)) for i, (lo, hi) in enumerate(bounds) if hi > lo]
            if hit:
                idx = np.concatenate([np.arange(lo, hi, dtype=np.int64) for _, lo, hi in hit])
                rows = table.to_rows(idx)
                off = 0
                for i, lo, hi in hit:
                    out[i] = rows[off : off + (hi - lo)]
                    off += hi - lo
            return out
        rows = self.rows
        return [rows[lo:hi] for lo, hi in bounds]

    def has(self, values: Sequence[str]) -> bool:
        """True when any row matches the key prefix (csvplus.go:899-905)."""
        lower, upper = self.bounds(values)
        return lower < upper

    def dedup(self, resolve: Callable[[List[Row]], Optional[Row]]) -> None:
        """Replace each duplicate-key group by *resolve*'s row; a row with
        fewer cells than key columns drops the group (csvplus.go:809-867)."""
        rows, cols = self.rows, self.columns
        out: List[Row] = []
        i, n = 0, len(rows)
        changed = False
        while i < n:
            j = i + 1
            while j < n and equal_rows(cols, rows[i], rows[j]):
                j += 1
            if j - i == 1:
                out.append(rows[i])
            else:
                changed = True
                chosen = resolve(rows[i:j])
                if chosen is not None and len(chosen) >= len(cols):
                    out.append(chosen if isinstance(chosen, Row) else Row(chosen))
            i = j
        if changed:
            self.rows = out


class Index:
    """Sorted collection of Rows (reference ``Index``, csvplus.go:610-653)."""

    def __init__(self, impl: IndexImpl):
        self._impl = impl
        # DeviceIndex over the sorted columnar copy (None = host-only);
        # device joins and finds use it
        self.device_table = impl.dev

    def materialize(self) -> "Index":
        """Decode a device-lazy index into host rows (idempotent)."""
        _ = self._impl.rows
        return self

    def sync(self) -> "Index":
        """Wait until the device build (sort and gathers) has run; a
        no-op for host indexes.  Without it the build's time lands in
        whatever first touches the index."""
        if self._impl.dev is not None:
            self._impl.dev.table.sync()
        return self

    def iterate(self, fn: RowFunc) -> None:
        """Iterate rows in key order, cloning each (csvplus.go:618-620)."""
        iterate(self._impl.rows, fn)

    Iterate = iterate

    def __len__(self) -> int:
        return len(self._impl)

    @property
    def columns(self) -> List[str]:
        return list(self._impl.columns)

    def find(self, *values: str) -> DataSource:
        """Source over the rows matching the key-value prefix
        (csvplus.go:625-627); on a device index only the matching range
        is decoded.  It is :meth:`find_many` of one probe."""
        return self.find_many([values])[0]

    def find_many(self, probes: Sequence) -> List[DataSource]:
        """Batched :meth:`find`: one DataSource per key-prefix probe (a
        bare string is a one-column prefix).  The batch runs through one
        vectorized bounds search and one decode, and each result equals
        the matching single ``find``.  On a supported device index every
        result also carries a :class:`~.plan.Lookup` plan, so stages
        applied to it keep lowering to the device."""
        impl = self._impl
        norm = [(p,) if isinstance(p, str) else tuple(p) for p in probes]
        bounds = impl.bounds_many(norm)
        groups = impl.rows_for_bounds(bounds)
        if impl._rows is None and impl.dev is not None and impl.dev.supported:
            from .plan import Lookup

            dev_table = impl.dev.table
            out = []
            # the decoded blocks may be shared with the mirror LRU: every
            # delivery path clones (iterate, the sinks' _rows_hint)
            for rows, (lo, hi) in zip(groups, bounds):
                src = DataSource(lambda fn, _rows=rows: iterate(_rows, fn))
                src._rows_hint = rows
                src.plan = Lookup(dev_table, lo, hi)
                out.append(src)
            return out
        return [take_rows(rows) for rows in groups]

    def sub_index(self, *values: str) -> "Index":
        """Index of the rows matching the key prefix, keyed on the
        remaining columns (csvplus.go:632-641); a device index gathers
        the range on the device."""
        impl = self._impl
        if len(values) >= len(impl.columns):
            raise ValueError("too many values in SubIndex()")
        rest = impl.columns[len(values):]
        if impl.is_lazy and impl.dev is not None and impl.dev.supported:
            from .ops.join import DeviceIndex

            lower, upper = impl.dev.point_bounds(list(values))
            table = impl.dev.table
            sel = torch.arange(lower, upper, dtype=torch.int64, device=table.device)
            return Index(IndexImpl(None, rest, dev=DeviceIndex.build(table.gather(sel), rest)))
        return Index(IndexImpl(impl.find_rows(values), rest))

    def resolve_duplicates(self, resolve: Resolver) -> None:
        """Resolve groups of rows with duplicate keys (csvplus.go:643-653).

        *resolve* is a callback receiving each group and returning the row
        to keep (an empty row or None drops the group), or a named policy,
        ``"first"`` or ``"last"``, which a device-lazy index applies with
        a run-boundary mask and a gather, decoding no rows."""
        impl = self._impl
        if isinstance(resolve, str):
            if resolve not in ("first", "last"):
                raise ValueError(f"unknown duplicate-resolution policy {resolve!r}")
            if impl.is_lazy and impl.dev is not None:
                self._device_policy_dedup(resolve)
                return
            resolve = (lambda g: g[0]) if resolve == "first" else (lambda g: g[-1])
        impl.dedup(resolve)
        self.device_table = None  # the columnar copy is stale after mutation
        impl.dev = None

    def _device_policy_dedup(self, policy: str) -> None:
        from .ops.join import DeviceIndex
        from .ops.sort import run_starts

        impl = self._impl
        table = impl.dev.table
        starts = run_starts(table, impl.columns)
        if policy == "first":
            keep = starts
        else:  # "last": a row is kept when the NEXT row starts a new run
            keep = np.roll(starts, -1)
            if keep.size:
                keep[-1] = True
        if keep.all():
            return
        sel = torch.from_numpy(np.flatnonzero(keep)).to(table.device)
        impl.dev = DeviceIndex.build(table.gather(sel), impl.columns)
        impl.rows = None
        self.device_table = impl.dev

    def on_device(self, device: str = "cuda") -> "Index":
        """Attach a device-resident columnar copy of this index so joins
        against it run on the device."""
        from .columnar.ingest import index_to_device

        self.device_table = index_to_device(self, device=device)
        self._impl.dev = self.device_table
        return self

    OnDevice = on_device
    Find = find
    FindMany = find_many
    SubIndex = sub_index
    ResolveDuplicates = resolve_duplicates


def _validate_index_columns(columns: Sequence[str]) -> Tuple[str, ...]:
    columns = tuple(columns)
    if len(columns) == 0:
        raise ValueError("empty column list in CreateIndex()")
    if len(columns) > 1 and not all_columns_unique(columns):
        raise ValueError("duplicate column name(s) in CreateIndex()")
    return columns


def create_index(src, columns: Sequence[str]) -> Index:
    """Materialize and sort an index (csvplus.go:707-738); a
    device-planned source builds it on the device."""
    columns = _validate_index_columns(columns)
    if getattr(src, "plan", None) is not None:
        from .columnar.exec import UnsupportedPlan

        try:
            return _create_index_device(src.plan, columns)
        except UnsupportedPlan:
            pass  # fall through to the host build

    rows: List[Row] = []

    def collect(row: Row) -> None:
        for col in columns:
            if col not in row:
                raise ValueError(f'missing column "{col}" while creating an index')
        rows.append(row)

    src(collect)
    impl = IndexImpl(rows, columns)
    impl.sort()
    return Index(impl)


def _create_index_device(plan, columns: Tuple[str, ...]) -> Index:
    from .columnar.exec import execute_plan_view, first_missing_cell
    from .ops.join import DeviceIndex
    from .ops.sort import sort_table

    view = execute_plan_view(plan)
    if view.deferred_error is not None:
        # the build consumes every row, so it reaches the failing row
        raise view.deferred_error[1]
    if view.sel.shape[0] == 0:
        # the host build checks per row, so an empty source gives an
        # empty index without any column check
        return Index(IndexImpl([], columns))
    bad = first_missing_cell(view, columns)
    if bad is not None:
        raise DataSourceError(
            bad[0], f'missing column "{bad[1]}" while creating an index'
        )
    sorted_table = sort_table(view.materialize(), list(columns))
    return Index(IndexImpl(None, columns, dev=DeviceIndex.build(sorted_table, list(columns))))


def create_unique_index(src, columns: Sequence[str]) -> Index:
    """Index build + duplicate-key check (csvplus.go:740-756); on a device
    index one adjacent-equality reduction, decoding only the offending
    row."""
    index = create_index(src, columns)
    impl = index._impl
    cols = impl.columns
    if impl.is_lazy and impl.dev is not None:
        from .ops.sort import find_adjacent_duplicate

        i = find_adjacent_duplicate(impl.dev.table, cols)
        if i is not None:
            row = impl.dev.table.to_rows(np.array([i], dtype=np.int64))[0]
            raise CsvPlusError(
                "duplicate value while creating unique index: "
                + str(row.select_existing(*cols))
            )
        return index
    rows = impl.rows
    for i in range(1, len(rows)):
        if equal_rows(cols, rows[i - 1], rows[i]):
            raise CsvPlusError(
                "duplicate value while creating unique index: "
                + str(rows[i].select_existing(*cols))
            )
    return index
