"""Index: a sorted, materialized collection of Rows with O(log n) search.

Port of ``csvplus_tpu/index.py`` (the reference's index,
csvplus.go:610-920): building, the unique check, ``find``, the batched
``find_many``, ``sub_index``, ``resolve_duplicates``, ``on_device``,
iteration and persistence (``write_to`` / ``load_index``, in the
reference's file formats, so a file written by either package loads in
the other).

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
import json
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .errors import CsvPlusError, DataSourceError
from .row import Row, all_columns_unique, equal_rows
from .source import DataSource, RowFunc, iterate, take_rows

#: The index file header's magic and the JSON-lines (host) format's
#: version; columnar files are version 2, or 3 when they hold lane
#: columns.  The reference's values: the formats are shared.
_MAGIC = "csvplus-tpu-index"
_VERSION = 1

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
        self._invalidate()

    def _invalidate(self) -> None:
        """Drop the caches built from the rows (key tuples, probe map)."""
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

    def __iter__(self):
        """The rows in key order, each a clone."""
        return iter(take_rows(self._impl.rows))

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
        to keep (an empty row or None drops the group, raising aborts and
        leaves the index as it was), or a named policy, ``"first"`` or
        ``"last"``, which a device-lazy index applies with a run-boundary
        mask and a gather, decoding no rows.  A callback on a device-lazy
        index decodes only the duplicate groups
        (:meth:`_device_callback_dedup`); the index stays on the device
        unless the callback makes a row that is not a member of its
        group."""
        impl = self._impl
        if isinstance(resolve, str):
            if resolve not in ("first", "last"):
                raise ValueError(f"unknown duplicate-resolution policy {resolve!r}")
            if impl.is_lazy and impl.dev is not None:
                self._device_policy_dedup(resolve)
                return
            resolve = (lambda g: g[0]) if resolve == "first" else (lambda g: g[-1])
        elif impl.is_lazy and impl.dev is not None:
            self._device_callback_dedup(resolve)
            return
        impl.dedup(resolve)
        self.device_table = None  # the columnar copy is stale after mutation
        impl.dev = None

    def _device_policy_dedup(self, policy: str) -> None:
        """The policy's run-boundary dedup, on the device, in three
        stages: the kept rows' flags compared (``dedup:run-starts``), the
        flags compacted into positions (``dedup:select``: ``device_rows``
        flags, one 8-byte count read back to size the result), and the
        kept rows gathered (``dedup:gather``) before the index is packed
        again."""
        from .ops.join import DeviceIndex, _flat
        from .ops.sort import flag_positions, run_flags
        from .utils.observe import telemetry

        impl = self._impl
        table = impl.dev.table
        n = table.nrows
        with telemetry.stage("dedup:run-starts", n) as stage:
            keep = run_flags(table, impl.columns, policy)
            stage["d2h_bytes"] = 0
            telemetry.barrier(keep)
        with telemetry.stage("dedup:select", n) as stage:
            sel = flag_positions(keep)
            stage["d2h_bytes"] = 8
            stage["h2d_bytes"] = 0
            stage["device_rows"] = n
            if sel.numel() == n:
                return  # no duplicates; nothing to do
            stage["rows_out"] = int(sel.numel())
            telemetry.barrier(sel)
        with telemetry.stage("dedup:gather", n) as stage:
            kept = table.gather(sel)
            stage["rows_out"] = kept.nrows
            telemetry.barrier(_flat([c.storage for c in kept.columns.values()]))
        impl.dev = DeviceIndex.build(kept, impl.columns)
        impl.rows = None
        self.device_table = impl.dev

    def _device_callback_dedup(self, resolve: Callable[[List[Row]], Optional[Row]]) -> None:
        """Callback dedup of a device-lazy index that decodes only the
        duplicate groups' rows (csvplus.go:809-867 semantics).

        The group boundaries come from the run starts over the sorted
        key columns; the callback runs exactly once per duplicate group,
        in index order, on a list of that group's decoded rows.  A chosen
        row that is None or shorter than the key column list drops the
        group.  A chosen row is a member when it equals one of the
        group's rows as decoded (pristine clones, compared before the
        callback could mutate them), so a mutated member counts as a new
        row.  When every chosen row is a member, the index is rebuilt by
        one columnar gather and stays on the device; otherwise the whole
        table is decoded once and the recorded decisions spliced in (the
        callback is not called again) and the index ends on the host.
        Each step records a telemetry stage of its own (``dedup:groups``,
        ``:decode``, ``:callback``, then ``:compact`` or ``:splice``)."""
        from .ops.join import DeviceIndex
        from .ops.sort import run_starts
        from .utils.observe import telemetry

        impl = self._impl
        table = impl.dev.table
        n = table.nrows
        with telemetry.stage("dedup:groups", n) as _t:
            starts = run_starts(table, impl.columns)
            idx_starts = np.flatnonzero(starts)
            lengths = np.diff(np.append(idx_starts, n))
            dup = lengths > 1
            g_start = idx_starts[dup].astype(np.int64)
            g_len = lengths[dup].astype(np.int64)
            # every duplicate group's row ids, group after group
            g_off = np.cumsum(g_len) - g_len
            n_dup = int(g_len.sum())
            dup_rows = np.repeat(g_start - g_off, g_len) + np.arange(n_dup, dtype=np.int64)
            _t["rows_out"] = n_dup
            _t["groups"] = int(g_len.shape[0])
        if n_dup == 0:
            return  # no duplicate keys (or an empty index)
        with telemetry.stage("dedup:decode", n_dup):
            decoded = table.to_rows(torch.from_numpy(dup_rows))

        n_cols = len(impl.columns)
        # per group: the chosen member's offset, -1 to drop the group, or
        # -2 for a new row (kept in new_rows)
        choice = np.empty(g_len.shape[0], dtype=np.int64)
        new_rows: Dict[int, Row] = {}
        with telemetry.stage("dedup:callback", n_dup) as _t:
            pos = 0
            for g, ln in enumerate(g_len.tolist()):
                group = decoded[pos : pos + ln]
                pos += ln
                pristine = [Row(r) for r in group]
                chosen = resolve(list(group))
                if chosen is None or len(chosen) < n_cols:
                    choice[g] = -1
                    continue
                off = next((i for i, r in enumerate(pristine) if r == chosen), None)
                if off is None:
                    choice[g] = -2
                    new_rows[g] = chosen if isinstance(chosen, Row) else Row(chosen)
                else:
                    choice[g] = off
            _t["rows_out"] = int((choice != -1).sum())

        if not new_rows:
            # one columnar compaction: the singleton rows and each group's
            # chosen member
            with telemetry.stage("dedup:compact", n) as _t:
                keep = np.ones(n, dtype=bool)
                keep[dup_rows] = False
                hit = choice >= 0
                keep[g_start[hit] + choice[hit]] = True
                sel = torch.from_numpy(np.flatnonzero(keep)).to(table.device)
                impl.dev = DeviceIndex.build(table.gather(sel), impl.columns)
                impl._rows = None
                impl._invalidate()
                self.device_table = impl.dev
                _t["rows_out"] = int(sel.shape[0])
                telemetry.barrier(tuple(c.storage for c in impl.dev.table.columns.values()))
            return

        # a new row: decode the whole table once and splice the recorded
        # decisions in
        with telemetry.stage("dedup:splice", n) as _t:
            rows = table.to_rows()
            out: List[Row] = []
            cursor = 0
            for g, (s0, ln, d) in enumerate(zip(g_start.tolist(), g_len.tolist(),
                                                choice.tolist())):
                out.extend(rows[cursor:s0])
                if d >= 0:
                    out.append(rows[s0 + d])
                elif d == -2:
                    out.append(new_rows[g])
                cursor = s0 + ln
            out.extend(rows[cursor:])
            impl.rows = out
            self.device_table = None
            impl.dev = None
            _t["rows_out"] = len(out)

    def write_to(self, file_name: str) -> None:
        """Persist the index; on any write error the file is removed
        (csvplus.go:656-680).  The reference's two formats:

        * a device-lazy index writes **columnar** npz (version 2): the key
          list and, per column, its dictionary and codes (a typed column
          writes its demoted dictionary).  A lane-dictionary column
          writes its sorted lanes instead (``l{i}:name``, version 3), so
          neither writing nor loading builds its host dictionary;
        * any other index writes JSON lines (version 1): a header object,
          then one object per row with sorted keys."""
        impl = self._impl
        if impl.is_lazy and impl.dev is not None:
            self._write_columnar(file_name)
            return
        from .sinks import _write_file

        def dump(f) -> None:
            f.write(json.dumps({
                "magic": _MAGIC,
                "version": _VERSION,
                "columns": impl.columns,
                "count": len(impl.rows),
            }))
            f.write("\n")
            for row in impl.rows:
                f.write(json.dumps(row, sort_keys=True, separators=(",", ":")))
                f.write("\n")

        _write_file(file_name, dump)

    WriteTo = write_to

    def _write_columnar(self, file_name: str) -> None:
        """The npz write (version 2, or 3 with lane columns)."""
        table = self._impl.dev.table
        lane_columns: Dict[str, int] = {}
        arrays: Dict[str, np.ndarray] = {}
        for name, col in table.columns.items():
            if col.dev_dictionary is not None and col._dictionary is None:
                col._ensure_sorted_lanes()  # version 3 stores sorted lanes
                lanes = col.dev_dictionary
                lane_columns[name] = len(lanes)
                for i, lane in enumerate(lanes):
                    arrays[f"l{i}:{name}"] = lane.cpu().numpy()
            else:
                arrays[f"d:{name}"] = col.dictionary
            arrays[f"c:{name}"] = col.codes.cpu().numpy()
        arrays["__meta__"] = np.frombuffer(
            json.dumps({
                "magic": _MAGIC,
                # 3 = lane columns present: a reader without lanes then
                # reports an unsupported version, not a missing key
                "version": 3 if lane_columns else 2,
                "key_columns": self._impl.columns,
                "columns": list(table.columns),
                "lane_columns": lane_columns,
                "count": table.nrows,
            }).encode("utf-8"),
            dtype=np.uint8,
        )
        from .sinks import _write_file

        _write_file(file_name, lambda f: np.savez(f, **arrays), mode="wb")

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


def load_index(file_name: str, device: "str | None" = None) -> Index:
    """Load an index written by :meth:`Index.write_to` (csvplus.go:683-705)
    in either package.  A columnar file restores a device-lazy index on
    *device* (``"cuda"`` when None, which raises with no card; ``"cpu"``
    on request); a JSON-lines file restores a host index.  A file that is
    not an index, of another version, or cut short raises
    ``ValueError``."""
    with open(file_name, "rb") as fb:
        magic2 = fb.read(2)
    if magic2 == b"PK":  # an npz (zip) container: the columnar format
        return _load_columnar(file_name, device)
    with open(file_name, "r", encoding="utf-8") as f:
        try:
            header = json.loads(f.readline())
        except json.JSONDecodeError:
            raise ValueError(f"{file_name}: not a csvplus-tpu index file") from None
        if header.get("magic") != _MAGIC:
            raise ValueError(f"{file_name}: not a csvplus-tpu index file")
        if header.get("version") != _VERSION:
            raise ValueError(f"{file_name}: unsupported index version {header.get('version')}")
        rows = [Row(json.loads(line)) for line in f if line.strip()]
    if len(rows) != header.get("count"):
        raise ValueError(
            f"{file_name}: truncated index file "
            f"({len(rows)} rows, expected {header.get('count')})"
        )
    return Index(IndexImpl(rows, header["columns"]))


LoadIndex = load_index


def _load_columnar(file_name: str, device: "str | None") -> Index:
    import zipfile

    from .columnar.table import DeviceTable, StringColumn, resolve_device
    from .ops.join import DeviceIndex

    dev = resolve_device("cuda" if device is None else device)
    try:
        with np.load(file_name) as z:
            meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
            if meta.get("magic") != _MAGIC:
                raise ValueError(f"{file_name}: not a csvplus-tpu index file")
            if meta.get("version") not in (2, 3):
                raise ValueError(
                    f"{file_name}: unsupported columnar index version {meta.get('version')}"
                )
            lane_columns = meta.get("lane_columns", {})
            cols = {}
            for name in meta["columns"]:
                codes = torch.from_numpy(z[f"c:{name}"]).to(dev)
                if name in lane_columns:
                    # sorted lanes straight to the device: the host
                    # dictionary is never built
                    lanes = tuple(
                        torch.from_numpy(z[f"l{i}:{name}"]).to(dev)
                        for i in range(int(lane_columns[name]))
                    )
                    cols[name] = StringColumn(None, codes, dev_dictionary=lanes)
                else:
                    cols[name] = StringColumn(z[f"d:{name}"], codes)
            count = meta["count"]
            key_columns = meta["key_columns"]
    except (KeyError, zipfile.BadZipFile, json.JSONDecodeError) as e:
        raise ValueError(f"{file_name}: not a csvplus-tpu index file") from e
    table = DeviceTable(cols, count, dev)
    return Index(IndexImpl(None, key_columns, dev=DeviceIndex.build(table, key_columns)))


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
