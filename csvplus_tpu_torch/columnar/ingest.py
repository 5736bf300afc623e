"""CSV / Index -> DeviceTable ingestion.

Port of ``csvplus_tpu/columnar/ingest.py`` without its device-parse
tier and its sharded (mesh) ingest.  ``from_file(...).on_device("cuda")``
parses the CSV with the Reader's exact header and field-count policies
and row-numbered errors, encodes each column on the host and uploads it.
The tiers, in the reference's order:

0. ``streamed``, for files of ``CSVPLUS_STREAM_MIN_BYTES`` (256 MiB) and
   more: the file is read in chunks of ``CSVPLUS_STREAM_CHUNK_BYTES``
   (64 MiB), scanned and encoded by K workers, reassembled in file order
   (:func:`~csvplus_tpu_torch.native.scanner.stream_encoded_chunks`) and
   uploaded chunk by chunk (:func:`_stream_to_table`); only
   :class:`~csvplus_tpu_torch.native.scanner.StreamFallback` drops to
   the whole-file tiers below;
1. ``native-encoded``: the native scanner and a vectorized encode
   (:func:`~csvplus_tpu_torch.native.scanner.read_encoded_columns_native`),
   no per-cell Python strings; ``prefix + canonical int32`` columns
   become typed value lanes
   (:class:`~csvplus_tpu_torch.columnar.typed.IntColumn`);
2. ``native-strings``: the native scanner, Python strings per cell, then
   dictionary encoding (:func:`_read_columns_fast`);
3. ``python``: the Reader's own ``read_columns``.

A tier declines only for the reference's reasons of semantics (see
:mod:`~csvplus_tpu_torch.native.scanner`); a scanner that cannot be
built or loaded raises.  The tier that ran is recorded on the table as
``ingest_tier``.  The reference's device-parse tier (and the streamed
tier's device chunk encoder) is not ported yet.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..source import DataSource
from .table import DeviceTable, StringColumn


def source_from_table(table: DeviceTable) -> DataSource:
    """Plan-capable DataSource over an existing DeviceTable."""
    from ..plan import Scan
    from .exec import plan_runner

    plan = Scan(table)
    ds = DataSource(None, plan=plan)
    ds._run = plan_runner(plan, fallback=table.iterate, owner=ds)
    return ds


def _encoded_nrows(value) -> int:
    """Row count of one encoded column: (dictionary, codes) pairs count
    codes; ("int", prefix, values) typed triples count values."""
    if len(value) == 3 and value[0] == "int":
        return int(value[2].shape[0])
    return int(value[1].shape[0])


def _ingest(reader, device) -> DeviceTable:
    """The first tier that accepts *reader*'s input, as a DeviceTable.
    Each tier that ran records one telemetry stage (``ingest:streamed``,
    ``ingest:native-encoded``, or ``ingest:python`` for both string
    tiers, as the reference names them); a tier that declines records
    nothing."""
    from ..utils.observe import telemetry

    path = getattr(reader, "_path", None)
    if path is not None and _stream_ingest_wanted(path):
        from ..native.scanner import StreamFallback

        try:
            with telemetry.stage("ingest:streamed", 0) as _t:
                table = _stream_to_table(reader, path, device)
                _t["rows_out"] = table.nrows
            table.ingest_tier = "streamed"
            return table
        except StreamFallback:
            pass  # the reference's reasons only; everything else raises
    if path is not None:
        from ..native import scanner

        with telemetry.stage("ingest:native-encoded", 0) as _t:
            enc = scanner.read_encoded_columns_native(reader, path)
            if enc is not None:
                names, data = enc
                nrows = _encoded_nrows(data[names[0]]) if names else 0
                table = DeviceTable.from_encoded({n: data[n] for n in names}, nrows, device)
                _t["rows_out"] = nrows
            else:
                _t["discard"] = True  # the tier declined: the next one records
        if enc is not None:
            table.ingest_tier = "native-encoded"
            return table
    with telemetry.stage("ingest:python", 0) as _t:
        names, data, tier = _read_columns_fast(reader)
        table = DeviceTable.from_pylists({n: data[n] for n in names}, device)
        _t["rows_out"] = table.nrows
    table.ingest_tier = tier
    return table


def reader_to_device(reader, device: str = "cuda") -> DataSource:
    """Parse *reader*'s CSV into a DeviceTable on *device* and wrap it as
    a plan-capable source.  Errors carry the Reader's record numbers."""
    table = _ingest(reader, device)
    # source row number of data record 0, as the host Reader numbers it
    # (record 1 is the header when one is read)
    table.row_base = 2 if reader._header_from_first_row else 1
    return source_from_table(table)


_STREAM_MIN_BYTES = 256 << 20


def _stream_ingest_wanted(path: str) -> bool:
    """The streamed tier engages for files of ``CSVPLUS_STREAM_MIN_BYTES``
    (default 256 MiB) and more, where the whole-file tiers' ``f.read()``
    would hold the whole file in host memory; 0 turns it off."""
    from ..utils.env import env_int

    thresh = env_int("CSVPLUS_STREAM_MIN_BYTES", _STREAM_MIN_BYTES)
    if thresh <= 0:
        return False
    try:
        return os.path.getsize(path) >= thresh
    except OSError:
        return False


def _uploader(device: torch.device):
    """Host -> device copies that do not block the host.  On a CUDA device
    each array is copied into pinned memory from torch's caching host
    allocator and sent with ``non_blocking=True``, so the thread that
    places chunks never waits for the copy engine; the allocator reuses a
    pinned block only once the copy recorded behind it has completed.  On
    the CPU the array is wrapped as it is."""

    def upload(arr: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type != "cuda" or host.numel() == 0:
            return host.to(device)
        return host.pin_memory().to(device, non_blocking=True)

    return upload


def _narrow_codes(codes: np.ndarray, size: int) -> np.ndarray:
    """Codes (nonnegative slots of a *size*-entry dictionary) in the
    smallest unsigned dtype that holds them: a low-cardinality column
    ships 1-2 bytes a row; the card widens them back to int32."""
    if size <= 0xFF:
        return codes.astype(np.uint8)
    if size <= 0xFFFF:
        return codes.astype(np.uint16)
    return codes


def _narrow_values(vals: np.ndarray) -> np.ndarray:
    """Typed values in int8/int16 when the chunk's range allows."""
    lo, hi = (int(vals.min()), int(vals.max())) if vals.size else (0, 0)
    if -128 <= lo and hi <= 127:
        return vals.astype(np.int8)
    if -32768 <= lo and hi <= 32767:
        return vals.astype(np.int16)
    return vals


def _stream_to_table(reader, path: str, device) -> DeviceTable:
    """Consume the native chunk generator into one DeviceTable.

    Each chunk's int32 codes or typed values are uploaded at once,
    narrowed to the smallest dtype that holds them (the next chunk's
    scan overlaps the copy), and only the chunk's sorted dictionary stays
    on the host.  After the last chunk, host-dictionary columns merge to
    a sorted union with the codes remapped on the device (code order ==
    string order).

    Host memory holds a constant number of chunks ((prefetch + 2) with
    the default ``CSVPLUS_STREAM_PREFETCH=1``, one with 0) plus
    per-column dictionary state.  A column whose running distinct count
    reaches ``CSVPLUS_DICT_DEVICE_MIN_DISTINCT`` (default 4M; values of at
    most 32 bytes) switches to device-lane dictionaries
    (:mod:`..ops.lanes`): each chunk's dictionary is packed into int32
    byte lanes, uploaded and freed on the host; the column ships as the
    lane concatenation with offset codes, and its union sort is deferred
    until an operation needs code order
    (:meth:`StringColumn._ensure_sorted_lanes`).

    Typed chunks ``("int", prefix, values)`` accumulate on the device and
    finish as one ``IntColumn``.  A column whose later chunk stops
    conforming demotes: the accumulated values are re-encoded through the
    dictionary path (``format_affix`` + per-chunk unique), bitwise what a
    never-typed run makes.

    The table records ``ingest_seconds``: the time this thread waited on
    the scan pipeline (what the prefetch did not hide) and the time it
    spent placing chunks (uploads, dictionary bookkeeping), the chunk
    count and K."""
    from ..native.scanner import StreamFallback, _ingest_workers, stream_encoded_chunks
    from ..ops.lanes import lanes_for_width, pack_host
    from ..utils.env import env_int
    from .table import resolve_device
    from .typed import IntColumn, format_affix

    dev = resolve_device(device)
    _pc = time.perf_counter
    # what "place" is made of (host seconds, the ingest:place stage's
    # extras): pinned staging + copy enqueue, dtype narrowing, the running
    # host dictionary union, and lane packing; the rest is bookkeeping
    parts = {"upload_s": 0.0, "narrow_s": 0.0, "union_s": 0.0, "lanes_s": 0.0}
    _upload = _uploader(dev)

    def upload(arr: np.ndarray) -> torch.Tensor:
        t0 = _pc()
        out = _upload(arr)
        parts["upload_s"] += _pc() - t0
        return out

    def narrowed(fn, *args) -> np.ndarray:
        t0 = _pc()
        out = fn(*args)
        parts["narrow_s"] += _pc() - t0
        return out
    prefetch_depth = env_int("CSVPLUS_STREAM_PREFETCH", 1)
    lane_thresh = env_int("CSVPLUS_DICT_DEVICE_MIN_DISTINCT", 4_000_000)
    names = None
    chunk_dicts: "dict[str, list]" = {}  # host mode: 'S' arrays
    chunk_lanes: "dict[str, list]" = {}  # lane mode: device lane tuples
    chunk_codes: "dict[str, list]" = {}
    # the running distinct count, as an incremental host union while below
    # the threshold (so bounded by it), dropped when the column switches
    running_union: "dict[str, np.ndarray | None]" = {}
    max_width: "dict[str, int]" = {}
    host_only: "dict[str, bool]" = {}  # wider than the lane cap: never switch
    int_vals: "dict[str, list]" = {}  # typed mode: device value chunks
    int_prefix: "dict[str, bytes]" = {}
    # columns that left typed mode once never re-enter it (the IntColumn
    # finish would drop the dictionary chunks made in between)
    int_demoted: "set[str]" = set()
    nrows = 0

    def to_lanes(c, d: np.ndarray) -> tuple:
        t0 = _pc()
        packed = pack_host(d, lanes_for_width(max_width[c]))
        parts["lanes_s"] += _pc() - t0
        return tuple(upload(x) for x in packed)

    def add_dict_chunk(c, d, codes):
        """One chunk's (dictionary, codes) through the host-union /
        lane-switch bookkeeping and the narrowed code upload."""
        max_width[c] = max(max_width[c], d.dtype.itemsize)
        if max_width[c] > 32:  # past the lane cap
            host_only[c] = True
            if chunk_lanes[c]:
                # committed to lanes and now a wider value: this tier
                # cannot finish the column
                raise StreamFallback(f'column "{c}" exceeded the lane width cap mid-stream')
        if not host_only[c] and not chunk_lanes[c]:
            ru = running_union[c]
            if ru is None:
                running_union[c] = d
            else:
                t0 = _pc()
                dt = np.dtype(f"S{max_width[c]}")
                running_union[c] = np.union1d(ru.astype(dt), d.astype(dt))
                parts["union_s"] += _pc() - t0
        chunk_codes[c].append(upload(narrowed(_narrow_codes, codes, d.size)))
        if chunk_lanes[c] or (
            not host_only[c]
            and running_union[c] is not None
            and running_union[c].size >= lane_thresh
        ):
            # lane mode (new or not): host dictionaries become device
            # lanes and are freed
            running_union[c] = None
            if chunk_dicts[c]:
                chunk_lanes[c] = [to_lanes(c, x) for x in chunk_dicts[c]]
                chunk_dicts[c] = []
            chunk_lanes[c].append(to_lanes(c, d))
        else:
            chunk_dicts[c].append(d)

    def demote_typed(c):
        """Re-encode a no-longer-typed column's value chunks through the
        dictionary path (format_affix inverts the native parse)."""
        int_demoted.add(c)
        for dev_arr in int_vals[c]:
            v = dev_arr.cpu().numpy().astype(np.int32)
            dd, cc = np.unique(format_affix(int_prefix[c], v), return_inverse=True)
            add_dict_chunk(c, dd, cc.astype(np.int32))
        int_vals[c] = []

    workers = _ingest_workers()
    chunks = stream_encoded_chunks(reader, path, workers=workers)
    if prefetch_depth > 0:
        # overlap chunk N+1's read + scan + encode (a producer thread)
        # with chunk N's uploads and bookkeeping (this thread)
        chunks = _prefetch_iter(chunks, prefetch_depth)
    n_chunks = 0
    # scan_wait: this thread blocked on the producer (the part the
    # prefetch did not hide); place: uploads + dictionary bookkeeping
    t_wait = t_place = 0.0
    it = iter(chunks)
    end = object()
    while True:
        t0 = _pc()
        item = next(it, end)
        t_wait += _pc() - t0
        if item is end:
            break
        cnames, encoded, n = item
        n_chunks += 1
        t0 = _pc()
        if names is None:
            names = cnames
            for store in (chunk_dicts, chunk_lanes, chunk_codes, int_vals):
                store.update({c: [] for c in names})
            running_union = {c: None for c in names}
            max_width = {c: 1 for c in names}
            host_only = {c: False for c in names}
        nrows += n
        for c in names:
            enc = encoded[c]
            if len(enc) == 3 and enc[0] == "int":
                _, prefix, vals = enc
                if c in int_demoted or (c in int_prefix and int_prefix[c] != prefix):
                    # prefix drift, or a column already out of typed mode:
                    # demote what accumulated and re-encode this chunk as
                    # a dictionary too (re-pinning the prefix would read
                    # the earlier chunks under the wrong affix)
                    if int_vals[c]:
                        demote_typed(c)
                    int_demoted.add(c)
                    strs = format_affix(prefix, vals.astype(np.int32))
                    dd, cc = np.unique(strs, return_inverse=True)
                    add_dict_chunk(c, dd, cc.astype(np.int32))
                    continue
                int_prefix[c] = prefix
                int_vals[c].append(upload(narrowed(_narrow_values, vals)))
                continue
            if int_vals[c]:
                demote_typed(c)  # the column left typed mode with this chunk
            add_dict_chunk(c, *enc)
        t_place += _pc() - t0
    if names is None:  # an empty file: the whole-file tiers handle it
        raise StreamFallback("empty file")

    from ..utils.observe import telemetry

    # the same numbers as ingest_seconds: scan-wait is the producer time
    # the prefetch did not hide (the generator's own ingest:cut / :encode
    # / :reorder-stall records attribute it), place the consuming
    # thread's uploads and bookkeeping
    telemetry.add_stage("ingest:scan", nrows, nrows, t_wait, workers=workers,
                        prefetch=prefetch_depth)
    telemetry.add_stage("ingest:place", nrows, nrows, t_place,
                        **{k: round(v, 4) for k, v in parts.items()})

    out = {}
    for c in names:
        # each column's chunks are dropped as soon as its result exists, so
        # the card holds at most one column twice
        if int_vals[c]:
            # a column with typed chunks never also holds dictionary chunks
            assert not chunk_dicts[c] and not chunk_lanes[c] and not chunk_codes[c]
            out[c] = IntColumn(int_prefix[c], _values_concat(int_vals.pop(c)))
            continue
        dicts, codes = chunk_dicts.pop(c), chunk_codes.pop(c)
        if chunk_lanes[c]:
            lanes_list = chunk_lanes[c]
            if len(lanes_list) == 1:
                out[c] = StringColumn(None, codes[0].to(torch.int32),
                                      dev_dictionary=lanes_list[0])
                continue
            # defer the global union: the column ships as the chunk
            # dictionaries' concatenation with codes shifted by per-chunk
            # offsets; an op that needs code order sorts it later
            n_lanes = max(len(x) for x in lanes_list)
            sizes = [int(x[0].shape[0]) for x in lanes_list]
            offsets = [0]
            for size in sizes[:-1]:
                offsets.append(offsets[-1] + size)
            out[c] = StringColumn(
                None,
                _offset_concat(codes, offsets),
                dev_dictionary=_concat_lanes_device(lanes_list, n_lanes),
                dev_dict_sorted=False,
            )
            continue
        if len(dicts) == 1:
            out[c] = (dicts[0], codes[0].to(torch.int32))
            continue
        width = max(d.dtype.itemsize for d in dicts)
        dt = np.dtype(f"S{width}")
        union = np.unique(np.concatenate([d.astype(dt) for d in dicts]))
        mappings = [upload(np.searchsorted(union, d.astype(dt)).astype(np.int32)) for d in dicts]
        out[c] = (union, _remap_concat(mappings, codes))
    table = DeviceTable.from_encoded(out, nrows, dev)
    table.ingest_seconds = {"scan_wait": t_wait, "place": t_place, "chunks": n_chunks,
                            "workers": workers}
    return table


def _prefetch_iter(gen, depth: int):
    """Run *gen* on a background thread, buffering up to *depth* items, so
    the streamed tier's read + scan + encode overlaps the consumer's
    uploads (``CSVPLUS_STREAM_PREFETCH``).  Exceptions re-raise in the
    consumer where they occurred; abandoning the iterator stops the
    producer, so a fallback never leaks a thread pinning chunk memory."""
    from ..utils.relay import relay_iter

    def run(emit) -> None:
        for item in gen:
            emit(item)

    return relay_iter(run, maxsize=depth)


def _concat_lanes_device(lanes_list, n_lanes: int) -> tuple:
    """Per-chunk lane tuples (narrower chunks widened with the packed-NUL
    fill) concatenated into one device lane tuple, in order."""
    from ..ops.lanes import widen_lanes_device

    widened = [widen_lanes_device(x, n_lanes) for x in lanes_list]
    return tuple(torch.cat([w[i] for w in widened]) for i in range(n_lanes))


def _concat_into(chunks, fill) -> torch.Tensor:
    """One int32 tensor of the chunks' lengths, each slice filled by
    ``fill(i, chunk, out_slice)``: the narrowed chunks are widened
    straight into their slice, never as whole int32 copies first."""
    n = sum(int(c.shape[0]) for c in chunks)
    out = torch.empty(n, dtype=torch.int32, device=chunks[0].device)
    off = 0
    for i, c in enumerate(chunks):
        fill(i, c, out[off : off + int(c.shape[0])])
        off += int(c.shape[0])
    return out


def _offset_concat(codes, offsets) -> torch.Tensor:
    """Per-chunk codes (narrowed uploads) widened to int32, shifted into
    the concatenated dictionary's slot space and concatenated."""
    return _concat_into(codes, lambda i, c, dst: dst.copy_(c).add_(offsets[i]))


def _values_concat(chunks) -> torch.Tensor:
    """Per-chunk typed values (narrowed uploads) as one int32 tensor."""
    return _concat_into(chunks, lambda i, c, dst: dst.copy_(c))


def _remap_concat(mappings, codes) -> torch.Tensor:
    """Each chunk's codes translated to the union's slots (one gather
    through its mapping table) and concatenated."""
    return _concat_into(codes, lambda i, c, dst: torch.index_select(
        mappings[i], 0, c.to(torch.int64), out=dst))


def _read_columns_fast(reader):
    """(names, {name: [values]}, tier): the native scanner's columnar read
    when the reader's configuration allows it, else the Reader's own."""
    path = getattr(reader, "_path", None)
    if path is not None:
        from ..native import scanner

        cols = scanner.read_columns_native(reader, path)
        if cols is not None:
            return cols[0], cols[1], "native-strings"
    names, data = reader.read_columns()
    return names, data, "python"


def index_to_device(index, device: str = "cuda"):
    """Columnarize an Index (sorted rows + key columns) into a
    :class:`~csvplus_tpu_torch.ops.join.DeviceIndex`."""
    from ..ops.join import DeviceIndex

    table = DeviceTable.from_rows(index._impl.rows, device)
    return DeviceIndex.build(table, index._impl.columns)
