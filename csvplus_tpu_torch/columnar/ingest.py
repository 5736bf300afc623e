"""CSV / Index -> DeviceTable ingestion.

Port of ``csvplus_tpu/columnar/ingest.py``.
``from_file(...).on_device("cuda")`` parses the CSV with the Reader's
exact header and field-count policies and row-numbered errors, encodes
each column and places it on the device; with ``shards=`` or ``mesh=``
the table is row-sharded over a mesh (:func:`resolve_mesh`).  The tiers,
in the reference's order:

0. ``streamed``, for files of ``CSVPLUS_STREAM_MIN_BYTES`` (256 MiB) and
   more: the file is read in chunks of ``CSVPLUS_STREAM_CHUNK_BYTES``
   (64 MiB), scanned and encoded by K workers, reassembled in file order
   (:func:`~csvplus_tpu_torch.native.scanner.stream_encoded_chunks`) and
   uploaded chunk by chunk (:func:`_stream_to_table`); only
   :class:`~csvplus_tpu_torch.native.scanner.StreamFallback` drops to
   the whole-file tiers below.  With the device-parse policy on, its
   string columns are encoded on the device per chunk
   (:func:`_device_chunk_encoder`), which forces K = 1;
1. ``device-parsed``, when :func:`_device_parse_enabled`: the numpy
   separator scan, one upload of the bytes and the dictionary encode on
   the device (:func:`~csvplus_tpu_torch.native.scanner.read_device_parsed_columns`,
   :mod:`~csvplus_tpu_torch.ops.parse`); every column comes out a
   dictionary column, none typed, as in the reference;
2. ``native-encoded``: the native scanner and a vectorized encode
   (:func:`~csvplus_tpu_torch.native.scanner.read_encoded_columns_native`),
   no per-cell Python strings; ``prefix + canonical int32`` columns
   become typed value lanes
   (:class:`~csvplus_tpu_torch.columnar.typed.IntColumn`);
3. ``native-strings``: the native scanner, Python strings per cell, then
   dictionary encoding (:func:`_read_columns_fast`);
4. ``python``: the Reader's own ``read_columns``.

A tier declines only for the reference's reasons of semantics (see
:mod:`~csvplus_tpu_torch.native.scanner`); a scanner or kernel that
cannot be built or loaded raises.  The tier that ran is recorded on the
table as ``ingest_tier``.

Under a mesh the streamed tier places each chunk straight on the shard
that will own its rows and stitches the shards' blocks at the end
(``ingest:seal``, ``ingest:shard-assemble``); its chunk encoder stays off
(codes are born on their shard on the host), and a column that would
need a device-lane dictionary falls back to the whole-file tiers, whose
table is then cut into shards (``DeviceTable.with_sharding``).
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


def resolve_mesh(device, shards: "int | None" = None, mesh=None):
    """The mesh an ``on_device(device, shards=, mesh=)`` call places its
    shards on, or None for an unsharded table.  *mesh* wins (the table is
    then made on the mesh's first device, whatever *device* says).  Otherwise
    *shards* shards go on the one device *device* names (``"cpu"``,
    ``"cuda:0"``), or over ``cuda:0`` .. ``cuda:N-1`` for a bare
    ``"cuda"``, which raises when fewer cards are visible.  Nothing falls
    back to another device."""
    if mesh is not None:
        return mesh
    if not shards:
        return None
    from ..parallel.mesh import make_mesh

    dev = torch.device(device)
    shards = int(shards)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < shards:
            raise RuntimeError(
                f"on_device: shards={shards} over cuda:0..cuda:{shards - 1} needs {shards} "
                f"cards, {count} visible; pass mesh=make_mesh({shards}, devices=['cuda:0'] * "
                f"{shards}) to place the shards on one card")
        return make_mesh(shards)
    return make_mesh(shards, devices=[device] * shards)


def _maybe_shard(table: DeviceTable, mesh) -> DeviceTable:
    """*table* row-sharded over *mesh* (already so when its chunks landed
    on their shards at ingest)."""
    if mesh is None or table._pre_sharded:
        return table
    return table.with_sharding(mesh)


def _ingest(reader, device, mesh=None) -> DeviceTable:
    """The first tier that accepts *reader*'s input, as a DeviceTable (the
    streamed tier places its chunks on *mesh*'s shards when one is given;
    the caller shards the other tiers' tables).  Each tier that ran
    records one telemetry stage (``ingest:streamed``,
    ``ingest:device-parsed``, ``ingest:native-encoded``, or
    ``ingest:python`` for both string tiers, as the reference names
    them); a tier that declines records nothing."""
    from ..utils.observe import telemetry

    path = getattr(reader, "_path", None)
    if path is not None and _stream_ingest_wanted(path):
        from ..native.scanner import StreamFallback

        try:
            with telemetry.stage("ingest:streamed", 0) as _t:
                table = _stream_to_table(reader, path, device, mesh=mesh)
                _t["rows_out"] = table.nrows
            table.ingest_tier = "streamed"
            return table
        except StreamFallback:
            pass  # the reference's reasons only; everything else raises
    if path is not None and _device_parse_enabled(device):
        from ..native import scanner

        with telemetry.stage("ingest:device-parsed", 0) as _t:
            enc = scanner.read_device_parsed_columns(reader, path, device)
            if enc is not None:
                names, data = enc
                nrows = _encoded_nrows(data[names[0]]) if names else 0
                table = DeviceTable.from_encoded({n: data[n] for n in names}, nrows, device)
                _t["rows_out"] = nrows
            else:
                _t["discard"] = True
        if enc is not None:
            table.ingest_tier = "device-parsed"
            return table
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


def reader_to_device(reader, device: str = "cuda", shards: "int | None" = None,
                     mesh=None) -> DataSource:
    """Parse *reader*'s CSV into a DeviceTable on *device* and wrap it as
    a plan-capable source.  Errors carry the Reader's record numbers.

    ``shards=N`` (or an explicit *mesh*) lays the columns row-sharded over
    a mesh (:func:`resolve_mesh`), so every downstream stage runs per
    shard.  The mesh is resolved before the ingest, so a streamed file's
    chunks land on their shards directly."""
    mesh = resolve_mesh(device, shards, mesh)
    if mesh is not None:
        device = mesh.devices[0]  # the mesh places the table, first shard first
    table = _maybe_shard(_ingest(reader, device, mesh), mesh)
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


def _stream_to_table(reader, path: str, device, mesh=None) -> DeviceTable:
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
    count and K.

    Under *mesh* (sharded ingest) each chunk's arrays upload straight to
    the shard that will own its rows: chunk i goes to shard ``i * chunk
    bytes * k // file bytes``, monotone, so every shard holds one
    contiguous row range.  When the assignment passes a shard, its typed
    chunks are sealed into one int32 segment on it (``ingest:seal``).
    The end (:func:`_finalize_sharded`) cuts the shards' rows into the
    equal blocks of ``with_sharding``, moving only the slivers at block
    boundaries between shards; no device ever holds the whole table.  A
    column that would switch to device-lane dictionaries raises
    :class:`StreamFallback` (the whole-file tiers and ``with_sharding``
    take the file), and the device chunk encoder stays off, so K is not
    forced to 1."""
    from ..native.scanner import StreamFallback, _ingest_workers, stream_encoded_chunks
    from ..ops.lanes import lanes_for_width, pack_host
    from ..utils.env import env_int
    from .table import resolve_device
    from .typed import IntColumn, format_affix

    dev = resolve_device(device)
    shard_devs = None
    fsize = cb = 1
    if mesh is not None:
        from ..native.scanner import _stream_chunk_bytes

        shard_devs = list(mesh.devices)
        fsize = max(os.path.getsize(path), 1)
        cb = _stream_chunk_bytes()
    # under a mesh the codes are born on their shard: host encode only
    encoder = (_device_chunk_encoder(dev)
               if shard_devs is None and _device_parse_enabled(dev) else None)
    tgt = {"dev": dev, "si": 0}  # the device the current chunk's arrays go to
    _pc = time.perf_counter
    # what "place" is made of (host seconds, the ingest:place stage's
    # extras): pinned staging + copy enqueue, dtype narrowing, the running
    # host dictionary union, and lane packing; the rest is bookkeeping
    parts = {"upload_s": 0.0, "narrow_s": 0.0, "union_s": 0.0, "lanes_s": 0.0}
    uploaders = {d: _uploader(d) for d in (shard_devs or [dev])}

    def upload(arr: np.ndarray, to: "torch.device | None" = None) -> torch.Tensor:
        t0 = _pc()
        d = tgt["dev"] if to is None else to
        if d.type == "cuda":
            # the current device is per thread: stage and copy on d's own
            with torch.cuda.device(d):
                out = uploaders[d](arr)
        else:
            out = uploaders[d](arr)
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
    # sharded ingest: the typed chunks of every passed shard, sealed into
    # one int32 segment on that shard, in shard order
    int_segs: "dict[str, list]" = {}
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

    def add_dict_chunk(c, d, codes, to=None):
        """One chunk's (dictionary, codes) through the host-union /
        lane-switch bookkeeping and the narrowed code upload (to *to*, the
        device the chunk's rows live on, when given)."""
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
        if isinstance(codes, np.ndarray):
            codes = upload(narrowed(_narrow_codes, codes, d.size), to)
        # codes the device encoder made are int32 on the card already
        chunk_codes[c].append(codes)
        if chunk_lanes[c] or (
            not host_only[c]
            and running_union[c] is not None
            and running_union[c].size >= lane_thresh
        ):
            if shard_devs is not None:
                # a deferred lane dictionary cannot be built shard by shard
                raise StreamFallback(
                    f'column "{c}" crossed the lane threshold under sharded ingest')
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
        for dev_arr in int_segs.get(c, []) + int_vals[c]:
            v = dev_arr.cpu().numpy().astype(np.int32)
            dd, cc = np.unique(format_affix(int_prefix[c], v), return_inverse=True)
            # each re-encoded chunk stays on the device its rows live on
            add_dict_chunk(c, dd, cc.astype(np.int32), to=dev_arr.device)
        int_vals[c] = []
        int_segs[c] = []

    def seal_typed_shard():
        """The passed shard's pending typed chunks as one int32 segment on
        that shard (the copies are queued on the card; the scan goes on)."""
        for c in names or ():
            if int_vals.get(c):
                int_segs[c].append(_values_concat(int_vals[c]))
                int_vals[c] = []

    # the device chunk encoder needs one upload stream: K = 1
    workers = 1 if encoder is not None else _ingest_workers()
    chunks = stream_encoded_chunks(reader, path, encoder=encoder, workers=workers)
    if prefetch_depth > 0:
        # overlap chunk N+1's read + scan + encode (a producer thread)
        # with chunk N's uploads and bookkeeping (this thread)
        chunks = _prefetch_iter(chunks, prefetch_depth)
    n_chunks = 0
    n_seals = 0
    # scan_wait: this thread blocked on the producer (the part the
    # prefetch did not hide); place: uploads + dictionary bookkeeping;
    # seal: the per-shard typed finish under a mesh
    t_wait = t_place = t_seal = 0.0
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
        if shard_devs is not None:
            # byte-position assignment: chunk i covers about bytes
            # [i*cb, (i+1)*cb), so it belongs to the shard owning that
            # share of the file; monotone in i
            k = len(shard_devs)
            si = min(k - 1, (n_chunks - 1) * cb * k // fsize)
            if si != tgt["si"]:
                t0 = _pc()
                seal_typed_shard()  # the assignment passed shard tgt["si"]
                t_seal += _pc() - t0
                n_seals += 1
            tgt["si"], tgt["dev"] = si, shard_devs[si]
        t0 = _pc()
        if names is None:
            names = cnames
            for store in (chunk_dicts, chunk_lanes, chunk_codes, int_vals, int_segs):
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
                    if int_vals[c] or int_segs[c]:
                        demote_typed(c)
                    int_demoted.add(c)
                    strs = format_affix(prefix, vals.astype(np.int32))
                    dd, cc = np.unique(strs, return_inverse=True)
                    add_dict_chunk(c, dd, cc.astype(np.int32))
                    continue
                int_prefix[c] = prefix
                int_vals[c].append(upload(narrowed(_narrow_values, vals)))
                continue
            if int_vals[c] or int_segs[c]:
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
    ingest_seconds = {"scan_wait": t_wait, "place": t_place, "chunks": n_chunks,
                      "workers": workers}
    if shard_devs is not None:
        t0 = _pc()
        seal_typed_shard()
        t_seal += _pc() - t0
        telemetry.add_stage("ingest:seal", nrows, nrows, t_seal, n_seals=n_seals + 1)
        table = _finalize_sharded(mesh, names, nrows, int_segs, int_prefix, chunk_dicts,
                                  chunk_codes, upload)
        ingest_seconds["seal"] = t_seal
        table.ingest_seconds = ingest_seconds
        return table

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
    table.ingest_seconds = ingest_seconds
    return table


def _assemble_rows_sharded(mesh, arrs, nrows: int, fill: int):
    """Per-chunk int32 arrays (chunk order == row order, each on the shard
    that owns its rows) cut into the equal blocks of ``with_sharding``
    (``ceil(n / k)`` rows, the tail filled with *fill*): each block is
    stitched from the chunks that overlap it, so only the slivers at
    block boundaries move between shards."""
    from ..parallel.mesh import ShardedRows, block_lens, relayout

    return ShardedRows(mesh, relayout(mesh, list(arrs), block_lens(mesh, nrows), fill))


def _finalize_sharded(mesh, names, nrows, int_segs, int_prefix, chunk_dicts, chunk_codes,
                      upload) -> DeviceTable:
    """The sharded ingest's end: every column becomes row-sharded storage
    in equal blocks (typed value lanes, padded with ``PAD_VALUE``, or
    dictionary codes, padded with ``PAD_CODE``).  Typed columns arrive
    sealed per shard; dictionary columns merge to the union of their
    chunk dictionaries here, each chunk remapped on its own shard."""
    from ..utils.observe import telemetry
    from .table import PAD_CODE
    from .typed import PAD_VALUE, IntColumn

    out = {}
    with telemetry.stage("ingest:shard-assemble", nrows) as _t:
        _t["n_shards"] = mesh.size
        _t["max_shard_rows"] = -(-nrows // mesh.size)
        for c in names:
            if int_segs.get(c):
                # a column with typed chunks never also holds dictionary chunks
                assert not chunk_dicts[c] and not chunk_codes[c]
                out[c] = IntColumn(int_prefix[c], _assemble_rows_sharded(
                    mesh, int_segs.pop(c), nrows, int(PAD_VALUE)))
                continue
            dicts, codes = chunk_dicts.pop(c), chunk_codes.pop(c)
            if len(dicts) == 1:
                arrs = [x.to(torch.int32) for x in codes]
                out[c] = StringColumn(dicts[0], _assemble_rows_sharded(
                    mesh, arrs, nrows, PAD_CODE))
                continue
            width = max(d.dtype.itemsize for d in dicts)
            dt = np.dtype(f"S{width}")
            union = np.unique(np.concatenate([d.astype(dt) for d in dicts]))
            # each chunk remapped on its own shard (the mapping is small)
            arrs = [
                torch.index_select(
                    upload(np.searchsorted(union, d.astype(dt)).astype(np.int32), ck.device),
                    0, ck.to(torch.int64))
                for d, ck in zip(dicts, codes)
            ]
            out[c] = StringColumn(union, _assemble_rows_sharded(mesh, arrs, nrows, PAD_CODE))
    table = DeviceTable(out, nrows, mesh.devices[0])
    table._pre_sharded = True
    _trim_host_staging()
    return table


def _trim_host_staging() -> None:
    """Give the streamed ingest's freed staging memory back to the OS
    (glibc's ``malloc_trim``): the chunked scan frees hundreds of staging
    buffers whose pages glibc would otherwise keep as resident memory
    into the join.  Does nothing without glibc."""
    import ctypes

    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        return  # no glibc, or one without malloc_trim


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


def _device_chunk_encoder(device: torch.device):
    """Per-chunk column encoder that runs the dictionary encode on the
    device (:func:`~csvplus_tpu_torch.ops.parse.encode_column_device`):
    each chunk's bytes go up once and every string column's codes are born
    on the device.  It declines (None) a column with a field over 32 bytes
    and a chunk of 2 GiB or more (int32 offsets); the scanner then encodes
    on the host."""
    state: dict = {}

    def encode(combined, col_starts, col_lens):
        from ..ops.parse import encode_column_device, upload_bytes

        if combined.shape[0] >= 2**31:
            return None  # int32 offsets would wrap
        if state.get("combined") is not combined:
            # holding the array keeps the identity check sound (one chunk
            # of host memory, freed with the next chunk)
            state["combined"] = combined
            state["dev"] = upload_bytes(combined, device)
        return encode_column_device(state["dev"], col_starts, col_lens)

    return encode


_link_rtt_cache: "dict[str, float]" = {}


def link_rtt_ms(device="cuda") -> float:
    """The round trip of a tiny dispatch + sync to *device*, in
    milliseconds: the median of 3 probes after a warm-up, cached per
    process and device.  A card on the host's own bus answers in well
    under a millisecond."""
    from .table import resolve_device

    dev = resolve_device(device)
    key = str(dev)
    if key in _link_rtt_cache:
        return _link_rtt_cache[key]
    x = torch.zeros(8, dtype=torch.int32, device=dev)
    int(x.sum())  # warm: the first launch loads the module
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        int(x.sum())
        samples.append((time.perf_counter() - t0) * 1000.0)
    rtt = sorted(samples)[1]
    _link_rtt_cache[key] = rtt
    return rtt


_DEVICE_PARSE_MAX_RTT_MS = 20.0


def _device_parse_enabled(device="cuda") -> bool:
    """The device-parse tier's policy, as the reference's: on by default
    for an accelerator whose measured round trip (:func:`link_rtt_ms`) is
    at most ``CSVPLUS_DEVICE_PARSE_MAX_RTT_MS`` (default 20 ms), off on the
    CPU; ``CSVPLUS_DEVICE_PARSE=1`` / ``=0`` forces it on or off.  The
    reference keys it on JAX's default backend; the port on the *target*
    device of the ingest (ROADMAP §3)."""
    from ..utils.env import env_str

    flag = env_str("CSVPLUS_DEVICE_PARSE")
    if flag is not None:
        return flag == "1"
    if torch.device(device).type == "cpu":
        return False
    v = env_str("CSVPLUS_DEVICE_PARSE_MAX_RTT_MS")
    try:
        thresh = float(v) if v else _DEVICE_PARSE_MAX_RTT_MS
    except ValueError:
        thresh = _DEVICE_PARSE_MAX_RTT_MS
    return link_rtt_ms(device) <= thresh


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
