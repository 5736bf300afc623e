"""ctypes binding and build of the port's native CSV scanner.

Port of ``csvplus_tpu/native/scanner.py`` without its device-parse
tier: the scan (single pass and threaded over newline-aligned chunks),
the vectorized dictionary encode of a column straight from field
offsets, the typed ``prefix + canonical int32`` parse (per column,
strided over rectangular chunks, and fused with the tokenizer), the C++
itoa, the two whole-file ingest tiers built on them
(:func:`read_encoded_columns_native` and :func:`read_columns_native`),
and the streamed tier's staged chunk pipeline
(:func:`stream_encoded_chunks`).

``scanner.cpp`` is compiled with ``g++ -O3`` at first use into
``csvplus_tpu_torch/_build/``, under a name that carries a hash of the
source.  Unlike the reference, a failed build or load **raises**
(``RuntimeError``): the port never hides a broken scanner behind the
Python parser.  The tiers decline (return None, or raise
:class:`StreamFallback` in the streamed tier, and the caller takes the
next tier) only for the reference's reasons of semantics: leading-space
trimming, a delimiter or comment that is not one byte, a NUL byte in the
data, a field longer than :data:`_VEC_MAX_FIELD_LEN` bytes, or (streamed
tier) a quote under LazyQuotes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..csvio import ERR_BARE_QUOTE, ERR_FIELD_COUNT, ERR_QUOTE
from ..errors import DataSourceError, map_error
from ..obs.recompile import register_kernel
from ..resilience import faults
from ..utils.env import env_int

SOURCE = Path(__file__).resolve().parent / "scanner.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_lock = threading.Lock()
_lib = None

_ERR_MSG = {-1: ERR_BARE_QUOTE, -2: ERR_QUOTE, -3: "native scanner overflow"}


def build() -> Path:
    """Compile ``scanner.cpp`` with ``g++ -O3`` into ``_build/`` and return
    the shared library's path; raises ``RuntimeError`` when ``g++`` is
    missing or fails.  The file name carries a hash of the source, so an
    edited scanner never loads a stale build."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    out = BUILD_DIR / f"libcsvplus_scanner_{digest}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native CSV scanner cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")  # no concurrent clobber
    cmd = [gxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"native scanner build failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_CH = ctypes.c_char

# (restype, argtypes) of the entry points of scanner.cpp that the
# ingest tiers and the CSV sink call
_SIGNATURES = {
    "csv_count_bounds": (_I64, [_VP, _I64, _CH, _CH, _I64P, _I64P, _I64P]),
    "csv_scan": (_I64, [_VP, _I64, _CH, _CH, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        _I64P, _I32P, _I32P, ctypes.c_char_p, _I64, _I64P, _I64, _I64,
                        _I64P]),
    "csv_pack_fields": (None, [_VP, _I64P, _I32P, _I64, _I32, _VP]),
    "csv_pack_fields_u64": (None, [_VP, _I64P, _I32P, _I64, _VP]),
    "csv_encode_hash_u64": (_I64, [_VP, _I64, _VP, _VP, _I64]),
    "csv_encode_hash_u64x2": (_I64, [_VP, _VP, _I64, _VP, _VP, _VP, _I64]),
    "csv_u64_to_bytes": (None, [_VP, _I64, _I32, _VP]),
    "csv_scan_simple": (_I64, [_VP, _I64, _CH, _I64P, _I32P, _I32P, _I64P]),
    "csv_pack_int32": (_I64, [_VP, _I64P, _I32P, _I64, ctypes.c_char_p, _I64P, _I64,
                              _VP]),
    "csv_format_i32": (None, [_VP, _I64, _I32, _VP, _VP]),
    "csv_scatter_fields": (None, [ctypes.c_char_p, _I64P, _I32P, _I32P, _I64P, _I64, _CH,
                                  _VP]),
    "csv_pack_int32_strided": (_I64, [_VP, _I64P, _I32P, _I64, _I64, _I64,
                                      ctypes.c_char_p, _I64P, _I64, _VP]),
    "csv_scan_parse_i32": (_I64, [_VP, _I64, _CH, _I64, ctypes.c_char_p, _I64P, _I64P,
                                  ctypes.POINTER(ctypes.c_void_p), _I64]),
}


@register_kernel("scanner.cpp")
def _open_library():
    """Build ``scanner.cpp`` if needed and load it (counted in
    :mod:`..obs.recompile`)."""
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"native scanner {path.name} cannot be loaded: {e}") from e
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _load():
    """The loaded scanner library (built on first use).  Raises
    ``RuntimeError`` when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = _open_library()
        return _lib


def scan_bytes(
    data: bytes,
    delimiter: str = ",",
    comment: Optional[str] = None,
    lazy_quotes: bool = False,
    offset: int = 0,
    length: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, bytes]:
    """Native scan: (field_starts, field_lens, rec_counts, scratch).

    field_starts < 0 index the scratch buffer at -(start+1); record
    ordinals for errors are 1-based like the reference's row numbers.
    ``offset``/``length`` scan a sub-range of *data* with zero copies
    (the parallel chunker's path); returned starts are range-relative.
    """
    lib = _load()
    delim_b = delimiter.encode("utf-8")
    if len(delim_b) != 1:
        raise ValueError(f"native scan requires a 1-byte delimiter, got {delimiter!r}")
    n = len(data) - offset if length is None else length
    base = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value + offset
    max_fields = ctypes.c_int64(0)
    max_records = ctypes.c_int64(0)
    flags = ctypes.c_int64(0)
    comment_b = (comment or "\x00").encode("utf-8")[0:1]
    lib.csv_count_bounds(
        base, n, delim_b, comment_b,
        ctypes.byref(max_fields), ctypes.byref(max_records), ctypes.byref(flags),
    )
    mf, mr = max_fields.value, max_records.value
    starts = np.empty(mf, dtype=np.int64)
    lens = np.empty(mf, dtype=np.int32)
    counts = np.empty(mr, dtype=np.int32)

    # the SWAR tokenizer applies when the range holds no quote, CR or
    # (one-byte) comment byte: no scratch buffer, no parse error possible.
    # A multi-byte comment does not disqualify it (callers gate those).
    no_comment = (
        comment is None
        or len(comment.encode("utf-8")) != 1
        or (flags.value & 4) == 0
    )
    if (flags.value & 3) == 0 and no_comment:
        nrec = ctypes.c_int64(0)
        total = int(
            lib.csv_scan_simple(
                base, n, delim_b,
                starts.ctypes.data_as(_I64P),
                lens.ctypes.data_as(_I32P),
                counts.ctypes.data_as(_I32P),
                ctypes.byref(nrec),
            )
        )
        return starts[:total], lens[:total], counts[: nrec.value], b""

    # `data` keeps the bytes object (and its base address) alive for both
    # native calls
    scratch = ctypes.create_string_buffer(max(n, 1))
    scratch_used = ctypes.c_int64(0)
    err_record = ctypes.c_int64(0)
    rc = lib.csv_scan(
        base, n, delim_b, comment_b,
        # a multi-byte comment is ignored by both native paths alike
        1 if comment and len(comment.encode("utf-8")) == 1 else 0,
        1 if lazy_quotes else 0,
        0,  # leading-space trimming is the Python tier's (unicode semantics)
        starts.ctypes.data_as(_I64P),
        lens.ctypes.data_as(_I32P),
        counts.ctypes.data_as(_I32P),
        scratch, len(scratch), ctypes.byref(scratch_used),
        mf, mr, ctypes.byref(err_record),
    )
    if rc < 0:
        raise DataSourceError(int(err_record.value), _ERR_MSG[int(rc)])
    nrec = int(err_record.value)
    total = int(rc)
    return starts[:total], lens[:total], counts[:nrec], scratch.raw[: scratch_used.value]


_PARALLEL_MIN_BYTES = 8 << 20  # files below this parse fine in one pass
_SCAN_THREADS_CAP = 16


def scan_bytes_parallel(
    data: bytes,
    delimiter: str = ",",
    comment: Optional[str] = None,
    lazy_quotes: bool = False,
    n_threads: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, bytes]:
    """Multi-threaded chunk scan for large quote-free files.

    The byte range is split at newline boundaries and each chunk runs
    through the native scanner concurrently (ctypes releases the GIL).
    Chunking at newlines is unambiguous only when the file holds no quote
    (a quoted field may span lines), so quoted files take the single
    pass.  Quote-free chunks cannot raise parse errors and never use the
    scratch buffer, so the merge is an offset-shifted concatenation.
    """
    n = len(data)
    k = min(n_threads or os.cpu_count() or 1, _SCAN_THREADS_CAP)
    if n < _PARALLEL_MIN_BYTES or k < 2 or b'"' in data:
        return scan_bytes(data, delimiter, comment, lazy_quotes)

    bounds = [0]
    for i in range(1, k):
        pos = data.find(b"\n", i * n // k)
        bounds.append(n if pos < 0 else pos + 1)
    bounds.append(n)
    bounds = sorted(set(bounds))

    from concurrent.futures import ThreadPoolExecutor

    def scan_chunk(lo: int, hi: int):
        return scan_bytes(data, delimiter, comment, lazy_quotes, offset=lo, length=hi - lo)

    with ThreadPoolExecutor(max_workers=len(bounds) - 1) as pool:
        parts = list(pool.map(lambda b: scan_chunk(*b), zip(bounds[:-1], bounds[1:])))

    starts = np.concatenate([p[0] + lo for p, lo in zip(parts, bounds[:-1])])
    lens = np.concatenate([p[1] for p in parts])
    counts = np.concatenate([p[2] for p in parts])
    return starts, lens, counts, b""


def _field_str(data: bytes, scratch: bytes, start: int, length: int) -> str:
    if start < 0:
        s = -start - 1
        return scratch[s : s + length].decode("utf-8")
    return data[start : start + length].decode("utf-8")


_VEC_MAX_FIELD_LEN = 256  # longer fields decline the vectorized encode
_PACK_THREADS_MIN_N = 200_000  # below this a single native call is faster
_pack_pool = None
_pack_pool_lock = threading.Lock()


def _pack_pool_get():
    """Shared worker pool for the native row-range calls.  Distinct from
    the column pool, so nested use cannot deadlock (pack tasks never
    submit further pack tasks)."""
    global _pack_pool
    if _pack_pool is None:
        with _pack_pool_lock:
            if _pack_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                _pack_pool = ThreadPoolExecutor(
                    max_workers=min(os.cpu_count() or 1, 8),
                    thread_name_prefix="csvplus-pack",
                )
    return _pack_pool


def _run_ranges(run, n: int) -> list:
    """``run(lo, hi)`` over [0, n): threaded over up to 8 row ranges when
    the rows are many and the host has more than one core."""
    k = min(os.cpu_count() or 1, 8)
    if n >= _PACK_THREADS_MIN_N and k >= 2:
        bounds = [n * i // k for i in range(k + 1)]
        return list(_pack_pool_get().map(lambda b: run(*b), zip(bounds[:-1], bounds[1:])))
    return [run(0, n)]


def _pack_fields_native(
    combined: np.ndarray, starts: np.ndarray, lens: np.ndarray, width: int,
    u64: bool = False,
) -> np.ndarray:
    """Gather (start, len) fields into NUL-padded fixed-width rows with the
    C++ pack (one memcpy per field, GIL released, threaded over row
    ranges).  ``u64=True`` packs <= 8-byte fields big-endian straight
    into uint64 values (integer order == padded byte order)."""
    lib = _load()
    n = int(starts.shape[0])
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    out = np.empty(n, dtype=np.uint64) if u64 else np.empty((n, width), np.uint8)
    if n == 0:
        return out
    base = combined.ctypes.data

    def run(lo: int, hi: int) -> None:
        sp = starts[lo:hi].ctypes.data_as(_I64P)
        lp = lens[lo:hi].ctypes.data_as(_I32P)
        if u64:
            lib.csv_pack_fields_u64(base, sp, lp, hi - lo, out[lo:hi].ctypes.data)
        else:
            lib.csv_pack_fields(base, sp, lp, hi - lo, width, out[lo:hi].ctypes.data)

    _run_ranges(run, n)
    return out


_PREFIX_CAP = 24  # affix prefixes longer than this stay dictionary columns


def _prefix_marshal(prefix: "bytes | None"):
    """(ctypes prefix buffer, c_int64 length) for the pack entry points;
    None when the prefix exceeds the cap.  Length -1 = derive."""
    pbuf = ctypes.create_string_buffer(_PREFIX_CAP)
    if prefix is None:
        return pbuf, ctypes.c_int64(-1)
    if len(prefix) > _PREFIX_CAP:
        return None
    pbuf.raw = prefix + b"\x00" * (_PREFIX_CAP - len(prefix))
    return pbuf, ctypes.c_int64(len(prefix))


def pack_int32_native(
    combined: np.ndarray,
    starts: np.ndarray,
    lens: np.ndarray,
    prefix: "bytes | None",
):
    """Parse a column's fields as ``prefix + canonical int32`` (typed value
    lanes).  Returns ``(prefix, int32 values)`` when every field conforms,
    else None.  ``prefix=None`` derives the prefix from the first field.
    The C++ parse releases the GIL and is threaded over row ranges."""
    lib = _load()
    n = int(starts.shape[0])
    if n == 0:
        return None  # nothing to derive a prefix from: the dictionary runs
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    out = np.empty(n, dtype=np.int32)
    base = combined.ctypes.data
    marshalled = _prefix_marshal(prefix)
    if marshalled is None:
        return None
    pbuf, plen = marshalled

    def run(lo: int, hi: int) -> int:
        return int(
            lib.csv_pack_int32(
                base,
                starts[lo:hi].ctypes.data_as(_I64P),
                lens[lo:hi].ctypes.data_as(_I32P),
                hi - lo, pbuf, ctypes.byref(plen), _PREFIX_CAP,
                out[lo:hi].ctypes.data,
            )
        )

    if plen.value < 0:
        # derive the prefix from field 0 alone, so every threaded range
        # below verifies against one established prefix
        if not run(0, 1):
            return None
    if not all(_run_ranges(run, n)):
        return None
    return bytes(pbuf.raw[: plen.value]), out


def pack_int32_strided_native(
    combined: np.ndarray,
    starts: np.ndarray,
    lens: np.ndarray,
    n_records: int,
    stride: int,
    off: int,
    prefix: "bytes | None",
):
    """Typed parse of column *off* of a rectangular chunk, whose record i
    holds it at flat field ``off + i*stride``: no per-column position
    gather.  Same contract as :func:`pack_int32_native`."""
    lib = _load()
    if n_records == 0:
        return None
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    out = np.empty(n_records, dtype=np.int32)
    marshalled = _prefix_marshal(prefix)
    if marshalled is None:
        return None
    pbuf, plen = marshalled
    ok = int(
        lib.csv_pack_int32_strided(
            combined.ctypes.data, starts.ctypes.data_as(_I64P), lens.ctypes.data_as(_I32P),
            n_records, stride, off, pbuf, ctypes.byref(plen), _PREFIX_CAP, out.ctypes.data,
        )
    )
    if not ok:
        return None
    return bytes(pbuf.raw[: plen.value]), out


def scan_parse_i32_native(data: bytes, delimiter: str, ncols: int, header, typed_state):
    """Tokenize and typed-parse a fully typed rectangular chunk in one C++
    pass, with no (start, len) offset arrays.  Every selected column must
    be typed with an established prefix.  Returns ``(nrec, {name:
    ("int", prefix, values)})``, or None to bail (the caller then runs
    the chunk through the generic scan, which owns error numbering)."""
    lib = _load()
    delim_b = delimiter.encode("utf-8")
    if len(delim_b) != 1:
        return None
    n = len(data)
    if n == 0 or ncols <= 0:
        return None
    # a typed record needs >= 1 digit per field plus its separator
    max_records = n // (2 * ncols) + 2
    outs = {}
    ptrs = (ctypes.c_void_p * ncols)()
    blob = bytearray()
    poff = np.zeros(ncols, dtype=np.int64)
    plen = np.zeros(ncols, dtype=np.int64)
    for name, idx in header.items():
        st = typed_state.get(name)
        if st is None or st[0] is None or idx >= ncols:
            return None
        arr = np.empty(max_records, dtype=np.int32)
        outs[name] = arr
        ptrs[idx] = arr.ctypes.data
        poff[idx] = len(blob)
        plen[idx] = len(st[0])
        blob.extend(st[0])
    base = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value
    rc = int(
        lib.csv_scan_parse_i32(
            base, n, delim_b, ncols, bytes(blob),
            poff.ctypes.data_as(_I64P), plen.ctypes.data_as(_I64P), ptrs, max_records,
        )
    )
    if rc <= 0:
        return None
    # copy the used slice: a view would pin the whole max_records buffer
    # (several times the real row count) for as long as the chunk lives
    return rc, {
        name: ("int", typed_state[name][0], np.ascontiguousarray(arr[:rc]))
        for name, arr in outs.items()
    }


def format_i32_native(values: np.ndarray, width: int = 12):
    """(NUL-padded (n, width) u8 matrix, int32 lens) of the decimal forms
    of *values*: the C++ itoa behind typed-column decode and demotion."""
    lib = _load()
    values = np.ascontiguousarray(values, dtype=np.int32)
    n = int(values.shape[0])
    out = np.empty((n, width), dtype=np.uint8)
    lens = np.empty(n, dtype=np.int32)
    if n == 0:
        return out, lens

    def run(lo: int, hi: int) -> None:
        lib.csv_format_i32(
            values[lo:hi].ctypes.data, hi - lo, width,
            out[lo:hi].ctypes.data, lens[lo:hi].ctypes.data,
        )

    _run_ranges(run, n)
    return out, lens


def encode_fields_vectorized(combined: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """Dictionary-encode a column straight from (start, len) offsets, with
    no per-field Python objects.

    The native pack gathers every field into NUL-padded fixed-width rows
    (uint64 for <= 8 bytes, a big-endian (hi, lo) pair for 9-16, a byte
    matrix beyond), which are deduplicated in padded-byte order.  Byte
    order on padded UTF-8 equals code-point order (no field holds a NUL;
    the caller checks), so the codes keep string order exactly like
    :func:`csvplus_tpu_torch.columnar.table.encode_strings`.

    Returns (dictionary of 'S' bytes, int32 codes), or None when a field
    is longer than :data:`_VEC_MAX_FIELD_LEN`.
    """
    n = starts.shape[0]
    if n == 0:
        return np.empty(0, dtype="S1"), np.empty(0, dtype=np.int32)
    L = int(lens.max())
    if L > _VEC_MAX_FIELD_LEN:
        return None
    L = max(L, 1)
    if L <= 8:
        packed = _pack_fields_native(combined, starts, lens, 8, u64=True)
        uniq64, codes = _encode_u64(packed)
        return _u64_dictionary_bytes(uniq64, L), codes.ravel().astype(np.int32)
    if L <= 16:
        be = _pack_fields_native(combined, starts, lens, 16).view(">u8")
        (uh, ul), codes = _encode_u64x2(be[:, 0].astype(np.uint64), be[:, 1].astype(np.uint64))
        pair = np.empty((uh.size, 2), dtype=">u8")
        pair[:, 0] = uh
        pair[:, 1] = ul
        dictionary = np.frombuffer(pair.tobytes(), dtype="S16").astype(f"S{L}")
        return dictionary, codes.ravel().astype(np.int32)
    mat = _pack_fields_native(combined, starts, lens, L)
    as_void = np.ascontiguousarray(mat).view([("v", f"V{L}")])["v"].ravel()
    uniq, codes = np.unique(as_void, return_inverse=True)
    return uniq.view(f"S{L}").ravel(), codes.ravel().astype(np.int32)


def _encode_u64(packed: np.ndarray):
    """Dictionary-encode packed u64 fields with ``np.unique``'s output
    contract: the C++ linear-probe hash encode while the distinct count
    stays under max(1024, n/4), else ``np.unique``'s sort."""
    lib = _load()
    n = packed.shape[0]
    max_k = max(1024, n // 4)
    uniq = np.empty(max_k, dtype=np.uint64)
    prov = np.empty(n, dtype=np.int32)
    k = lib.csv_encode_hash_u64(packed.ctypes.data, n, uniq.ctypes.data, prov.ctypes.data, max_k)
    if k >= 0:
        d = uniq[:k]
        order = np.argsort(d)
        rank = np.empty(k, dtype=np.int32)
        rank[order] = np.arange(k, dtype=np.int32)
        return d[order], rank[prov]
    return np.unique(packed, return_inverse=True)  # high cardinality


def _encode_u64x2(hi: np.ndarray, lo: np.ndarray):
    """Dictionary-encode (hi, lo) big-endian u64 lane pairs (9-16 byte
    fields): the C++ two-lane hash encode first, a lexsort when the
    distinct count is high.  Pair order == padded byte order, so the
    codes keep string order."""
    lib = _load()
    n = hi.shape[0]
    max_k = max(1024, n // 4)
    uh = np.empty(max_k, dtype=np.uint64)
    ul = np.empty(max_k, dtype=np.uint64)
    prov = np.empty(n, dtype=np.int32)
    hi_c = np.ascontiguousarray(hi)  # locals: alive through the native call
    lo_c = np.ascontiguousarray(lo)
    k = lib.csv_encode_hash_u64x2(
        hi_c.ctypes.data, lo_c.ctypes.data, n,
        uh.ctypes.data, ul.ctypes.data, prov.ctypes.data, max_k,
    )
    if k < 0:  # high cardinality
        order = np.lexsort((lo, hi))
        sh, sl = hi[order], lo[order]
        new = np.empty(n, dtype=bool)
        new[0] = True
        np.logical_or(sh[1:] != sh[:-1], sl[1:] != sl[:-1], out=new[1:])
        codes = np.empty(n, dtype=np.int32)
        codes[order] = (np.cumsum(new) - 1).astype(np.int32)
        return (sh[new], sl[new]), codes
    dh, dl = uh[:k], ul[:k]
    lex = np.lexsort((dl, dh))
    rank = np.empty(k, dtype=np.int32)
    rank[lex] = np.arange(k, dtype=np.int32)
    return (dh[lex], dl[lex]), rank[prov]


def _u64_dictionary_bytes(uniq64: np.ndarray, L: int) -> np.ndarray:
    """Big-endian-packed u64 dictionary values -> 'S{L}' bytes array."""
    lib = _load()
    k = uniq64.shape[0]
    uniq64 = np.ascontiguousarray(uniq64, dtype=np.uint64)
    out = np.empty((k, L), dtype=np.uint8)
    if k:
        lib.csv_u64_to_bytes(uniq64.ctypes.data, k, L, out.ctypes.data)
    return out.view(f"S{L}").ravel()


def _column_positions(data_counts, field_offset, header, rec_base, pad_allowed):
    """Per-column (positions, ok-mask) into the flat field arrays, with the
    column-not-found policy (csvplus.go:1121-1130)."""
    rec_offsets = np.zeros(data_counts.shape[0] + 1, dtype=np.int64)
    np.cumsum(data_counts, out=rec_offsets[1:])
    rec_offsets += field_offset
    for name in header:
        idx = header[name]
        pos = rec_offsets[:-1] + idx
        ok = data_counts > idx
        if not ok.all() and not pad_allowed:
            first_bad = int(np.flatnonzero(~ok)[0]) + rec_base
            raise DataSourceError(first_bad, f'column not found: "{name}" ({idx})')
        yield name, pos, ok


def _check_field_counts(data_counts, expected: int, first_record: int) -> int:
    """Field-count policy over data records (csvplus.go:1121-1130): lock
    *expected* from the first record when auto (0), then every record
    must match.  Returns the (possibly locked) expected width."""
    if data_counts.shape[0]:
        if expected == 0:
            expected = int(data_counts[0])
        bad = np.flatnonzero(data_counts != expected)
        if bad.size:
            raise DataSourceError(int(bad[0]) + first_record, ERR_FIELD_COUNT)
    return expected


def _resolve_header_from_arrays(reader, data, scratch, starts, lens, counts):
    """Header and field-count policy over pre-scanned offset arrays.
    Raises DataSourceError; never returns None."""
    nrec = counts.shape[0]
    expected = reader._num_fields
    if reader._header_from_first_row:
        if nrec == 0:
            raise DataSourceError(1, "EOF")
        first_n = int(counts[0])
        if expected == 0:
            expected = first_n
        elif expected > 0 and first_n != expected:
            raise DataSourceError(1, ERR_FIELD_COUNT)
        first = [
            _field_str(data, scratch, int(starts[i]), int(lens[i])) for i in range(first_n)
        ]
        header = reader._make_header(first, 1)
        rec_base = 2
        field_offset = first_n
        data_counts = counts[1:]
    else:
        header = dict(reader._header or {})
        rec_base = 1
        field_offset = 0
        data_counts = counts
    if reader._num_fields >= 0:
        expected = _check_field_counts(data_counts, expected, rec_base)
    return header, rec_base, field_offset, data_counts, expected


def read_encoded_columns_native(reader, path: str):
    """Columnar ingest fast path: parse natively and encode each selected
    column vectorized, with no per-cell Python strings.  Every
    all-present column of the form ``prefix + canonical int32`` becomes
    typed value lanes ``("int", prefix, int32 values)``; the others
    become ``(dictionary, codes)`` pairs.

    Returns (names, {name: encoded column}) or None to decline.
    """
    scanned = _scan_for_reader(reader, path)
    if scanned is None:
        return None
    data, starts, lens, counts, scratch, header, rec_base, field_offset = scanned
    if b"\x00" in data:  # a NUL would be ambiguous with the padding
        return None

    data_counts = counts[1:] if rec_base == 2 else counts
    # one buffer: scratch fields get offsets past the input data
    combined = np.frombuffer(data + scratch, dtype=np.uint8)
    abs_starts = np.where(starts >= 0, starts, len(data) + (-starts - 1))

    pad_allowed = reader._num_fields < 0
    cols = list(_column_positions(data_counts, field_offset, header, rec_base, pad_allowed))
    # the reference's switch, default on
    typed = os.environ.get("CSVPLUS_TYPED_LANES", "1") != "0"

    def enc_one(args):
        name, pos, ok = args
        all_present = bool(ok.all())
        if all_present:
            col_starts, col_lens = abs_starts[pos], lens[pos]
        else:
            col_starts = np.where(ok, abs_starts[np.where(ok, pos, 0)], 0)
            col_lens = np.where(ok, lens[np.where(ok, pos, 0)], 0)
        col_lens = col_lens.astype(np.int32)
        if typed and all_present:
            packed = pack_int32_native(combined, col_starts, col_lens, None)
            if packed is not None:
                return name, ("int", packed[0], packed[1])
        enc = encode_fields_vectorized(combined, col_starts, col_lens)
        if enc is None:
            raise _EncodeFallback(name)
        return name, enc

    try:
        out = dict(_map_columns(enc_one, cols))
    except _EncodeFallback:
        return None  # an over-long field: the strings tier handles it
    return list(header), out


class _EncodeFallback(Exception):
    """A column declined the vectorized encode (an over-long field); the
    caller abandons the whole encode at once."""


_col_pool = None
_col_pool_lock = threading.Lock()


def _col_pool_get():
    """Persistent column-encode pool (distinct from the pack pool: column
    tasks submit pack tasks, so they must not share one pool)."""
    global _col_pool
    if _col_pool is None:
        with _col_pool_lock:
            if _col_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                _col_pool = ThreadPoolExecutor(
                    max_workers=max(2, min((os.cpu_count() or 2) // 2, 8)),
                    thread_name_prefix="csvplus-col",
                )
    return _col_pool


def _map_columns(fn, cols):
    """Run *fn* over the columns, concurrently when there are several, the
    rows are many and the host has more than one core (``np.unique`` and
    the native calls release the GIL).  An exception from any column
    cancels the columns not yet started."""
    if (
        len(cols) < 2
        or (os.cpu_count() or 1) < 2
        or cols[0][1].shape[0] < _PACK_THREADS_MIN_N
    ):
        return [fn(c) for c in cols]
    futs = [_col_pool_get().submit(fn, c) for c in cols]
    try:
        return [f.result() for f in futs]
    except BaseException:
        for f in futs:
            f.cancel()
        raise


def _scan_for_reader(reader, path: str):
    """The native scan and header policy shared by both whole-file tiers;
    None when the reader's configuration needs the Python tier."""
    if reader._trim_leading_space:
        return None
    if len(reader._delimiter.encode("utf-8")) != 1:
        return None
    if reader._comment is not None and len(reader._comment.encode("utf-8")) != 1:
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise DataSourceError(1, f"open: {e.strerror or e}") from e
    starts, lens, counts, scratch = scan_bytes_parallel(
        data,
        delimiter=reader._delimiter,
        comment=reader._comment,
        lazy_quotes=reader._lazy_quotes,
    )
    header, rec_base, field_offset, _counts, _ = _resolve_header_from_arrays(
        reader, data, scratch, starts, lens, counts
    )
    return data, starts, lens, counts, scratch, header, rec_base, field_offset


def read_columns_native(reader, path: str):
    """Columnar read honouring the Reader's header and field-count
    policies: (names, {name: [values]}) like ``Reader.read_columns``, or
    None when the reader's configuration needs the Python tier.  Only the
    selected columns are ever materialized as strings."""
    scanned = _scan_for_reader(reader, path)
    if scanned is None:
        return None
    data, starts, lens, counts, scratch, header, rec_base, field_offset = scanned
    data_counts = counts[1:] if rec_base == 2 else counts
    out: Dict[str, List[str]] = {}
    pad_allowed = reader._num_fields < 0
    for name, pos, ok in _column_positions(
        data_counts, field_offset, header, rec_base, pad_allowed
    ):
        col_starts = starts[np.where(ok, pos, 0)]
        col_lens = lens[np.where(ok, pos, 0)]
        out[name] = [
            _field_str(data, scratch, int(s), int(l)) if o else ""
            for s, l, o in zip(col_starts.tolist(), col_lens.tolist(), ok.tolist())
        ]
    return list(header), out


# -- the streamed tier: a staged chunk pipeline ------------------------------


class StreamFallback(Exception):
    """Raised by the streamed tier on input it cannot handle (a quote
    under LazyQuotes, a NUL byte, an over-long field, an empty file, a
    lane dictionary outgrowing its width mid-stream); the caller then
    takes the whole-file tiers, which re-read the file from the start."""


_STREAM_CHUNK_BYTES = 64 << 20


def _stream_chunk_bytes() -> int:
    v = os.environ.get("CSVPLUS_STREAM_CHUNK_BYTES")
    return int(v) if v else _STREAM_CHUNK_BYTES


def _ingest_workers() -> int:
    """K, the chunk workers of the staged pipeline
    (``CSVPLUS_INGEST_WORKERS``).  0, unset or malformed = auto: half the
    cores (the scan also threads within a chunk), capped at 8.  K = 1 runs
    the same worker function inline."""
    k = env_int("CSVPLUS_INGEST_WORKERS", 0)
    if k <= 0:
        k = min(max((os.cpu_count() or 1) // 2, 1), 8)
    return max(1, min(k, 32))


def _iter_parity_chunks(reader, f, chunk_bytes: int):
    """Readahead stage: cut the file into chunks that each start at a
    record boundary with closed quote state.  The cut is the last newline
    whose cumulative quote count is even (under strict quoting an odd
    count means the newline lies inside a quoted field); the pending
    tail's parity carries across reads, so each byte is parity-scanned
    once.  Pure byte cutting, so every worker count sees the same
    chunks."""
    pending = b""
    pend_parity = 0
    pend_quote = False
    eof = False
    while not eof:
        faults.inject("ingest:read")  # fault site: an I/O error mid-file
        raw = f.read(chunk_bytes)
        if not raw:
            eof = True
            data, pending = pending, b""
            pend_parity, pend_quote = 0, False
            if not data:
                break
        else:
            raw_quote = b'"' in raw
            if raw_quote or pend_quote:
                if reader._lazy_quotes:
                    # a bare quote in an unquoted field is legal under
                    # LazyQuotes and breaks the parity cut
                    raise StreamFallback("quote under LazyQuotes")
                a = np.frombuffer(raw, dtype=np.uint8)
                parity = (np.cumsum(a == ord('"'), dtype=np.int64) + pend_parity) & 1
                safe_nl = np.flatnonzero((a == ord("\n")) & (parity == 0))
                if safe_nl.size == 0:
                    pending += raw  # one giant quoted record: read on
                    pend_parity = int(parity[-1])
                    pend_quote = pend_quote or raw_quote
                    continue
                cut = int(safe_nl[-1]) + 1
                data, pending = pending + raw[:cut], raw[cut:]
                pend_parity = int(parity[-1])
                pend_quote = b'"' in pending
            else:
                cut = raw.rfind(b"\n") + 1
                if cut == 0:
                    pending += raw  # no record boundary yet
                    continue
                data, pending = pending + raw[:cut], raw[cut:]
        yield data


class _StreamCtx:
    """State the chunk workers read, set by the first encoded chunk and
    owned by the ordered reassembler afterwards.  ``typed`` maps the live
    typed columns to their pinned prefix (None only while the first chunk
    derives it).  The reassembler swaps in a smaller dict when a column
    demotes; a worker reads the attribute once per chunk, so one in
    flight may still encode a just-demoted column, and the reassembler
    normalizes that result."""

    __slots__ = ("reader", "header", "names", "expected", "pad_allowed", "typed",
                 "fused_ncols", "delim_b", "scan_threads")

    def __init__(self, reader):
        self.reader = reader
        self.header = None
        self.names = []
        self.expected = reader._num_fields
        self.pad_allowed = reader._num_fields < 0
        self.typed = {}
        self.fused_ncols = 0
        self.delim_b = reader._delimiter.encode("utf-8")
        self.scan_threads = None


class _ChunkResult:
    """One chunk's scan + encode, made by a worker and consumed in file
    order by the reassembler.  Errors are chunk-relative (absolute =
    rel + next_record - 1): only the reassembler knows the chunk's base."""

    __slots__ = ("nscanned", "nrec", "cols", "error", "t_scan", "t_encode", "worker")

    def __init__(self):
        self.nscanned = 0  # records scanned (the header included on chunk 0)
        self.nrec = 0  # data records
        self.cols = None
        self.error = None  # ("data", rel_record, msg) | ("fallback", reason)
        self.t_scan = 0.0  # the worker's scan seconds (the fused path: all)
        self.t_encode = 0.0  # the worker's encode seconds
        self.worker = ""  # the thread that ran it (per-worker busy tallies)


_NOT_TYPED = object()  # sentinel: None is a valid (derive-mode) prefix


def _encode_scanned(ctx, res, data, scratch, starts, lens, data_counts, field_offset,
                    rec_base):
    """Column encode over pre-scanned offset arrays, for the first chunk
    (prefix-derive mode, inline) and the workers (pinned prefixes) alike.
    Fills *res*; data-shaped problems land in ``res.error``."""
    header = ctx.header
    typed = ctx.typed  # one read: the reassembler may swap in a new dict
    # scratch holds unescaped quoted content; negative starts index it
    enc_data = data + scratch if scratch else data
    combined = np.frombuffer(enc_data, dtype=np.uint8)
    base = len(data)
    abs_starts = np.where(starts >= 0, starts, base + (-starts - 1)) if scratch else starts
    # rectangular chunks: column idx of record r is flat field
    # field_offset + r*nf + idx, which the strided parse reads directly
    typed_out = {}
    failed_typed = set()
    nrec = int(data_counts.shape[0])
    res.nrec = nrec
    uniform_nf = 0
    if typed and not scratch and nrec:
        mn, mx = int(data_counts.min()), int(data_counts.max())
        if mn == mx:
            uniform_nf = mn
    if uniform_nf:
        for name, idx in header.items():
            prefix = typed.get(name, _NOT_TYPED)
            if prefix is _NOT_TYPED or idx >= uniform_nf:
                continue
            packed = pack_int32_strided_native(
                combined, starts, lens, nrec, uniform_nf, field_offset + idx, prefix
            )
            if packed is None:
                failed_typed.add(name)  # a dictionary from here; the reassembler demotes
                continue
            typed_out[name] = ("int", packed[0], packed[1])

    try:
        cols = (
            list(_column_positions(data_counts, field_offset, header, rec_base,
                                   ctx.pad_allowed))
            if len(typed_out) < len(header)
            else []
        )
    except DataSourceError as e:
        res.error = ("data", int(e.line), e.err)
        return
    cols = [c for c in cols if c[0] not in typed_out]

    def enc_one(args):
        name, pos, ok = args
        all_present = bool(ok.all())
        if all_present:
            col_starts, col_lens = abs_starts[pos], lens[pos].astype(np.int32)
        else:
            col_starts = np.where(ok, abs_starts[np.where(ok, pos, 0)], 0)
            col_lens = np.where(ok, lens[np.where(ok, pos, 0)], 0).astype(np.int32)
        prefix = typed.get(name, _NOT_TYPED)
        if prefix is not _NOT_TYPED and name not in failed_typed and all_present:
            packed = pack_int32_native(combined, col_starts, col_lens, prefix)
            if packed is not None:
                return name, ("int", packed[0], packed[1])
        enc = encode_fields_vectorized(combined, col_starts, col_lens)
        if enc is None:
            raise StreamFallback("field too long for vectorized encode")
        return name, enc

    try:
        out = dict(_map_columns(enc_one, cols))
    except StreamFallback as e:
        res.error = ("fallback", str(e))
        return
    out.update(typed_out)
    res.cols = out


def _scan_encode_chunk(ctx, data):
    """One worker's unit: scan and encode one chunk after the first,
    against the context.  It reads ``ctx`` and mutates nothing shared, so
    K workers run it at once (the native calls release the GIL) and the
    reassembler's file-order merge is the only serialization point.  The
    ``ingest:worker`` fault site fires first; :func:`_run_chunk` re-runs
    a chunk whose worker crashed."""
    faults.inject("ingest:worker")  # fault site: one worker crashes
    res = _ChunkResult()
    res.worker = threading.current_thread().name
    t0 = time.perf_counter()
    reader = ctx.reader
    if b"\x00" in data:
        res.error = ("fallback", "NUL in chunk")
        return res
    typed = ctx.typed
    # fused path: every selected column typed with a pinned prefix and a
    # plain chunk (no quote, CR or comment) -> one C++ pass tokenizes and
    # parses without writing field offsets.  Any bail reruns the chunk
    # through the generic path, which owns the error numbering.
    if (
        ctx.fused_ncols
        and typed
        and len(ctx.delim_b) == 1
        and reader._comment is None
        and len(typed) == len(ctx.header)
        and all(
            p is not None
            # a prefix holding the delimiter or a record terminator would
            # let the fused prefix compare read across fields
            and ctx.delim_b not in p and b"\n" not in p and b"\r" not in p
            for p in typed.values()
        )
        and b'"' not in data
        and b"\r" not in data
    ):
        fused = scan_parse_i32_native(
            data, reader._delimiter, ctx.fused_ncols, ctx.header,
            {n: (p,) for n, p in typed.items()},
        )
        if fused is not None:
            # fused records have exact arity by construction
            res.nscanned = res.nrec = fused[0]
            res.cols = fused[1]
            res.t_scan = time.perf_counter() - t0
            return res
    try:
        # chunks start at record boundaries with closed quote state, so
        # the threaded newline-split scan applies as to whole files
        starts, lens, counts, scratch = scan_bytes_parallel(
            data, delimiter=reader._delimiter, comment=reader._comment,
            lazy_quotes=reader._lazy_quotes, n_threads=ctx.scan_threads,
        )
    except DataSourceError as e:
        res.error = ("data", int(e.line), e.err)
        return res
    res.nscanned = int(counts.shape[0])
    res.t_scan = time.perf_counter() - t0
    if reader._num_fields >= 0:
        try:
            _check_field_counts(counts, ctx.expected, 1)
        except DataSourceError as e:
            res.error = ("data", int(e.line), e.err)
            return res
    _encode_scanned(ctx, res, data, scratch, starts, lens, counts, 0, 1)
    res.t_encode = time.perf_counter() - t0 - res.t_scan
    return res


#: Bounded re-runs of one chunk after transient worker crashes.
_WORKER_RETRIES = 3


def _run_chunk(ctx, data):
    """Run one worker unit, re-running the chunk after a transient worker
    crash (at most :data:`_WORKER_RETRIES` times).  Sound because
    :func:`_scan_encode_chunk` is pure over the immutable ``ctx`` and the
    chunk bytes: the reassembler cannot tell that a crash happened.
    Other failures re-raise untouched; each recovery counts
    ``ingest.worker_recovered``."""
    from ..resilience.retry import TRANSIENT, classify
    from ..utils.observe import telemetry

    attempt = 0
    while True:
        try:
            return _scan_encode_chunk(ctx, data)
        except Exception as err:
            if classify(err) != TRANSIENT or attempt >= _WORKER_RETRIES:
                raise
            attempt += 1
            telemetry.count("ingest.worker_recovered")


def stream_encoded_chunks(reader, path: str, chunk_bytes: Optional[int] = None,
                          workers: Optional[int] = None):
    """Generator over record-aligned chunks of *path*, each scanned and
    encoded natively with no per-cell Python objects.

    Yields ``(names, {name: encoded column}, nrows)`` per chunk: an
    encoded column is a ``(dictionary, codes)`` pair or, for a column
    whose every cell so far is ``prefix + canonical int32``, a typed
    ``("int", prefix, int32 values)`` triple (``CSVPLUS_TYPED_LANES=0``
    turns those off).  The column set is fixed by the first chunk with
    records, which resolves the header, locks the field-count policy and
    derives the typed prefixes inline.  Host memory holds a constant
    number of chunks, never the whole file.

    After that the staged pipeline runs: the readahead stage
    (:func:`_iter_parity_chunks`), K workers (``CSVPLUS_INGEST_WORKERS``
    or *workers*) running :func:`_scan_encode_chunk`, and an ordered
    reassembler that emits chunks in file order.  Workers encode typed
    columns speculatively against a prefix snapshot; the reassembler owns
    demotion (the first non-conforming chunk in file order demotes) and
    normalizes stale typed results through ``format_affix`` to the same
    dictionary encoding, and it renumbers chunk-relative errors to
    absolute records.  So what is yielded, where a column demotes and
    every error's row number are the same for every K; K = 1 drives the
    same worker function inline.

    Raises :class:`StreamFallback` for the reference's reasons (see the
    class) and :class:`DataSourceError` with absolute 1-based record
    numbers for header and field-count errors.
    """
    if reader._trim_leading_space:
        raise StreamFallback("trim")
    if len(reader._delimiter.encode("utf-8")) != 1:
        raise StreamFallback("delimiter")
    if reader._comment is not None and len(reader._comment.encode("utf-8")) != 1:
        raise StreamFallback("comment")
    chunk_bytes = chunk_bytes or _stream_chunk_bytes()
    k_workers = max(1, workers if workers is not None else _ingest_workers())
    typed_enabled = os.environ.get("CSVPLUS_TYPED_LANES", "1") != "0"
    next_record = 1  # absolute 1-based ordinal of the next record scanned
    typed_live: set = set()  # columns still typed, in file order
    _pc = time.perf_counter
    stats = {
        "cut": 0.0,  # readahead: file read + parity cut
        "stall": 0.0,  # the reassembler waiting on the head-of-line chunk
        "scan": 0.0,
        "encode": 0.0,
        "rows": 0,
        "chunks": 0,
        "per_worker": {},
    }

    def account(res):
        stats["chunks"] += 1
        stats["rows"] += res.nrec
        stats["scan"] += res.t_scan
        stats["encode"] += res.t_encode
        w = stats["per_worker"]
        w[res.worker] = w.get(res.worker, 0.0) + res.t_scan + res.t_encode

    try:
        f = open(path, "rb")
    except OSError as e:
        raise DataSourceError(1, f"open: {e.strerror or e}") from e
    with f:
        chunks_iter = _iter_parity_chunks(reader, f, chunk_bytes)
        ctx = None

        # establishment, inline until the first chunk with records
        while True:
            try:
                data = next(chunks_iter, None)
            except OSError as e:
                raise map_error(e, next_record) from e
            if data is None:
                break
            t0 = _pc()
            if b"\x00" in data:
                raise StreamFallback("NUL in chunk")
            try:
                starts, lens, counts, scratch = scan_bytes_parallel(
                    data, delimiter=reader._delimiter, comment=reader._comment,
                    lazy_quotes=reader._lazy_quotes,
                )
            except DataSourceError as e:
                raise DataSourceError(e.line + next_record - 1, e.err)
            if counts.shape[0] == 0:
                continue  # a comment-only chunk before the first record
            header, rec_base, field_offset, data_counts, expected = (
                _resolve_header_from_arrays(reader, data, scratch, starts, lens, counts)
            )
            ctx = _StreamCtx(reader)
            ctx.header = header
            ctx.names = list(header)
            ctx.expected = expected
            if typed_enabled:
                ctx.typed = {n: None for n in ctx.names}  # derive mode
                if expected and expected > 0:
                    ctx.fused_ncols = int(expected)
                elif data_counts.size and int(data_counts.min()) == int(data_counts.max()):
                    ctx.fused_ncols = int(data_counts[0])
            if k_workers > 1:
                # chunk workers and the scan's own threads split the cores
                ctx.scan_threads = max(1, (os.cpu_count() or 1) // k_workers)
            res = _ChunkResult()
            res.worker = threading.current_thread().name
            res.nscanned = int(counts.shape[0])
            res.t_scan = _pc() - t0
            _encode_scanned(ctx, res, data, scratch, starts, lens, data_counts,
                            field_offset, rec_base)
            res.t_encode = _pc() - t0 - res.t_scan
            if res.error is not None:
                if res.error[0] == "fallback":
                    raise StreamFallback(res.error[1])
                raise DataSourceError(res.error[1], res.error[2])  # next_record == 1
            # pin the derived prefixes; a column that came back as a
            # dictionary left typed mode on its first chunk
            ctx.typed = {
                c: enc[1] for c, enc in res.cols.items() if len(enc) == 3 and enc[0] == "int"
            }
            typed_live = set(ctx.typed)
            account(res)
            next_record += res.nscanned
            yield ctx.names, res.cols, res.nrec
            break
        if ctx is None:
            return  # no records at all: the consumer falls back

        def emit(res):
            """Ordered reassembly of one chunk: absolute error numbers,
            demotion in file order, normalized stale typed results."""
            nonlocal next_record
            if res.error is not None:
                if res.error[0] == "fallback":
                    raise StreamFallback(res.error[1])
                raise DataSourceError(res.error[1] + next_record - 1, res.error[2])
            out = res.cols
            demoted_now = False
            for c in ctx.names:
                enc = out[c]
                if len(enc) == 3 and enc[0] == "int":
                    if c not in typed_live:
                        # a worker's snapshot predates this column's
                        # demotion: re-encode exactly as a dictionary
                        # (format_affix inverts the native parse)
                        from ..columnar.typed import format_affix

                        strs = format_affix(enc[1], np.asarray(enc[2], np.int32))
                        dd, cc = np.unique(strs, return_inverse=True)
                        out[c] = (dd, cc.astype(np.int32))
                elif c in typed_live:
                    # the first non-conforming chunk in file order: the
                    # column leaves typed mode for good
                    typed_live.discard(c)
                    demoted_now = True
            if demoted_now:
                # new chunks skip the dead speculative work
                ctx.typed = {c: p for c, p in ctx.typed.items() if c in typed_live}
            account(res)
            next_record += res.nscanned
            return ctx.names, out, res.nrec

        cut_error = None
        read_error = None
        if k_workers == 1:
            while True:
                t0 = _pc()
                try:
                    data = next(chunks_iter, None)
                except StreamFallback as e:
                    cut_error = e
                    data = None
                except OSError as e:
                    read_error = e
                    data = None
                stats["cut"] += _pc() - t0
                if data is None:
                    break
                yield emit(_run_chunk(ctx, data))
        else:
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=k_workers, thread_name_prefix="csvplus-ingest")
            try:
                pending: deque = deque()
                exhausted = False
                while True:
                    # at most K chunks in flight: K encodes + one being cut
                    while not exhausted and len(pending) < k_workers:
                        t0 = _pc()
                        try:
                            data = next(chunks_iter, None)
                        except StreamFallback as e:
                            # chunks already cut still emit first, in the
                            # serial loop's order
                            cut_error = e
                            data = None
                        except OSError as e:
                            read_error = e
                            data = None
                        stats["cut"] += _pc() - t0
                        if data is None:
                            exhausted = True
                            break
                        pending.append((pool.submit(_scan_encode_chunk, ctx, data), data))
                    if not pending:
                        break
                    t0 = _pc()
                    fut, chunk_data = pending.popleft()
                    try:
                        res = fut.result()
                    except Exception as err:
                        from ..resilience.retry import TRANSIENT, classify

                        if classify(err) != TRANSIENT:
                            raise
                        # a crashed worker: re-run its chunk here, in the
                        # same head-of-line position, so K stays
                        # unobservable
                        from ..utils.observe import telemetry

                        telemetry.count("ingest.worker_recovered")
                        res = _run_chunk(ctx, chunk_data)
                    stats["stall"] += _pc() - t0
                    yield emit(res)
            finally:
                pool.shutdown(wait=False, cancel_futures=True)
        if read_error is not None:
            raise map_error(read_error, next_record) from read_error
        if cut_error is not None:
            raise cut_error

    # per-stage attribution (recorded only while collecting; no
    # barriers): cut = readahead read + parity cut, encode = worker busy
    # time (summed over workers, so above wall time when they overlap),
    # reorder-stall = the reassembler's head-of-line waits
    from ..obs.span import tracer
    from ..utils.observe import telemetry

    rows = stats["rows"]
    telemetry.add_stage("ingest:cut", rows, rows, stats["cut"], chunks=stats["chunks"])
    telemetry.add_stage(
        "ingest:encode", rows, rows, stats["scan"] + stats["encode"],
        workers=k_workers,
        scan_s=round(stats["scan"], 4),
        encode_s=round(stats["encode"], 4),
        per_worker_busy_s={k: round(v, 4) for k, v in sorted(stats["per_worker"].items())},
    )
    if k_workers > 1:
        telemetry.add_stage("ingest:reorder-stall", rows, rows, stats["stall"],
                            workers=k_workers)
    # in a trace, each worker's busy time is one span on its own lane
    if tracer.active():
        for worker, busy_s in sorted(stats["per_worker"].items()):
            tracer.add_span("ingest:encode-worker", float(busy_s),
                            lane=f"ingest-w{worker}", worker=worker)
