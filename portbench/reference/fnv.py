"""Byte and hash helpers of the plain reference, in numpy alone.

Frozen copies from ``chip_smoke.py`` (commit e8ef993), so that the
yardstick does not move when that script does:

* :func:`fnv32` is ``chip_smoke._fnv32``, :func:`fnv32_mat` is
  ``_fnv32_mat`` and :func:`fnv_affix` is ``_fnv_affix``: 32-bit FNV-1a
  of a value's bytes;
* :func:`digits`, :func:`lit` and :func:`lines` are ``_digits``,
  ``_lit`` and ``_lines``: CSV bytes built from NUL-padded byte matrices;
* :func:`write_rows` is ``_write_rows``.

Nothing here imports the program under test.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

FNV_OFFSET = np.uint32(2166136261)
FNV_PRIME = np.uint32(16777619)


def fnv32(values: np.ndarray) -> np.ndarray:
    """32-bit FNV-1a of each entry of an 'S' array."""
    n = values.size
    width = values.dtype.itemsize
    mat = np.frombuffer(values.tobytes(), dtype=np.uint8).reshape(n, width)
    lens = np.char.str_len(values)
    h = np.full(n, FNV_OFFSET, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for i in range(width):
            h = np.where(i < lens, (h ^ mat[:, i]) * FNV_PRIME, h)
    return h


def fnv32_mat(mat: np.ndarray) -> np.ndarray:
    """:func:`fnv32` of the rows of a NUL-padded (n, width) byte matrix."""
    h = np.full(mat.shape[0], FNV_OFFSET, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for i in range(mat.shape[1]):
            col = mat[:, i]
            h = np.where(col != 0, (h ^ col) * FNV_PRIME, h)
    return h


def digits(v: np.ndarray, width: int = 0) -> np.ndarray:
    """(n, w) uint8 decimal digits of the nonnegative ints *v*, left
    aligned and NUL padded; ``width`` > 0 gives exactly that many digits,
    zero filled (``%0*d``)."""
    v = np.asarray(v, dtype=np.int64)
    w = width or max(len(str(int(v.max()))) if v.size else 1, 1)
    if v.size and int(v.max()) >= 10**w:
        raise ValueError("value too wide")

    def fixed(x: np.ndarray, d: int) -> np.ndarray:
        out = np.empty((x.size, d), np.uint8)
        for k in range(d - 1, -1, -1):
            x, r = np.divmod(x, 10)
            out[:, k] = r + 48
        return out

    if width:
        return fixed(v, w)
    out = np.zeros((v.size, w), np.uint8)
    nd = np.ones(v.shape, np.int64)
    for k in range(1, w):
        nd += v >= 10**k
    for d in range(1, w + 1):
        rows = np.flatnonzero(nd == d)
        if rows.size:
            out[rows, :d] = fixed(v[rows], d)
    return out


def lit(n: int, b: bytes) -> np.ndarray:
    """The constant bytes *b* as an (n, len(b)) matrix."""
    return np.broadcast_to(np.frombuffer(b, np.uint8), (n, len(b)))


def lines(pieces) -> bytes:
    """Side-by-side byte matrices as one run of bytes, NULs dropped."""
    mat = np.hstack(pieces)
    flat = mat.ravel()
    return flat[flat != 0].tobytes()


def fnv_affix(prefix: bytes, v: np.ndarray, width: int = 0) -> np.ndarray:
    """FNV-1a of ``prefix + decimal(v)`` per row, for nonnegative ints
    (``width`` > 0: zero filled to that many digits)."""
    n = v.size
    d = digits(v, width)
    return fnv32_mat(np.hstack([lit(n, prefix), d]) if prefix else d)


def write_rows(f, n: int, make_lines, chunk: int = 2_000_000) -> None:
    """Write ``make_lines(lo, hi)`` (the bytes of rows [lo, hi)) for every
    *chunk* rows of *n*, in order, built on a few threads (numpy releases
    the interpreter lock in its loops), at most a window of them held."""
    starts = list(range(0, n, chunk))
    workers = max(1, min(8, os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as pool:
        for w in range(0, len(starts), 2 * workers):
            window = starts[w:w + 2 * workers]
            for data in pool.map(lambda lo: make_lines(lo, min(lo + chunk, n)), window):
                f.write(data)
