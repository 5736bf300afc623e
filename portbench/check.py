"""The comparison that decides ``correct``: a result table of the
program, read cell by cell, against the plain reference's columns.

The program's output is read only to be judged.  A dictionary column's
entries (a host 'S' array, or the device's sign-flipped big-endian int32
byte lanes) are decoded here on the table's device; a typed column's
cells are ``prefix + decimal(value)``.  Each column is then put in the
reference's terms:

* against :class:`~.reference.cells.Cells` every row becomes the int its
  bytes spell after the prefix, or -1 when its bytes are not exactly
  ``prefix`` then the digits (``width`` of them, zero filled, when
  ``width`` > 0; canonical otherwise);
* against :class:`~.reference.cells.Hashes` every row becomes the 32-bit
  FNV-1a of its bytes, by this module's own copy of the hash.

An absent cell reads -2.  The numbers compared are the rows missing or
extra, the columns missing or extra, and the cells that differ; every
limit is 0, since the guarantees (stream order, the first row of each
key kept, every value's bytes kept) admit no other answer.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.cells import Cells
from .reference.fnv import FNV_OFFSET, FNV_PRIME, fnv_affix

_M32 = 0xFFFFFFFF
_ABSENT = -2

#: The numbers a comparison yields, each with its limit.
LIMITS = {"rows_off": 0, "columns_off": 0, "cells_off": 0}


def _entry_bytes(col) -> torch.Tensor:
    """(entries, width) uint8 bytes of a dictionary column, NUL padded,
    on the codes' device."""
    lanes = col.dev_dictionary  # read before the codes: it may remap them
    if lanes is not None:
        cols = []
        for lane in lanes:
            word = (lane.to(torch.int64) ^ -0x80000000) & _M32
            cols += [((word >> s) & 0xFF).to(torch.uint8) for s in (24, 16, 8, 0)]
        return torch.stack(cols, dim=1)
    d = np.asarray(col.dictionary)
    mat = np.frombuffer(d.tobytes(), np.uint8).reshape(d.size, max(d.dtype.itemsize, 1))
    return torch.from_numpy(mat.copy()).to(col.codes.device)


def _fnv_rows(mat: torch.Tensor) -> torch.Tensor:
    """FNV-1a of each row's bytes, NULs skipped (int64, < 2**32)."""
    h = torch.full((mat.shape[0],), int(FNV_OFFSET), dtype=torch.int64, device=mat.device)
    for j in range(mat.shape[1]):
        b = mat[:, j].to(torch.int64)
        h = torch.where(b != 0, ((h ^ b) * int(FNV_PRIME)) & _M32, h)
    return h


def _parse_rows(mat: torch.Tensor, prefix: bytes, width: int) -> torch.Tensor:
    """The int each row's bytes spell after *prefix*, or -1 (see the
    module docstring).  Column by column, so that a long dictionary
    needs no wide temporary."""
    n, w = mat.shape
    p = len(prefix)
    if w < p + 1:
        return torch.full((n,), -1, dtype=torch.int64, device=mat.device)
    ok = torch.ones(n, dtype=torch.bool, device=mat.device)
    for j, b in enumerate(prefix):
        ok &= mat[:, j] == b
    v = torch.zeros(n, dtype=torch.int64, device=mat.device)
    length = torch.zeros(n, dtype=torch.int64, device=mat.device)
    ended = torch.zeros(n, dtype=torch.bool, device=mat.device)
    for j in range(p, w):
        b = mat[:, j]
        live = b != 0
        ok &= ~(ended & live)  # the bytes run unbroken up to the first NUL
        ended |= ~live
        ok &= ((b >= 48) & (b <= 57)) | ~live
        v = torch.where(live, v * 10 + (b.to(torch.int64) - 48), v)
        length += live
    ok &= (length >= 1) & (length <= 18)
    if width:
        ok &= length == width
    else:
        ok &= (length == 1) | (mat[:, p] != 48)
    return torch.where(ok, v, -1)


def _typed_rows(col, want, n: int) -> np.ndarray:
    """A typed column (``prefix + decimal(value)``, int32 values) in the
    reference's terms."""
    values = col.values[:n].to(torch.int64).cpu().numpy()
    if isinstance(want, Cells):
        if col.prefix != want.prefix:
            return np.full(n, -1, dtype=np.int64)
        if want.width:
            ok = (values >= 0) & (values < 10**want.width)
            if want.width > 1:
                ok &= values >= 10 ** (want.width - 1)
            return np.where(ok, values, -1)
        return np.where(values >= 0, values, -1)
    neg = values < 0
    out = fnv_affix(col.prefix, np.abs(values)).astype(np.int64)
    if neg.any():
        out[neg] = fnv_affix(col.prefix + b"-", -values[neg]).astype(np.int64)
    return out


def column_rows(col, want, n: int) -> np.ndarray:
    """The first *n* rows of a program column, in the terms of *want*."""
    if col.kind == "int":
        return _typed_rows(col, want, n)
    mat = _entry_bytes(col)
    codes = col.codes[:n].to(torch.int64)
    if isinstance(want, Cells):
        per_entry = _parse_rows(mat, want.prefix, want.width)
    else:
        per_entry = _fnv_rows(mat)
    if per_entry.numel() == 0:
        return np.full(n, _ABSENT, dtype=np.int64)
    rows = torch.where(codes >= 0, per_entry[codes.clamp(min=0)], _ABSENT)
    return rows.cpu().numpy()


def reading(want) -> np.ndarray:
    """A reference column in the terms :func:`column_rows` reads a
    program column in."""
    return want.ints.astype(np.int64) if isinstance(want, Cells) else want.hashes()


def compare_columns(got: dict, nrows: int, expected: dict) -> dict:
    """Compare per-row readings *got* (column -> array over the program's
    *nrows* rows, from :func:`column_rows`) with the reference."""
    n_want = len(next(iter(expected.values()))) if expected else 0
    out = {"rows_off": abs(nrows - n_want),
           "columns_off": len(set(got) ^ set(expected)), "cells_off": 0}
    m = min(nrows, n_want)
    for name, want in expected.items():
        if name not in got:
            out["cells_off"] += n_want
            continue
        out["cells_off"] += int(np.count_nonzero(got[name][:m] != reading(want)[:m]))
        out["cells_off"] += abs(nrows - n_want)
    return out


def read_table(table, expected: dict) -> "tuple[dict, int]":
    """Every column of a program result table in the reference's terms,
    and its row count; a column the reference does not name reads None
    and counts as extra."""
    n = int(table.nrows)
    got = {name: column_rows(col, expected[name], n) if name in expected else None
           for name, col in table.columns.items()}
    return got, n


def add(total: dict, part: dict) -> dict:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v
    return total
