"""Vectorized CSV and JSON encoding of columnar results.

Port of ``csvplus_tpu/columnar/csvenc.py``.  The streaming sink calls a
Python writer per row; for a device-resident result this module builds
the whole body at once instead:

* quoting and escaping run once per **dictionary entry**, not per cell:
  Go csv.Writer's needs-quotes rule (delimiter, quote, CR, LF, a leading
  space, or the value ``\\.``) and ``""`` doubling;
* the CSV body is one pre-sized byte buffer: per-row field starts from
  length gathers and a running sum across columns, then one C++
  memcpy-per-cell scatter per column (``csv_scatter_fields`` in
  ``native/scanner.cpp``).  :func:`encode_csv_body` with ``native=False``
  builds the same bytes with numpy string ops (its plain version);
* the JSON body is a numpy string reduction over the sorted columns.

The output is byte for byte the streaming writer's; a table with absent
cells or a missing column returns None, and the sink then streams rows
for the exact per-row errors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from .table import DeviceTable, host_array


def _escape_dictionary(d_str: np.ndarray, delimiter: str = ",") -> np.ndarray:
    """Go csv.Writer's fieldNeedsQuotes and escaping, per unique value."""
    if d_str.size == 0:
        return d_str
    has_special = (
        (np.char.find(d_str, delimiter) >= 0)
        | (np.char.find(d_str, '"') >= 0)
        | (np.char.find(d_str, "\r") >= 0)
        | (np.char.find(d_str, "\n") >= 0)
    )
    first = d_str.astype("U1")
    # Go: unicode.IsSpace on the first rune; np.char.isspace("") is False
    leading_space = np.char.isspace(first)
    backslash_dot = d_str == "\\."
    needs = (has_special | leading_space | backslash_dot) & (d_str != "")
    if not needs.any():
        return d_str
    escaped = np.char.add(np.char.add('"', np.char.replace(d_str[needs], '"', '""')), '"')
    out = d_str.astype(object)
    out[needs] = escaped
    return out.astype(np.str_)


def _host_codes(col) -> np.ndarray:
    """A dictionary column's codes on the host, read after a deferred
    lane dictionary is sorted (its host dictionary needs sorted codes); a
    row-sharded column downloads shard by shard, in row order."""
    col._ensure_sorted_lanes()
    return host_array(col.storage)


def encode_json_body(table: DeviceTable) -> Optional[str]:
    """The JSON array body (between the brackets), byte for byte the
    streaming sink's (sorted keys, compact separators, a newline after
    each object, Go string escaping with ``SetEscapeHTML(false)``), or
    None when a column has absent cells (rows then differ in schema and
    the streaming path handles them)."""
    from ..utils.gojson import go_json_string

    names = sorted(table.columns)
    cols = []
    for c in names:
        col = table.columns[c]
        if col.has_absent:
            return None
        cols.append(col)
    if table.nrows == 0:
        return ""
    if not names:
        return "\n,".join(["{}"] * table.nrows) + "\n"

    line = None
    for i, (name, col) in enumerate(zip(names, cols)):
        if col.kind == "int":
            # '"<escaped prefix><digits>"': digits and '-' never need
            # escaping, the constant prefix escapes once
            body = go_json_string(col.prefix.decode("utf-8"))[1:-1]
            digits = host_array(col.storage).astype(np.str_)
            vals = np.char.add(np.char.add('"' + body, digits), '"')
        else:
            codes = _host_codes(col)
            d = col.dictionary_str()
            enc = np.asarray([go_json_string(v) for v in d.tolist()], dtype=np.str_)
            vals = enc[codes]
        prefix = ("{" if i == 0 else ",") + go_json_string(name) + ":"
        piece = np.char.add(prefix, vals)
        line = piece if line is None else np.char.add(line, piece)
    line = np.char.add(line, "}")
    return "\n,".join(line.tolist()) + "\n"


def encode_csv_body(
    table: DeviceTable, columns: Sequence[str], native: bool = True
) -> Optional[str]:
    """The CSV body (no header) of the selected columns, or None when this
    path cannot match the streaming sink (a missing column or absent
    cells: the caller streams for the exact per-row errors).  *native*
    picks the C++ scatter (the sink's path) or the numpy string build;
    both give the same bytes."""
    cols = []
    for c in columns:
        col = table.columns.get(c)
        if col is None or col.has_absent:
            return None
        cols.append(col)
    if table.nrows == 0:
        return ""
    if native:
        return _encode_csv_body_native(table.nrows, cols)

    pieces = []
    for i, col in enumerate(cols):
        if col.kind == "int":
            vals = col.formatted_str()
            if _affix_needs_quotes(col.prefix.decode("utf-8")):
                vals = _escape_dictionary(vals)
        else:
            codes = _host_codes(col)
            vals = _escape_dictionary(col.dictionary_str())[codes]
        pieces.append(np.char.add(vals, ",") if i < len(cols) - 1 else vals)
    line = pieces[0]
    for p in pieces[1:]:
        line = np.char.add(line, p)
    line = np.char.add(line, "\n")
    return "".join(line.tolist())


def _affix_needs_quotes(prefix: str) -> bool:
    """Whether a typed column's values can need CSV quoting: only through
    the constant prefix (digits and '-' never do, a typed value is never
    empty or ``\\.``, and its first rune is the prefix's or a digit/'-')."""
    return any(ch in prefix for ch in ',"\r\n') or (prefix[:1].isspace() if prefix else False)


def _encode_csv_body_native(nrows: int, cols) -> str:
    """The CSV body assembled by the C++ scatter into one byte buffer."""
    from ..native.scanner import _load

    lib = _load()
    per_col = []
    field_lens = []
    for col in cols:
        if col.kind == "int":
            # typed: the formatted rows are the blob (identity codes);
            # quoting can only come from the constant prefix
            enc_s = col.formatted_host()
            if _affix_needs_quotes(col.prefix.decode("utf-8")):
                esc = _escape_dictionary(np.char.decode(enc_s, "utf-8"))
                enc_s = np.char.encode(esc, "utf-8")
            lens = np.char.str_len(enc_s).astype(np.int32)
            offs = np.arange(lens.size, dtype=np.int64) * enc_s.dtype.itemsize
            codes = np.arange(lens.size, dtype=np.int32)
            per_col.append((enc_s.tobytes(), offs, lens, codes))
            field_lens.append(lens.astype(np.int64))
            continue
        codes = np.ascontiguousarray(_host_codes(col), dtype=np.int32)
        d = _escape_dictionary(col.dictionary_str())
        enc = np.char.encode(d, "utf-8") if d.size else np.empty(0, "S1")
        lens = np.char.str_len(enc).astype(np.int32)
        # the padded 'S' buffer as the blob: the scatter copies lens[c]
        # bytes per slot, so no per-entry Python object is made
        offs = np.arange(lens.size, dtype=np.int64) * enc.dtype.itemsize
        per_col.append((enc.tobytes(), offs, lens, codes))
        field_lens.append(lens[codes].astype(np.int64))

    # each field is followed by one separator byte (',' inside a row,
    # '\n' at its end), rows laid out back to back
    row_len = np.zeros(nrows, dtype=np.int64)
    for flens in field_lens:
        row_len += flens + 1
    row_off = np.zeros(nrows, dtype=np.int64)
    if nrows > 1:
        np.cumsum(row_len[:-1], out=row_off[1:])

    out = np.empty(int(row_len.sum()), dtype=np.uint8)
    col_start = row_off
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    for i, ((blob, offs, lens, codes), flens) in enumerate(zip(per_col, field_lens)):
        lib.csv_scatter_fields(
            blob,
            offs.ctypes.data_as(i64p),
            lens.ctypes.data_as(i32p),
            codes.ctypes.data_as(i32p),
            col_start.ctypes.data_as(i64p),
            nrows,
            b"\n" if i == len(per_col) - 1 else b",",
            out.ctypes.data,
        )
        if i < len(per_col) - 1:
            col_start = col_start + flens + 1
    return out.tobytes().decode("utf-8")
