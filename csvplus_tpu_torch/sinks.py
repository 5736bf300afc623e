"""Eager sinks: the terminals that drive a lazy chain.

Port of ``csvplus_tpu/sinks.py``: ``to_csv``/``to_csv_file``
(csvplus.go:376-415), ``to_json``/``to_json_file`` (csvplus.go:445-480),
``to_rows`` (csvplus.go:483-490) and the atomic ``writeFile``
(csvplus.go:418-443: on any error the partly written file is closed and
removed).

A device-planned source runs its plan once (:func:`..columnar.exec.
device_table_for`) and the body is encoded at once by
:mod:`.columnar.csvenc`: quoting once per dictionary entry, the CSV body
through the C++ scatter, typed columns through the C++ itoa.  A result
with absent cells or a missing column streams its rows instead, for the
reference's exact per-row errors; so does any source without a device
plan.  The bytes are the same either way.
"""

from __future__ import annotations

import os
from typing import IO, List

from .csvio import write_record
from .row import Row
from .utils.gojson import go_json_object


def to_csv(src, out: IO[str], *columns: str) -> None:
    """Write selected columns in canonical CSV form: the header line
    first, then one record per row (csvplus.go:379-406)."""
    if not columns:
        raise ValueError("empty column list in ToCsv() function")

    write_record(out, list(columns))

    if getattr(src, "plan", None) is not None:
        from .columnar.csvenc import encode_csv_body
        from .columnar.exec import device_table_for

        table = device_table_for(src)  # remembered: a prefix never runs twice
        if table is not None:
            body = encode_csv_body(table, columns)
            if body is not None:
                out.write(body)
                return
            # stream the computed table for the exact per-row
            # missing-column errors and partial output
            from .source import iterate

            iterate(
                table.to_rows(),
                lambda row: write_record(out, row.select_values(*columns)),
                clone=False,
            )
            return

    def fn(row: Row) -> None:
        write_record(out, row.select_values(*columns))

    src(fn)


def to_csv_file(src, name: str, *columns: str) -> None:
    """CSV sink to a named file with no partial output (csvplus.go:411-415)."""
    _write_file(name, lambda f: to_csv(src, f, *columns))


def to_json(src, out: IO[str]) -> None:
    """Write the rows as a JSON array of objects (csvplus.go:446-475), in
    Go's ``json.Encoder`` byte format: each object compact with sorted
    keys and followed by a newline, objects separated by commas inside
    ``[...]``, ``&<>`` unescaped (``SetEscapeHTML(false)``,
    csvplus.go:456), written in ~10 KB batches when streamed."""
    if getattr(src, "plan", None) is not None:
        from .columnar.csvenc import encode_json_body
        from .columnar.exec import device_table_for

        table = device_table_for(src)
        if table is not None:
            body = encode_json_body(table)
            if body is not None:
                out.write("[" + body + "]")
                return
            # rows of different schemas: stream the computed table
            from .source import iterate

            rows_out: List[Row] = []
            iterate(table.to_rows(), rows_out.append, clone=False)
            src = lambda fn: [fn(r) for r in rows_out]  # noqa: E731

    buf: List[str] = ["["]
    buf_len = 1
    count = 0

    def emit(row: Row) -> None:
        nonlocal buf_len, count
        count += 1
        if count != 1:
            buf.append(",")
            buf_len += 1
        s = go_json_object(row) + "\n"
        buf.append(s)
        buf_len += len(s)
        if buf_len > 10000:
            out.write("".join(buf))
            buf.clear()
            buf_len = 0

    src(emit)

    buf.append("]")
    out.write("".join(buf))


def to_json_file(src, name: str) -> None:
    """JSON sink to a named file with no partial output (csvplus.go:478-480)."""
    _write_file(name, lambda f: to_json(src, f))


def to_rows(src) -> List[Row]:
    """Materialize the source into a list of Rows (csvplus.go:483-490).
    A ``take_rows`` or ``find`` result clones straight off its backing
    rows, which is what streaming it would deliver."""
    hint = getattr(src, "_rows_hint", None)
    if hint is not None:
        return [Row(r) for r in hint]
    out: List[Row] = []
    src(out.append)
    return out


def to_rows_many(sources) -> List[List[Row]]:
    """Materialize a batch of sources, one Row list per source in order:
    the sink for :meth:`Index.find_many` results, whose search and decode
    the batched engine already amortized."""
    out = []
    for src in sources:
        hint = getattr(src, "_rows_hint", None)
        out.append([Row(r) for r in hint] if hint is not None else to_rows(src))
    return out


def _write_file(name: str, fn, mode: str = "w") -> None:
    """Create *name*, run *fn(file)*; on any failure remove the file
    (csvplus.go:418-443).  ``mode="wb"`` for binary writers."""
    if "b" in mode:
        f = open(name, mode)
    else:
        f = open(name, mode, encoding="utf-8", newline="")
    try:
        fn(f)
        f.close()  # a failing close (e.g. ENOSPC on flush) also removes it
    except BaseException:
        try:
            f.close()
        except OSError:
            pass
        try:
            os.remove(name)
        except OSError:
            pass
        raise
