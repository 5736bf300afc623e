"""Eager sinks: the terminals that drive a lazy chain.

Port of ``to_csv``/``to_csv_file``/``to_rows`` from
``csvplus_tpu/sinks.py`` (csvplus.go:376-415, 483-490, and the atomic
``writeFile`` of csvplus.go:418-443: on any error the partly written file
is closed and removed).  A device-planned source runs its plan inside
``src(fn)`` (its run function is
:func:`csvplus_tpu_torch.columnar.exec.plan_runner`), so the sinks are the
same for both paths and write the same bytes.  Typed affix-int32 columns
reach them as strings formatted by the native C++ itoa
(``IntColumn.decode``), byte for byte the reference's; the reference's
vectorized CSV encoder (``columnar/csvenc.py``) is not ported yet.
"""

from __future__ import annotations

import os
from typing import IO, List

from .csvio import write_record
from .row import Row


def to_csv(src, out: IO[str], *columns: str) -> None:
    """Write selected columns in canonical CSV form: the header line
    first, then one record per row (csvplus.go:379-406)."""
    if not columns:
        raise ValueError("empty column list in ToCsv() function")

    write_record(out, list(columns))

    def fn(row: Row) -> None:
        write_record(out, row.select_values(*columns))

    src(fn)


def to_csv_file(src, name: str, *columns: str) -> None:
    """CSV sink to a named file with no partial output (csvplus.go:411-415)."""
    _write_file(name, lambda f: to_csv(src, f, *columns))


def to_rows(src) -> List[Row]:
    """Materialize the source into a list of Rows (csvplus.go:483-490)."""
    out: List[Row] = []
    src(out.append)
    return out


def _write_file(name: str, fn) -> None:
    """Create *name*, run *fn(file)*; on any failure remove the file
    (csvplus.go:418-443)."""
    f = open(name, "w", encoding="utf-8", newline="")
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
