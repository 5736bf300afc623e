"""The filter of a drawn query, evaluated in numpy over the generated
columns.

A drawn predicate is plain data (see :mod:`portbench.units`):
``["like", [[column, prefix, value, width], ...]]`` matches a row whose
every listed column holds ``prefix + decimal(value)`` (Go csvplus's
``Like``, csvplus.go:1279-1293); ``["not", p]``, ``["any", [p, ...]]`` and
``["all", [p, ...]]`` combine them.
"""

from __future__ import annotations

import numpy as np


def evaluate(node, cells_of, n: int) -> np.ndarray:
    """Boolean keep mask over *n* rows; ``cells_of(column)`` gives the
    column's :class:`~.cells.Cells`."""
    op, arg = node
    if op == "like":
        keep = np.ones(n, dtype=bool)
        for column, prefix, value, width in arg:
            c = cells_of(column)
            if c.prefix != prefix.encode() or c.width != width:
                return np.zeros(n, dtype=bool)
            keep &= c.ints == value
        return keep
    if op == "not":
        return ~evaluate(arg, cells_of, n)
    if op in ("any", "all"):
        parts = [evaluate(p, cells_of, n) for p in arg]
        reduce = np.logical_or if op == "any" else np.logical_and
        return reduce.reduce(parts) if parts else np.full(n, op == "all")
    raise ValueError(f"unknown predicate {op!r}")
