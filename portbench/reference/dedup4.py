"""Plain reference of ``index_on(key).resolve_duplicates(policy)`` over
the deduplication table of BASELINE.json's config 4, in numpy alone.

:func:`generate` is a frozen copy of ``chip_smoke._dedup_data`` (commit
e8ef993) with the sizes read from the configuration:
``order_id,cust_id,qty,ts`` rows whose ``order_id`` (``o%08d``,
zero-padded, so byte order is numeric order) takes each of
``distinct`` ids once and re-uses a seeded draw of them for the rest,
in a seeded row order; ``ts`` is the row number.

:func:`expected_index_dedup` works the result out again: the index
orders rows by the key's bytes, stably, and ``"first"`` keeps each
key's first row in that order, which is its lowest row number
(``"last"``: its highest), as Go csvplus's ``ResolveDuplicates`` does
(csvplus.go:643-653).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .cells import Cells
from .fnv import digits, lines, lit, write_rows


def generate(root: Path, tables: dict, seed: int) -> dict:
    """Write ``orders.csv`` into *root* and return the arrays it was made
    from."""
    spec = tables["orders"]
    n, n_distinct, n_cust = spec["rows"], spec["distinct_order_ids"], spec["customers"]
    rng = np.random.default_rng(seed + 10)
    ids = rng.permutation(np.concatenate([
        np.arange(n_distinct), rng.integers(0, n_distinct, n - n_distinct)]))
    cust = rng.integers(0, n_cust, n)
    qty = rng.integers(1, 101, n)
    path = root / "orders.csv"
    with open(path, "wb") as f:
        f.write(b"order_id,cust_id,qty,ts\n")
        write_rows(f, n, lambda lo, hi: lines([
            lit(hi - lo, b"o"), digits(ids[lo:hi], 8), lit(hi - lo, b",c"),
            digits(cust[lo:hi]), lit(hi - lo, b","), digits(qty[lo:hi]), lit(hi - lo, b","),
            digits(np.arange(lo, hi)), lit(hi - lo, b"\n")]))
    return {"paths": {"orders": path}, "n": n, "distinct": n_distinct, "ids": ids,
            "cust": cust, "qty": qty}


def kept_rows(data: dict, policy: str) -> np.ndarray:
    """The row numbers the deduplicated index holds, in index order."""
    ids, n = data["ids"], data["n"]
    if policy == "first":
        pick = np.full(data["distinct"], n, dtype=np.int64)
        np.minimum.at(pick, ids, np.arange(n))
        return pick[pick < n]
    if policy == "last":
        pick = np.full(data["distinct"], -1, dtype=np.int64)
        np.maximum.at(pick, ids, np.arange(n))
        return pick[pick >= 0]
    raise ValueError(policy)


def expected_index_dedup(data: dict, key: list, policy: str) -> dict:
    """Every column of the deduplicated index, row by row."""
    if list(key) != ["order_id"]:
        raise ValueError(f"this table is indexed on order_id, not {key}")
    rows = kept_rows(data, policy)
    return {
        "order_id": Cells(b"o", data["ids"][rows], 8),
        "cust_id": Cells(b"c", data["cust"][rows]),
        "qty": Cells(b"", data["qty"][rows]),
        "ts": Cells(b"", rows),
    }
