"""Plain reference of the README's three-way join over BASELINE.json's
config 5 (orders, customers, products), in numpy alone.

:func:`generate` writes the three tables in vectorised blocks with the
layout of :mod:`.orders3` (``o<row>,c<cust>,p<prod>,<qty>`` orders,
``c<i>,name<i mod 9973>`` customers, ``p<i>,prod<i>,<price>`` products),
but with heavy-tailed customer keys: each order's customer rank is drawn
from Zipf(``cust_zipf_s``) truncated to the customers (rank k, from 1,
with probability proportional to ``k ** -s``, by the inverse of its
cumulative sum), and ranks become ids through a seeded permutation of
the customers, so the hottest customers are spread over the id range.
Every block of rows draws from a generator seeded by (seed, block), so a
seed gives the same tables whatever the thread timing.

:func:`expected_filter_join` works out ``orders.filter(pred).join(
customers, "cust_id").join(products)`` again from the generated arrays,
block by block: every order matches one customer and one product, so
the result is the surviving orders in stream order, each merged with
its customer and its product (a stream value wins a name clash,
csvplus.go:571-583).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .cells import Cells, Hashes
from .fnv import digits, fnv32, lines, lit, write_rows
from .orders3 import _orders_lines, _price, _sbytes

#: Rows a block of generation or of the expected result works on.
BLOCK = 4_000_000


def _blocks(n: int, fn) -> None:
    """``fn(block, lo, hi)`` for every :data:`BLOCK` rows of *n*, on a
    few threads (numpy releases the interpreter lock in its loops)."""
    starts = range(0, n, BLOCK)
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        list(pool.map(lambda b: fn(b, starts[b], min(starts[b] + BLOCK, n)), range(len(starts))))


def zipf_cdf(n: int, s: float) -> np.ndarray:
    """Cumulative weights of ranks 1..n under Zipf(s), ``k ** -s``."""
    return np.cumsum(np.arange(1, n + 1, dtype=np.float64) ** -float(s))


def generate(root: Path, tables: dict, seed: int) -> dict:
    """Write ``orders.csv``, ``customers.csv`` and ``products.csv`` into
    *root* (sizes and the Zipf exponent from *tables*) and return the
    arrays they were made from."""
    spec = tables["orders"]
    n, s = spec["rows"], spec["cust_zipf_s"]
    n_cust = tables["customers"]["rows"]
    n_prod = tables["products"]["rows"]
    cdf = zipf_cdf(n_cust, s)
    ids = np.random.default_rng([seed, 1]).permutation(n_cust).astype(np.int32)
    cust = np.empty(n, np.int32)
    prod = np.empty(n, np.int32)
    qty = np.empty(n, np.int32)

    def draw(b: int, lo: int, hi: int) -> None:
        rng = np.random.default_rng([seed, 2, b])
        rank = np.searchsorted(cdf, rng.random(hi - lo) * cdf[-1], side="right")
        cust[lo:hi] = ids[np.minimum(rank, n_cust - 1)]
        prod[lo:hi] = rng.integers(0, n_prod, hi - lo)
        qty[lo:hi] = rng.integers(1, 101, hi - lo)

    _blocks(n, draw)
    paths = {t: root / f"{t}.csv" for t in ("orders", "customers", "products")}
    with open(paths["orders"], "wb") as f:
        f.write(b"order_id,cust_id,prod_id,qty\n")
        write_rows(f, n, lambda lo, hi: _orders_lines(lo, hi, cust, prod, qty))
    with open(paths["customers"], "wb") as f:
        f.write(b"id,name\n")
        write_rows(f, n_cust, lambda lo, hi: lines([
            lit(hi - lo, b"c"), digits(np.arange(lo, hi)), lit(hi - lo, b",name"),
            digits(np.arange(lo, hi) % 9973), lit(hi - lo, b"\n")]))
    pi = np.arange(n_prod)
    with open(paths["products"], "wb") as f:
        f.write(b"prod_id,product,price\n")
        f.write(b"\n".join(np.char.add(np.char.add(np.char.add(_sbytes(b"p", pi), b","),
                                                   np.char.add(_sbytes(b"prod", pi), b",")),
                                       _price(pi)).tolist()) + b"\n")
    return {"paths": paths, "n": n, "cust": cust, "prod": prod, "qty": qty,
            "price_hash": fnv32(_price(pi))}


def column_cells(data: dict, table: str, column: str) -> Cells:
    """The values of one fact-table column, row by row (what a filter
    reads)."""
    if table != "orders":
        raise KeyError(table)
    if column == "order_id":
        return Cells(b"o", np.arange(data["n"], dtype=np.int32))
    return {"cust_id": Cells(b"c", data["cust"]), "prod_id": Cells(b"p", data["prod"]),
            "qty": Cells(b"", data["qty"])}[column]


def expected_filter_join(data: dict, keep: np.ndarray) -> dict:
    """Every column of the filtered three-way join, row by row, filled
    block by block into int32 arrays."""
    n = data["n"]
    counts = [int(np.count_nonzero(keep[lo:lo + BLOCK])) for lo in range(0, n, BLOCK)]
    at = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    m = int(at[-1])
    rows, cust, prod, qty = (np.empty(m, np.int32) for _ in range(4))
    name = np.empty(m, np.int32)
    price = np.empty(m, np.uint32)

    def fill(b: int, lo: int, hi: int) -> None:
        a, z = at[b], at[b + 1]
        r = np.flatnonzero(keep[lo:hi]) + lo
        rows[a:z] = r
        cust[a:z] = data["cust"][r]
        prod[a:z] = data["prod"][r]
        qty[a:z] = data["qty"][r]
        name[a:z] = cust[a:z] % 9973
        price[a:z] = data["price_hash"][prod[a:z]]

    _blocks(n, fill)
    return {
        "order_id": Cells(b"o", rows),
        "cust_id": Cells(b"c", cust),
        "prod_id": Cells(b"p", prod),
        "qty": Cells(b"", qty),
        "id": Cells(b"c", cust),
        "name": Cells(b"name", name),
        "product": Cells(b"prod", prod),
        "price": Hashes(price),
    }
