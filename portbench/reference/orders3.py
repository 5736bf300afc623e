"""Plain reference of the README's three-way join (orders, customers,
products), in numpy alone.

:func:`generate` is a frozen copy of ``chip_smoke.generate`` and
``chip_smoke._orders_lines`` (commit e8ef993), with the three tables'
row counts read from the configuration; :func:`expected_filter_join`
works out the result of ``orders.filter(pred).join(customers,
"cust_id").join(products)`` again from the generated arrays, as
``chip_smoke.oracle`` does: every order matches one customer and one
product, so the result is the surviving orders in stream order, each
merged with its customer and its product (a stream value wins a name
clash, csvplus.go:571-583).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .cells import Cells, Hashes
from .fnv import digits, fnv32, lines, lit, write_rows


def _sbytes(prefix: bytes, ints: np.ndarray) -> np.ndarray:
    return np.char.add(prefix, ints.astype("S"))


def _orders_lines(lo: int, hi: int, cust, prod, qty) -> bytes:
    """Orders rows [lo, hi): ``o<row>,c<cust>,p<prod>,<qty>``."""
    m = hi - lo
    return lines([lit(m, b"o"), digits(np.arange(lo, hi)), lit(m, b",c"),
                  digits(cust[lo:hi]), lit(m, b",p"), digits(prod[lo:hi]), lit(m, b","),
                  digits(qty[lo:hi]), lit(m, b"\n")])


def _price(pi: np.ndarray) -> np.ndarray:
    return np.array([f"{(i % 9900) / 100 + 0.99:.2f}".encode() for i in pi.tolist()])


def generate(root: Path, tables: dict, seed: int) -> dict:
    """Write ``orders.csv``, ``customers.csv`` and ``products.csv`` into
    *root* (row counts from *tables*) and return the arrays they were
    made from."""
    n = tables["orders"]["rows"]
    n_cust = tables["customers"]["rows"]
    n_prod = tables["products"]["rows"]
    rng = np.random.default_rng(seed)
    cust = rng.integers(0, n_cust, n)
    prod = rng.integers(0, n_prod, n)
    qty = rng.integers(1, 101, n)
    ci = np.arange(n_cust)
    pi = np.arange(n_prod)
    paths = {t: root / f"{t}.csv" for t in ("orders", "customers", "products")}
    with open(paths["customers"], "wb") as f:
        f.write(b"id,name\n")
        f.write(b"\n".join(np.char.add(np.char.add(_sbytes(b"c", ci), b","),
                                       _sbytes(b"name", ci % 9973)).tolist()) + b"\n")
    with open(paths["products"], "wb") as f:
        f.write(b"prod_id,product,price\n")
        f.write(b"\n".join(np.char.add(np.char.add(np.char.add(_sbytes(b"p", pi), b","),
                                                   np.char.add(_sbytes(b"prod", pi), b",")),
                                       _price(pi)).tolist()) + b"\n")
    with open(paths["orders"], "wb") as f:
        f.write(b"order_id,cust_id,prod_id,qty\n")
        write_rows(f, n, lambda lo, hi: _orders_lines(lo, hi, cust, prod, qty))
    return {"paths": paths, "n": n, "cust": cust, "prod": prod, "qty": qty,
            "price_hash": fnv32(_price(pi))}


def column_cells(data: dict, table: str, column: str) -> Cells:
    """The values of one fact-table column, row by row (what a filter
    reads)."""
    if table != "orders":
        raise KeyError(table)
    if column == "order_id":
        return Cells(b"o", np.arange(data["n"]))
    return {"cust_id": Cells(b"c", data["cust"]), "prod_id": Cells(b"p", data["prod"]),
            "qty": Cells(b"", data["qty"])}[column]


def expected_filter_join(data: dict, keep: np.ndarray) -> dict:
    """Every column of the filtered three-way join, row by row."""
    rows = np.flatnonzero(keep)
    cust, prod = data["cust"][rows], data["prod"][rows]
    return {
        "order_id": Cells(b"o", rows),
        "cust_id": Cells(b"c", cust),
        "prod_id": Cells(b"p", prod),
        "qty": Cells(b"", data["qty"][rows]),
        "id": Cells(b"c", cust),
        "name": Cells(b"name", cust % 9973),
        "product": Cells(b"prod", prod),
        "price": Hashes(data["price_hash"][prod]),
    }
