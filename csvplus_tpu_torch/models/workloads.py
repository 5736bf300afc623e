"""Canned pipelines for the BASELINE.json benchmark configs.

Port of ``csvplus_tpu/models/workloads.py``: each function builds one of
the benchmark workloads as a ready-to-run pipeline over the public API,
parameterized by input sources:

1. ``filter_map``  — take(people).filter(Like).map(SetValue) (attach a sink)
2. ``index_build`` — unique_index_on(id) + point finds
3. ``threeway``    — orders ⋈ custIndex ⋈ prodIndex (``models.flagship``
   is the fused form)
4. ``dedup``       — index_on(non-unique key).resolve_duplicates

Config 5 (``sharded_join``, the join with a row-sharded stream over a
mesh) needs sharded tables behind ``on_device``, which this package does
not have yet.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from ..exprs import SetValue
from ..predicates import Like


def filter_map(source, match: dict, set_col: str, set_val: str):
    """Config 1: symbolic filter + rename-style map; returns the lazy
    pipeline (attach a sink to run it)."""
    return source.filter(Like(match)).map(SetValue(set_col, set_val))


def index_build(source, key: str, probes: Iterable[Sequence[str]] = ()):
    """Config 2: unique index build + point lookups; returns (index,
    probe results)."""
    index = source.unique_index_on(key)
    results = [index.find(*p).to_rows() for p in probes]
    return index, results


def threeway(orders, cust_index, prod_index, cust_col="cust_id", prod_col="prod_id"):
    """Config 3: the README 3-table join as a lazy pipeline."""
    return orders.join(cust_index, cust_col).join(prod_index, prod_col)


def dedup(source, key: str, policy="first"):
    """Config 4: non-unique index + duplicate resolution; returns the
    compacted index."""
    index = source.index_on(key)
    index.resolve_duplicates(policy)
    return index
