"""Canned pipelines for the BASELINE.json benchmark configs.

Port of ``csvplus_tpu/models/workloads.py``: each function builds one of
the benchmark workloads as a ready-to-run pipeline over the public API,
parameterized by input sources:

1. ``filter_map``  — take(people).filter(Like).map(SetValue) (attach a sink)
2. ``index_build`` — unique_index_on(id) + point finds
3. ``threeway``    — orders ⋈ custIndex ⋈ prodIndex (``models.flagship``
   is the fused form)
4. ``dedup``       — index_on(non-unique key).resolve_duplicates
5. ``sharded_join`` — the join with a row-sharded stream over a mesh
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


def sharded_join(orders_reader, cust_index, shards: int, cust_col="cust_id", mesh=None):
    """Config 5: the join with a row-sharded stream over an N-shard mesh
    (probes take the all-to-all partitioned tier when the build side is
    large; see ``ops.join.DeviceIndex.PARTITION_MIN_KEYS``).  The shards
    go over ``cuda:0`` .. ``cuda:N-1``; *mesh* (an addition to the
    reference's signature) places them itself instead, e.g. all on one
    card with ``make_mesh(N, devices=["cuda:0"] * N)``."""
    stream = orders_reader.on_device(shards=None if mesh is not None else shards, mesh=mesh)
    return stream.join(cust_index, cust_col)
