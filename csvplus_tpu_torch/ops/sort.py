"""Device index build: multi-key sort over dictionary codes.

Port of ``csvplus_tpu/ops/sort.py``.  Each dictionary is sorted, so code
order == byte-lexicographic string order, and a stable sort on
(col0, col1, ..., colk) gives the reference's left-to-right key order
(csvplus.go:722-736, 794-807) with ties kept in input order.

``lax.sort(num_keys=k, is_stable=True)`` sorts on k keys in one call;
``torch.sort`` sorts on one.  The port runs one stable pass per key, from
the least significant key to the most, carrying the permutation — the
classic LSD composition, equal to the lexicographic stable sort.

A table row-sharded over more than one shard, of at least
:data:`DSORT_MIN_ROWS` rows, sorts through the distributed sample sort
(:mod:`..parallel.dsort`) on its packed key lanes.  Its permutation holds
global row ids in the mesh's block layout, and the sorted table keeps
that layout: each shard gathers its rows from a copy of the column on
its device, one copy per distinct device, made and dropped column by
column.  Below the threshold the reference's replicated sort puts the
whole array on every device; here the key columns are assembled on the
table's device and sorted there, and the sorted table lives there.
Every assembly and every such copy is counted
(``parallel.mesh.assemblies``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..columnar.table import DeviceTable, GlobalRows, host_or_storage
from ..parallel.mesh import Mesh, ShardedRows, smap
from ..utils.env import env_int

# Sharded tables of at least this many rows sort through the distributed
# sample sort instead of the replicated one.  Read at import, as the
# reference reads it.
DSORT_MIN_ROWS = env_int("CSVPLUS_DSORT_MIN_ROWS", 1_000_000)


def sort_permutation(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """int64 permutation that stably sorts rows by *keys* (most
    significant first)."""
    n = int(keys[0].shape[0])
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in reversed(keys):
        _, order = torch.sort(torch.index_select(k, 0, perm), stable=True)
        perm = torch.index_select(perm, 0, order)
    return perm


def _code_storage(col):
    """A key column's code storage (a typed column's demoted codes)."""
    return (col._demote() if col.kind == "int" else col).storage


def _sharded_mesh(key_cols) -> Optional[Mesh]:
    """The mesh every key column's codes are row-sharded over, when it has
    more than one shard (the shard count, not the device set: eight
    shards on one card count), else None."""
    mesh = None
    for c in key_cols:
        st = _code_storage(c)
        if not isinstance(st, ShardedRows) or st.mesh.size <= 1:
            return None
        if mesh is None:
            mesh = st.mesh
        elif st.mesh is not mesh:
            return None
    return mesh


def _packed_sort_lanes(key_cols) -> "Optional[Tuple[ShardedRows, ...]]":
    """The key columns' codes packed into sample-sort lanes, per shard, as
    the join packs its keys: one int32 lane up to 31 packed bits, two
    nonnegative 31-bit (hi, lo) lanes up to 62, None beyond.  Sorted
    dictionaries make packed order the lexicographic code order."""
    from .join import _bits_for, _pack_qk, pack_lanes

    bits = [_bits_for(c.dict_size) for c in key_cols]
    total = sum(bits)
    if total > 62:
        return None
    shifts = []
    acc = 0
    for b in reversed(bits):
        shifts.insert(0, acc)
        acc += b
    codes = [_code_storage(c) for c in key_cols]
    mesh = codes[0].mesh
    if total <= 31:
        return (smap(mesh, lambda *cs: _pack_qk(cs, shifts), *codes),)
    return smap(mesh, lambda *cs: pack_lanes(list(cs), shifts, bits), *codes)


def _dsort_table(table: DeviceTable, key_columns, mesh: Mesh, lanes) -> DeviceTable:
    """The distributed sample sort of a sharded table by its packed key
    lanes: a stable sort (the payload is each row's global id, the tie
    breaker), then every column gathered by the permutation, shard by
    shard, into a table sharded as the permutation is."""
    from ..parallel.dsort import distributed_sort_device
    from ..utils.observe import telemetry

    with telemetry.stage("dsort", table.nrows):
        offs = lanes[0].offsets()
        iota = smap(mesh, lambda ln, o: torch.arange(ln.shape[0], dtype=torch.int32,
                                                      device=ln.device) + o,
                    lanes[0], ShardedRows(mesh, [torch.tensor(o) for o in offs]))
        _, perm = distributed_sort_device(mesh, lanes, iota)
    perm = GlobalRows(mesh, perm.map(lambda p: p.to(torch.int64)).shards)
    keys = set(key_columns)
    # key columns come out as dictionary columns, as the replicated sort
    # gives them (a typed key is demoted)
    out = {name: (col._demote() if name in keys and col.kind == "int" else col).gather(perm)
           for name, col in table.columns.items()}
    return DeviceTable(out, table.nrows, table.device)


def sort_table(table: DeviceTable, key_columns: Sequence[str]) -> DeviceTable:
    """A new table with rows stably sorted by the key columns.

    Sorting by a column needs code order == string order, so a typed key
    column is demoted to its dictionary here and comes out as a
    ``StringColumn``, as in the reference, and a deferred (unsorted) lane
    dictionary is sorted on the device; every other column, typed, lane
    or not, rides along as its storage array.  A sharded table sorts as
    the module docstring says.

    The replicated sort and its gathers are the stage ``index:sort``; a
    deferred dictionary's sort (``lane-dict:deferred-sort``) nests in
    it.  The sharded path records its ``dsort`` stage alone: its
    ``index:sort`` record is discarded, while the span and range stay
    around the nested ``dsort``, as every discarded stage's do."""
    from ..utils.observe import telemetry
    from .join import _flat

    with telemetry.stage("index:sort", table.nrows) as stage:
        for c in key_columns:
            table.columns[c]._ensure_sorted_lanes()
        if table.mesh is not None and table.stored_len != table.nrows:
            table = DeviceTable({n: c.with_storage(host_or_storage(c.storage, table.nrows))
                                 for n, c in table.columns.items()}, table.nrows, table.device)
        key_cols = [table.columns[c] for c in key_columns]
        if table.nrows >= DSORT_MIN_ROWS:
            mesh = _sharded_mesh(key_cols)
            # packed lanes need a real code in every key cell: the index
            # build checked that; other callers take the replicated sort
            if mesh is not None and not any(c.has_absent for c in key_cols):
                lanes = _packed_sort_lanes(key_cols)
                if lanes is not None:
                    stage["discard"] = True
                    return _dsort_table(table, key_columns, mesh, lanes)
        keys = {c: table.columns[c].codes for c in key_columns}
        perm = sort_permutation(list(keys.values()))
        out = {}
        for name, col in table.columns.items():
            if name in keys:
                out[name] = col.with_codes(torch.index_select(keys[name], 0, perm))
            else:
                out[name] = col.gather(perm)
        telemetry.barrier(_flat([c.storage for c in out.values()]))
    return DeviceTable(out, table.nrows, table.device)


def _adjacent_equal(table: DeviceTable, key_columns: Sequence[str]) -> torch.Tensor:
    """bool[n-1]: row i+1's key equals row i's, over every key column."""
    eq = None
    for c in key_columns:
        k = table.columns[c].codes
        e = k[1:] == k[:-1]
        eq = e if eq is None else (eq & e)
    return eq


def find_adjacent_duplicate(
    table: DeviceTable, key_columns: Sequence[str]
) -> "int | None":
    """Index of the first row whose key equals the previous row's, or
    None — the columnar form of the reference's adjacent scan
    (csvplus.go:749-753), with one scalar transfer."""
    if table.nrows < 2:
        return None
    eq = _adjacent_equal(table, key_columns)
    # argmax of a bool tensor is the first True; -1 when there is none
    first = torch.where(eq.any(), torch.argmax(eq.to(torch.uint8)) + 1, -1)
    i = int(first.item())
    return None if i < 0 else i


def run_flags(
    table: DeviceTable, key_columns: Sequence[str], policy: str = "first"
) -> torch.Tensor:
    """Device bool[n] marking the row each equal-key run keeps: its first
    (``"first"``) or its last (``"last"``, the shifted compare: row i is
    kept when row i+1 starts a new run).  Nothing is copied to the host."""
    if table.nrows < 2:
        return torch.ones(table.nrows, dtype=torch.bool, device=table.device)
    neq = ~_adjacent_equal(table, key_columns)
    edge = torch.ones(1, dtype=torch.bool, device=neq.device)
    return torch.cat([edge, neq] if policy == "first" else [neq, edge])


def flag_positions(flags: torch.Tensor) -> torch.Tensor:
    """int64 positions of *flags*' set entries, compacted on the device;
    the one host read is the output size (counted)."""
    from ..utils.observe import telemetry

    telemetry.count_sync(1)
    return torch.nonzero(flags).squeeze(1)


def run_starts(table: DeviceTable, key_columns: Sequence[str]) -> np.ndarray:
    """Host bool array marking the first row of each equal-key run."""
    return run_flags(table, key_columns).to("cpu").numpy()
