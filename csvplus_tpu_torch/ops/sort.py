"""Device index build: multi-key sort over dictionary codes.

Port of ``csvplus_tpu/ops/sort.py``.  Each dictionary is sorted, so code
order == byte-lexicographic string order, and a stable sort on
(col0, col1, ..., colk) gives the reference's left-to-right key order
(csvplus.go:722-736, 794-807) with ties kept in input order.

``lax.sort(num_keys=k, is_stable=True)`` sorts on k keys in one call;
``torch.sort`` sorts on one.  The port runs one stable pass per key, from
the least significant key to the most, carrying the permutation — the
classic LSD composition, equal to the lexicographic stable sort.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..columnar.table import DeviceTable


def sort_permutation(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """int64 permutation that stably sorts rows by *keys* (most
    significant first)."""
    n = int(keys[0].shape[0])
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in reversed(keys):
        _, order = torch.sort(torch.index_select(k, 0, perm), stable=True)
        perm = torch.index_select(perm, 0, order)
    return perm


def sort_table(table: DeviceTable, key_columns: Sequence[str]) -> DeviceTable:
    """A new table with rows stably sorted by the key columns.

    Sorting by a column needs code order == string order, so a typed key
    column is demoted to its dictionary here and comes out as a
    ``StringColumn``, as in the reference, and a deferred (unsorted) lane
    dictionary is sorted on the device; every other column, typed, lane
    or not, rides along as its storage array."""
    for c in key_columns:
        table.columns[c]._ensure_sorted_lanes()
    keys = {c: table.columns[c].codes for c in key_columns}
    perm = sort_permutation(list(keys.values()))
    out = {}
    for name, col in table.columns.items():
        if name in keys:
            out[name] = col.with_codes(torch.index_select(keys[name], 0, perm))
        else:
            out[name] = col.gather(perm)
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


def run_starts(table: DeviceTable, key_columns: Sequence[str]) -> np.ndarray:
    """Host bool array marking the first row of each equal-key run."""
    if table.nrows == 0:
        return np.zeros(0, dtype=bool)
    if table.nrows == 1:
        return np.ones(1, dtype=bool)
    neq = ~_adjacent_equal(table, key_columns)
    head = torch.ones(1, dtype=torch.bool, device=neq.device)
    return torch.cat([head, neq]).cpu().numpy()
