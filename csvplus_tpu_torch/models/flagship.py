"""The flagship workload: the 3-way lookup join as one fused device step.

Port of ``csvplus_tpu/models/flagship.py``.  The reference's call stack
being replaced: per orders row, two host binary searches and two map
merges (csvplus.go:552-583).  Here the probe is a few tensor ops over
dictionary codes:

* both build sides (customers, products) are unique indexes, so each
  stream row matches at most one build row and the output has the
  stream's length: two vectorized searches, the attribute gathers and the
  validity mask, with no host round trip but the match count;
* the probe keys are the orders' key columns translated into each
  index's code space (``renumbered_to_col``), for dictionary columns and
  typed value lanes alike.

:func:`threeway_step` is the "forward step" that
``csvplus_tpu_torch.graft.entry()`` exposes; ``graft.dryrun_multichip``
runs it data-parallel, one call per shard of a mesh over replicated keys.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..columnar.table import DeviceTable, StringColumn, gather_storage, split_like
from ..ops.join import DeviceIndex, direct_probe_parts
from ..parallel.mesh import ShardedRows, assemble, smap

_INT32_MIN = -(2**31)

#: ``ThreewayJoin.run`` calls by branch ("fused", "step" or "padded", and
#: "compaction" when the matches were compacted) — counted where the
#: branch is taken, nowhere else.  ``chip_smoke.py`` and the tests read it.
run_paths: Counter = Counter()


def _take(values: torch.Tensor, idx: torch.Tensor, in_range: bool = False) -> torch.Tensor:
    """``jnp.take(values, idx, axis=0)`` in its default fill mode: an index
    in [-n, 0) counts from the end, any other out-of-range index gives
    INT32_MIN (torch would raise).  *in_range*: the caller's indices lie
    in [0, n) by construction (row ids of matched probes, clamped
    bounds), so a nonempty *values* is one gather."""
    n = int(values.shape[0])
    if in_range and n:
        return torch.index_select(values, 0, idx)
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    inside = (idx >= 0) & (idx < n)
    if n == 0:
        return torch.full(idx.shape, _INT32_MIN, dtype=values.dtype, device=values.device)
    got = torch.index_select(values, 0, torch.where(inside, idx, 0))
    return torch.where(inside, got, _INT32_MIN)


def _unique_probe(keys: torch.Tensor, qk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first row at or above each probe, clamped to the last row; hit)."""
    lo = torch.searchsorted(keys, qk, out_int32=True).clamp(max=int(keys.shape[0]) - 1)
    return lo, (_take(keys, lo, in_range=True) == qk) & (qk >= 0)


def threeway_step(
    cust_keys: torch.Tensor,  # sorted unique customer key codes
    prod_keys: torch.Tensor,  # sorted unique product key codes
    qk_cust: torch.Tensor,  # orders' cust key, translated codes (-1 = miss)
    qk_prod: torch.Tensor,  # orders' prod key, translated codes
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused probe step: (cust row id, prod row id, valid mask)."""
    lo_c, hit_c = _unique_probe(cust_keys, qk_cust)
    lo_p, hit_p = _unique_probe(prod_keys, qk_prod)
    return lo_c, lo_p, hit_c & hit_p


def gather_columns(ids: torch.Tensor, valid: torch.Tensor, *code_arrays: torch.Tensor):
    """Gather attribute code columns by build row id, masking misses."""
    safe = torch.where(valid, ids, 0)
    return tuple(torch.where(valid, _take(codes, safe), -1) for codes in code_arrays)


def _fused_unique_join(cum_c, cum_p, qk_c, qk_p, cust_codes, prod_codes):
    """The whole all-matched flagship join: two dictionary-direct probes
    (``ops/join.direct_probe_parts``, the single definition of the direct
    tier's semantics), the validity reduction, and every build-side
    attribute gather.  Returns the match count as a device scalar, so the
    caller syncs exactly one value."""
    lo_c, cnt_c = direct_probe_parts(cum_c, qk_c, 1)
    lo_p, cnt_p = direct_probe_parts(cum_p, qk_p, 1)
    valid = (cnt_c > 0) & (cnt_p > 0)
    n_valid = valid.sum()
    safe_c = torch.where(valid, lo_c, 0)
    safe_p = torch.where(valid, lo_p, 0)
    # a valid row matched (count > 0), so its lower bound is a row of the
    # build side; every other row reads row 0
    g_c = tuple(torch.where(valid, _take(codes, safe_c, in_range=True), -1)
                for codes in cust_codes)
    g_p = tuple(torch.where(valid, _take(codes, safe_p, in_range=True), -1)
                for codes in prod_codes)
    return n_valid, lo_c, lo_p, valid, g_c, g_p


def _fused_direct_probe(cum_c, cum_p, qk_c, qk_p):
    """Probe-only variant of :func:`_fused_unique_join` (the reference's
    padded, mesh-sharded streams take it and compact afterwards)."""
    lo_c, cnt_c = direct_probe_parts(cum_c, qk_c, 1)
    lo_p, cnt_p = direct_probe_parts(cum_p, qk_p, 1)
    return lo_c, lo_p, (cnt_c > 0) & (cnt_p > 0)


@dataclass
class ThreewayJoin:
    """Prepared flagship pipeline: translate the probe keys once, run many
    times.

    A row-sharded orders table (``with_sharding`` / ``on_device(shards=)``)
    runs every step per shard, against the build keys and columns copied
    once per distinct device of its mesh (the reference's ``_lanes_for``
    / ``_aligned_codes``).  A padded one (codes stored beyond ``nrows``)
    takes the reference's padded branch: the direct probes alone
    (:func:`_fused_direct_probe`), then always the compaction, whose build
    row ids are assembled on each build side's device (the reference's
    ``device_put``) and the gathered rows cut back into the compacted
    stream's shards.  ``.item()`` waits for the whole stream, so the
    reference's one-time settling of the pass-through orders columns has
    no counterpart."""

    cust: DeviceIndex
    prod: DeviceIndex
    qk_cust: torch.Tensor
    qk_prod: torch.Tensor
    orders_cols: Dict[str, StringColumn]
    n_orders: int

    @classmethod
    def build(
        cls,
        orders: DeviceTable,
        cust_index: DeviceIndex,
        prod_index: DeviceIndex,
        cust_col: str = "cust_id",
        prod_col: str = "prod_id",
    ) -> "ThreewayJoin":
        if len(cust_index.key_columns) != 1 or len(prod_index.key_columns) != 1:
            raise ValueError("ThreewayJoin: both indexes must have one key column")
        qk_c = orders.columns[cust_col].renumbered_to_col(
            cust_index.table.columns[cust_index.key_columns[0]])
        qk_p = orders.columns[prod_col].renumbered_to_col(
            prod_index.table.columns[prod_index.key_columns[0]])
        return cls(cust=cust_index, prod=prod_index, qk_cust=qk_c, qk_prod=qk_p,
                   orders_cols=dict(orders.columns), n_orders=orders.nrows)

    def step(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The fused probe step over the indexes' sorted packed keys (per
        shard for a sharded stream)."""
        if isinstance(self.qk_cust, ShardedRows):
            mesh = self.qk_cust.mesh
            return smap(mesh, threeway_step,
                        self.cust._replicated(mesh, "packed_i32", self.cust.packed_i32),
                        self.prod._replicated(mesh, "packed_i32", self.prod.packed_i32),
                        self.qk_cust, self.qk_prod)
        return threeway_step(self.cust.packed_i32, self.prod.packed_i32, self.qk_cust,
                             self.qk_prod)

    def run(self) -> DeviceTable:
        """Full join: probe, compact to matches, merge columns.

        Column merge semantics match the reference (csvplus.go:571-583):
        both indexes' columns and the stream's survive, the stream wins on
        a name collision, and stream row order is kept."""
        names_c = list(self.cust.table.columns)
        names_p = list(self.prod.table.columns)
        names_o = list(self.orders_cols)
        direct = self.cust.direct_cum is not None and self.prod.direct_cum is not None
        if isinstance(self.qk_cust, ShardedRows):
            return self._run_sharded(names_c, names_p, names_o, direct)
        run_paths["fused" if direct else "step"] += 1
        if direct:
            # one pass for probes + gathers + match count; the speculative
            # gathers are wasted only on the partial-match path below
            n_dev, lo_c, lo_p, valid, g_c, g_p = _fused_unique_join(
                self.cust.direct_cum, self.prod.direct_cum, self.qk_cust, self.qk_prod,
                tuple(self.cust.table.columns[n].storage for n in names_c),
                tuple(self.prod.table.columns[n].storage for n in names_p),
            )
            n_valid = int(n_dev.item())  # the one scalar sync
        else:
            lo_c, lo_p, valid = self.step()
            n_valid = int(valid.sum().item())  # scalar sync
        if n_valid == self.n_orders:
            # every stream row matched (the referential-integrity common
            # case): no compaction; stream columns pass through untouched
            if not direct:
                ones = torch.ones(self.n_orders, dtype=torch.bool, device=valid.device)
                g_c = gather_columns(
                    lo_c, ones, *(self.cust.table.columns[n].storage for n in names_c))
                g_p = gather_columns(
                    lo_p, ones, *(self.prod.table.columns[n].storage for n in names_p))
            g_o = tuple(self.orders_cols[n].storage for n in names_o)
            n_out = self.n_orders
        else:
            # compaction: the matching rows (the selection's size syncs),
            # then device gathers
            run_paths["compaction"] += 1
            sel = torch.nonzero(valid).flatten()
            ids_c = torch.index_select(lo_c, 0, sel)
            ids_p = torch.index_select(lo_p, 0, sel)
            g_c = tuple(torch.index_select(self.cust.table.columns[n].storage, 0, ids_c)
                        for n in names_c)
            g_p = tuple(torch.index_select(self.prod.table.columns[n].storage, 0, ids_p)
                        for n in names_p)
            g_o = tuple(torch.index_select(self.orders_cols[n].storage, 0, sel)
                        for n in names_o)
            n_out = int(sel.shape[0])

        out: Dict[str, StringColumn] = {}
        for name, codes in zip(names_c, g_c):
            out[name] = self.cust.table.columns[name].with_storage(codes)
        for name, codes in zip(names_p, g_p):
            out[name] = self.prod.table.columns[name].with_storage(codes)
        for name, codes in zip(names_o, g_o):  # stream wins
            out[name] = self.orders_cols[name].with_storage(codes)
        device = next(iter(out.values())).storage.device if out else self.qk_cust.device
        return DeviceTable(out, n_out, device)

    def _run_sharded(self, names_c, names_p, names_o, direct: bool) -> DeviceTable:
        """:meth:`run` over a sharded stream (see the class docstring)."""
        qc, qp = self.qk_cust, self.qk_prod
        mesh = qc.mesh
        dev0 = mesh.devices[0]
        cust_st = [self.cust.table.columns[n].storage for n in names_c]
        prod_st = [self.prod.table.columns[n].storage for n in names_p]
        unpadded = qc.nrows == self.n_orders
        if direct:
            cum_c = self.cust._replicated(mesh, "direct_cum", self.cust.direct_cum)
            cum_p = self.prod._replicated(mesh, "direct_cum", self.prod.direct_cum)
        if direct and unpadded:
            run_paths["fused"] += 1
            rep_c = [self.cust._replicated(mesh, ("col", n), st) for n, st in zip(names_c, cust_st)]
            rep_p = [self.prod._replicated(mesh, ("col", n), st) for n, st in zip(names_p, prod_st)]
            outs = []
            for i in range(mesh.size):
                with mesh.on(i):
                    outs.append(_fused_unique_join(
                        cum_c[i], cum_p[i], qc.shards[i], qp.shards[i],
                        tuple(r[i] for r in rep_c), tuple(r[i] for r in rep_p)))
            # the one scalar sync: the shards' match counts add on dev0
            n_valid = int(torch.stack([o[0].to(dev0) for o in outs]).sum().item())
            lo_c, lo_p, valid = (ShardedRows(mesh, [o[j] for o in outs]) for j in (1, 2, 3))
            g_c = tuple(ShardedRows(mesh, [o[4][j] for o in outs]) for j in range(len(names_c)))
            g_p = tuple(ShardedRows(mesh, [o[5][j] for o in outs]) for j in range(len(names_p)))
        elif direct:
            # the padded branch: probes only, then always the compaction
            run_paths["padded"] += 1
            lo_c, lo_p, valid = smap(mesh, _fused_direct_probe, cum_c, cum_p, qc, qp)
        else:
            run_paths["step"] += 1
            lo_c, lo_p, valid = self.step()
        if not unpadded:
            n_valid = -1
        elif not direct:
            n_valid = int(torch.stack([v.sum().to(dev0) for v in valid.shards]).sum().item())
        if n_valid == self.n_orders:
            if not direct:
                ones = valid.map(torch.ones_like)
                g_c = tuple(smap(mesh, gather_columns, lo_c, ones,
                                 self.cust._replicated(mesh, ("col", n), st))[0]
                            for n, st in zip(names_c, cust_st))
                g_p = tuple(smap(mesh, gather_columns, lo_p, ones,
                                 self.prod._replicated(mesh, ("col", n), st))[0]
                            for n, st in zip(names_p, prod_st))
            g_o = tuple(self.orders_cols[n].storage for n in names_o)
            n_out = self.n_orders
        else:
            # the compaction: each shard's matching rows (local ids), the
            # build row ids assembled on each build side's device, the
            # gathered build rows cut back into the compacted shards
            run_paths["compaction"] += 1
            sel = valid.map(lambda v: torch.nonzero(v).flatten())
            ids_c = assemble(smap(mesh, lambda lo, s: torch.index_select(lo, 0, s), lo_c, sel),
                             self.cust.table.device).to(torch.int64)
            ids_p = assemble(smap(mesh, lambda lo, s: torch.index_select(lo, 0, s), lo_p, sel),
                             self.prod.table.device).to(torch.int64)
            g_c = tuple(split_like(torch.index_select(st, 0, ids_c), sel) for st in cust_st)
            g_p = tuple(split_like(torch.index_select(st, 0, ids_p), sel) for st in prod_st)
            g_o = tuple(gather_storage(self.orders_cols[n].storage, sel) for n in names_o)
            n_out = sel.nrows
        out: Dict[str, StringColumn] = {}
        for name, codes in zip(names_c, g_c):
            out[name] = self.cust.table.columns[name].with_storage(codes)
        for name, codes in zip(names_p, g_p):
            out[name] = self.prod.table.columns[name].with_storage(codes)
        for name, codes in zip(names_o, g_o):  # stream wins
            out[name] = self.orders_cols[name].with_storage(codes)
        return DeviceTable(out, n_out, dev0)


def example_step_args(n_orders: int = 4096, n_cust: int = 512, n_prod: int = 64,
                      device: str = "cuda"):
    """Deterministic small example inputs for compile checks, on
    *device*."""
    from ..columnar.table import resolve_device

    dev = resolve_device(device)
    cust_keys = torch.arange(n_cust, dtype=torch.int32, device=dev)
    prod_keys = torch.arange(n_prod, dtype=torch.int32, device=dev)
    qk_c = torch.arange(n_orders, dtype=torch.int32, device=dev) % (n_cust + 7) - 3
    qk_p = torch.arange(n_orders, dtype=torch.int32, device=dev) % (n_prod + 3) - 1
    return cust_keys, prod_keys, qk_c, qk_p
