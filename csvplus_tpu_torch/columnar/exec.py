"""The device plan executor.

Port of ``csvplus_tpu/columnar/exec.py``.  It walks a plan chain
(:mod:`csvplus_tpu_torch.plan`) rooted at a ``Scan`` of a
:class:`~csvplus_tpu_torch.columnar.table.DeviceTable`, or at a
``Lookup`` (one contiguous row range of an index's sorted table, the
leaf of ``Index.find``/``find_many`` results):

* ``Filter`` -> boolean mask (:mod:`..ops.filter`, through the fused mask
  kernel) and a compaction of the selection vector;
* ``Validate`` (last stage only) -> a deferred row-numbered error;
* ``Top``/``DropRows`` -> selection slicing; ``TakeWhile``/``DropWhile``
  -> one cut at the first false row (a device argmax);
* ``SelectCols``/``DropCols``/``MapExpr`` -> column-metadata updates;
* ``Join`` -> the packed-key probe and gathers of :mod:`..ops.join`;
  ``MultiwayJoin`` -> one pass over a run of joins; ``FusedProbe`` -> a
  Filter/Map/projection run evaluated on the selection, then a probe of
  the selected rows with no materialized stream; ``Except`` -> the
  anti-join mask over the key columns only.

Execution keeps a selection vector (int64 row ids on the device) over
full-length columns and gathers as late as possible.

A row-sharded table (``on_device(shards=N)`` / ``mesh=``) runs every
stage per shard: the selection is a
:class:`~csvplus_tpu_torch.parallel.mesh.ShardedRows` of shard-local row
ids (uneven after a filter), global row order is shard order, and the
padded tail of a table cut into equal blocks is never selected.  Where
the reference's semantics cross shards, they are taken across shards
here: ``Top``/``DropRows``/``TakeWhile`` cut the selection at a global
position, and ``Validate`` and the missing-cell errors name the first
failing global row.

Before lowering, the static verifier (:mod:`..analysis.verify`) runs, as
the reference's executor runs it by default (``CSVPLUS_VERIFY=1``): a
plan it finds unlowerable raises :class:`UnsupportedPlan` before any
device work, and the caller falls back to the host streaming path with
the reference's outcome.  ``CSVPLUS_VERIFY=0`` skips it.  The plain
fluent API lowers the plan as built — it never rewrites, so its joins
stay the cascade; the rewriter's ``MultiwayJoin``/``FusedProbe`` forms
run only through the plan cache (:mod:`..serve.plancache`), which
verifies each shape once and then executes with ``preverified=True``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import plan as P
from ..errors import CsvPlusError, DataSourceError
from ..parallel.mesh import ShardedRows, smap
from ..resilience import faults
from ..row import MissingColumnError, Row
from .table import DeviceTable, StringColumn, host_or_storage, merge_with_fallback


class UnsupportedPlan(Exception):
    """Plan contains a stage the device executor cannot lower."""


class _View:
    """Full-length columns + an ordered selection vector of row ids.

    ``full_len`` is the column length, kept explicitly so a view with no
    columns still knows its row count.  ``scan_base`` is the source row
    number of row 0, so ``scan_base + sel[i]`` numbers the i-th streamed
    row as the host path does; a Join resets it to 0.  ``identity`` is
    true while ``sel`` is ``arange(full_len)``: materializing then passes
    the columns through ungathered."""

    __slots__ = ("cols", "_sel", "device", "full_len", "scan_base",
                 "deferred_error", "identity", "lens")

    def __init__(
        self,
        cols: Dict[str, StringColumn],
        sel: torch.Tensor,
        device: torch.device,
        full_len: int,
        scan_base: int = 0,
        identity: bool = False,
    ):
        self.cols = cols
        self.sel = sel
        self.device = device
        self.full_len = full_len
        self.scan_base = scan_base
        self.identity = identity
        self.deferred_error = None
        # a sharded view: the scanned table's stored rows per shard (the
        # layout its shard-local row ids index), else None
        self.lens = None

    @property
    def sel(self) -> torch.Tensor:
        return self._sel

    @sel.setter
    def sel(self, value: torch.Tensor) -> None:
        self._sel = value
        self.identity = False  # any rewrite of the selection ends identity

    def materialize(self) -> DeviceTable:
        n = int(self.sel.shape[0])
        if self.identity:
            # every row in order: the columns pass through (a padded
            # sharded table drops its tail per shard, as views)
            cols = dict(self.cols)
            if n != self.full_len:
                cols = {name: c.with_storage(host_or_storage(c.storage, n))
                        for name, c in cols.items()}
            table = DeviceTable(cols, n, self.device)
        else:
            gathered = {name: c.gather(self.sel) for name, c in self.cols.items()}
            table = DeviceTable(gathered, n, self.device)
        table.deferred_error = self.deferred_error
        return table


def _range_sel(table: DeviceTable, lower: int, upper: int):
    """The selection of rows [lower, upper) of *table*; a sharded table's
    holds each shard's rows of that range, below its padding."""
    lens = table.shard_lens()
    if lens is None:
        return torch.arange(lower, upper, dtype=torch.int64, device=table.device)
    parts, off = [], 0
    for n, d in zip(lens, table.mesh.devices):
        parts.append(torch.arange(min(max(lower - off, 0), n), min(max(upper - off, 0), n),
                                  dtype=torch.int64, device=d))
        off += n
    return ShardedRows(table.mesh, parts)


def _sharded_view(view: _View, table: DeviceTable) -> _View:
    """*view* with the stored rows per shard of a sharded *table*."""
    if table.mesh is not None:
        view.lens = next(c.storage for c in table.columns.values()).lens
    return view


def _scan_view(table: DeviceTable, scan_base: int = 0) -> _View:
    """Every row of *table*, in order."""
    return _sharded_view(_View(dict(table.columns), _range_sel(table, 0, table.nrows),
                               table.device, table.stored_len, scan_base=scan_base,
                               identity=True), table)


# -- the selection of a sharded view ----------------------------------------


def _apply_mask(sel, mask):
    """The selected rows where *mask* (aligned to *sel*) holds."""
    if isinstance(sel, ShardedRows):
        return smap(sel.mesh, lambda s, m: s[m], sel, mask)
    return sel[mask]


def _slice_sel(sel, start: int, stop: "int | None" = None):
    """``sel[start:stop]`` over the global order (shard order)."""
    if not isinstance(sel, ShardedRows):
        return sel[start:stop]
    n = sel.nrows
    stop = n if stop is None else min(stop, n)
    out, off = [], 0
    for s in sel.shards:
        m = int(s.shape[0])
        out.append(s[max(0, min(m, start - off)):max(0, min(m, stop - off))])
        off += m
    return ShardedRows(sel.mesh, out)


def _first_true(mask) -> int:
    """Position of the first True of *mask* in global order, or -1: one
    scalar transfer (one small vector for a sharded mask)."""
    if not isinstance(mask, ShardedRows):
        if not mask.shape[0]:
            return -1
        return int(torch.where(mask.any(), torch.argmax(mask.to(torch.uint8)), -1).item())
    dev0 = mask.mesh.devices[0]
    parts = [torch.where(m.any(), torch.argmax(m.to(torch.uint8)), -1).to(dev0)
             if m.shape[0] else torch.tensor(-1, device=dev0) for m in mask.shards]
    firsts = torch.stack(parts).tolist()
    off = 0
    for f, m in zip(firsts, mask.shards):
        if f >= 0:
            return off + int(f)
        off += int(m.shape[0])
    return -1


def _row_id(view: _View, pos: int) -> int:
    """The stored row id of the *pos*-th selected row (global: a shard's
    block offset plus its local id, for a sharded view)."""
    sel = view.sel
    if not isinstance(sel, ShardedRows):
        return int(sel[pos].item())
    off = 0
    for n_stored, s in zip(view.lens, sel.shards):
        m = int(s.shape[0])
        if pos < m:
            return off + int(s[pos].item())
        pos -= m
        off += n_stored
    raise IndexError(pos)


def execute_plan(root: P.PlanNode) -> DeviceTable:
    """Run the plan and return the materialized result table."""
    return execute_plan_view(root).materialize()


def execute_plan_view(root: P.PlanNode, preverified: bool = False) -> _View:
    """Run the plan, returning the final view (columns + selection vector
    + source row numbering) without materializing.

    The static verifier runs first (see the module docstring):
    unlowerable plans raise :class:`UnsupportedPlan` before any device
    work.  ``preverified=True`` skips it: the caller vouches that a plan
    of this exact structural shape already verified clean — the plan
    cache, which verifies each shape once at admission, is the one
    caller that does."""
    if not preverified:
        from ..analysis.verify import verify_before_lower

        verify_before_lower(root)
    stages = P.linearize(root)
    # Validate lowers only as the final stage: upstream of anything else
    # the host's push semantics cannot be reproduced by an eager check
    for node in stages[:-1]:
        if isinstance(node, P.Validate):
            raise UnsupportedPlan("Validate is device-lowered only as last stage")
    leaf = stages[0]
    table: DeviceTable = leaf.table
    if isinstance(leaf, P.Lookup):
        # a Scan restricted to a statically-known contiguous row range:
        # the selection starts as arange(lower, upper) over the index's
        # sorted table; every downstream stage lowers unchanged
        view = _sharded_view(_View(
            dict(table.columns),
            _range_sel(table, leaf.lower, leaf.upper),
            table.device,
            table.stored_len,
            # host parity: streaming a find result numbers rows 0-based
            # within the matched slice, so shift the base by -lower
            scan_base=table.row_base - leaf.lower,
            identity=leaf.lower == 0 and leaf.upper == table.nrows,
        ), table)
    else:
        view = _scan_view(table, scan_base=table.row_base)
    from ..obs.span import tracer
    from ..utils.observe import telemetry

    # grouping span: in a trace the per-node stages nest under one
    # plan:execute region
    with tracer.span("plan:execute", nodes=len(stages) - 1):
        # fault site: a transient raise here fails the whole execution
        # before any stage runs; the serving tier's retry re-executes the
        # cached executable
        faults.inject("exec:device")
        for node in stages[1:]:
            # row counts come from shapes: recording them syncs nothing
            with telemetry.stage(type(node).__name__, int(view.sel.shape[0])) as _t:
                view = _exec_stage(view, node)
                _t["rows_out"] = int(view.sel.shape[0])
    return view


def _join_specs(view: _View, joins) -> list:
    """(DeviceIndex, key columns) per build side, each key set checked
    over the current selection (host-parity errors, row numbers in the
    originating source's numbering)."""
    specs = []
    for index, columns in joins:
        dev_index = index.device_table
        if dev_index is None or not dev_index.supported:
            raise UnsupportedPlan("join build side has no packed device index")
        _check_key_cells(view, columns)
        specs.append((dev_index, tuple(columns)))
    return specs


def _drop(view: _View, columns) -> None:
    view.cols = {n: c for n, c in view.cols.items() if n not in set(columns)}


def _exec_stage(view: _View, node: P.PlanNode) -> _View:
    """Execute one plan node against the view (mutating or replacing it)."""
    from ..ops import join as J

    if isinstance(node, P.Filter):
        view.sel = _apply_mask(view.sel, _sel_mask(view, node.pred))
    elif isinstance(node, P.Validate):
        # one scalar transfer on the happy path: the first failing
        # position, or -1 (an empty selection has nothing to check)
        first = _first_true(_negate(_sel_mask(view, node.pred)))
        if first >= 0:
            rowno = view.scan_base + _row_id(view, first)
            # deferred: it fires only if streaming reaches row `first`
            view.deferred_error = (
                first, DataSourceError(rowno, CsvPlusError(node.message))
            )
    elif isinstance(node, (P.TakeWhile, P.DropWhile)):
        # the first false row, or the whole selection: one scalar transfer
        n = int(view.sel.shape[0])
        cut = _first_true(_negate(_sel_mask(view, node.pred))) if n else 0
        cut = n if cut < 0 else cut
        if isinstance(node, P.TakeWhile):
            view.sel = _slice_sel(view.sel, 0, cut)  # stop at the first false row
        else:
            view.sel = _slice_sel(view.sel, cut)  # pass from the first false row on
    elif isinstance(node, P.Top):
        view.sel = _slice_sel(view.sel, 0, node.n)
    elif isinstance(node, P.DropRows):
        view.sel = _slice_sel(view.sel, node.n)
    elif isinstance(node, P.SelectCols):
        _apply_select(view, node.columns)
    elif isinstance(node, P.DropCols):
        _drop(view, node.columns)
    elif isinstance(node, P.MapExpr):
        _apply_map(view, node.expr)
    elif isinstance(node, P.Join):
        ((dev_index, columns),) = _join_specs(view, [(node.index, node.columns)])
        view = _scan_view(J.join_tables(view.materialize(), dev_index, list(columns)))
    elif isinstance(node, P.MultiwayJoin):
        # every build side's keys validate against the ORIGINAL stream
        # (the rewriter's license proves later keys PRESENT), then one
        # materialize feeds one expansion — no intermediate table
        specs = _join_specs(view, node.joins)
        view = _scan_view(J.multiway_join(view.materialize(), specs))
    elif isinstance(node, P.FusedProbe):
        # the absorbed run executes through the same view code paths the
        # staged stages use (masks, metadata updates, error sites); the
        # probe then consumes the selection directly
        rows_full = int(view.sel.shape[0])
        for kind, payload in node.ops:
            if kind == "filter":
                view.sel = _apply_mask(view.sel, _sel_mask(view, payload))
            elif kind == "map":
                _apply_map(view, payload)
            elif kind == "select":
                _apply_select(view, payload)
            elif kind == "drop":
                _drop(view, payload)
            else:
                raise UnsupportedPlan(f"no device lowering for fused op {kind!r}")
        specs = _join_specs(view, node.joins)
        rows_selected = int(view.sel.shape[0])
        if rows_selected == 0:
            # nothing selected: the staged join's empty folds define the
            # result schema, and materializing zero rows is free
            joined = J.multiway_join(view.materialize(), specs)
        else:
            joined = J.multiway_join_selected(
                view.cols, view.sel, view.device, specs, identity=view.identity
            )
        from ..obs.joinskew import joinskew

        joinskew.on_fused(
            "+".join(",".join(di.key_columns) for di, _ in specs),
            len(specs), rows_full, rows_selected, joined.nrows,
        )
        view = _scan_view(joined)
    elif isinstance(node, P.Except):
        dev_index = node.index.device_table
        if dev_index is None or not dev_index.supported:
            raise UnsupportedPlan("except build side has no packed device index")
        _check_key_cells(view, node.columns)
        # the anti-join needs only the KEY columns: gather just those
        key_view = _View(
            {c: view.cols[c] for c in node.columns if c in view.cols},
            view.sel, view.device, view.full_len, identity=view.identity,
        )
        keep = J.except_mask(key_view.materialize(), dev_index, list(node.columns))
        # rows pass through 1:1, so the row space and its numbering stay
        view.sel = _apply_mask(view.sel, keep)
    else:
        raise UnsupportedPlan(f"no device lowering for {type(node).__name__}")
    return view


class _SelView:
    """Column mapping that hands out columns gathered down to the current
    selection, only for the columns a predicate references."""

    def __init__(self, cols, sel):
        self._cols = cols
        self._sel = sel
        self._cache: dict = {}

    def __contains__(self, name) -> bool:
        return name in self._cols

    def __getitem__(self, name):
        got = self._cache.get(name)
        if got is None:
            got = self._cache[name] = self._cols[name].gather(self._sel)
        return got


def _sel_mask(view: _View, pred) -> torch.Tensor:
    """Boolean mask aligned to ``view.sel`` — the one definition of
    predicate lowering against the current selection.  A selection much
    narrower than the columns builds the mask over gathered sub-columns
    instead of all rows."""
    from ..ops.filter import UnsupportedPredicate, build_mask

    if isinstance(view.sel, ShardedRows):
        return _sel_mask_sharded(view, pred)
    nrows = view.full_len
    sel_n = int(view.sel.shape[0])
    if sel_n == 0:
        return torch.zeros(0, dtype=torch.bool, device=view.device)
    try:
        if 4 * sel_n < nrows:
            return build_mask(_SelView(view.cols, view.sel), sel_n, pred, view.device)
        mask = build_mask(view.cols, nrows, pred, view.device)
    except UnsupportedPredicate as e:
        raise UnsupportedPlan(str(e)) from e
    return mask if view.identity else mask[view.sel]


def _sel_mask_sharded(view: _View, pred) -> ShardedRows:
    """:func:`_sel_mask` per shard, each on its shard's device: the mask
    kernel runs once per shard that has selected rows, over that shard's
    block (or over its gathered sub-columns when its selection is
    narrow)."""
    from ..ops.filter import UnsupportedPredicate, build_mask

    sel = view.sel
    mesh = sel.mesh
    out = []
    try:
        for i, (s, n_stored) in enumerate(zip(sel.shards, view.lens)):
            n = int(s.shape[0])
            dev = mesh.devices[i]
            with mesh.on(i):
                if n == 0:
                    out.append(torch.zeros(0, dtype=torch.bool, device=dev))
                    continue
                cols = _ShardCols(view.cols, i)
                if 4 * n < n_stored:
                    out.append(build_mask(_SelView(cols, s), n, pred, dev))
                    continue
                mask = build_mask(cols, n_stored, pred, dev)
                # the identity selection of a block is its leading rows
                out.append(mask[:n] if view.identity else mask[s])
    except UnsupportedPredicate as e:
        raise UnsupportedPlan(str(e)) from e
    return ShardedRows(mesh, out)


class _ShardCols:
    """Column mapping over shard *i* of a sharded view's columns, made
    only for the columns a predicate references."""

    def __init__(self, cols, i: int):
        self._cols = cols
        self._i = i

    def __contains__(self, name) -> bool:
        return name in self._cols

    def __getitem__(self, name):
        return self._cols[name].shard(self._i)


def _negate(mask):
    if isinstance(mask, ShardedRows):
        return mask.map(lambda m: ~m)
    return ~mask


def _check_key_cells(view: _View, columns) -> None:
    """Host-parity key validation for Join: the error names the first
    streamed row lacking a key cell; an empty stream never errors."""
    if view.sel.shape[0] == 0:
        return
    bad = first_missing_cell(view, columns)
    if bad is not None:
        raise DataSourceError(bad[0], MissingColumnError(bad[1]))


def first_missing_cell(view: _View, columns):
    """``(source row number, column)`` of the first missing cell in
    streamed row-major order — the first streamed row lacking any of
    *columns*, and within it the first such column — or None."""
    best = None  # (streamed position, column)
    for c in columns:
        col = view.cols.get(c)
        if col is None:
            pos = 0  # missing from the schema: every streamed row lacks it
        elif col.has_absent:
            if isinstance(view.sel, ShardedRows):
                bad = smap(view.sel.mesh, lambda a, i: torch.index_select(a, 0, i) < 0,
                           col.storage, view.sel)
                pos = _first_true(bad)
                if pos < 0:
                    continue
            else:
                bad = torch.index_select(col.codes, 0, view.sel) < 0
                if not bool(bad.any()):
                    continue
                pos = int(torch.argmax(bad.to(torch.uint8)))
        else:
            continue
        if best is None or pos < best[0]:
            best = (pos, c)
            if pos == 0:
                break  # nothing can precede streamed row 0
    if best is None:
        return None
    pos, c = best
    return view.scan_base + _row_id(view, pos), c


def _apply_select(view: _View, columns) -> None:
    """SelectCols with host-parity errors: the first streamed row lacking
    a cell raises, so an empty selection never errors."""
    if view.sel.shape[0] == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=view.device)
        if view.lens is not None:
            # a column missing from the schema: absent on every stored row
            empty = ShardedRows(view.sel.mesh, [
                torch.full((n,), -1, dtype=torch.int32, device=d)
                for n, d in zip(view.lens, view.sel.mesh.devices)])
        view.cols = {
            c: view.cols.get(c, StringColumn(np.empty(0, dtype="S1"), empty))
            for c in columns
        }
        return
    bad = first_missing_cell(view, columns)
    if bad is not None:
        raise DataSourceError(bad[0], MissingColumnError(bad[1]))
    view.cols = {c: view.cols[c] for c in columns}


def _apply_map(view: _View, expr) -> None:
    from ..exprs import Rename, SetValue, Update

    if isinstance(expr, Update):
        for e in expr.exprs:
            _apply_map(view, e)
        return
    if isinstance(expr, SetValue):
        if view.lens is not None:  # laid out as the view's sharded columns
            mesh = view.sel.mesh
            like = ShardedRows(mesh, [torch.empty(n, dtype=torch.int32, device=d)
                                      for n, d in zip(view.lens, mesh.devices)])
            view.cols[expr.column] = StringColumn.constant_like(expr.value, like)
        else:
            view.cols[expr.column] = StringColumn.constant(
                expr.value, view.full_len, view.device
            )
        return
    if isinstance(expr, Rename):
        # sequential pop/overwrite, as the host expr does it: a rename onto
        # an existing name overwrites it, chained renames cascade, and a
        # row without the old cell keeps its existing new-column value
        for old, new in expr.mapping.items():
            if old in view.cols:
                moved = view.cols.pop(old)
                existing = view.cols.pop(new, None)
                if existing is not None and moved.has_absent:
                    moved = merge_with_fallback(moved, existing)
                view.cols[new] = moved
        return
    raise UnsupportedPlan(f"cannot lower map expression {expr!r} to device")


def try_execute_plan(root: Optional[P.PlanNode]) -> Optional[List[Row]]:
    """Execute the plan to host Rows, or None when it cannot lower.  A
    failing terminal Validate raises: a full materialization always
    reaches the first invalid row."""
    if root is None:
        return None
    try:
        table = execute_plan(root)
    except UnsupportedPlan:
        return None
    if table.deferred_error is not None:
        raise table.deferred_error[1]
    return table.to_rows()


def device_table_for(src) -> Optional[DeviceTable]:
    """Run *src*'s device plan to a table, or None when it has no plan or
    the plan cannot lower.  A plan that cannot lower is remembered on the
    source, so sinks and the run function never execute the same device
    prefix twice."""
    plan = getattr(src, "plan", None)
    if plan is None or getattr(src, "_plan_unsupported", False):
        return None
    try:
        table = execute_plan(plan)
    except UnsupportedPlan:
        src._plan_unsupported = True
        return None
    if table.deferred_error is not None:
        # a failing terminal Validate: the sink replays the streaming path
        # for the exact write-then-remove behaviour.  It depends on the
        # data, so it is not remembered.
        return None
    return table


def plan_runner(root: P.PlanNode, fallback=None, owner=None):
    """A DataSource run function that executes *root* on device and streams the
    decoded rows; it falls back to *fallback* when the plan cannot lower
    (remembered on *owner*)."""

    def run(fn) -> None:
        if owner is not None and getattr(owner, "_plan_unsupported", False):
            fallback(fn)
            return
        try:
            table = execute_plan(root)
        except UnsupportedPlan:
            if owner is not None:
                owner._plan_unsupported = True
            if fallback is None:
                raise
            fallback(fn)
            return
        from ..source import iterate

        if table.deferred_error is not None:
            # stream up to the first invalid row; the error fires only if
            # the consumer is still listening when it is reached
            k, err = table.deferred_error
            delivered = 0

            def counting(row):
                nonlocal delivered
                fn(row)
                delivered += 1

            iterate(table.to_rows(np.arange(k)), counting, clone=False)
            if delivered == k:
                raise err
            return
        iterate(table.to_rows(), fn, clone=False)

    return run
