"""DataSource: the lazy, composable iteration protocol.

Port of ``csvplus_tpu/source.py`` (the reference's data source,
csvplus.go:207-256): a data source *is a function* — invoking it pushes
rows one at a time into a callback — and combinators return new lazy
sources.  Nothing runs until a sink (or a direct call) drives the chain.

Semantics kept from the reference:

* rows from materialized sources are **cloned** before delivery
  (csvplus.go:225-249);
* a callback may raise :class:`StopPipeline` to stop early without error;
* errors carry row numbers where the reference wraps them (``iterate``
  uses the 0-based position, the CSV reader 1-based records);
* ``Transform`` drops empty result rows (csvplus.go:265);
* ``Top`` stops via the EOF mechanism (csvplus.go:319).

Each DataSource may carry a symbolic ``plan`` (:mod:`.plan`).  When every
stage of a chain is symbolic and the origin is a device table, the chain
runs on the device executor; an opaque callback drops the chain to the
host streaming path.

Ported so far: ``transform``, ``filter``, ``map``, ``validate``,
``top``, ``drop``, ``take_while``, ``drop_while``, ``drop_columns``,
``select_columns``, ``index_on``, ``unique_index_on``, ``join``,
``except_``, ``on_device``, ``reshard``, ``explain`` and the sinks ``to_csv``,
``to_csv_file``, ``to_json``, ``to_json_file``, ``to_rows`` and
``to_device_table``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence

from .errors import CsvPlusError, DataSourceError, StopPipeline
from .row import Row, merge_rows

#: A row callback: called once per row; raise :class:`StopPipeline` to
#: stop cleanly, any other exception to fail.
RowFunc = Callable[[Row], None]


def iterate(rows: Sequence[Row], fn: RowFunc, clone: bool = True) -> None:
    """Drive *fn* over a row slice, cloning each row (csvplus.go:225-249).
    Errors raised by *fn* are wrapped with the row's 0-based position."""
    i = 0
    try:
        for i, row in enumerate(rows):
            fn(Row(row) if clone else row)
    except StopPipeline:
        return
    except DataSourceError:
        raise
    except Exception as e:
        raise DataSourceError(i, e) from e


class DataSource:
    """A lazy stream of Rows; call it with a row callback to execute."""

    __slots__ = ("_run", "plan", "_plan_unsupported", "plan_note", "_rows_hint")

    def __init__(self, run: Callable[[RowFunc], None], plan: Any = None):
        self._run = run
        self.plan = plan  # symbolic plan node, or None (host-only chain)
        self._plan_unsupported = False  # memo: device plan cannot lower
        self.plan_note = None  # why device execution stopped, if it did
        # the backing row list of a take_rows / find result: the sinks
        # clone straight off it (what iterate() would deliver)
        self._rows_hint = None

    def explain(self) -> str:
        """The execution plan: the device plan when the chain is symbolic,
        or where (and why) it fell to the host path."""
        from .plan import explain as _explain

        base = _explain(self.plan)
        if self.plan is None and self.plan_note:
            return f"{base}\n  device execution stopped at: {self.plan_note}"
        return base

    def __call__(self, fn: RowFunc) -> None:
        """Push every row into *fn* (which may raise StopPipeline)."""
        try:
            self._run(fn)
        except StopPipeline:
            return

    def __iter__(self) -> Iterator[Row]:
        """Pull iteration over the rows.  The push pipeline runs on a
        helper thread and rows cross a bounded queue
        (:func:`~csvplus_tpu_torch.utils.relay.relay_iter`), so memory
        stays constant on long streams; abandoning the iterator stops
        the producer at its next row."""
        from .utils.relay import RelayStopped, relay_iter

        def run(emit) -> None:
            def fn(row: Row) -> None:
                try:
                    emit(row)
                except RelayStopped:
                    raise StopPipeline from None

            self(fn)

        return relay_iter(run, maxsize=1024)

    # -- per-row lazy combinators (csvplus.go:258-310) ---------------------

    def transform(self, trans: Callable[[Row], Optional[Row]]) -> "DataSource":
        """Most generic per-row stage (csvplus.go:262-272): *trans*
        returns the replacement row; an empty dict or None drops it."""

        def run(fn: RowFunc) -> None:
            def step(row: Row) -> None:
                out = trans(row)
                if out:
                    fn(out if isinstance(out, Row) else Row(out))

            self._run(step)

        from .plan import transform_plan

        return _make(run, transform_plan(self.plan, trans), self, "transform", trans)

    def filter(self, pred: Callable[[Row], bool]) -> "DataSource":
        """Keep rows for which *pred* is true (csvplus.go:276-286)."""

        def run(fn: RowFunc) -> None:
            def step(row: Row) -> None:
                if pred(row):
                    fn(row)

            self._run(step)

        from .plan import filter_plan

        return _make(run, filter_plan(self.plan, pred), self, "filter", pred)

    def map(self, mf: Callable[[Row], Row]) -> "DataSource":
        """Apply *mf* to every row (csvplus.go:290-296)."""

        def run(fn: RowFunc) -> None:
            def step(row: Row) -> None:
                out = mf(row)
                fn(out if isinstance(out, Row) else Row(out))

            self._run(step)

        from .plan import map_plan

        return _make(run, map_plan(self.plan, mf), self, "map", mf)

    def validate(
        self, vf: Callable[[Row], "None | bool"], message: str = "validation failed"
    ) -> "DataSource":
        """Check every row (csvplus.go:300-310): *vf* raises to fail the
        pipeline at that row.  A symbolic predicate instead keeps the
        check on the device, failing with *message* at the first failing
        row's source number."""
        from .predicates import Predicate

        if isinstance(vf, Predicate):
            pred = vf

            def run(fn: RowFunc) -> None:
                def step(row: Row) -> None:
                    if not pred(row):
                        raise CsvPlusError(message)
                    fn(row)

                self._run(step)

            from .plan import validate_plan

            return _make(run, validate_plan(self.plan, pred, message), self, "validate", pred)

        def run(fn: RowFunc) -> None:
            def step(row: Row) -> None:
                vf(row)
                fn(row)

            self._run(step)

        return _make(run, None, self, "validate", vf)

    def top(self, n: int) -> "DataSource":
        """Pass down at most *n* rows, then stop cleanly (csvplus.go:313-326)."""

        def run(fn: RowFunc) -> None:
            counter = n

            def step(row: Row) -> None:
                nonlocal counter
                if counter == 0:
                    raise StopPipeline
                counter -= 1
                fn(row)

            self._run(step)

        from .plan import top_plan

        return _make(run, top_plan(self.plan, n), self)

    def drop(self, n: int) -> "DataSource":
        """Skip the first *n* rows (csvplus.go:329-342)."""

        def run(fn: RowFunc) -> None:
            counter = n

            def step(row: Row) -> None:
                nonlocal counter
                if counter == 0:
                    fn(row)
                else:
                    counter -= 1

            self._run(step)

        from .plan import drop_plan

        return _make(run, drop_plan(self.plan, n), self)

    def take_while(self, pred: Callable[[Row], bool]) -> "DataSource":
        """Pass rows until *pred* is first false, then stop (csvplus.go:346-358)."""

        def run(fn: RowFunc) -> None:
            def step(row: Row) -> None:
                if not pred(row):
                    raise StopPipeline
                fn(row)

            self._run(step)

        from .plan import take_while_plan

        return _make(run, take_while_plan(self.plan, pred), self, "take_while", pred)

    def drop_while(self, pred: Callable[[Row], bool]) -> "DataSource":
        """Skip rows while *pred* holds, then pass everything (csvplus.go:362-374)."""

        def run(fn: RowFunc) -> None:
            yielding = False

            def step(row: Row) -> None:
                nonlocal yielding
                if not yielding and pred(row):
                    return
                yielding = True
                fn(row)

            self._run(step)

        from .plan import drop_while_plan

        return _make(run, drop_while_plan(self.plan, pred), self, "drop_while", pred)

    # -- column projection (csvplus.go:492-525) ----------------------------

    def drop_columns(self, *columns: str) -> "DataSource":
        """Remove the listed columns from each row (csvplus.go:493-507)."""
        if not columns:
            raise ValueError("no columns specified in DropColumns()")

        def run(fn: RowFunc) -> None:
            def step(row: Row) -> None:
                for c in columns:
                    row.pop(c, None)
                fn(row)

            self._run(step)

        from .plan import drop_columns_plan

        return _make(run, drop_columns_plan(self.plan, columns), self)

    def select_columns(self, *columns: str) -> "DataSource":
        """Keep exactly the listed columns; error if any is missing
        (csvplus.go:511-525)."""
        if not columns:
            raise ValueError("no columns specified in SelectColumns()")

        def run(fn: RowFunc) -> None:
            def step(row: Row) -> None:
                fn(row.select(*columns))

            self._run(step)

        from .plan import select_columns_plan

        return _make(run, select_columns_plan(self.plan, columns), self)

    # -- index / join (index.py) -------------------------------------------

    def index_on(self, *columns: str):
        """Materialize a sorted :class:`~csvplus_tpu_torch.index.Index`
        on the listed key columns (csvplus.go:529-531)."""
        from .index import create_index

        return create_index(self, columns)

    def unique_index_on(self, *columns: str):
        """Like :meth:`index_on` but errors on duplicate keys
        (csvplus.go:535-537)."""
        from .index import create_unique_index

        return create_unique_index(self, columns)

    def join(self, index, *columns: str) -> "DataSource":
        """Lazy lookup join against *index* (csvplus.go:539-569): the
        listed stream columns match the index's key columns left to right
        (none given: the index's own key names).  On a name collision the
        stream row's value wins (csvplus.go:560, 571-583)."""
        cols = _resolve_join_columns(index, columns, "Join()")

        def run(fn: RowFunc) -> None:
            index.materialize()  # host probe loop: decode a lazy index once

            def step(row: Row) -> None:
                values = row.select_values(*cols)
                for index_row in index._impl.find_rows(values):
                    fn(merge_rows(index_row, row))

            self._run(step)

        from .plan import join_plan

        return _make(run, join_plan(self.plan, index, cols), self, "join")

    def except_(self, index, *columns: str) -> "DataSource":
        """Anti-join: pass through rows whose key is NOT in *index*
        (csvplus.go:585-608)."""
        cols = _resolve_join_columns(index, columns, "Except()")

        def run(fn: RowFunc) -> None:
            index.materialize()  # host probe loop: decode a lazy index once

            def step(row: Row) -> None:
                values = row.select_values(*cols)
                if not index._impl.has(values):
                    fn(row)

            self._run(step)

        from .plan import except_plan

        return _make(run, except_plan(self.plan, index, cols), self, "except")

    # -- device migration --------------------------------------------------

    def on_device(self, device: str = "cuda", shards: "int | None" = None,
                  mesh=None) -> "DataSource":
        """Columnarize this source onto *device* (``"cuda"`` unless the
        caller asks for ``"cpu"``) and return a plan-capable source over
        it; ``shards=`` / *mesh* row-shard it as ``Reader.on_device``
        does.  A source that is a device table as it stands (what
        ``on_device`` returns, before any combinator) is row-sharded
        device to device by :meth:`reshard`, not streamed through the
        host.  Error row numbers downstream count streamed rows from 0;
        ``from_file(...).on_device()`` keeps the reader's numbering."""
        from .columnar.ingest import _maybe_shard, resolve_mesh, source_from_table
        from .columnar.table import DeviceTable
        from .plan import Scan

        mesh = resolve_mesh(device, shards, mesh)
        if mesh is not None and isinstance(self.plan, Scan):
            return self.reshard(mesh=mesh)
        table = DeviceTable.from_rows(self.to_rows(), mesh.devices[0] if mesh else device)
        return source_from_table(_maybe_shard(table, mesh))

    def reshard(self, device: str = "cuda", shards: "int | None" = None,
                mesh=None) -> "DataSource":
        """This source's device table row-sharded over a mesh (``shards=``
        over *device*, or *mesh*, as :meth:`on_device` takes them): each
        column cut into ``ceil(n / k)``-row blocks copied device to
        device (``DeviceTable.with_sharding``), so no row passes through
        the host, and the source's table may be dropped afterwards.  The
        source must be a device table as it stands (what ``on_device``
        returns, before any combinator).  The result equals
        ``on_device``'s row for row, its error row numbers counting from
        0; the stage ``shard:relayout`` records the re-lay and the bytes
        it copied between cards (``peer_bytes``)."""
        from .columnar.ingest import resolve_mesh, source_from_table
        from .plan import Scan
        from .utils.observe import telemetry

        mesh = resolve_mesh(device, shards, mesh)
        if mesh is None:
            raise ValueError("reshard() needs shards= or mesh=")
        if not isinstance(self.plan, Scan):
            raise ValueError("reshard() needs a device table as it stands; "
                             "on_device() columnarizes a chain")
        table = self.plan.table
        with telemetry.stage("shard:relayout", table.nrows):
            out = table.with_sharding(mesh)
            out.row_base = 0
            telemetry.barrier(tuple(s for c in out.columns.values() for s in c.storage.shards))
        return source_from_table(out)

    OnDevice = on_device

    # -- sinks (sinks.py) --------------------------------------------------

    def to_csv(self, out, *columns: str) -> None:
        """Write selected columns as canonical CSV (csvplus.go:379-406)."""
        from .sinks import to_csv

        to_csv(self, out, *columns)

    def to_csv_file(self, name: str, *columns: str) -> None:
        """CSV sink to a named file, removed on any error (csvplus.go:411-443)."""
        from .sinks import to_csv_file

        to_csv_file(self, name, *columns)

    def to_json(self, out) -> None:
        """Drive the chain, writing a JSON array of row objects to *out*
        (csvplus.go:446-475, byte-compatible with Go's json.Encoder)."""
        from .sinks import to_json

        to_json(self, out)

    def to_json_file(self, name: str) -> None:
        """JSON sink to a named file; the file is removed on any error
        (csvplus.go:478-480)."""
        from .sinks import to_json_file

        to_json_file(self, name)

    def to_rows(self) -> List[Row]:
        """Drive the chain and collect every row (csvplus.go:483-490)."""
        from .sinks import to_rows

        return to_rows(self)

    def to_device_table(self, device: str = "cuda"):
        """Execute the chain into a device-resident table without decoding
        rows.  A chain that cannot lower columnarizes its streamed rows
        onto the device it was pinned to; a host-only chain onto
        *device*."""
        from .columnar.exec import UnsupportedPlan, execute_plan
        from .columnar.table import DeviceTable

        if self.plan is not None:
            try:
                table = execute_plan(self.plan)
            except UnsupportedPlan:
                from .plan import linearize

                device = linearize(self.plan)[0].table.device
            else:
                if table.deferred_error is not None:
                    raise table.deferred_error[1]
                return table
        return DeviceTable.from_rows(self.to_rows(), device)

    # -- Go-style aliases --------------------------------------------------
    Transform = transform
    Filter = filter
    Map = map
    Validate = validate
    Top = top
    Drop = drop
    TakeWhile = take_while
    DropWhile = drop_while
    DropColumns = drop_columns
    SelectColumns = select_columns
    IndexOn = index_on
    UniqueIndexOn = unique_index_on
    Join = join
    Except = except_
    ToCsv = to_csv
    ToCsvFile = to_csv_file
    ToJSON = to_json
    ToJSONFile = to_json_file
    ToRows = to_rows


_STAGE_BREAK_NOTES = {
    "join": "join() against an index with no device copy "
    "(call index.on_device() to keep the chain on device)",
    "except": "except_() against an index with no device copy "
    "(call index.on_device() to keep the chain on device)",
    "validate": "validate() callbacks have no symbolic form",
}


def _make(run, plan, parent=None, stage: str = "", arg: Any = None) -> DataSource:
    """A combinator result: device plan execution when the chain is
    symbolic, with *run* (the host streaming closure) as fallback.  When
    the stage breaks an existing device plan (an opaque argument, a
    host-only index), the reason is recorded, and carried through later
    stages, for :meth:`DataSource.explain`."""
    if plan is None:
        ds = DataSource(run)
        if parent is not None:
            if parent.plan is not None and stage:
                ds.plan_note = _STAGE_BREAK_NOTES.get(
                    stage, f"{stage}({_describe_arg(arg)}) is not symbolic"
                )
            else:
                ds.plan_note = parent.plan_note  # keep the original reason
        return ds
    from .columnar.exec import plan_runner

    ds = DataSource(run, plan=plan)
    ds._run = plan_runner(plan, fallback=run, owner=ds)
    return ds


def _describe_arg(arg: Any) -> str:
    if arg is None:
        return ""
    return getattr(arg, "__name__", None) or type(arg).__name__


def _resolve_join_columns(index, columns: Sequence[str], what: str) -> List[str]:
    """Join/Except column-list resolution (csvplus.go:546-550, 589-593)."""
    if not columns:
        return list(index._impl.columns)
    if len(columns) > len(index._impl.columns):
        raise ValueError(f"too many source columns in {what}")
    return list(columns)


def take_rows(rows: Iterable[Row]) -> DataSource:
    """A DataSource over a list of Rows, cloned on every iteration
    (csvplus.go:218-222)."""
    rows = list(rows)

    def run(fn: RowFunc) -> None:
        iterate(rows, fn)

    ds = DataSource(run)
    ds._rows_hint = rows
    return ds


def take(src: Any) -> DataSource:
    """Lift anything with an ``iterate(fn)``/``Iterate(fn)`` method — a
    Reader, an Index, a DeviceTable — into a DataSource (csvplus.go:252-256)."""
    if isinstance(src, DataSource):
        return src
    it = getattr(src, "iterate", None) or getattr(src, "Iterate", None)
    if it is None:
        raise TypeError(f"take(): {type(src).__name__} has no iterate() method")
    return DataSource(it, plan=getattr(src, "plan", None))
