"""CSV / Index -> DeviceTable ingestion.

Port of the whole-file tiers of ``csvplus_tpu/columnar/ingest.py``.
``from_file(...).on_device("cuda")`` parses the CSV with the Reader's
exact header and field-count policies and row-numbered errors, encodes
each column on the host and uploads it.  The tiers, in the reference's
order:

1. ``native-encoded``: the native scanner and a vectorized encode
   (:func:`~csvplus_tpu_torch.native.scanner.read_encoded_columns_native`),
   no per-cell Python strings; ``prefix + canonical int32`` columns
   become typed value lanes
   (:class:`~csvplus_tpu_torch.columnar.typed.IntColumn`);
2. ``native-strings``: the native scanner, Python strings per cell, then
   dictionary encoding (:func:`_read_columns_fast`);
3. ``python``: the Reader's own ``read_columns``.

A tier declines only for the reference's reasons of semantics (see
:mod:`~csvplus_tpu_torch.native.scanner`); a scanner that cannot be
built or loaded raises.  The tier that ran is recorded on the table as
``ingest_tier``.  The reference's streamed and device-parse tiers are
not ported yet.
"""

from __future__ import annotations

from ..source import DataSource
from .table import DeviceTable


def source_from_table(table: DeviceTable) -> DataSource:
    """Plan-capable DataSource over an existing DeviceTable."""
    from ..plan import Scan
    from .exec import plan_runner

    plan = Scan(table)
    ds = DataSource(None, plan=plan)
    ds._run = plan_runner(plan, fallback=table.iterate, owner=ds)
    return ds


def _encoded_nrows(value) -> int:
    """Row count of one encoded column: (dictionary, codes) pairs count
    codes; ("int", prefix, values) typed triples count values."""
    if len(value) == 3 and value[0] == "int":
        return int(value[2].shape[0])
    return int(value[1].shape[0])


def _ingest(reader, device) -> DeviceTable:
    """The first tier that accepts *reader*'s input, as a DeviceTable."""
    path = getattr(reader, "_path", None)
    if path is not None:
        from ..native import scanner

        enc = scanner.read_encoded_columns_native(reader, path)
        if enc is not None:
            names, data = enc
            nrows = _encoded_nrows(data[names[0]]) if names else 0
            table = DeviceTable.from_encoded({n: data[n] for n in names}, nrows, device)
            table.ingest_tier = "native-encoded"
            return table
    names, data, tier = _read_columns_fast(reader)
    table = DeviceTable.from_pylists({n: data[n] for n in names}, device)
    table.ingest_tier = tier
    return table


def reader_to_device(reader, device: str = "cuda") -> DataSource:
    """Parse *reader*'s CSV into a DeviceTable on *device* and wrap it as
    a plan-capable source.  Errors carry the Reader's record numbers."""
    table = _ingest(reader, device)
    # source row number of data record 0, as the host Reader numbers it
    # (record 1 is the header when one is read)
    table.row_base = 2 if reader._header_from_first_row else 1
    return source_from_table(table)


def _read_columns_fast(reader):
    """(names, {name: [values]}, tier): the native scanner's columnar read
    when the reader's configuration allows it, else the Reader's own."""
    path = getattr(reader, "_path", None)
    if path is not None:
        from ..native import scanner

        cols = scanner.read_columns_native(reader, path)
        if cols is not None:
            return cols[0], cols[1], "native-strings"
    names, data = reader.read_columns()
    return names, data, "python"


def index_to_device(index, device: str = "cuda"):
    """Columnarize an Index (sorted rows + key columns) into a
    :class:`~csvplus_tpu_torch.ops.join.DeviceIndex`."""
    from ..ops.join import DeviceIndex

    table = DeviceTable.from_rows(index._impl.rows, device)
    return DeviceIndex.build(table, index._impl.columns)
