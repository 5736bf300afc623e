"""CSV / Index -> DeviceTable ingestion.

Port of the pure-Python tier of ``csvplus_tpu/columnar/ingest.py``:
``from_file(...).on_device("cuda")`` parses the CSV through the Reader's
own ``read_columns`` (the reference's exact header and field-count
policies and row-numbered errors), dictionary-encodes each column on the
host and uploads the code arrays to the device.  The returned DataSource
carries a ``Scan`` plan, so downstream symbolic combinators extend the
device plan.  The reference's native C++ scanner and streamed tiers are
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


def reader_to_device(reader, device: str = "cuda") -> DataSource:
    """Parse *reader*'s CSV into a DeviceTable on *device* and wrap it as
    a plan-capable source.  Errors carry the Reader's record numbers."""
    names, data = reader.read_columns()
    table = DeviceTable.from_pylists({n: data[n] for n in names}, device)
    # source row number of data record 0, as the host Reader numbers it
    # (record 1 is the header when one is read)
    table.row_base = 2 if reader._header_from_first_row else 1
    return source_from_table(table)


def index_to_device(index, device: str = "cuda"):
    """Columnarize an Index (sorted rows + key columns) into a
    :class:`~csvplus_tpu_torch.ops.join.DeviceIndex`."""
    from ..ops.join import DeviceIndex

    table = DeviceTable.from_rows(index._impl.rows, device)
    return DeviceIndex.build(table, index._impl.columns)
