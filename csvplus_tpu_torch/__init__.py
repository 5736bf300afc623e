"""csvplus_tpu_torch — the PyTorch/CUDA port of csvplus_tpu.

The same fluent pipeline API as ``csvplus_tpu`` (which stays in the repo
as the reference), with the device path written in PyTorch for an NVIDIA
H100, the reference's Pallas kernel rewritten by hand in CUDA C++
(``csrc/mask.cu``), the device dictionary encode's field pack written by
hand too (``csrc/parse.cu``), and the reference's native CSV scanner
copied and built with ``g++`` (``native/scanner.cpp``).  The port imports neither
``jax`` nor any module of ``csvplus_tpu``: it keeps its own copies of the
host modules it needs.

Device entry points run on ``"cuda"`` unless the caller asks for
``"cpu"``; ``"cuda"`` with no card present raises::

    import csvplus_tpu_torch as csvplus

    orders = csvplus.from_file("orders.csv").on_device()
    cust = csvplus.from_file("customers.csv").on_device().unique_index_on("id")
    prod = csvplus.from_file("products.csv").on_device().unique_index_on("prod_id")
    rows = orders.filter(csvplus.Like({"qty": "1"})) \
        .join(cust, "cust_id").join(prod).to_rows()

Point lookups batch through ``Index.find_many``, and concurrent callers
share batches through ``csvplus_tpu_torch.serve.LookupServer``, which
also takes appends and deletes into a ``storage.MutableIndex`` (delta
tiers, a WAL, compaction).  ``Index.write_to`` / ``load_index`` persist an
index in the reference's file formats, and ``telemetry.collect()`` /
``profile_to`` observe a run stage by stage.
"""

from .errors import CsvPlusError, DataSourceError, StopPipeline
from .row import ConversionError, MissingColumnError, Row, merge_rows
from .source import DataSource, RowFunc, take, take_rows
from .reader import Reader, from_file, from_read_closer, from_reader
from .index import Index, create_index, create_unique_index, load_index
from .sinks import to_rows_many
from .predicates import All, Any_, Like, Not, Predicate
from .exprs import Rename, SetValue, Update
from . import obs
from . import plan
from . import serve
from . import storage
from .utils import telemetry, profile_to

# Go-style aliases (the reference API names)
Take = take
TakeRows = take_rows
FromFile = from_file
FromReader = from_reader
FromReadCloser = from_read_closer
LoadIndex = load_index
Any = Any_
ToRowsMany = to_rows_many

__all__ = [
    "Row",
    "DataSource",
    "RowFunc",
    "Index",
    "Reader",
    "CsvPlusError",
    "DataSourceError",
    "StopPipeline",
    "MissingColumnError",
    "ConversionError",
    "take",
    "take_rows",
    "from_file",
    "from_reader",
    "from_read_closer",
    "load_index",
    "create_index",
    "create_unique_index",
    "to_rows_many",
    "Predicate",
    "All",
    "Any",
    "Any_",
    "Not",
    "Like",
    "Rename",
    "SetValue",
    "Update",
    "merge_rows",
    "obs",
    "plan",
    "serve",
    "storage",
    "telemetry",
    "profile_to",
    "Take",
    "TakeRows",
    "FromFile",
    "FromReader",
    "FromReadCloser",
    "LoadIndex",
    "ToRowsMany",
]

__version__ = "0.1.0"
