"""Error types for csvplus_tpu_torch (a copy of ``csvplus_tpu/errors.py``).

Mirrors the reference's error protocol (csvplus.go:1208-1238): every error
surfaced from a pipeline is annotated with a 1-based row number, rendered as
``row {line}: {message}``.  The Go library returns errors; here they are
exceptions.  The Go sentinel ``io.EOF`` (csvplus.go:212-214) — "stop the
iteration early, not an error" — maps to :class:`StopPipeline`.
"""

from __future__ import annotations


class CsvPlusError(Exception):
    """Base class for all csvplus_tpu_torch errors."""


class DataSourceError(CsvPlusError):
    """Error annotated with the row number it occurred at.

    Reference: ``DataSourceError{Line, Err}`` csvplus.go:1229-1238; message
    format ``row %d: %s`` csvplus.go:1236-1238.
    """

    def __init__(self, line: int, err: "Exception | str"):
        self.line = int(line)
        self.err = err
        super().__init__(f"row {self.line}: {err}")


class StopPipeline(Exception):
    """Raised by a row callback to stop iteration early without error.

    Equivalent of returning ``io.EOF`` from a ``RowFunc`` in the reference
    (csvplus.go:212-214, 238-239).  Sinks treat it as a clean end-of-data.
    """


def map_error(err: Exception, line_no: int) -> DataSourceError:
    """Wrap *err* with a row number unless it already carries one.

    Reference: ``mapError`` csvplus.go:1209-1227.
    """
    if isinstance(err, DataSourceError):
        return err
    return DataSourceError(line_no, err)
