"""Observability: the port of ``csvplus_tpu/obs/``.

* :mod:`.span`: hierarchical per-query spans with ``contextvars`` trace
  isolation (:data:`tracer`);
* :mod:`.export`: Chrome-trace/Perfetto JSON and span JSON-lines
  exporters, and the trace schema validator;
* :mod:`.recompile`: build/load counts of the hand-built binaries
  (:class:`RecompileWatch`);
* :mod:`.memory`: RSS/device-memory watermarks attachable to any span,
  and the artifact host header;
* :mod:`.diff`: the stage-table and bench-record regression differs
  behind ``python -m csvplus_tpu_torch.obs diff``;
* :mod:`.metrics`: the telemetry plane the serving tier carries (typed
  metric registry, Prometheus text exposition and optional HTTP
  endpoint, the JSONL metrics pump, tail-sampled request tracing);
* :mod:`.flight`: the crash flight recorder, a bounded process-global
  event ring dumped atomically on terminal failure paths;
* :mod:`.sketch` and :mod:`.joinskew`: the Space-Saving top-K sketch
  (behind ``python -m csvplus_tpu_torch.obs skew``) and the build-side
  key sketches and join counters the cost model reads.
"""

from .diff import (
    diff_bench_files,
    diff_bench_records,
    diff_files,
    diff_stage_tables,
    load_stage_table,
)
from .export import (
    SpanJsonlSink,
    chrome_trace_events,
    export_chrome_trace,
    spans_to_json,
    validate_chrome_trace,
    write_chrome_trace,
    write_spans_jsonl,
)
from .flight import FlightRecorder, recorder
from .memory import (
    MemoryWatermark,
    device_memory_stats,
    host_header,
    peak_rss_mb,
    rss_mb,
    watch_memory,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    MetricsPump,
    PromHttpEndpoint,
    TailSampler,
    TelemetryPlane,
)
from .recompile import (
    RecompileWatch,
    compile_counts,
    register_kernel,
    registered_kernels,
)
from .sketch import SpaceSaving, skew_report
from .span import Span, Trace, Tracer, tracer

__all__ = [
    "Span",
    "Trace",
    "Tracer",
    "tracer",
    "SpanJsonlSink",
    "chrome_trace_events",
    "export_chrome_trace",
    "spans_to_json",
    "validate_chrome_trace",
    "write_chrome_trace",
    "write_spans_jsonl",
    "MemoryWatermark",
    "device_memory_stats",
    "host_header",
    "peak_rss_mb",
    "rss_mb",
    "watch_memory",
    "RecompileWatch",
    "compile_counts",
    "register_kernel",
    "registered_kernels",
    "diff_bench_files",
    "diff_bench_records",
    "diff_files",
    "diff_stage_tables",
    "load_stage_table",
    "FlightRecorder",
    "recorder",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "MetricsPump",
    "PromHttpEndpoint",
    "TailSampler",
    "TelemetryPlane",
    "SpaceSaving",
    "skew_report",
]
