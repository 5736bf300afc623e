"""Span exporters: Chrome-trace/Perfetto JSON + span JSON-lines.

Port of ``csvplus_tpu/obs/export.py``.  Two consumers, two formats:

* :func:`write_chrome_trace` / :func:`export_chrome_trace` emit the
  Chrome Trace Event format (``{"traceEvents": [...]}``, complete
  ``"ph": "X"`` events) that Perfetto and ``chrome://tracing`` open
  directly.  :func:`export_chrome_trace` takes the same ``log_dir`` as
  :func:`csvplus_tpu_torch.utils.observe.profile_to`, so the host-side
  span trace and the ``torch.profiler`` trace of one run land side by
  side and open in the same Perfetto session, on one time axis: a span's
  ``ts`` is where the profiler's Chrome trace puts its range.
* :func:`spans_to_json` / :func:`write_spans_jsonl` emit one flat JSON
  object per span, the shape bench artifacts embed and the ``obs diff``
  tooling consumes.

:func:`validate_chrome_trace` is the schema check run over the emitted
file: it returns a list of problems (empty = valid) rather than raising,
so a caller can print every violation at once.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from .span import Span, Trace, tracer

#: Keys every trace event must carry; "ts" is additionally required for
#: "X" events but NOT for "M" metadata (per the Trace Event spec).
_REQUIRED_EVENT_KEYS = ("name", "ph", "pid", "tid")

#: The profiler's Chrome trace writes an event's Unix-epoch time as
#: microseconds since its ``baseTimeNanoseconds``, which keeps the numbers
#: small enough for a double.  libkineto takes that base as the start of
#: the current interval of this many seconds since the epoch
#: (``ChromeTraceBaseTime``): the base assumed when no profiler trace is
#: at hand to read it from.
_TRACE_BASE_INTERVAL_S = 7_889_238

_BASE_KEY = re.compile(rb'"baseTimeNanoseconds"\s*:\s*(\d+)')


def profiler_axis_us(base_ns: Optional[int] = None) -> float:
    """What to add to a ``perf_counter`` time, in microseconds, to place
    it on the time axis of a profiler Chrome trace whose
    ``baseTimeNanoseconds`` is *base_ns*: the clocks' offset now, taken
    once per export.  With no *base_ns*, libkineto's current base."""
    epoch_ns = time.time_ns()
    offset_ns = epoch_ns - time.perf_counter_ns()
    if base_ns is None:
        interval_ns = _TRACE_BASE_INTERVAL_S * 1_000_000_000
        base_ns = epoch_ns // interval_ns * interval_ns
    return (offset_ns - base_ns) / 1e3


def profiler_base_ns(log_dir: str) -> Optional[int]:
    """``baseTimeNanoseconds`` of the newest profiler Chrome trace in
    *log_dir* (kineto writes it in the file's header), or ``None`` when
    the directory holds none."""
    try:
        names = [n for n in os.listdir(log_dir)
                 if n.endswith(".json") and not n.startswith("csvplus_host_trace.")]
    except FileNotFoundError:
        return None
    for name in sorted(names, key=lambda n: os.path.getmtime(os.path.join(log_dir, n)),
                       reverse=True):
        with open(os.path.join(log_dir, name), "rb") as f:
            m = _BASE_KEY.search(f.read(1 << 16))
        if m:
            return int(m.group(1))
    return None


def _iter_spans(traces: Iterable[Trace]) -> Iterable[Span]:
    for t in traces:
        yield from t.snapshot()


def chrome_trace_events(
    traces: Sequence[Trace], base_ns: Optional[int] = None
) -> List[Dict[str, Any]]:
    """Chrome Trace Event list for *traces*: one ``"X"`` (complete)
    event per span plus ``"M"`` metadata naming the process and each
    lane.  ``tid`` is a dense integer per distinct lane; timestamps are
    microseconds on the axis of the profiler trace whose base is
    *base_ns* (:func:`profiler_axis_us`), so a span lines up with the
    device work it launched."""
    pid = os.getpid()
    spans = list(_iter_spans(traces))
    if not spans:
        return []
    axis_us = profiler_axis_us(base_ns)
    lanes: Dict[str, int] = {}
    events: List[Dict[str, Any]] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": "csvplus-host"},
        }
    ]
    for s in spans:
        tid = lanes.get(s.lane)
        if tid is None:
            tid = lanes[s.lane] = len(lanes) + 1
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": s.lane},
                }
            )
        args: Dict[str, Any] = {
            "trace_id": s.trace_id,
            "span_id": s.span_id,
        }
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        for k, v in s.attrs.items():
            args[k] = v if isinstance(v, (int, float, str, bool)) else repr(v)
        events.append(
            {
                "name": s.name,
                "cat": "csvplus",
                "ph": "X",
                "ts": round(s.t_start * 1e6 + axis_us, 3),
                "dur": round(s.seconds * 1e6, 3),
                "pid": pid,
                "tid": tid,
                "args": args,
            }
        )
    return events


def write_chrome_trace(
    path: str, traces: Optional[Sequence[Trace]] = None, base_ns: Optional[int] = None
) -> str:
    """Write *traces* (default: every finished trace in the global
    tracer) as one Chrome-trace JSON file, on the axis *base_ns* gives
    (:func:`chrome_trace_events`); returns the path."""
    if traces is None:
        traces = tracer.finished()
    payload = {
        "traceEvents": chrome_trace_events(traces, base_ns),
        "displayTimeUnit": "ms",
        "metadata": {"producer": "csvplus_tpu_torch.obs"},
    }
    with open(path, "w") as f:
        json.dump(payload, f)
        f.write("\n")
    return path


def export_chrome_trace(
    log_dir: str, traces: Optional[Sequence[Trace]] = None
) -> str:
    """Write the host span trace under *log_dir* (the same directory
    ``profile_to(log_dir)`` fills with the ``torch.profiler`` trace) as
    ``csvplus_host_trace.<pid>.json``, on the time axis of the newest
    profiler trace there (:func:`profiler_base_ns`); returns the file
    path."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"csvplus_host_trace.{os.getpid()}.json")
    return write_chrome_trace(path, traces, profiler_base_ns(log_dir))


def validate_chrome_trace(obj: Union[dict, list]) -> List[str]:
    """Schema check for a Chrome-trace payload: returns every problem
    found (empty list = valid).  Accepts both the object form
    (``{"traceEvents": [...]}``) and the bare array form."""
    problems: List[str] = []
    if isinstance(obj, dict):
        events = obj.get("traceEvents")
        if not isinstance(events, list):
            return ["traceEvents missing or not a list"]
    elif isinstance(obj, list):
        events = obj
    else:
        return [f"payload is {type(obj).__name__}, expected dict or list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event[{i}] is not an object")
            continue
        for k in _REQUIRED_EVENT_KEYS:
            if k not in ev:
                problems.append(f"event[{i}] ({ev.get('name')!r}) missing {k!r}")
        ph = ev.get("ph")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)):
                problems.append(f"event[{i}] ({ev.get('name')!r}) X without numeric dur")
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                problems.append(f"event[{i}] ({ev.get('name')!r}) X without numeric ts")
            elif ts < 0:
                problems.append(f"event[{i}] ({ev.get('name')!r}) negative ts")
        elif ph == "M":
            if not isinstance(ev.get("args"), dict):
                problems.append(f"event[{i}] metadata without args")
        elif ph is None:
            pass  # already reported as missing
        elif not isinstance(ph, str):
            problems.append(f"event[{i}] ph is not a string")
    return problems


def spans_to_json(traces: Optional[Sequence[Trace]] = None) -> List[Dict[str, Any]]:
    """Flat JSON-safe span dicts (the bench-artifact embedding shape)."""
    if traces is None:
        traces = tracer.finished()
    return [s.to_json() for s in _iter_spans(traces)]


def write_spans_jsonl(
    path: str, traces: Optional[Sequence[Trace]] = None
) -> str:
    """One JSON object per line per span; returns the path."""
    rows = spans_to_json(traces)
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row))
            f.write("\n")
    return path


class SpanJsonlSink:
    """Incremental JSON-lines span sink for long runs: call
    :meth:`flush` periodically to append newly-finished traces without
    holding every span in memory until the end."""

    def __init__(self, path: str):
        self.path = path
        self.written = 0
        self._t_open = time.time()
        # truncate on open: one sink = one run's spans
        with open(path, "w"):
            pass

    def flush(self) -> int:
        """Drain finished traces from the global tracer into the file;
        returns the number of spans appended."""
        rows = spans_to_json(tracer.drain())
        if rows:
            with open(self.path, "a") as f:
                for row in rows:
                    f.write(json.dumps(row))
                    f.write("\n")
            self.written += len(rows)
        return len(rows)
