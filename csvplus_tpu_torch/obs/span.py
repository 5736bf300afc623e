"""Hierarchical host-side spans with ``contextvars`` trace propagation.

Copy of ``csvplus_tpu/obs/span.py``.  The process-global
:data:`~csvplus_tpu_torch.utils.observe.telemetry` records a flat
per-stage table; the serving tier, where N concurrent queries interleave,
needs a tree per query:

* a :class:`Span` is one timed region with a ``trace_id`` / ``span_id``
  / ``parent_id`` triple, so spans form a tree;
* the *current* span rides a :mod:`contextvars` ``ContextVar`` — every
  thread (and every ``contextvars.Context``) sees its own current span,
  so concurrent queries each grow an isolated tree with zero locking on
  the hot path;
* worker threads that must contribute to a parent's trace adopt an
  explicitly captured context (:meth:`Tracer.capture` /
  :meth:`Tracer.adopt`): cross-thread state flows by explicit handoff,
  never ambient sharing — the serving dispatcher records each request's
  queue wait and dispatch into the submitter's trace this way;
* finished traces land in a bounded list (:meth:`Tracer.finished`).

``telemetry.stage()`` also opens a span whenever a trace is active in the
calling context (see ``utils/observe.py``).  Every live span (a trace's
root, an opened span) is also a ``torch.profiler`` range named
``csvplus:<name>``, so a profiler capture shows it on the profiler's own
clock beside the device work it launched; a pre-measured span
(:meth:`Tracer.add_span`, :meth:`Tracer.record_span`) has no range.  With
no active trace, :meth:`Tracer.span` is one ``ContextVar.get`` and one
generator frame.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from torch.profiler import record_function

#: Finished traces kept for export before the oldest are dropped.
MAX_FINISHED_TRACES = 512

#: The current (trace, open span_id) — per-thread / per-context by
#: ``contextvars`` semantics, which is what isolates concurrent queries.
_CURRENT: "contextvars.ContextVar[Optional[Tuple[Trace, int]]]" = (
    contextvars.ContextVar("csvplus_obs_current", default=None)
)


@dataclass
class Span:
    """One timed region inside a trace."""

    trace_id: int
    span_id: int
    parent_id: Optional[int]
    name: str
    t_start: float  # perf_counter seconds (the profiler's clock on export)
    t_end: float
    lane: str  # thread name or explicit worker lane
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start

    def to_json(self) -> Dict[str, Any]:
        return {
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "t_start": round(self.t_start, 6),
            "ms": round(self.seconds * 1e3, 4),
            "lane": self.lane,
            "attrs": self.attrs,
        }


class Trace:
    """One span tree (one query / one pipeline run).

    Spans append under the trace's own lock: workers adopted into the
    trace may close spans concurrently with the owner, and the finished
    list must never interleave-corrupt (the exact failure mode of the
    flat telemetry list this module replaces).
    """

    __slots__ = ("trace_id", "name", "spans", "_lock")

    def __init__(self, trace_id: int, name: str):
        self.trace_id = trace_id
        self.name = name
        self.spans: List[Span] = []
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def root(self) -> Optional[Span]:
        with self._lock:
            for s in self.spans:
                if s.parent_id is None:
                    return s
        return None

    def span_ids(self) -> set:
        with self._lock:
            return {s.span_id for s in self.spans}

    def snapshot(self) -> List[Span]:
        """Consistent copy of the span list (safe while workers append)."""
        with self._lock:
            return list(self.spans)

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            spans = list(self.spans)
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "spans": [s.to_json() for s in spans],
        }


def enter_range(name: str) -> record_function:
    """Open the profiler range ``csvplus:<name>`` on this thread; close it
    with :func:`exit_range`.  Outside a ``torch.profiler`` capture it
    records nothing."""
    rng = record_function(f"csvplus:{name}")
    rng.__enter__()
    return rng


def exit_range(rng: record_function) -> None:
    rng.__exit__(None, None, None)


class _OpenSpan:
    """Handle for a span opened via the low-level open/close API."""

    __slots__ = ("trace", "span", "token", "range")

    def __init__(self, trace: Trace, span: Span, token, rng: record_function):
        self.trace = trace
        self.span = span
        self.token = token
        self.range = rng


class Tracer:
    """Process-global span collector (one instance: :data:`tracer`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._finished: List[Trace] = []
        self._dropped = 0

    # -- context -----------------------------------------------------------

    def active(self) -> bool:
        """True when a trace is open in the calling context."""
        return _CURRENT.get() is not None

    def capture(self) -> Optional[Tuple[Trace, int]]:
        """Snapshot of the current (trace, span) for explicit handoff to
        another thread; ``None`` when no trace is active."""
        return _CURRENT.get()

    @contextlib.contextmanager
    def adopt(self, ctx: Optional[Tuple[Trace, int]]) -> Iterator[None]:
        """Run the body inside a context captured elsewhere (a worker
        lane contributing spans to its coordinator's trace).  ``None``
        adopts nothing and the body runs untraced."""
        if ctx is None:
            yield
            return
        token = _CURRENT.set(ctx)
        try:
            yield
        finally:
            _CURRENT.reset(token)

    # -- tracing -----------------------------------------------------------

    @contextlib.contextmanager
    def trace(self, name: str, **attrs) -> Iterator[Trace]:
        """Open a new root trace in this context; yields the
        :class:`Trace` and registers it in the finished list on exit."""
        t = Trace(next(self._ids), name)
        root = Span(
            trace_id=t.trace_id,
            span_id=next(self._ids),
            parent_id=None,
            name=name,
            t_start=time.perf_counter(),
            t_end=0.0,
            lane=threading.current_thread().name,
            attrs=dict(attrs),
        )
        rng = enter_range(name)
        token = _CURRENT.set((t, root.span_id))
        try:
            yield t
        finally:
            _CURRENT.reset(token)
            root.t_end = time.perf_counter()
            exit_range(rng)
            t.add(root)
            with self._lock:
                self._finished.append(t)
                while len(self._finished) > MAX_FINISHED_TRACES:
                    self._finished.pop(0)
                    self._dropped += 1

    def open_span(self, name: str, **attrs) -> Optional[_OpenSpan]:
        """Low-level span open, with its profiler range: returns ``None``
        (and records nothing) when no trace is active — the disabled fast
        path."""
        ctx = _CURRENT.get()
        if ctx is None:
            return None
        t, parent = ctx
        span = Span(
            trace_id=t.trace_id,
            span_id=next(self._ids),
            parent_id=parent,
            name=name,
            t_start=time.perf_counter(),
            t_end=0.0,
            lane=threading.current_thread().name,
            attrs=dict(attrs) if attrs else {},
        )
        token = _CURRENT.set((t, span.span_id))
        return _OpenSpan(t, span, token, enter_range(name))

    def close_span(self, handle: Optional[_OpenSpan], **attrs) -> None:
        if handle is None:
            return
        _CURRENT.reset(handle.token)
        handle.span.t_end = time.perf_counter()
        exit_range(handle.range)
        if attrs:
            handle.span.attrs.update(attrs)
        handle.trace.add(handle.span)

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[Dict[str, Any]]:
        """Child span under the current context.  Yields the span's
        attrs dict (the body may annotate it); a no-op yielding a
        throwaway dict when no trace is active."""
        handle = self.open_span(name, **attrs)
        if handle is None:
            yield {}
            return
        try:
            yield handle.span.attrs
        except BaseException as e:
            handle.span.attrs["error"] = type(e).__name__
            raise
        finally:
            self.close_span(handle)

    def add_span(
        self,
        name: str,
        seconds: float,
        *,
        lane: Optional[str] = None,
        t_end: Optional[float] = None,
        **attrs,
    ) -> Optional[Span]:
        """Pre-measured span under the current context (the
        ``add_stage`` analogue: work accumulated across many slices,
        e.g. a worker lane's total busy time).  ``t_end`` defaults to
        now, so the span covers [now - seconds, now]."""
        ctx = _CURRENT.get()
        if ctx is None:
            return None
        t, parent = ctx
        end = time.perf_counter() if t_end is None else t_end
        return self.record_span(
            t, parent, name, end - float(seconds), end, lane=lane, **attrs
        )

    def record_span(
        self,
        trace: Trace,
        parent_id: Optional[int],
        name: str,
        t_start: float,
        t_end: float,
        *,
        lane: Optional[str] = None,
        **attrs,
    ) -> Span:
        """Record a fully-specified span into *trace* from any thread —
        the serving dispatcher uses this to attribute batch-shared work
        back to each request's own trace."""
        span = Span(
            trace_id=trace.trace_id,
            span_id=next(self._ids),
            parent_id=parent_id,
            name=name,
            t_start=t_start,
            t_end=t_end,
            lane=lane or threading.current_thread().name,
            attrs=dict(attrs) if attrs else {},
        )
        trace.add(span)
        return span

    # -- export ------------------------------------------------------------

    def finished(self) -> List[Trace]:
        """Snapshot copy of the finished traces (oldest first)."""
        with self._lock:
            return list(self._finished)

    def drain(self) -> List[Trace]:
        """Finished traces, removing them from the tracer."""
        with self._lock:
            out = list(self._finished)
            self._finished.clear()
            return out

    def reset(self) -> None:
        with self._lock:
            self._finished.clear()
            self._dropped = 0

    @property
    def dropped(self) -> int:
        return self._dropped


#: Process-global tracer (mirrors the ``telemetry`` singleton pattern).
tracer = Tracer()
