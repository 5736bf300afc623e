"""Request coalescer: N concurrent callers, ONE batched device call.

Port of ``csvplus_tpu/serve/coalesce.py``.  :class:`LookupServer`
registers one or more named indexes (an immutable
:class:`~csvplus_tpu_torch.index.Index` or a
:class:`~csvplus_tpu_torch.storage.MutableIndex`).  Callers submit single
point-lookup probes (or whole plan-IR queries, or, against a mutable
index, append batches and key deletes) from any thread; a single
dispatcher thread drains the pending queue into one ``find_rows_many``
call per (cycle, index) pair and scatters the per-key row blocks back to
caller futures.  Independent single-key clients ride the same
one-searchsorted-pass / one-amortized-decode path as ``find_many``: the
server is how callers that cannot batch still get batched execution.
Writes drained in one cycle apply in submission order before its lookups,
and their futures complete only after the index's WAL is synced.  Live
materialized views (``register_view``/``view``/``view_names``) of a plan
over a registered mutable index refresh in every cycle after its writes
and before its lookups; ``view(name).read(key)`` answers on the caller's
thread from the view's epoch-pinned snapshot.

Coalescing policy (``tick_us``, else ``CSVPLUS_SERVE_TICK_US``):

* ``0`` (default) — **adaptive**: the dispatcher drains whatever is
  pending the moment it finishes the previous batch.  Under load the
  previous dispatch IS the coalescing window (requests pile up while
  the device call runs), so batches grow with pressure and an idle
  server adds zero latency.
* ``> 0`` — **fixed ticker**: after the first request arrives the
  dispatcher holds the batch open for the tick, or until the
  ``max_batch`` watermark (``CSVPLUS_SERVE_MAX_BATCH``) fills, trading
  p50 latency for bigger batches at low arrival rates.

Thread model: ALL shared state (the pending queue, open flag, crash
record, registry) is mutated only under ``self._cv``; the expensive work
(the batched lookup, plan execution, result scatter) runs outside the
lock on requests that have already left the queue.  A request is
completed only after it is popped from the queue, and completion sets a
per-request event that the submitting thread waits on.  The dispatcher
thread issues the device work under ``torch.cuda.device`` of the table
it reads (torch's current device is per thread); a batch's one host
sync on the lookup path is its ``(lower, upper)`` transfer.

Failure model: transient device failures on the coalesced lookup get
bounded deadline-aware retries; retries exhausting feeds a circuit
breaker that degrades the server onto a host-fallback oracle with equal
rows (half-open probes recover it); and ANY dispatcher death fails every
pending and future request fast with a typed
:class:`~csvplus_tpu_torch.resilience.retry.ServerCrashed` instead of
hanging clients.  The ladder is the reference's recovery path; the
snapshot counts every retry and degraded lookup (``retried``,
``degraded``) and ``breaker.snapshot()`` every opening.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

from ..obs.metrics import TelemetryPlane
from ..obs.span import tracer
from ..resilience import faults
from ..resilience.degrade import CircuitBreaker, HostLookupOracle
from ..resilience.retry import (
    TRANSIENT,
    RetryPolicy,
    ServerCrashed,
    call_with_retry,
    classify,
)
from ..row import Row
from ..utils.env import env_int
from ..utils.observe import telemetry
from .admit import AdmissionController, DeadlineExceeded
from .metrics import ServingMetrics
from .plancache import PlanCache


def _device_scope(device):
    """``torch.cuda.device(device)`` for a CUDA device (the dispatcher
    thread's current card), a no-op context otherwise."""
    if device is not None and getattr(device, "type", None) == "cuda":
        import torch

        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _index_device(impl):
    dev = getattr(impl, "dev", None)
    if dev is None:
        return getattr(impl, "device", None)  # a MutableIndex's tiers
    return dev.table.device


def _plan_device(root):
    from ..plan import linearize

    try:
        return getattr(linearize(root)[0].table, "device", None)
    except Exception:
        return None  # not a plan the executor knows: admission says why


#: Default cap on requests per dispatch cycle (``max_batch``).
DEFAULT_MAX_BATCH = 4096

#: Name the constructor's positional index registers under.
DEFAULT_INDEX = "default"


class _Registered:
    """One named index and its per-index serving state.  ``mutable``
    marks an impl with the storage write surface (``append_rows``); only
    those accept :meth:`LookupServer.append`.  Each registration carries
    its own host-fallback oracle so breaker degradation of one index never
    materializes another's rows."""

    __slots__ = ("name", "index", "impl", "key_width", "oracle", "mutable")

    def __init__(self, name: str, index):
        self.name = name
        self.index = index
        self.impl = index._impl
        self.key_width = len(self.impl.columns)
        self.oracle = HostLookupOracle(self.impl)
        self.mutable = hasattr(self.impl, "append_rows")


class ServeFuture:
    """Completion handle for one submitted request.

    ``result()`` returns the request's value — a ``List[Row]`` for a
    point lookup (rows cloned on delivery, same contract as
    ``iterate``), a materialized ``DeviceTable`` for a plan query, the
    appended row count for an append batch, 1 for a delete — or raises
    the request's error (:class:`DeadlineExceeded`, a plan admission
    rejection, or whatever the batched call raised).
    """

    __slots__ = ("probe", "plan", "rows", "del_key", "index_name",
                 "deadline_s", "callback", "t_submit", "t_dispatch",
                 "trace_ctx", "value", "error", "_event", "_done")

    def __init__(self, probe, plan, deadline_s, callback,
                 index_name=DEFAULT_INDEX, rows=None, del_key=None):
        self._done = False
        self.probe = probe
        self.plan = plan
        self.rows = rows
        self.del_key = del_key
        self.index_name = index_name
        self.deadline_s = deadline_s
        self.callback = callback
        # explicit handoff of the submitter's trace context: the
        # dispatcher thread attributes this request's queue-wait and
        # dispatch back into the SUBMITTER's span tree (cross-thread
        # state flows by capture, never ambient sharing)
        self.trace_ctx = tracer.capture()
        self.t_submit = time.perf_counter()
        self.t_dispatch = 0.0
        self.value: Any = None
        self.error: Optional[BaseException] = None
        self._event = None if callback is not None else threading.Event()

    def done(self) -> bool:
        return self._event is not None and self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if self._event is None:
            raise RuntimeError("callback-mode request has no blocking result()")
        if not self._event.wait(timeout):
            raise TimeoutError("request not completed within timeout")
        if self.error is not None:
            raise self.error
        return self.value


class LookupServer:
    """Coalescing query server over one registered index.

    Use as a context manager (``with LookupServer(index) as srv:``) or
    call :meth:`start`/:meth:`stop` explicitly.  ``stop()`` drains every
    admitted request before the dispatcher exits — shutdown sheds at
    admission, never drops admitted work.
    """

    def __init__(
        self,
        index=None,
        *,
        indexes: Optional[dict] = None,
        max_batch: Optional[int] = None,
        max_pending: Optional[int] = None,
        tick_us: Optional[int] = None,
        plancache: Optional[PlanCache] = None,
        metrics: Optional[ServingMetrics] = None,
        plane: Optional[TelemetryPlane] = None,
    ):
        # registry: the positional index lands under DEFAULT_INDEX;
        # *indexes* (name -> Index | MutableIndex) adds named routes.
        # Stored as an immutable-by-convention dict swapped whole under
        # self._cv, so the dispatcher reads it with one attribute load.
        regs: dict = {}
        if index is not None:
            regs[DEFAULT_INDEX] = _Registered(DEFAULT_INDEX, index)
        for name, ix in (indexes or {}).items():
            regs[str(name)] = _Registered(str(name), ix)
        if not regs:
            raise ValueError("LookupServer needs at least one index")
        self._indexes = regs
        # registered live views (name -> MaterializedView), swapped
        # whole under self._cv like the index registry
        self._views: dict = {}
        default = regs.get(DEFAULT_INDEX) or regs[next(iter(regs))]
        self._default_name = default.name
        self.max_batch = (
            int(max_batch)
            if max_batch is not None
            else env_int("CSVPLUS_SERVE_MAX_BATCH", DEFAULT_MAX_BATCH)
        )
        tick = tick_us if tick_us is not None else env_int("CSVPLUS_SERVE_TICK_US", 0)
        self._tick_s = max(0, int(tick)) * 1e-6
        self.admission = AdmissionController(max_pending)
        self.plancache = plancache if plancache is not None else PlanCache()
        self.metrics = metrics if metrics is not None else ServingMetrics()
        for reg in regs.values():
            rec = getattr(reg.impl, "recovered_records", 0)
            if rec:
                self.metrics.on_recovered(reg.name, rec)
        self._cv = threading.Condition()
        self._pending: List[ServeFuture] = []
        self._open = False
        self._thread: Optional[threading.Thread] = None
        # resilience: retry policy + breaker for the coalesced lookup
        # path, the host oracle the breaker degrades onto, and the
        # crash record that fails post-mortem submits fast
        self.retry_policy = RetryPolicy()
        self.breaker = CircuitBreaker()
        self._crashed: Optional[ServerCrashed] = None
        # the always-on telemetry plane: registry + tail
        # sampler + skew sketches + the process-global flight recorder.
        # Construction is cheap; exposition transports stay opt-in.
        self.plane = plane if plane is not None else TelemetryPlane()
        self.plane.attach_server(self)

    def register(self, name: str, index) -> None:
        """Register (or replace) a named index while running.  The
        registry dict is replaced whole under ``self._cv`` — in-flight
        dispatch cycles keep the snapshot they already read."""
        reg = _Registered(str(name), index)
        rec = getattr(reg.impl, "recovered_records", 0)
        if rec:
            self.metrics.on_recovered(reg.name, rec)
        with self._cv:
            regs = dict(self._indexes)
            regs[reg.name] = reg
            self._indexes = regs
        if hasattr(reg.impl, "key_sketch"):
            # late registrations get their build-key sketch too
            reg.impl.key_sketch = self.plane.build_sketch(reg.name)

    def registered(self) -> dict:
        """Snapshot of the index registry as ``{name: impl}`` — the
        surface the telemetry plane's collectors walk."""
        return {name: reg.impl for name, reg in self._indexes.items()}

    def register_view(self, name: str, root, *, source: Optional[str] = None):
        """Register a live materialized view of plan *root* over the
        MUTABLE index registered as *source* (default route when
        omitted) and return it.

        Registration gates the plan (the delta-rule check,
        :class:`~csvplus_tpu_torch.views.ViewRejected`, and static
        verification through this server's plan cache,
        :class:`~csvplus_tpu_torch.serve.plancache.PlanRejected`), both
        raising HERE, never later; then it builds the initial snapshot
        and subscribes to the source's tier events.  From then on every
        dispatch cycle refreshes the view AFTER the cycle's writes land
        (and before its lookups), so a reader that saw an append future
        complete sees the view contents include it by the next cycle.
        The view runs on the source's device (``"cuda"`` for a source
        with none)."""
        from ..views import MaterializedView

        reg = self._registered(source)
        if not reg.mutable or not hasattr(reg.impl, "subscribe"):
            raise TypeError(
                f"index {reg.name!r} is not a MutableIndex — views need "
                f"a tier-event source"
            )
        view = MaterializedView(
            str(name), root, reg.impl,
            plancache=self.plancache, metrics=self.metrics,
        )
        with self._cv:
            views = dict(self._views)
            views[str(name)] = view
            self._views = views
        return view

    def view(self, name: str):
        """The registered :class:`~csvplus_tpu_torch.views.MaterializedView`."""
        v = self._views.get(str(name))
        if v is None:
            raise KeyError(
                f"no view registered as {name!r} "
                f"(have: {', '.join(sorted(self._views))})"
            )
        return v

    def view_names(self) -> List[str]:
        return sorted(self._views)

    def _registered(self, name: Optional[str]) -> "_Registered":
        regs = self._indexes
        key = self._default_name if name is None else str(name)
        reg = regs.get(key)
        if reg is None:
            raise KeyError(
                f"no index registered as {key!r} "
                f"(have: {', '.join(sorted(regs))})"
            )
        return reg

    def index_names(self) -> List[str]:
        return sorted(self._indexes)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "LookupServer":
        with self._cv:
            if self._open:
                return self
            self._open = True
        t = threading.Thread(
            target=self._dispatch_loop, name="csvplus-serve-dispatch", daemon=True
        )
        self._thread = t
        t.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        """Close admission and wait for the dispatcher to drain every
        already-admitted request.  With *timeout* (seconds) the wait is
        bounded: a dispatcher still running after it raises
        :class:`TimeoutError` (admission stays closed)."""
        with self._cv:
            self._open = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(f"LookupServer dispatcher still draining after {timeout}s")
            self._thread = None

    def __enter__(self) -> "LookupServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission (any thread) -------------------------------------------

    def submit(
        self,
        probe,
        *,
        deadline_s: Optional[float] = None,
        callback: Optional[Callable[[ServeFuture], None]] = None,
        index: Optional[str] = None,
    ) -> ServeFuture:
        """Enqueue one point-lookup probe (a bare string = one-column
        prefix, else a sequence of key values) against the named
        *index* (default route when omitted).  Returns a
        :class:`ServeFuture`; with *callback* set, the dispatcher thread
        invokes it on completion instead (no blocking handle).

        Raises :class:`~csvplus_tpu_torch.serve.admit.ServerOverloaded` when
        the pending queue is at its bound — the request is shed, not
        enqueued.  Probe width is validated here against the routed
        index so a bad probe fails its caller instead of poisoning a
        whole coalesced batch.
        """
        reg = self._registered(index)
        norm = (probe,) if isinstance(probe, str) else tuple(probe)
        if len(norm) > reg.key_width:
            raise ValueError("too many columns in Index.find()")
        return self._enqueue(
            ServeFuture(norm, None, deadline_s, callback, index_name=reg.name)
        )

    def submit_append(
        self,
        rows: Sequence,
        *,
        deadline_s: Optional[float] = None,
        callback: Optional[Callable[[ServeFuture], None]] = None,
        index: Optional[str] = None,
    ) -> ServeFuture:
        """Enqueue one append batch against a MUTABLE named index.

        Appends coalesce like reads: every append for the same index
        drained in one dispatch cycle lands as ONE delta tier (one
        columnarize + encode + sort), and all of them are visible to
        lookups dispatched in the same cycle.  The future's value is
        this request's appended row count."""
        reg = self._registered(index)
        if not reg.mutable:
            raise TypeError(
                f"index {reg.name!r} is immutable (register a "
                f"MutableIndex to accept appends)"
            )
        batch = [r if isinstance(r, Row) else Row(r) for r in rows]
        if not batch:
            raise ValueError("append batch is empty")
        return self._enqueue(
            ServeFuture(None, None, deadline_s, callback,
                        index_name=reg.name, rows=batch)
        )

    def append(
        self,
        rows: Sequence,
        *,
        deadline_s: Optional[float] = None,
        index: Optional[str] = None,
    ) -> int:
        """Blocking convenience: submit one append batch and wait for its
        appended row count."""
        return self.submit_append(rows, deadline_s=deadline_s, index=index).result()

    def submit_delete(
        self,
        key: Sequence[str],
        *,
        deadline_s: Optional[float] = None,
        callback: Optional[Callable[[ServeFuture], None]] = None,
        index: Optional[str] = None,
    ) -> ServeFuture:
        """Enqueue one full-width-key tombstone against a MUTABLE named
        index.  Writes drained into one dispatch cycle — appends AND
        deletes — apply in SUBMISSION order before the cycle's lookups,
        so a delete()+append() for the same key lands exactly as the
        caller issued it.  The future's value is the tombstoned key count
        (1)."""
        reg = self._registered(index)
        if not reg.mutable or not hasattr(reg.impl, "delete"):
            raise TypeError(
                f"index {reg.name!r} is immutable (register a "
                f"MutableIndex to accept deletes)"
            )
        norm = (key,) if isinstance(key, str) else tuple(key)
        if len(norm) != reg.key_width:
            raise ValueError(
                f"delete() needs a full-width key ({reg.key_width} "
                f"columns, got {len(norm)})"
            )
        return self._enqueue(
            ServeFuture(None, None, deadline_s, callback,
                        index_name=reg.name, del_key=norm)
        )

    def delete(
        self,
        key: Sequence[str],
        *,
        deadline_s: Optional[float] = None,
        index: Optional[str] = None,
    ) -> int:
        """Blocking convenience: submit one tombstone and wait for it to be
        applied (and, on a durable index, synced)."""
        return self.submit_delete(key, deadline_s=deadline_s, index=index).result()

    def submit_plan(
        self,
        root,
        *,
        deadline_s: Optional[float] = None,
        callback: Optional[Callable[[ServeFuture], None]] = None,
    ) -> ServeFuture:
        """Enqueue one plan-IR query.  The dispatcher admits it through
        the plan cache (verified once per shape, rejected shapes never
        lower) and executes the cached shape's executable."""
        return self._enqueue(ServeFuture(None, root, deadline_s, callback))

    def lookup(
        self,
        *values: str,
        deadline_s: Optional[float] = None,
        index: Optional[str] = None,
    ) -> List[Row]:
        """Blocking convenience: submit one probe and wait for its rows."""
        return self.submit(values, deadline_s=deadline_s, index=index).result()

    def _enqueue(self, req: ServeFuture) -> ServeFuture:
        with self._cv:
            if self._crashed is not None:
                # the dispatcher is dead: fail fast and typed, never
                # queue against a thread that will not drain
                raise self._crashed
            if not self._open:
                raise RuntimeError("LookupServer is not running (call start())")
            try:
                self.admission.admit(len(self._pending))
            except Exception:
                self.metrics.on_shed()
                raise
            self._pending.append(req)
            self._cv.notify_all()
        self.metrics.on_enqueue()
        return req

    # -- dispatcher (single thread) ----------------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and self._open:
                    self._cv.wait()
                if self._tick_s > 0.0 and self._pending and self._open:
                    # fixed ticker: hold the batch open for one tick or
                    # until the watermark fills
                    t_end = time.perf_counter() + self._tick_s
                    while len(self._pending) < self.max_batch and self._open:
                        left = t_end - time.perf_counter()
                        if left <= 0.0:
                            break
                        self._cv.wait(left)
                batch = self._pending[: self.max_batch]
                self._pending = self._pending[len(batch):]
                depth_after = len(self._pending)
                if not batch and not self._open:
                    return
            self.metrics.on_tick(depth_after + len(batch))
            if batch:
                try:
                    self._run_batch(batch)
                except BaseException as err:
                    # dispatcher hardening: an escape here used to
                    # leave every pending future hanging forever —
                    # instead fail everything typed and fast
                    self._on_dispatcher_crash(err, batch)
                    return

    def _run_batch(self, batch: List[ServeFuture]) -> None:
        """Execute one drained batch OUTSIDE the queue lock: deadline
        sweep, one coalesced lookup call, per-request plan executions,
        then scatter.  Every request in *batch* has left the queue — the
        dispatcher owns it exclusively until completion.  Metrics land
        in one lock round at the end (``on_complete_batch``)."""
        faults.inject("serve:dispatch")
        t0 = time.perf_counter()
        regs = self._indexes  # one snapshot for the whole cycle
        samples: List[tuple] = []
        lookups: dict = {}  # index name -> sub-batch
        writes: dict = {}  # index name -> appends + deletes, submission order
        plans: List[ServeFuture] = []
        for req in batch:
            req.t_dispatch = t0
            expired = self.admission.deadline_error(req.t_submit, req.deadline_s, t0)
            if expired is not None:
                self._complete(req, None, expired, samples)
            elif req.plan is not None:
                plans.append(req)
            elif req.rows is not None or req.del_key is not None:
                writes.setdefault(req.index_name, []).append(req)
            else:
                lookups.setdefault(req.index_name, []).append(req)
        # writes land BEFORE the cycle's view refresh and lookups: a
        # lookup (or view read) coalesced into the same dispatch cycle
        # as a write observes it
        for name, reqs in writes.items():
            self._run_writes(regs[name], reqs, samples)
        self._refresh_views()
        for name, reqs in lookups.items():
            self._run_lookups(regs[name], reqs, samples)
        for req in plans:
            # a long lookup phase, retries, or earlier plans in THIS
            # batch may have consumed a plan request's whole budget
            # since the drain-time sweep: re-check with a fresh clock
            # before paying for the execution
            expired = self.admission.deadline_error(req.t_submit, req.deadline_s)
            if expired is not None:
                self._complete(req, None, expired, samples)
                continue
            # plans execute under the submitter's adopted context inside
            # an open dispatch span, so the executor's per-node stages
            # (telemetry.stage shim) nest inside it in the right trace
            with tracer.adopt(req.trace_ctx):
                handle = tracer.open_span(
                    "serve:dispatch", kind="plan", batch=len(batch)
                )
                try:
                    with _device_scope(_plan_device(req.plan)):
                        value = self._execute_plan_with_retry(req)
                except Exception as err:
                    tracer.close_span(handle, error=True)
                    self._complete(req, None, err, samples, own_dispatch=True)
                else:
                    tracer.close_span(handle)
                    self._complete(req, value, None, samples, own_dispatch=True)
        self.metrics.on_batch(len(batch))
        self.metrics.on_complete_batch(samples)
        cycle_s = time.perf_counter() - t0
        self.metrics.observe_dispatch(len(batch), cycle_s)
        # telemetry plane: tail-sample the cycle's completion records
        # and note the cycle summary in the flight ring — a constant
        # number of lock rounds regardless of batch size
        self.plane.on_cycle(len(batch), cycle_s, samples)

    def _run_writes(
        self, reg: _Registered, reqs: List[ServeFuture], samples: List[tuple]
    ) -> None:
        """One mutable index's writes for the cycle, applied in
        SUBMISSION order: contiguous append runs concatenate into a
        single ``append_rows`` call each (one columnarize + encode +
        sort, one delta tier per run), with each ``delete`` applied
        between runs exactly where the caller issued it.

        Durable-ack ordering: against a durable index the cycle's WAL
        records are forced to disk (``wal_sync()``, the ``batch``
        policy's fsync barrier; a cheap no-op under ``always``/``off``)
        BEFORE any future in the cycle completes, so a completed write
        future is a durability promise, not just a visibility one.  A
        failure anywhere fails EVERY future in the cycle un-acked.  The
        device work runs under ``torch.cuda.device`` of the index's
        device."""
        t_a = time.perf_counter()
        wal_stats = None
        rows_appended = 0
        append_reqs = delete_reqs = 0
        try:
            with _device_scope(_index_device(reg.impl)):
                run: List[Row] = []
                for req in reqs:
                    if req.rows is not None:
                        append_reqs += 1
                        run.extend(req.rows)
                        continue
                    if run:
                        reg.impl.append_rows(run)
                        rows_appended += len(run)
                        run = []
                    delete_reqs += 1
                    reg.impl.delete(req.del_key)
                if run:
                    reg.impl.append_rows(run)
                    rows_appended += len(run)
            sync = getattr(reg.impl, "wal_sync", None)
            if sync is not None:
                wal_stats = sync()
        except Exception as err:
            for req in reqs:
                self._complete(req, None, err, samples, batch_n=len(reqs))
        else:
            phases = (("serve:append", t_a, time.perf_counter()),)
            for req in reqs:
                self._complete(
                    req, len(req.rows) if req.rows is not None else 1,
                    None, samples, batch_n=len(reqs), phases=phases,
                )
        self.metrics.on_index_batch(
            reg.name,
            append_reqs=append_reqs,
            delete_reqs=delete_reqs,
            rows_appended=rows_appended,
            deltas_live=getattr(reg.impl, "delta_count", None),
            wal=wal_stats,
        )

    def _refresh_views(self) -> None:
        """Refresh every registered view with pending tier events,
        ordered AFTER the cycle's writes, BEFORE its lookups; each view
        runs its device work under ``torch.cuda.device`` of its source
        (``MaterializedView.refresh``).  A failing refresh (the
        ``views:refresh`` fault site) leaves that view's prior snapshot
        live and its events queued: readers keep the last consistent
        epoch, the failure is counted, and the next cycle retries; a
        crashed refresh never takes the dispatcher down with it."""
        views = self._views
        for name, view in views.items():
            if not view.pending:
                continue
            try:
                view.refresh()
            except Exception as err:
                self.metrics.on_view_refresh(name, failures=1)
                sys.stderr.write(
                    f"csvplus-serve: view {name!r} refresh failed "
                    f"({type(err).__name__}: {err}); prior snapshot "
                    f"stays live, retrying next cycle\n"
                )
                # post-mortem evidence for the views:refresh crash
                # window: note + atomic flight dump (never raises)
                self.plane.flight.note(
                    "views:refresh-failed", view=name,
                    error=type(err).__name__,
                )
                self.plane.flight_dump(f"views:refresh:{name}", err)

    def _run_lookups(
        self, reg: _Registered, lookups: List[ServeFuture], samples: List[tuple]
    ) -> None:
        """One coalesced batched lookup against one registered index,
        with the recovery ladder: bounded deadline-aware retries on
        transient device failures, then — retries exhausted or breaker
        open — that index's host-fallback oracle (bitwise-identical
        results).  Non-transient failures surface typed to every
        request in the sub-batch.  The breaker and retry policy are
        server-wide: a sick device path is a property of the process,
        not of one index.  An index too large for the oracle
        (``HostLookupOracle.available``) gets the retries alone, as a
        plan does: its batch then fails with its own error, and the
        breaker, which only chooses the fallback, is left alone.  The
        device work runs under ``torch.cuda.device`` of the index's
        table."""
        probes = [r.probe for r in lookups]

        def time_left():
            # tightest remaining deadline budget across the sub-batch
            # (None = unbounded): a retry must never sleep past it
            now = time.perf_counter()
            budgets = [
                r.deadline_s - (now - r.t_submit)
                for r in lookups
                if r.deadline_s is not None
            ]
            return min(budgets) if budgets else None

        def primary_pass():
            # find_rows_many decomposed so the coalesced batch's two
            # phases carry their own timestamps; each request's trace
            # gets both as batch-shared children of its dispatch span
            t_a = time.perf_counter()
            faults.inject("serve:bounds")
            with _device_scope(_index_device(reg.impl)):
                bounds = reg.impl.bounds_many(probes)
                t_b = time.perf_counter()
                groups = reg.impl.rows_for_bounds(bounds)
            return t_a, t_b, time.perf_counter(), groups, bounds

        def fallback_pass():
            t_a = time.perf_counter()
            bounds = reg.oracle.bounds_many(probes)
            t_b = time.perf_counter()
            groups = reg.oracle.rows_for_bounds(bounds)
            return t_a, t_b, time.perf_counter(), groups, bounds

        fallback = reg.oracle.available

        def on_retry(attempt, err):
            self.metrics.on_retry()
            if fallback:
                self.breaker.on_failure()

        degraded = fallback and self.breaker.route() == "fallback"
        try:
            if degraded:
                t_a, t_b, t_c, groups, bounds = fallback_pass()
            else:
                try:
                    t_a, t_b, t_c, groups, bounds = call_with_retry(
                        primary_pass,
                        policy=self.retry_policy,
                        time_left=time_left,
                        on_retry=on_retry,
                        site="serve:bounds",
                    )
                    if fallback:
                        self.breaker.on_success()
                except Exception as err:
                    if not fallback:
                        raise
                    self.breaker.on_failure()
                    if classify(err) != TRANSIENT:
                        raise
                    # retries exhausted on a transient device failure:
                    # serve the batch from the host oracle instead of
                    # failing it back to callers
                    degraded = True
                    t_a, t_b, t_c, groups, bounds = fallback_pass()
        except Exception as err:
            for req in lookups:
                self._complete(req, None, err, samples, batch_n=len(lookups))
            self.metrics.on_index_batch(reg.name, lookups=len(lookups))
            return
        if degraded:
            self.metrics.on_degraded(len(lookups))
        self.metrics.on_index_batch(
            reg.name,
            lookups=len(lookups),
            tiers_probed=getattr(bounds, "tiers_probed", None),
            tiers_pruned=getattr(bounds, "tiers_pruned", None),
        )
        # skew evidence: the sub-batch's probe keys into this index's
        # Space-Saving sketch, one lock round
        self.plane.offer_probes(reg.name, probes)
        phases = (
            ("serve:bounds", t_a, t_b),
            ("serve:gather-decode", t_b, t_c),
        )
        t_d = time.perf_counter()
        for req, rows in zip(lookups, groups):
            # clone on delivery: blocks may be shared with the
            # mirror LRU (same contract as iterate/_rows_hint)
            self._complete(
                req,
                [Row(r) for r in rows],
                None,
                samples,
                batch_n=len(lookups),
                phases=phases,
            )
        if telemetry.enabled:
            # how the batch's time splits (stages of the port's own: the
            # reference records these phases as spans only)
            n, n_rows = len(lookups), sum(len(g) for g in groups)
            telemetry.add_stage("serve:bounds", n, n, t_b - t_a)
            telemetry.add_stage("serve:gather-decode", n, n_rows, t_c - t_b)
            telemetry.add_stage("serve:deliver", n_rows, n_rows, time.perf_counter() - t_d)

    def _execute_plan_with_retry(self, req: ServeFuture):
        """Execute one plan query through the cache, retrying transient
        device failures within the request's remaining deadline.  The
        cached executable is reused across attempts."""
        if req.deadline_s is not None:
            deadline_s = req.deadline_s
            t_submit = req.t_submit

            def time_left():
                return deadline_s - (time.perf_counter() - t_submit)

        else:
            time_left = None

        def on_retry(attempt, err):
            self.metrics.on_retry()

        return call_with_retry(
            lambda: self.plancache.execute(req.plan),
            policy=self.retry_policy,
            time_left=time_left,
            on_retry=on_retry,
            site="plan:execute",
        )

    def _on_dispatcher_crash(
        self, err: BaseException, inflight: List[ServeFuture]
    ) -> None:
        """Terminal failure path: record the crash (post-mortem submits
        raise it at admission), close the server, and complete every
        in-flight and still-pending request with a typed
        :class:`ServerCrashed` — clients unblock in well under a second
        instead of hanging on futures nobody will ever complete."""
        crash = ServerCrashed(err)
        with self._cv:
            self._crashed = crash
            orphans, self._pending = self._pending, []
            self._open = False
            self._cv.notify_all()
        sys.stderr.write(
            f"csvplus-serve: dispatcher crashed "
            f"({type(err).__name__}: {err}); failing "
            f"{len(inflight) + len(orphans)} request(s) with ServerCrashed\n"
        )
        samples: List[tuple] = []
        for req in list(inflight) + orphans:
            self._complete(req, None, crash, samples)
        self.metrics.on_complete_batch(samples)
        # the flight recorder's reason-to-exist: dump the last N cycle
        # summaries, fault firings, and storage events with the crash
        # attached (atomic tmp->fsync->rename; never raises)
        self.plane.tail.offer_batch(samples)
        self.plane.flight.note(
            "serve:dispatcher-crash", error=type(err).__name__,
            failed=len(samples),
        )
        self.plane.flight_dump("serve:dispatcher-crash", err)

    def _complete(
        self,
        req: ServeFuture,
        value,
        error,
        samples: List[tuple],
        batch_n: int = 0,
        phases: Sequence[tuple] = (),
        own_dispatch: bool = False,
    ) -> None:
        if req._done:
            # already delivered — e.g. completed earlier in a batch the
            # dispatcher then crashed out of; never double-complete
            return
        req._done = True
        req.value = value
        req.error = error
        done = time.perf_counter()
        outcome = (
            "ok"
            if error is None
            else ("expired" if isinstance(error, DeadlineExceeded) else "failed")
        )
        # extended completion record: the first three fields are the
        # classic ServingMetrics shape; the tail sampler reads the
        # rest (request kind, route, error type) when it retains one
        kind = (
            "plan" if req.plan is not None
            else "write" if (req.rows is not None or req.del_key is not None)
            else "lookup"
        )
        samples.append(
            (
                done - req.t_submit,
                req.t_dispatch - req.t_submit,
                outcome,
                kind,
                req.index_name,
                type(error).__name__ if error is not None else None,
            )
        )
        if req.trace_ctx is not None:
            # attribute the dispatcher's work back into the SUBMITTER's
            # span tree: queue-wait, then the dispatch window with the
            # coalesced batch's phases as batch-shared children
            trace, parent = req.trace_ctx
            t_disp = req.t_dispatch or done
            tracer.record_span(
                trace, parent, "serve:queue-wait", req.t_submit, t_disp
            )
            if not own_dispatch:
                dspan = tracer.record_span(
                    trace,
                    parent,
                    "serve:dispatch",
                    t_disp,
                    done,
                    outcome=outcome,
                    batch=batch_n,
                )
                for name, ts, te in phases:
                    tracer.record_span(
                        trace, dspan.span_id, name, ts, te,
                        shared=batch_n > 1, batch=batch_n,
                    )
        if req.callback is not None:
            try:
                req.callback(req)
            except Exception as cb_err:
                # a caller's callback must not kill the dispatcher (the
                # request itself completed) — but the failure is never
                # dropped: counted and warned once per occurrence
                self.metrics.on_callback_error()
                sys.stderr.write(
                    f"csvplus-serve: completion callback raised "
                    f"{type(cb_err).__name__}: {cb_err} (request completed; "
                    f"see metrics callback_errors)\n"
                )
        else:
            req._event.set()

    # -- observability -----------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-safe metrics snapshot including plan-cache stats."""
        return self.metrics.snapshot(self.plancache)
