"""One run of one cell: set-up, the measured window, the check, and the
metrics, as the result's last line reports them.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``BENCHMARK.json`` names the cell's configuration file and
traffic mix (``portbench/traffic/<mix>.json``), the mix names its unit
kind (``portbench/kinds/<unit>.py``), the configuration names
its reference module (``portbench/reference/<name>.py``), and every
metric is read by ``portbench/metrics/<metric>.py``'s ``read(ctx)``,
which returns None when the run holds nothing to read.

The window is a closed loop with one client: the next unit starts when
the last one's result is on the card and the card is synchronised.  It
ends with the first unit that finishes ``seconds`` or more after it
began, so a rate is over whole units and the whole window.  A traced run
(``trace``) splits the window in two: the first half, up to
:data:`PROFILE_MAX_S`, under ``torch.profiler``, each unit inside a span
trace of the program so that its stages name the profiler's ranges
without the collector's barriers; the rest under the program's stage
collector (``telemetry.collect()``, which waits for the card at every
stage) and the benchmark's own spans.  Set-up's first warm-up unit, the
first to meet the freshly ingested tables, runs its stages under spans
of their own (``first:<stage>``).  The memory peak reported is the
window's: the allocator's peak is reset as the window opens.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import statistics
import tempfile
import time
import traceback
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import check
from .units import Env, load_kind, no_span, seed_word

HERE = Path(__file__).resolve().parent

#: The profiled part of a traced window, at most: enough units for the
#: device metrics, and a trace that reads in seconds.
PROFILE_MAX_S = 10.0


def log(msg: str) -> None:
    import sys

    print(msg, file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_cell(root: Path, name: str) -> Cell:
    """The cell *name* of ``root/BENCHMARK.json`` with its configuration,
    traffic mix and metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name, w, config, traffic, mine(bench["end_to_end"]), mine(bench["per_layer"]))


def reader(metric: str):
    """``read(ctx)`` of ``portbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What the readers read: the window's units and their times, the
    benchmark's spans, the program's stage times, and the device trace."""

    card: str
    fact_rows: int = 0
    facts: dict = field(default_factory=dict)
    setup_s: float = 0.0
    window_s: float = 0.0
    rows: int = 0
    latencies_s: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)
    stages: dict = field(default_factory=dict)
    staged_units: int = 0
    profiled_units: int = 0
    trace: object = None

    def span_ms(self, name: str) -> "float | None":
        got = self.spans.get(name)
        return 1e3 * statistics.fmean(got) if got else None

    def stage_ms(self, *names: str) -> "float | None":
        got = [self.stages[n] for n in names if n in self.stages]
        if not got or not self.staged_units:
            return None
        return 1e3 * sum(got) / self.staged_units


class _Loop:
    """The closed loop over units, shared by the window's phases."""

    def __init__(self, unit, sync, keep_p: float, keep_max: int, seed: int):
        self.unit, self.sync = unit, sync
        self.keep_p, self.keep_max, self.seed = keep_p, keep_max, seed
        self.i = 0
        self.attempted = self.failed = self.rows = 0
        self.latencies: list = []
        self.kept: list = []
        self.last = None

    def run(self, seconds: float, around=nullcontext, span=no_span) -> "tuple[int, float]":
        """Run units for at least *seconds*; returns (units, seconds)."""
        n0, t_start = self.attempted, time.perf_counter()
        while True:
            drawn = self.unit.draw(self.i)
            t0 = time.perf_counter()
            try:
                with around():
                    out = self.unit.run(drawn, span=span)
                    self.sync()
            except Exception:  # a failed unit is counted, and the loop goes on
                self.failed += 1
                if self.failed == 1:
                    log("unit failed:\n" + traceback.format_exc())
                out = None
            t1 = time.perf_counter()
            self.attempted += 1
            if out is not None:
                self.latencies.append(t1 - t0)
                self.rows += self.unit.rows(drawn)
                u = np.random.default_rng([self.seed, 7, self.i]).random()
                if u < self.keep_p and len(self.kept) < self.keep_max:
                    self.kept.append((self.i, drawn, out))
                self.last = (self.i, drawn, out)
            out = None
            self.i += 1
            if t1 - t_start >= seconds:
                return self.attempted - n0, t1 - t_start


class Device:
    """The card (or, in tests, the CPU) a run uses, and the benchmark's
    spans, each ended by a synchronise."""

    def __init__(self, device: str):
        import torch

        self.torch = torch
        self.name = device
        self.cuda = device == "cuda"
        self.card = torch.cuda.get_device_name(0) if self.cuda else "cpu"
        self.spans: dict = {}

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with self.torch.profiler.record_function(f"portbench:{name}"):
            yield
        self.sync()
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)


def set_up(cell: Cell, seed: int, dev: Device, scale: "dict | None" = None):
    """Generate the cell's tables from *seed*, ingest them through the
    public API (the fact table under the ``ingest`` span), build the
    configuration's indexes, and return the traffic's unit kind over
    them.  *scale* replaces table sizes (tests only)."""
    import csvplus_tpu_torch as T

    config = cell.config
    tables = json.loads(json.dumps(config["tables"]))
    for t, over in (scale or {}).items():
        tables[t].update(over)
    ref = importlib.import_module(f"portbench.reference.{config['reference']}")
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        t0 = time.perf_counter()
        data = ref.generate(tmp, tables, seed_word(seed))
        log(f"set-up: generated {config['name']} from seed {seed} in "
            f"{time.perf_counter() - t0:.2f} s")
        sources = {}
        for name, path in data["paths"].items():
            t0 = time.perf_counter()
            with dev.span("ingest") if name == config["fact"] else nullcontext():
                sources[name] = T.from_file(str(path)).on_device(dev.name)
                dev.sync()
            tab = sources[name].plan.table
            log(f"set-up: ingested {name} ({tab.nrows} rows, {path.stat().st_size} bytes) "
                f"in {time.perf_counter() - t0:.2f} s on the {tab.ingest_tier} tier; kinds "
                + ",".join(f"{c}={col.kind}" for c, col in tab.columns.items()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    indexes = {}
    t0 = time.perf_counter()
    for name, spec in config.get("indexes", {}).items():
        indexes[name] = sources[name].unique_index_on(*spec["unique"]).sync()
    dev.sync()
    log(f"set-up: built {len(indexes)} indexes in {time.perf_counter() - t0:.2f} s")
    env = Env(T, config, cell.traffic, data, ref, sources, indexes, seed)
    return load_kind(cell.traffic["unit"])(env)


def _counted(unit, before: dict, units: int) -> str:
    """What the program's watched counters gained since *before*, per
    unit."""
    now = unit.counters()
    return ", ".join(f"{k} {(now[k] - v) / max(units, 1):.3f}" for k, v in before.items()) \
        or "none watched"


def judge(unit, drawn, out) -> dict:
    """The numbers compared for one unit's result: the program's output
    (or, for a control, readings already in the check's terms) against
    the reference."""
    want = unit.expected(drawn)
    if isinstance(out, dict):
        got, n = out, len(next(iter(out.values())))
    else:
        table = unit.output_table(out)
        got, n = check.read_table(table, want) if table is not None else ({}, 0)
    return check.compare_columns(got, n, want)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             scale: "dict | None" = None) -> dict:
    """One run of *cell*; returns the result object.  *scale* replaces
    table sizes (tests only).  The set-up time runs from the process's
    start to the window's."""
    import torch

    from csvplus_tpu_torch.obs.memory import device_peak_bytes
    from csvplus_tpu_torch.obs.span import tracer
    from csvplus_tpu_torch.utils import telemetry

    dev = Device(device)
    cuda, card, sync, span, traffic = dev.cuda, dev.card, dev.sync, dev.span, cell.traffic
    unit = set_up(cell, seed, dev, scale)
    data = unit.env.data

    def first(name: str):
        return span(f"first:{name}")

    # the first warm-up unit's stages are spans of their own ("first:<stage>"):
    # it meets the freshly ingested tables, so it does what only a first
    # unit does (such as sorting a deferred lane dictionary)
    warm, counted = [], unit.counters()
    for w in range(traffic.get("warmup", 1)):
        t0 = time.perf_counter()
        unit.run(unit.draw(w, stream=1), span=first if w == 0 else no_span)
        sync()
        warm.append(time.perf_counter() - t0)
    log(f"set-up: {len(warm)} warm-up units, seconds " + ", ".join(f"{x:.4f}" for x in warm)
        + "; program counters added: " + _counted(unit, counted, 1))
    log(f"set-up: device_peak_bytes (obs.memory) {device_peak_bytes() if cuda else None}")
    est_units = max(1.0, seconds / max(min(warm[-2:]), 1e-6))
    sample = traffic.get("check_sample", 3)
    loop = _Loop(unit, sync, min(1.0, sample / est_units), sample, seed_word(seed))

    run = Run(card, fact_rows=data["n"], facts=unit.facts())
    counted = unit.counters()
    if cuda:  # the peak reported is the window's, set-up's spikes left out
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = process_age()
    busy = None
    if not trace:
        _, run.window_s = loop.run(seconds)
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        from .trace import UNIT, WINDOW, DeviceTrace

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

        @contextmanager
        def traced_unit():
            with record_function(UNIT), tracer.trace("portbench:unit"):
                yield

        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                run.profiled_units, first_half = loop.run(min(seconds / 2, PROFILE_MAX_S),
                                                          around=traced_unit)
        tracer.drain()
        t0 = time.perf_counter()
        run.trace = DeviceTrace(prof)
        del prof
        busy = run.trace.busy_s
        per_unit = run.trace.launches_per_unit()
        log(f"trace: read in {time.perf_counter() - t0:.2f} s; window "
            f"{run.trace.window_s:.4f} s, device busy {busy:.6f} s, {run.profiled_units} "
            f"units; kernel launches per unit: min {min(per_unit, default=0)}, max "
            f"{max(per_unit, default=0)}, counts {sorted(set(per_unit))[:12]}")
        with telemetry.collect():
            run.staged_units, second_half = loop.run(seconds - first_half, span=span)
            run.window_s = first_half + second_half
            run.stages = {r.stage: r.seconds for r in telemetry.merged_stages()}
    sync()
    run.spans = dev.spans
    run.latencies_s, run.rows = loop.latencies, loop.rows
    lat = np.quantile(loop.latencies, [0.05, 0.5, 0.95]) * 1e3 if loop.latencies else []
    log(f"window: {loop.attempted} units ({loop.failed} failed) in {run.window_s:.4f} s; "
        f"unit ms p5 / p50 / p95 {' / '.join(f'{x:.3f}' for x in lat)}; program counters "
        f"added per unit: {_counted(unit, counted, loop.attempted)}")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    log(f"device: {card}; memory peak in the window {peak} bytes")

    # the check: every kept result, and the window's last, against the reference
    t0 = time.perf_counter()
    kept = loop.kept
    if loop.last is not None and loop.last[0] not in {k[0] for k in kept}:
        kept.append(loop.last)
    loop.kept = loop.last = None
    totals = dict.fromkeys(check.LIMITS, 0)
    for i, drawn, out in kept:
        part = judge(unit, drawn, out)
        check.add(totals, part)
        if any(part.values()):
            log(f"check: unit {i} differs from the reference: {part}")
    checked = len(kept)
    kept = out = None
    totals["units_failed"] = loop.failed
    correct = bool(checked >= 1 and all(v == 0 for v in totals.values()))
    log(f"check: {time.perf_counter() - t0:.2f} s")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": correct, "attempted": loop.attempted, "failed": loop.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": card,
                         "count": cell.workload["chips"], "memory_peak_bytes": peak}}
    if trace:
        result["device"].update(busy_s=busy, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {"units_checked": {"value": checked, "at_least": 1},
                        **{k: {"value": v, "at_most": 0} for k, v in totals.items()}}
    return result
