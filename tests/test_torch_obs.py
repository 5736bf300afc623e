"""The port's observability copies (``obs/span.py``, ``obs/flight.py``,
``obs/metrics.py``, ``obs/memory.py``, ``obs/recompile.py``,
``utils/observe.py``) held against the JAX package on the CPU.

* the same traced work builds the same span trees (names, parenting,
  attrs) in both tracers, and the serving tier records each request's
  queue wait and dispatch into the submitter's trace in both;
* the flight recorder's ring and dump equal the reference's, minus
  clocks and pid;
* ``MetricRegistry.render()`` is the reference's text for the same
  instrument updates and collectors; the tail sampler keeps the same
  records;
* the build/load counts count the port's hand-built binaries and a
  warm pass loads none again; device memory reads ``None`` on the CPU."""

import contextlib
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu.columnar.table import DeviceTable as JTable
from csvplus_tpu.obs import flight as j_flight
from csvplus_tpu.obs import metrics as j_metrics
from csvplus_tpu.obs.span import Tracer as JTracer
from csvplus_tpu.obs.span import tracer as j_tracer
from csvplus_tpu.serve import LookupServer as JServer
from csvplus_tpu.utils.observe import Telemetry as JTelemetry
from csvplus_tpu_torch.columnar.table import DeviceTable as TTable
from csvplus_tpu_torch.obs import flight, memory, metrics, recompile
from csvplus_tpu_torch.obs.span import Tracer, tracer
from csvplus_tpu_torch.serve import LookupServer
from csvplus_tpu_torch.utils.observe import Telemetry

KITS = {"port": (Tracer, Telemetry), "ref": (JTracer, JTelemetry)}


@contextlib.contextmanager
def running(srv):
    """Start *srv* and stop it on exit; the port's drain is bounded, so a
    stalled dispatcher fails the test instead of hanging the suite."""
    srv.start()
    try:
        yield srv
    finally:
        if isinstance(srv, LookupServer):
            srv.stop(timeout=30.0)
        else:
            srv.stop()  # the reference's stop takes no bound


def _shape(trace):
    """(name, parent name, attrs) per span, in a stable order."""
    spans = trace.snapshot()
    names = {s.span_id: s.name for s in spans}
    return sorted((s.name, names.get(s.parent_id), json.dumps(s.attrs, sort_keys=True))
                  for s in spans)


def _traced_work(tr, tel):
    with tr.trace("query", kind="plan") as t:
        with tr.span("outer", rows=3) as attrs:
            attrs["note"] = "x"
            with tr.span("inner"):
                pass
        try:
            with tr.span("fails"):
                raise ValueError("boom")
        except ValueError:
            pass
        ctx = tr.capture()

        def worker():
            with tr.adopt(ctx):
                with tr.span("worker", lane=1):
                    pass

        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=10)
        tr.add_span("premeasured", 0.5, chunks=2)
    return t


def test_span_trees_equal_reference():
    got = {side: _shape(_traced_work(tr_cls(), tel_cls()))
           for side, (tr_cls, tel_cls) in KITS.items()}
    assert got["port"] == got["ref"]
    assert ("fails", "query", json.dumps({"error": "ValueError"})) in got["port"]
    assert ("worker", "query", json.dumps({"lane": 1})) in got["port"]


def test_no_active_trace_records_nothing():
    tr = Tracer()
    assert tr.open_span("x") is None and not tr.active()
    with tr.span("y") as attrs:
        assert attrs == {}
    assert tr.finished() == []


def test_stage_shim_opens_spans_in_both_packages():
    """``telemetry.stage`` records its table row and, under a trace, a
    span (the process-global tracer), alike in both packages."""
    from csvplus_tpu.utils.observe import telemetry as j_tel
    from csvplus_tpu_torch.utils.observe import telemetry as t_tel

    out = {}
    for side, tel, tr in (("port", t_tel, tracer), ("ref", j_tel, j_tracer)):
        with tel.collect() as recs:
            with tr.trace("q") as t:
                with tel.stage("Filter", 10) as st:
                    st["rows_out"] = 4
                with tel.stage("skip", 3) as st:
                    st["discard"] = True
            tel.add_stage("serve:dispatch", 2, 2, 0.25, chunks=1)
            tel.count("serve.dispatched", 2)
        out[side] = ([(r.stage, r.rows_in, r.rows_out) for r in recs], _shape(t),
                     tel.to_json()["counters"],
                     [(r.stage, r.rows_in) for r in tel.merged_stages()])
    assert out["port"] == out["ref"]


def _serve_trees(pkg, table_cls, server_cls, tr):
    ids = np.arange(200) * 7
    t = table_cls.from_pylists({"id": [f"c{i}" for i in ids],
                                "v": [str(i) for i in range(200)]}, device="cpu")
    idx = pkg.take(t).index_on("id")
    with running(server_cls(idx)) as srv:
        with tr.trace("client") as trace:
            srv.submit("c7").result(timeout=30)
    return trace


def test_serve_request_span_trees_equal_reference():
    got = _shape(_serve_trees(T, TTable, LookupServer, tracer))
    ref = _shape(_serve_trees(J, JTable, JServer, j_tracer))
    assert [g[:2] for g in got] == [r[:2] for r in ref]
    names = [g[0] for g in got]
    for n in ("serve:queue-wait", "serve:dispatch", "serve:bounds", "serve:gather-decode"):
        assert n in names


def _flight_payload(mod, tmp_path, sub):
    rec = mod.FlightRecorder(capacity=4)
    for i in range(6):
        rec.note("serve:cycle", batch=i, ok=i)
    rec.attach("ctx", lambda: {"k": 1})
    rec.attach("broken", lambda: 1 / 0)
    path = rec.dump("unit", RuntimeError("why"), dir=str(tmp_path / sub))
    with open(path) as f:
        payload = json.load(f)
    for ev in payload["events"]:
        ev.pop("ts")
        ev.pop("mono")
    payload.pop("ts")
    payload.pop("pid")
    return payload, rec.snapshot()


def test_flight_recorder_equals_reference(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    got = _flight_payload(flight, tmp_path, "a")
    ref = _flight_payload(j_flight, tmp_path, "b")
    assert got == ref
    payload, snap = got
    assert [e["batch"] for e in payload["events"]] == [2, 3, 4, 5]  # bounded ring
    assert payload["context"]["broken"]["error"].startswith("ZeroDivisionError")
    assert snap["dumps"] == 1


def _registry(mod):
    reg = mod.MetricRegistry()
    c = reg.counter("csvplus_test_requests_total", 'requests "served"')
    c.inc(3)
    g = reg.gauge("csvplus_test_depth", "queue depth")
    g.set(7)
    g.add(-2.5)
    h = reg.histogram("csvplus_test_seconds", "latency", start=1e-3, factor=2.0, count=6)
    h.observe_many([0.0005, 0.003, 0.02, 0.5, 9.0])
    reg.register_collector(lambda: [mod.Sample("csvplus_test_coll", "gauge",
                                               (("index", 'a"b'),), 1.5)], "coll")
    reg.register_collector(lambda: 1 / 0, "broken")
    return reg


def test_registry_render_equals_reference():
    got, ref = _registry(metrics).render(), _registry(j_metrics).render()
    assert got == ref
    assert "# TYPE csvplus_test_seconds histogram" in got
    assert _registry(metrics).sample_dict() == _registry(j_metrics).sample_dict()


def _scrape(port, path="/metrics"):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode("utf-8")


def test_scrape_endpoint_and_pump_equal_reference(tmp_path):
    """The opt-in transports on the same updates: one localhost scrape of
    each package's endpoint returns its ``render()`` text, equal across
    packages, and one pump tick writes a JSONL row of ``sample_dict()``."""
    out = {}
    for side, mod in (("port", metrics), ("ref", j_metrics)):
        reg = _registry(mod)
        http = mod.PromHttpEndpoint(reg)
        port = http.start()
        ticked = []
        pump = mod.MetricsPump(_registry(mod), str(tmp_path / side), interval_s=3600.0,
                               on_tick=lambda: ticked.append(1))
        try:
            body = _scrape(port)
            with pytest.raises(urllib.error.HTTPError):
                _scrape(port, "/nope")
            pump.tick()
        finally:
            http.stop()
            pump.stop()
        with open(pump.path) as f:
            rows = [json.loads(line) for line in f]
        # each read counts the broken collector once more: the scrape and
        # the tick are each the first read of their registry
        assert body == _registry(mod).render()
        assert len(rows) == 1 and ticked == [1] and pump.ticks == 1
        assert rows[0]["series"] == _registry(mod).sample_dict()
        out[side] = (body, rows[0]["series"])
    assert out["port"] == out["ref"]


def test_plane_transports_start_and_close(tmp_path):
    """``TelemetryPlane.serve_http`` and ``start_pump`` start once (a second
    call returns the same port and pump), the pump's thread ticks with the
    RSS gauge sampled, and ``close`` stops both."""
    plane = metrics.TelemetryPlane()
    try:
        port = plane.serve_http()
        assert plane.serve_http() == port
        assert "csvplus_process_rss_mb" in _scrape(port)
        pump = plane.start_pump(str(tmp_path), interval_s=0.01)
        assert plane.start_pump(str(tmp_path)) is pump
        deadline = time.perf_counter() + 30.0
        while pump.ticks == 0 and time.perf_counter() < deadline:
            time.sleep(0.005)
        assert pump.ticks >= 1
    finally:
        plane.close()
    with open(pump.path) as f:
        row = json.loads(f.readline())
    assert row["series"]["csvplus_process_rss_mb"] > 0
    with pytest.raises(OSError):
        _scrape(port)


def test_serve_samples_equal_reference():
    snap = {"ticks": 3, "enqueued": 5, "completed": 5, "latency": {"p50_ms": 1.0, "p99_ms": 2.0},
            "by_index": {"default": {"lookups": 5, "last_compact_ms": None}},
            "plancache": {"hits": 1, "size": 2}}
    assert metrics.serve_samples(snap) == [tuple(s) for s in j_metrics.serve_samples(snap)]


def test_tail_sampler_equals_reference():
    fast = [(0.001, 0.0, "ok", "lookup", "default", None)] * 300
    odd = [(0.001, 0.0, "failed", "lookup", "default", "ValueError"),
           (0.001, 0.0, "expired", "lookup", "default", None),
           (5.0, 0.0, "ok", "lookup", "default", None)]
    out = {}
    for side, mod in (("port", metrics), ("ref", j_metrics)):
        tail = mod.TailSampler(capacity=8, window=64, recompute=16)
        tail.offer_batch(fast)
        tail.offer_batch(odd)
        snap = tail.snapshot()
        for rec in snap["records"]:
            rec.pop("t", None)
            rec.pop("ts", None)
        out[side] = snap
    assert out["port"] == out["ref"]
    assert out["port"]["kept_error"] == 1 and out["port"]["kept_expired"] == 1


def test_plane_scrape_carries_serve_and_binary_series():
    ids = np.arange(100) * 3
    t = TTable.from_pylists({"id": [f"c{i}" for i in ids], "v": [str(i) for i in range(100)]},
                            device="cpu")
    idx = T.take(t).index_on("id")
    with running(LookupServer(idx)) as srv:
        for f in [srv.submit(f"c{i}") for i in ids[:20]]:
            f.result(timeout=30)
        text = srv.plane.registry.render()
    assert "csvplus_serve_completed_total 20" in text
    assert "csvplus_serve_cycles_total" in text
    assert 'csvplus_skew_observed_total{index="default",side="probe"} 20' in text
    assert 'csvplus_binary_loads{binary="mask.cu"}' in text
    assert "csvplus_compile_cache_size" not in text


def test_binary_load_counts_and_recompile_watch(tmp_path):
    """Each hand-built binary is counted once per load; a warm pass of
    the main path loads nothing again."""
    from csvplus_tpu_torch.native import scanner

    counts = recompile.compile_counts()
    assert set(counts) >= {"mask.cu", "scanner.cpp"}
    scanner._load()
    loaded = recompile.compile_counts()["scanner.cpp"]
    assert loaded >= 1
    p = tmp_path / "o.csv"
    p.write_text("k,v\n" + "".join(f"k{i % 5},{i}\n" for i in range(50)))
    src = T.from_file(str(p)).on_device("cpu")
    with recompile.RecompileWatch() as w:
        src.filter(T.Like({"k": "k1"})).to_rows()
        T.from_file(str(p)).on_device("cpu").to_rows()
    w.assert_zero()
    assert recompile.compile_counts()["scanner.cpp"] == loaded
    assert w.observable()


def test_memory_probes():
    assert memory.rss_mb() > 0 and memory.peak_rss_mb() > 0
    assert memory.device_peak_bytes("cpu") is None
    head = memory.host_header()
    assert head["host_cpus"] >= 1 and set(head) == {"host_cpus", "device_count", "platform"}
    attrs = {}
    with memory.watch_memory(attrs, interval_s=0.005):
        _ = bytearray(8 << 20)
    assert attrs["rss_peak_mb"] >= attrs["rss_start_mb"] > 0


@pytest.mark.parametrize("side", ["port", "ref"])
def test_telemetry_report_shape(side):
    tel = KITS[side][1]()
    with tel.collect():
        with tel.stage("Join", 5) as st:
            st["rows_out"] = 2
        tel.count_sync(4)
    js = tel.to_json()
    assert js["host_sync_elements"] == 4 and js["stage_table"][0]["stage"] == "Join"
    assert "host_sync_elements: 4" in tel.report()
