"""The port's trace exporters and regression differs
(``csvplus_tpu_torch/obs/export.py``, ``diff.py`` and the ``obs`` CLI)
held against the JAX package's on the CPU: the port's Chrome trace of a
traced run validates and has the reference's event schema; the stage
and bench diffs of the committed artifacts give the reference's results
and reports; the CLI's output and exit codes (0, 1 on load or shape
errors, 2 with ``--fail-on-flag``) match; the span JSON-lines sink
drains as the reference's does."""

import importlib
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Pkg:
    def __init__(self, name):
        self.name = name
        self.obs = importlib.import_module(f"{name}.obs")
        self.export = importlib.import_module(f"{name}.obs.export")
        self.diff = importlib.import_module(f"{name}.obs.diff")
        self.cli = importlib.import_module(f"{name}.obs.__main__")
        self.tracer = importlib.import_module(f"{name}.obs.span").tracer
        self.telemetry = importlib.import_module(f"{name}.utils.observe").telemetry
        self.SpaceSaving = importlib.import_module(f"{name}.obs.sketch").SpaceSaving


TP = _Pkg("csvplus_tpu_torch")
JP = _Pkg("csvplus_tpu")
PKGS = (TP, JP)


@pytest.fixture(autouse=True)
def _fresh_tracers():
    for p in PKGS:
        p.tracer.reset()
    yield
    for p in PKGS:
        p.tracer.reset()


def _traced_run(pkg, **attrs):
    with pkg.tracer.trace("run"):
        with pkg.tracer.span("a", rows=3, **attrs):
            with pkg.tracer.span("b"):
                pass
        pkg.telemetry.add_stage("lane-work", 10, 10, 0.01)
    return pkg.tracer.finished()


def _schema(events):
    """Per event: its phase, name, key set and the key set of its args
    (ids and times aside, which differ run to run)."""
    return [(e["ph"], e["name"], sorted(e), sorted(e.get("args", {})), e.get("cat"))
            for e in events]


def test_chrome_trace_export_validates_with_the_references_schema(tmp_path):
    got = {}
    for p in PKGS:
        traces = _traced_run(p, note=object())  # a non-JSON attr goes out as its repr
        path = p.export.export_chrome_trace(str(tmp_path / p.name), traces)
        assert os.path.basename(path) == f"csvplus_host_trace.{os.getpid()}.json"
        with open(path) as f:
            obj = json.load(f)
        assert p.export.validate_chrome_trace(obj) == []
        assert sorted(obj) == ["displayTimeUnit", "metadata", "traceEvents"]
        got[p.name] = obj
    tp, jp = got["csvplus_tpu_torch"], got["csvplus_tpu"]
    assert _schema(tp["traceEvents"]) == _schema(jp["traceEvents"])
    assert tp["metadata"] == {"producer": "csvplus_tpu_torch.obs"}
    x = [e for e in tp["traceEvents"] if e["ph"] == "X"]
    a = next(e for e in x if e["name"] == "a")
    b = next(e for e in x if e["name"] == "b")
    assert b["args"]["parent_id"] == a["args"]["span_id"]
    assert a["args"]["rows"] == 3 and a["args"]["note"].startswith("<object")
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in x)


def test_exported_span_lines_up_with_the_profilers_range(tmp_path):
    """A span and its ``record_function`` range, opened around the same
    region, start within a millisecond of each other: the span exported
    by ``export_chrome_trace``, the range by ``profile_to``'s Chrome
    trace of the same run, so both open on one time axis."""
    import time

    from csvplus_tpu_torch.utils.observe import profile_to

    d = tmp_path / "prof"
    with profile_to(str(d), device="cpu"):
        for _ in range(2):  # the first round's range opens cold
            TP.tracer.reset()
            with TP.tracer.trace("region"):
                time.sleep(0.005)
    (prof_file,) = os.listdir(d)
    with open(d / prof_file) as f:
        ranges = [e for e in json.load(f)["traceEvents"] if e.get("name") == "csvplus:region"]
    with open(TP.export.export_chrome_trace(str(d))) as f:
        (span,) = [e for e in json.load(f)["traceEvents"] if e.get("name") == "region"]
    assert len(ranges) == 2
    assert abs(span["ts"] - ranges[-1]["ts"]) < 1000.0  # microseconds
    assert abs(span["dur"] - ranges[-1]["dur"]) < 1000.0


def test_the_assumed_trace_base_is_the_profilers(tmp_path):
    """With no profiler trace to read, the exporter assumes libkineto's
    base (the start of the current 7,889,238 s interval); a capture's
    own ``baseTimeNanoseconds`` is that base, and it is what the
    exporter reads from a directory that holds the capture."""
    from csvplus_tpu_torch.utils.observe import profile_to

    d = tmp_path / "prof"
    assert TP.export.profiler_base_ns(str(d)) is None
    with profile_to(str(d), device="cpu"):
        pass
    (prof_file,) = os.listdir(d)
    with open(d / prof_file) as f:
        base = json.load(f)["baseTimeNanoseconds"]
    assert TP.export.profiler_base_ns(str(d)) == base
    assumed = TP.export.profiler_axis_us()
    read = TP.export.profiler_axis_us(base)
    assert abs(assumed - read) < 1000.0  # the same axis, bar the clock read


def test_validator_findings_equal_the_references():
    cases = [
        {"nope": 1},
        42,
        [{"ph": "X", "ts": 0, "pid": 1, "tid": 1, "dur": 1},
         {"name": "n", "ph": "X", "ts": 0, "pid": 1, "tid": 1},
         {"name": "n", "ph": "X", "ts": -5, "pid": 1, "tid": 1, "dur": 1},
         {"name": "n", "ph": "M", "pid": 1, "tid": 1},
         {"name": "n", "ph": 3, "pid": 1, "tid": 1},
         "not an event"],
        [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0, "args": {}},
         {"name": "s", "ph": "X", "ts": 0.0, "dur": 1.0, "pid": 1, "tid": 1}],
    ]
    for case in cases:
        assert TP.export.validate_chrome_trace(case) == JP.export.validate_chrome_trace(case)
    assert len(TP.export.validate_chrome_trace(cases[2])) == 6
    assert TP.export.chrome_trace_events([]) == []


def test_spans_jsonl_and_sink_match_the_reference(tmp_path):
    shapes = []
    for p in PKGS:
        _traced_run(p)
        rows = p.export.spans_to_json()
        path = p.export.write_spans_jsonl(str(tmp_path / f"{p.name}.jsonl"))
        assert [json.loads(line) for line in open(path)] == rows
        sink = p.export.SpanJsonlSink(str(tmp_path / f"{p.name}.sink.jsonl"))
        assert sink.flush() == 4
        assert sink.flush() == 0
        with p.tracer.trace("two"):
            with p.tracer.span("child"):
                pass
        assert sink.flush() == 2 and sink.written == 6
        assert p.tracer.finished() == []
        shapes.append([(r["name"], sorted(r)) for r in rows])
    assert shapes[0] == shapes[1]


ARTIFACT_PAIRS = [
    ("NORTHSTAR_MESH_r05.json", "NORTHSTAR_MESH_r06.json"),
    ("BENCH_WAL_r11.json", "BENCH_WAL_r12.json"),
    ("BENCH_DELTA_r10.json", "BENCH_VIEW_r13.json"),
]


@pytest.mark.parametrize("a,b", ARTIFACT_PAIRS, ids=lambda s: s)
def test_committed_artifact_diffs_equal_the_references(a, b):
    pa, pb = os.path.join(REPO, a), os.path.join(REPO, b)
    bench = [p.diff.diff_bench_files(pa, pb) for p in PKGS]
    assert bench[0] == bench[1]
    assert TP.diff.format_bench_diff(bench[0], a, b) == JP.diff.format_bench_diff(bench[1], a, b)
    for th in (1.2, 3.0):
        assert (TP.diff.diff_bench_files(pa, pb, threshold=th)
                == JP.diff.diff_bench_files(pa, pb, threshold=th))
    stages = []
    for p in PKGS:
        try:
            stages.append(p.diff.diff_files(pa, pb))
        except ValueError as e:
            stages.append(("ValueError", str(e)))
    assert stages[0] == stages[1]
    if a.startswith("NORTHSTAR"):
        flagged = {r["stage"] for r in stages[0]["flagged"]}
        assert flagged == {"join:translate", "join:pack"}
        assert (TP.diff.format_diff(stages[0], a, b) == JP.diff.format_diff(stages[1], a, b))
        for kw in ({"threshold": 4.0}, {"min_share": 0.0}, {"key": "stage_table"}):
            assert TP.diff.diff_files(pa, pb, **kw) == JP.diff.diff_files(pa, pb, **kw)


def test_stage_table_diff_rules_equal_the_references():
    a = [{"stage": "big", "rows_in": 1000, "seconds": 1.0},
         {"stage": "fast", "rows_in": 1000, "seconds": 0.30},
         {"stage": "tiny", "rows_in": 1000, "seconds": 0.001},
         {"stage": "gone", "rows_in": 10, "seconds": 0.01},
         {"stage": "rss", "rows_in": 10, "seconds": 0.2, "rss_peak_mb": 100}]
    b = [{"stage": "big", "rows_in": 1000, "seconds": 1.0},
         {"stage": "fast", "rows_in": 1000, "seconds": 0.90},
         {"stage": "tiny", "rows_in": 1000, "seconds": 0.008},
         {"stage": "new", "rows_in": 10, "seconds": 0.01},
         {"stage": "rss", "rows_in": 10, "seconds": 0.2, "rss_peak_mb": 500}]
    for kw in ({}, {"min_share": 0.0}, {"threshold": 4.0}):
        got = TP.diff.diff_stage_tables(a, b, **kw)
        assert got == JP.diff.diff_stage_tables(a, b, **kw)
    r = TP.diff.diff_stage_tables(a, b)
    assert {x["stage"] for x in r["flagged"]} == {"fast", "rss"}
    assert TP.diff.flatten_numeric({"a": [1, {"b": 2.5}], "c": True}) == {"a[0]": 1.0,
                                                                         "a[1].b": 2.5}


def _cli(pkg, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = pkg.cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_obs_cli_output_and_exit_codes_equal_the_references(tmp_path):
    a = tmp_path / "a.json"
    b = tmp_path / "b.json"
    a.write_text(json.dumps({"stage_table": [{"stage": "s", "rows_in": 10, "seconds": 1.0}]}))
    b.write_text(json.dumps({"stage_table": [{"stage": "s", "rows_in": 10, "seconds": 5.0}]}))
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    skew = tmp_path / "skew.json"
    sk = TP.SpaceSaving(4)
    sk.offer_counts(["k1", "k2", "k3"], [90, 7, 3])
    skew.write_text(json.dumps({"skew": {"build": {"orders": sk.snapshot()}}}))
    mesh = [os.path.join(REPO, f) for f in ARTIFACT_PAIRS[0]]
    wal = [os.path.join(REPO, f) for f in ARTIFACT_PAIRS[1]]
    cases = [
        (["diff", str(a), str(b), "--json"], 0),
        (["diff", str(a), str(b)], 0),
        (["diff", str(a), str(b), "--fail-on-flag"], 2),
        (["diff", str(a), str(tmp_path / "missing.json")], 1),
        (["diff", str(a), str(bad)], 1),
        (["diff", str(a), str(bad), "--mode", "stages"], 1),
        (["diff", *mesh], 0),
        (["diff", *mesh, "--fail-on-flag", "--threshold", "100"], 0),
        (["diff", *mesh, "--fail-on-flag"], 2),
        (["diff", *wal, "--mode", "bench", "--json"], 0),
        (["diff", *wal, "--fail-on-flag"], 2),
        (["skew", str(skew)], 0),
        (["skew", str(skew), "--json", "--side", "build"], 0),
        (["skew", str(skew), "--side", "probe"], 1),
        (["skew", str(bad)], 1),
    ]
    for argv, rc in cases:
        got = _cli(TP, argv)
        want = _cli(JP, argv)
        assert got[0] == want[0] == rc, argv
        assert got[1] == want[1], argv
        assert got[2].replace("csvplus_tpu_torch", "csvplus_tpu") == want[2], argv


def test_obs_cli_runs_as_a_module(tmp_path):
    mesh = [os.path.join(REPO, f) for f in ARTIFACT_PAIRS[0]]
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "csvplus_tpu_torch.obs", "diff", *mesh,
                          "--fail-on-flag"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 2, res.stderr
    assert "flagged: join:pack" in res.stdout


def test_obs_package_re_exports_the_references_names_it_has():
    assert set(TP.obs.__all__) == set(JP.obs.__all__)
    for name in TP.obs.__all__:
        assert getattr(TP.obs, name) is not None
