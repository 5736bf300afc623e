"""The port's per-stage telemetry held against the JAX package's on the
CPU: under ``telemetry.collect()`` both packages must record the same
``(stage, rows_in, rows_out)`` sequence for the plain 3-table join, a
fused plan through ``PlanCache`` and a streamed ingest (1 MiB chunks,
K = 1 and 2); the same ``verify.*`` counters; the same recoveries after
a crash at the ``ingest:worker`` fault site, with byte-identical tables;
and the same error type from ``ingest:read``.  The port's own host syncs
(``host_sync_elements``) are pinned against the reference's: the port
counts the build sample as the reference does, plus the probe-stats and
compaction transfers the reference leaves uncounted.  ``barrier`` is a
strict no-op with collection off, and ``profile_to`` writes a trace on
the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu.resilience import faults as j_faults
from csvplus_tpu.serve import PlanCache as JCache
from csvplus_tpu.utils.checksum import checksum_device_table as j_checksum
from csvplus_tpu.utils.observe import telemetry as j_tel
from csvplus_tpu_torch.resilience import faults as t_faults
from csvplus_tpu_torch.serve import PlanCache as TCache
from csvplus_tpu_torch.utils.checksum import checksum_device_table as t_checksum
from csvplus_tpu_torch.utils.observe import Telemetry, telemetry as t_tel
from test_torch_rewrite import KITS, fact, fresh_sketches, fused_shape  # noqa: F401

PKGS = {"ref": (J, j_tel), "port": (T, t_tel)}


@pytest.fixture(autouse=True)
def _disarmed():
    """Fault injection disarmed before and after every test, in both."""
    t_faults.deactivate()
    j_faults.deactivate()
    yield
    t_faults.deactivate()
    j_faults.deactivate()


def _seq(tel):
    return [(r.stage, r.rows_in, r.rows_out) for r in tel.records]


def _collect(fn):
    """{side: (stage sequence, counters, host-sync elements, result)}."""
    out = {}
    for side, (pkg, tel) in PKGS.items():
        with tel.collect():
            res = fn(pkg)
            out[side] = (_seq(tel), dict(tel.counters), tel.host_sync_elements, res)
            out[f"{side}_records"] = list(tel.records)
    return out


def _port_extra_syncs(records):
    """The host-sync elements the port counts beyond the reference's, per
    ``join:expand`` record: the binary join's (total, max) transfer (2),
    the multiway and fused paths' (total, max, avoided) transfer (3),
    and the unique-partial compaction's size (1)."""
    extra = 0
    for r in records:
        if r.stage == "join:expand":
            extra += 3 if "dims" in r.extra else 2
            extra += r.extra["path"].endswith("unique-partial")
    return extra


def _join_3(pkg, corpus, pred):
    cust = pkg.from_file(corpus["people_csv"]).on_device("cpu").unique_index_on("id")
    prod = pkg.from_file(corpus["stock_csv"]).on_device("cpu").unique_index_on("prod_id")
    src = pkg.from_file(corpus["orders_csv"]).on_device("cpu").filter(pred(pkg))
    return src.join(cust, "cust_id").join(prod).to_rows()


PREDS = {
    # every kept order matches one customer and one product
    "like-2col": lambda pkg: pkg.Like({"prod_id": "3", "qty": "7"}),
    # an IN-list over prod_id
    "any-inlist": lambda pkg: pkg.Any(*[pkg.Like({"prod_id": str(p)}) for p in (1, 2, 5)]),
}


@pytest.mark.parametrize("pred", sorted(PREDS))
def test_plain_three_table_join_stages_match_reference(corpus, pred):
    got = _collect(lambda pkg: _join_3(pkg, corpus, PREDS[pred]))
    (ref_seq, ref_ctr, ref_sync, ref_rows), (seq, ctr, sync, rows) = got["ref"], got["port"]
    assert rows == ref_rows
    assert seq == ref_seq
    stages = [s for s, _, _ in seq]
    for name in ("ingest:native-encoded", "Filter", "Join", "join:translate", "join:pack",
                 "join:probe", "join:expand", "join:merge"):
        assert name in stages
    # the verifier ran on every plan and published the same counters
    assert ctr == ref_ctr and ctr["verify.plans"] >= 1
    # host syncs: the reference counts only the build samples; the port
    # also counts each join's own transfers
    assert ref_sync > 0
    assert sync == ref_sync + _port_extra_syncs(got["port_records"])


def test_fused_plan_stages_match_reference():
    out = {}
    for side, (pkg, tel) in PKGS.items():
        k = KITS[side]
        cache = (JCache if side == "ref" else TCache)()
        plan = fused_shape(k, fact(k))
        with tel.collect():
            t = cache.execute(plan)
            out[side] = (_seq(tel), dict(tel.counters), tel.host_sync_elements, t, cache.stats(),
                         list(tel.records))
    (ref_seq, ref_ctr, ref_sync, ref_t, ref_st, _), (seq, ctr, sync, t, st, recs) = (
        out["ref"], out["port"])
    assert st["fused_chains"] == ref_st["fused_chains"] == 1
    assert t_checksum(t) == j_checksum(ref_t)
    assert seq == ref_seq
    assert [s for s, _, _ in seq][-1] == "FusedProbe"
    assert ctr == ref_ctr and ctr["verify.plans"] >= 1
    assert sync == ref_sync + _port_extra_syncs(recs)


@pytest.fixture()
def stream_env(monkeypatch):
    monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")
    monkeypatch.setenv("CSVPLUS_STREAM_CHUNK_BYTES", str(1 << 20))


def _orders_file(tmp_path, n=120_000, seed=5):
    rng = np.random.default_rng(seed)
    cust = rng.integers(0, 5000, n)
    qty = rng.integers(1, 101, n)
    lines = [f"o{i:08d},c{c},{q},{i}\n" for i, (c, q) in enumerate(zip(cust.tolist(),
                                                                         qty.tolist()))]
    p = tmp_path / "orders.csv"
    p.write_text("order_id,cust_id,qty,ts\n" + "".join(lines))
    return str(p)


@pytest.mark.parametrize("workers", [1, 2])
def test_streamed_ingest_stages_match_reference(tmp_path, stream_env, monkeypatch, workers):
    monkeypatch.setenv("CSVPLUS_INGEST_WORKERS", str(workers))
    path = _orders_file(tmp_path)
    got = _collect(lambda pkg: pkg.from_file(path).on_device("cpu").plan.table)
    (ref_seq, _, _, ref_t), (seq, _, _, t) = got["ref"], got["port"]
    assert t.ingest_tier == "streamed" and t_checksum(t) == j_checksum(ref_t)
    assert seq == ref_seq
    want = ["ingest:cut", "ingest:encode", "ingest:scan", "ingest:place", "ingest:streamed"]
    if workers > 1:
        want.insert(2, "ingest:reorder-stall")
    assert [s for s, _, _ in seq] == want
    assert seq[-1] == ("ingest:streamed", 0, 120_000)
    # the place record carries the table's own accounting
    rec = {r.stage: r for r in t_tel.records}
    assert rec["ingest:place"].seconds == t.ingest_seconds["place"]
    assert rec["ingest:scan"].seconds == t.ingest_seconds["scan_wait"]
    assert rec["ingest:encode"].extra["workers"] == workers
    assert set(rec["ingest:place"].extra) == {"upload_s", "narrow_s", "union_s", "lanes_s"}


def test_lane_sort_and_demote_stages_match_reference(tmp_path, stream_env, monkeypatch):
    """An index on a lane column records the deferred lane sort; an index
    on a typed column records its demotion, in both packages."""
    monkeypatch.setenv("CSVPLUS_DICT_DEVICE_MIN_DISTINCT", "1000")
    path = _orders_file(tmp_path)  # three chunks: the lane union is deferred

    def run(pkg):
        src = pkg.from_file(path).on_device("cpu")
        return len(src.index_on("order_id")), len(src.index_on("cust_id"))

    got = _collect(run)
    assert got["port"][0] == got["ref"][0]
    stages = [s for s, _, _ in got["port"][0]]
    # the deferred sort's rows are the concatenated chunk dictionaries
    assert ("lane-dict:deferred-sort", 120_000, 120_000) in got["port"][0]
    assert "typed:demote" in stages


@pytest.mark.parametrize("workers", [1, 2])
def test_worker_crash_recovers_identically(tmp_path, stream_env, monkeypatch, workers):
    monkeypatch.setenv("CSVPLUS_INGEST_WORKERS", str(workers))
    path = _orders_file(tmp_path)
    spec = [{"site": "ingest:worker", "at": [0, 2], "error": "crash"}]
    out = {}
    for side, (pkg, tel) in PKGS.items():
        fmod = j_faults if side == "ref" else t_faults
        with tel.collect(), fmod.active(fmod.FaultPlan(spec, seed=3)):
            t = pkg.from_file(path).on_device("cpu").plan.table
            out[side] = (t, tel.counters.get("ingest.worker_recovered", 0))
    clean = T.from_file(path).on_device("cpu").plan.table
    assert out["port"][1] == out["ref"][1] == 2
    assert t_checksum(out["port"][0]) == j_checksum(out["ref"][0]) == t_checksum(clean)
    assert out["port"][0].to_rows() == clean.to_rows()


def test_worker_crash_past_the_retries_raises(tmp_path, stream_env, monkeypatch):
    monkeypatch.setenv("CSVPLUS_INGEST_WORKERS", "1")
    path = _orders_file(tmp_path)
    spec = [{"site": "ingest:worker", "every": 1, "error": "crash"}]
    errs = []
    for side, (pkg, _) in PKGS.items():
        fmod = j_faults if side == "ref" else t_faults
        with fmod.active(fmod.FaultPlan(spec, seed=3)):
            with pytest.raises(Exception) as ei:
                pkg.from_file(path).on_device("cpu")
        errs.append(type(ei.value).__name__)
    assert errs[0] == errs[1] == "InjectedWorkerCrash"


def test_read_fault_raises_the_same_error(tmp_path, stream_env):
    path = _orders_file(tmp_path)
    spec = [{"site": "ingest:read", "at": [2], "error": "io"}]
    errs = []
    for side, (pkg, _) in PKGS.items():
        fmod = j_faults if side == "ref" else t_faults
        with fmod.active(fmod.FaultPlan(spec, seed=1)):
            with pytest.raises(Exception) as ei:
                pkg.from_file(path).on_device("cpu")
        errs.append((type(ei.value).__name__, str(ei.value), getattr(ei.value, "line", None)))
    assert errs[0] == errs[1]
    assert errs[1][0] == "DataSourceError" and errs[1][2] > 1


def test_barrier_is_a_no_op_when_not_collecting(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(a))
    tel = Telemetry()
    x = torch.arange(8)
    assert tel.barrier(x) is x
    assert tel.barrier((x, None)) == (x, None)
    assert calls == []
    # collecting over CPU tensors: nothing to wait for either
    with tel.collect():
        tel.barrier((x, None))
        tel.barrier(None)
    assert calls == []


def test_join_with_telemetry_off_records_nothing(corpus, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(a))
    t_tel.reset()
    rows = _join_3(T, corpus, PREDS["like-2col"])
    assert rows and t_tel.records == [] and t_tel.host_sync_elements == 0
    assert t_tel.counters == {} and calls == []


def test_stage_table_merges_and_serializes(corpus):
    with t_tel.collect():
        _join_3(T, corpus, PREDS["like-2col"])
        merged = t_tel.merged_stages()
        snap = t_tel.to_json()
        report = t_tel.report()
    names = [r.stage for r in merged]
    assert len(names) == len(set(names))
    expand = [r for r in t_tel.records if r.stage == "join:expand"]
    m = next(r for r in merged if r.stage == "join:expand")
    assert m.rows_in == sum(r.rows_in for r in expand)
    assert {r["stage"] for r in snap["stage_table"]} == set(names)
    json.dumps(snap)
    assert "join:merge" in report and "host_sync_elements" in report


def test_profile_to_writes_a_trace_on_the_cpu(tmp_path, corpus):
    d = tmp_path / "prof"
    with T.profile_to(str(d), device="cpu"):
        with t_tel.collect():
            _join_3(T, corpus, PREDS["like-2col"])
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.loads((d / files[0]).read_text())
    names = {e.get("name") for e in trace.get("traceEvents", [])}
    # the stages appear as named ranges inside the trace
    assert "csvplus:join:probe" in names


def test_profile_to_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with T.profile_to(str(tmp_path)):
            pass
