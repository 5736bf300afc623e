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

import contextlib
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu.resilience import faults as j_faults
from csvplus_tpu.serve import PlanCache as JCache
from csvplus_tpu.utils.checksum import checksum_device_table as j_checksum
from csvplus_tpu.utils.observe import telemetry as j_tel
from csvplus_tpu_torch.obs.span import tracer
from csvplus_tpu_torch.resilience import faults as t_faults
from csvplus_tpu_torch.serve import PlanCache as TCache
from csvplus_tpu_torch.utils.checksum import checksum_device_table as t_checksum
from csvplus_tpu_torch.utils.observe import StageRecord, Telemetry, telemetry as t_tel
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


def _seq(records):
    return [(r.stage, r.rows_in, r.rows_out) for r in records]


def _collect(fn):
    """{side: (stage sequence, counters, host-sync elements, result)};
    the port's sequence as :func:`reference_view` gives it, its whole
    record list under ``port_records``."""
    out = {}
    for side, (pkg, tel) in PKGS.items():
        with tel.collect():
            res = fn(pkg)
            recs = list(tel.records)
            seen = recs if side == "ref" else reference_view(recs)
            out[side] = (_seq(seen), dict(tel.counters), tel.host_sync_elements, res)
            out[f"{side}_records"] = recs
    return out


#: What the port records and the reference does not: the stages of the
#: index build and of the policy dedup, and the host-memory counts on the
#: stages that do the work.  Parity tests drop them with
#: :func:`reference_view` and assert them with :func:`port_only_stages`.
PORT_ONLY_STAGES = frozenset(
    {"index:sort", "index:pack", "dedup:run-starts", "dedup:select", "dedup:gather"}
)
PORT_ONLY_EXTRAS = frozenset({"host_entries", "device_entries", "h2d_bytes", "d2h_bytes",
                              "device_rows"})


def reference_view(records):
    """*records* as the reference records them: the port-only stages left
    out, the port-only extras dropped from the rest."""
    return [StageRecord(r.stage, r.rows_in, r.rows_out, r.seconds,
                        {k: v for k, v in r.extra.items() if k not in PORT_ONLY_EXTRAS})
            for r in records if r.stage not in PORT_ONLY_STAGES]


def port_only_stages(records) -> list:
    """Checks every port-only item of *records* and returns the port-only
    stages' names in order: each index stage passes its rows through;
    the run-starts copy nothing down, the selection compacts every row's
    flag on the device and reads back one 8-byte count, the gather keeps
    what the selection kept; every translation
    counts its host entries and uploaded bytes, a string probe its
    device entries too, and only it."""
    kept = None
    for r in records:
        extras = set(r.extra) & PORT_ONLY_EXTRAS
        if r.stage in ("index:sort", "index:pack"):
            assert r.rows_out == r.rows_in and not r.extra, r
        elif r.stage == "dedup:run-starts":
            assert r.extra == {"d2h_bytes": 0}, r
        elif r.stage == "dedup:select":
            kept = r.rows_out
            assert r.extra == {"d2h_bytes": 8, "h2d_bytes": 0, "device_rows": r.rows_in}, r
        elif r.stage == "dedup:gather":
            assert not r.extra and r.rows_out == kept, r
        elif r.stage == "join:translate":
            assert extras - {"device_entries"} == {"host_entries", "h2d_bytes"}, r
            assert all(r.extra[k] >= 0 for k in extras), r
        else:
            assert not extras, r
    return [r.stage for r in records if r.stage in PORT_ONLY_STAGES]


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
    # the port's own: both unique indexes' sort and pack stages, and a
    # count of host entries on each translation
    assert port_only_stages(got["port_records"]) == ["index:sort", "index:pack"] * 2
    assert sum(r.stage == "join:translate" for r in got["port_records"]) == 2


def test_fused_plan_stages_match_reference():
    out = {}
    for side, (pkg, tel) in PKGS.items():
        k = KITS[side]
        cache = (JCache if side == "ref" else TCache)()
        plan = fused_shape(k, fact(k))
        with tel.collect():
            t = cache.execute(plan)
            recs = list(tel.records)
            seen = recs if side == "ref" else reference_view(recs)
            out[side] = (_seq(seen), dict(tel.counters), tel.host_sync_elements, t, cache.stats(),
                         recs)
    (ref_seq, ref_ctr, ref_sync, ref_t, ref_st, _), (seq, ctr, sync, t, st, recs) = (
        out["ref"], out["port"])
    assert st["fused_chains"] == ref_st["fused_chains"] == 1
    assert t_checksum(t) == j_checksum(ref_t)
    assert seq == ref_seq
    assert [s for s, _, _ in seq][-1] == "FusedProbe"
    assert ctr == ref_ctr and ctr["verify.plans"] >= 1
    assert sync == ref_sync + _port_extra_syncs(recs)
    assert port_only_stages(recs) == []


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
    # the port's own: each index's sort and pack; the deferred sort and
    # the demotion ran inside the first and the second sort
    recs = got["port_records"]
    assert port_only_stages(recs) == ["index:sort", "index:pack"] * 2
    names = [r.stage for r in recs]
    assert names.index("lane-dict:deferred-sort") < names.index("index:sort")
    assert names.index("typed:demote") < len(names) - 1 - names[::-1].index("index:sort")


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


def _dedup_job(policy):
    """A policy dedup over 60 rows of 11 keys, on the device path."""
    rows = [T.Row({"k": f"k{(i * 7) % 11:02d}", "v": str(i)}) for i in range(60)]
    idx = T.take_rows(rows).on_device("cpu").index_on("k")
    idx.resolve_duplicates(policy)
    return idx


def _small_join():
    """Orders probing customers on ``cust_id`` and products on
    ``prod_id``, every column a host dictionary; returns the result rows
    and the orders' probe columns."""
    cust = T.take_rows([T.Row({"cust_id": f"c{i}", "name": f"n{i}"}) for i in range(10)]) \
        .on_device("cpu").unique_index_on("cust_id")
    prod = T.take_rows([T.Row({"prod_id": f"p{i}", "pname": f"x{i}"}) for i in range(4)]) \
        .on_device("cpu").unique_index_on("prod_id")
    orders = T.take_rows([T.Row({"oid": str(i), "cust_id": f"c{i % 13}", "prod_id": f"p{i % 5}"})
                          for i in range(50)]).on_device("cpu")
    probe = orders.plan.table.columns
    return orders.join(cust, "cust_id").join(prod, "prod_id").to_rows(), probe


@pytest.mark.parametrize("policy", ["first", "last"])
def test_policy_dedup_records_its_stages_and_host_bytes(policy):
    with t_tel.collect():
        idx = _dedup_job(policy)
        recs = list(t_tel.records)
    # index_on's sort and pack, the three dedup stages, and the kept
    # rows' index packed again
    assert port_only_stages(recs) == ["index:sort", "index:pack", "dedup:run-starts",
                                      "dedup:select", "dedup:gather", "index:pack"]
    by = {r.stage: r for r in recs}
    assert len(idx) == by["dedup:gather"].rows_out == 11
    assert by["dedup:run-starts"].extra == {"d2h_bytes": 0}
    assert by["dedup:select"].extra == {"d2h_bytes": 8, "h2d_bytes": 0, "device_rows": 60}
    merged = {r.stage: r for r in t_tel.merged_stages()}
    assert merged["index:pack"].rows_in == 60 + 11


def test_join_counts_the_host_entries_of_its_probe_dictionaries():
    """Host-dictionary probes search on the device: no host entries, the
    probe dictionary's entries as device entries, and the two
    dictionaries' lanes (two int32 lanes an entry) sent up once."""
    with t_tel.collect():
        rows, probe = _small_join()
        recs = [r for r in t_tel.records if r.stage == "join:translate"]
        merged = {r.stage: r for r in t_tel.merged_stages()}["join:translate"]
    sizes = [probe["cust_id"].dictionary.size, probe["prod_id"].dictionary.size]
    assert len(rows) > 0 and sizes == [13, 5]
    builds = [10, 4]
    assert [r.extra for r in recs] == [
        {"host_entries": 0, "device_entries": n, "h2d_bytes": 8 * (n + b)}
        for n, b in zip(sizes, builds)]
    # the merged stage sums the counts, as it sums seconds
    assert merged.extra == {"host_entries": 0, "device_entries": 18, "h2d_bytes": 8 * 32}


def test_a_traced_join_counts_on_its_spans_with_collection_off():
    """A live span is a recorded stage too: with collection off, the
    translation's counts land on its ``join:translate`` spans."""
    t_tel.reset()
    tracer.reset()
    with tracer.trace("q"):
        _, probe = _small_join()
    (trace,) = tracer.finished()
    spans = [s for s in trace.snapshot() if s.name == "join:translate"]
    sizes = [probe["cust_id"].dictionary.size, probe["prod_id"].dictionary.size]
    assert [(s.attrs["host_entries"], s.attrs["device_entries"], s.attrs["h2d_bytes"])
            for s in spans] == [(0, n, 8 * (n + b)) for n, b in zip(sizes, [10, 4])]
    assert t_tel.records == []


def test_a_lane_probe_searches_no_host_entries(tmp_path, stream_env, monkeypatch):
    """A probe column whose dictionary stays on the device translates on
    the device: no host entries, only the host build dictionary's lanes
    and slot maps sent up."""
    monkeypatch.setenv("CSVPLUS_DICT_DEVICE_MIN_DISTINCT", "1000")
    src = T.from_file(_orders_file(tmp_path, n=3000)).on_device("cpu")
    assert src.plan.table.columns["order_id"].dev_dictionary is not None
    idx = T.take_rows([T.Row({"order_id": f"o{i:08d}", "tag": f"t{i}"}) for i in range(0, 3000, 7)]) \
        .on_device("cpu").unique_index_on("order_id")
    with t_tel.collect():
        rows = src.join(idx, "order_id").to_rows()
        recs = [r for r in t_tel.records if r.stage == "join:translate"]
    assert len(rows) == len(range(0, 3000, 7))
    assert len(recs) == 1 and recs[0].extra["host_entries"] == 0
    assert recs[0].extra["h2d_bytes"] > 0


def _csvplus_ranges(prof) -> Counter:
    return Counter(e.name() for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("csvplus:"))


@pytest.mark.parametrize("mode", ["traced", "traced-collected", "collected"])
def test_every_live_span_and_stage_is_one_profiler_range(mode):
    from torch.profiler import ProfilerActivity, profile

    _dedup_job("first")  # warm: nothing below is a first call
    tracer.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t_tel.collect() if "collected" in mode else contextlib.nullcontext():
            with tracer.trace("q") if "traced" in mode else contextlib.nullcontext():
                _small_join()
                _dedup_job("last")
            recs = list(t_tel.records)
    ranges = _csvplus_ranges(prof)
    if "traced" in mode:
        (tr,) = tracer.drain()
        want = Counter(f"csvplus:{s.name}" for s in tr.snapshot())
        assert ranges["csvplus:plan:execute"] >= 1
    else:
        want = Counter(f"csvplus:{r.stage}" for r in recs)
        assert "csvplus:plan:execute" not in ranges  # a span, and no trace is live
    assert ranges == want
    assert ranges["csvplus:dedup:select"] == 1 and ranges["csvplus:join:translate"] == 2


def test_dedup_and_join_with_telemetry_off_record_nothing_and_open_no_range(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    import csvplus_tpu_torch.obs.span as span_mod
    import csvplus_tpu_torch.utils.observe as observe_mod

    opened = []
    for mod in (span_mod, observe_mod):
        monkeypatch.setattr(mod, "enter_range", lambda name: opened.append(name))
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(a))
    import csvplus_tpu_torch.columnar.table as table_mod
    import csvplus_tpu_torch.columnar.typed as typed_mod

    tallied = []
    for mod in (table_mod, typed_mod):
        monkeypatch.setattr(mod, "tally_counts", lambda *a, **k: tallied.append(k))
    t_tel.reset()
    tracer.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rows, _ = _small_join()
        idx = _dedup_job("last")
    assert rows and len(idx) == 11
    assert t_tel.records == [] and t_tel.host_sync_elements == 0 and t_tel.counters == {}
    assert opened == [] and calls == [] and tracer.finished() == []
    assert tallied == []  # no count is computed for a stage nobody records
    assert _csvplus_ranges(prof) == Counter()


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
