"""The port's chaos gate (``csvplus_tpu_torch/resilience/chaos.py``) held
against the reference's (the root ``chaos.py``) on the CPU, case by case
at the reference's sizes: the same ``ok``, the same recovery flags, the
same injection snapshots (where the serving dispatcher's coalescing,
which is timing, leaves the hit counts alone), the same error text, and
the same rows each package recovers; the WAL crash matrix window by
window, each directory the port's child left recovered by both packages
to the checksums of the acked stream; the gate's command line; and the
port's counterparts of the reference's chaos tests that had none (a slow
plan expiring a later one, a callback error counted, ingest worker
crashes at every K, retry exhaustion, a read fault's K-independent row
number, a compactor crash under a live server, the upsert-mode torn
tail).  Every wait has a timeout."""

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu.resilience import faults as j_faults
from csvplus_tpu_torch.resilience import chaos as C
from csvplus_tpu_torch.resilience import faults
from csvplus_tpu_torch.resilience.faults import FaultPlan, InjectedWorkerCrash
from csvplus_tpu_torch.serve import DeadlineExceeded, LookupServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 30.0


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R = _load("chaos", os.path.join(ROOT, "chaos.py"))  # the reference gate (main() is not run)
CHILD = _load("wal_crash_child", os.path.join(ROOT, "tests", "wal_crash_child.py"))


@pytest.fixture(autouse=True)
def _disarmed():
    faults.deactivate()
    j_faults.deactivate()
    yield
    faults.deactivate()
    j_faults.deactivate()


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """``python -m csvplus_tpu_torch.resilience.chaos --device cpu``,
    started first so that it runs beside the other tests."""
    out = tmp_path_factory.mktemp("cli") / "chaos.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "csvplus_tpu_torch.resilience.chaos", "--device", "cpu",
         "--out", str(out)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def indexes(cli):
    """The gate's served index in each package (20,000 rows)."""
    return C.build_index(device="cpu"), R._build_index()


def _rows(groups):
    return [[dict(r) for r in g] for g in groups]


def _both_serial(indexes, n, seed):
    (tidx, tids), (jidx, jids) = indexes
    assert np.array_equal(tids, jids)
    probes = C.probes_of(tids, n, seed)
    assert probes == R._probes(jids, n, seed)
    port = _rows(tidx.find(p).to_rows() for p in probes)
    assert port == _rows(jidx.find(p).to_rows() for p in probes)
    return port


def _serve_retry(indexes, tmp):
    (tidx, tids), (jidx, jids) = indexes
    _both_serial(indexes, 600, 1)  # what each package recovers, equal
    return C.case_serve_retry(tidx, tids, device="cpu"), R.case_serve_retry(jidx, jids)


def _serve_degrade(indexes, tmp):
    (tidx, tids), (jidx, jids) = indexes
    _both_serial(indexes, 300, 2)
    return C.case_serve_degrade(tidx, tids, device="cpu"), R.case_serve_degrade(jidx, jids)


def _dispatcher_crash(indexes, tmp):
    (tidx, tids), (jidx, jids) = indexes
    return (C.case_dispatcher_crash(tidx, tids, device="cpu"),
            R.case_dispatcher_crash(jidx, jids))


def _ingest_crash(indexes, tmp):
    path = C.chaos_csv(str(tmp))
    assert C.stream_fold(path, 1) == R._stream_fold(path, 1)  # the same chunks, bitwise
    return (C.case_ingest_crash_recovery(str(tmp), device="cpu"),
            R.case_ingest_crash_recovery(str(tmp)))


def _read_fault(indexes, tmp):
    return (C.case_ingest_read_fault_typed(str(tmp), device="cpu"),
            R.case_ingest_read_fault_typed(str(tmp)))


def _mesh_join(indexes, tmp):
    (tmp / "port").mkdir()
    (tmp / "ref").mkdir()
    port = C.case_mesh_join_under_ingest_faults(str(tmp / "port"), device="cpu")
    ref = R.case_mesh_join_under_ingest_faults(str(tmp / "ref"))
    # the fault-free joins both cases recovered to, equal across packages
    orders, cust_path = C._mesh_files(str(tmp))
    from csvplus_tpu.models import workloads as JW
    from csvplus_tpu_torch.models import workloads as TW
    from csvplus_tpu_torch.parallel.mesh import make_mesh
    from csvplus_tpu_torch.utils.env import env_override

    with env_override({"CSVPLUS_STREAM_CHUNK_BYTES": "4096", "CSVPLUS_STREAM_MIN_BYTES": "1"}):
        cust = T.take(T.from_file(cust_path)).unique_index_on("id")
        cust.on_device("cpu")
        got = TW.sharded_join(T.from_file(orders), cust, shards=8,
                              mesh=make_mesh(8, devices=["cpu"] * 8)).to_rows()
        jcust = J.Take(J.from_file(cust_path)).unique_index_on("id")
        jcust.on_device("cpu")
        want = JW.sharded_join(J.from_file(orders), jcust, shards=8).to_rows()
    assert [dict(r) for r in got] == [dict(r) for r in want]
    return port, ref


def _storage(indexes, tmp):
    return C.case_storage_compact_crash(device="cpu"), R.case_storage_compact_crash()


def _view(indexes, tmp):
    return C.case_view_refresh_crash(device="cpu"), R.case_view_refresh_crash()


def _overhead(indexes, tmp):
    (tidx, tids), (jidx, jids) = indexes
    return (C.case_disarmed_overhead(tidx, tids, device="cpu"),
            R.case_disarmed_overhead(jidx, jids))


def _fired(rec):
    return rec["injections"]["fired"]


#: case -> (runs both packages' case, the keys whose values must be equal)
CASES = {
    "serve_retry": (_serve_retry, ("ok", "bitwise_equal")),
    "serve_degrade": (_serve_degrade, ("ok", "bitwise_equal_degraded", "breaker_opened",
                                       "breaker_recovered", "injections")),
    "dispatcher_crash": (_dispatcher_crash, ("ok", "pending_futures", "typed_failures",
                                             "post_crash_submit_typed", "flight",
                                             "injections")),
    "ingest_crash_recovery": (_ingest_crash, ("ok", "chunks", "per_workers")),
    "ingest_read_fault_typed": (_read_fault, ("ok", "typed", "k_independent", "error",
                                              "injections")),
    "mesh_join_under_ingest_faults": (_mesh_join, ("ok", "bitwise_equal", "rows",
                                                   "injections")),
    "storage_compact_crash": (_storage, ("ok", "tier_set_intact_after_crashes",
                                         "retry_compacted_deltas", "rebuild_parity",
                                         "injections")),
    "view_refresh_crash": (_view, ("ok", "write_futures_acked", "refresh_failures_recorded",
                                   "prior_snapshot_intact", "dispatcher_alive",
                                   "retry_converged", "from_scratch_parity", "flight",
                                   "injections", "view_cell")),
    "disarmed_overhead": (_overhead, ("ok", "sites_per_cycle", "budget_pct")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_outcome_equals_the_reference(case, indexes, tmp_path):
    run, keys = CASES[case]
    port, ref = run(indexes, tmp_path)
    assert port["ok"], port
    for k in keys:
        assert port[k] == ref[k], (k, port[k], ref[k])
    assert set(ref) - {"recompile_observable"} <= set(port)
    if case == "serve_retry":
        # the hits follow how the load coalesced into dispatch cycles
        # (timing, in both packages); the metrics follow the same cycles
        assert _fired(port)["serve:bounds"] >= 1 and _fired(ref)["serve:bounds"] >= 1
        assert port["metrics"]["retried"] >= 1 and port["metrics"]["failed"] == 0
        assert port["metrics"]["degraded"] == ref["metrics"]["degraded"] == 0
    if case == "serve_degrade":
        assert port["metrics"]["degraded"] == ref["metrics"]["degraded"] == 300
        assert port["metrics"]["failed"] == ref["metrics"]["failed"] == 0
    if case == "dispatcher_crash":
        assert port["unblock_seconds"] < 1.0
    if case == "mesh_join_under_ingest_faults":
        assert port["assemblies"] == 0


def test_the_gate_refuses_cuda_without_a_card():
    if C._device("cpu").type == "cpu" and not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError):
            C.build_index(n=10)
        with pytest.raises(RuntimeError):
            C.case_storage_compact_crash()


def test_a_hang_and_an_escape_are_failed_cases_not_a_stuck_gate():
    hung = C.with_timeout("hang", lambda: time.sleep(5) or {}, timeout=0.2, log=lambda m: None)
    assert not hung["ok"] and "timeout" in hung["error"]
    boom = C.with_timeout("boom", lambda: 1 / 0, timeout=5, log=lambda m: None)
    assert not boom["ok"] and boom["error"].startswith("ZeroDivisionError")
    assert C.summary({"a": {"ok": True}, "b": boom}, "cpu")["failed"] == ["b"]


def test_device_checks_replay_every_call_and_read_no_memory_on_the_cpu():
    """On the CPU the checks replay the recorded calls of both kernels'
    wrappers (their plain versions run) and take no memory reading."""
    from csvplus_tpu_torch.columnar.table import DeviceTable

    t = DeviceTable.from_pylists({"v": [str(i) for i in range(100)]}, device="cpu")
    src = T.take(t).filter(T.Any(T.Like({"v": "3"}), T.Like({"v": "7"})))
    with C.DeviceChecks("cpu", audit=True) as chk:
        chk.mark_oracle()
        assert len(src.to_rows()) == 2
        chk.mark_faulted()
    rec = chk.record()
    assert chk.ok and "memory" not in rec
    assert rec["kernel_replay"]["replayed"]["mask"] >= 1
    assert rec["kernel_replay"]["launches"] == {"mask": 0, "pack": 0}


# -- the WAL crash matrix ------------------------------------------------------


@pytest.fixture(scope="module")
def wal_matrix(tmp_path_factory):
    """The port's matrix, and an
    upsert-mode torn-tail child started beside it."""
    root = tmp_path_factory.mktemp("wal")
    upsert = C.start_wal_child(str(root / "upsert"), None, device="cpu", mode="upsert",
                               tear=True)
    rec = C.case_wal_crash_matrix(str(root), device="cpu", timeout=120)
    upsert[0].communicate(timeout=120)
    return root, rec, upsert


def test_wal_matrix_windows_are_the_references(wal_matrix):
    _, rec, _ = wal_matrix
    assert C.CRASH_WINDOWS == CHILD.CRASH_WINDOWS
    assert C.WAL_OPS == CHILD.ops_script()
    assert rec["ok"] and rec["windows_total"] == 8 and rec["windows_failed"] == []


def _ref_sums(mi):
    from csvplus_tpu.storage import index_checksums

    return index_checksums(mi.to_index())


@pytest.mark.parametrize("window", sorted(CHILD.CRASH_WINDOWS))
def test_wal_crash_window_recovers_as_the_reference(window, wal_matrix):
    """The window's record equals the reference gate's (acked ops,
    replayed records, parity, answers, exit status), and the reference
    package recovers the port child's directory to the checksums of its
    own replay of the acked ops, which equal the port's."""
    from csvplus_tpu.storage import MutableIndex as JMutable

    root, rec, _ = wal_matrix
    got = rec["windows"][window]
    fault, n_acked, n_replay = CHILD.CRASH_WINDOWS[window]
    assert got["ok"] and got["exit"] == (3 if fault else 0)
    assert (got["acked"], got["recovered_records"]) == (n_acked, n_replay)
    assert got["crashed"] == (fault is not None) and got["warm_recompiles"] == 0
    if window == "torn_tail":
        assert got["truncated_bytes"] > 0
    with open(root / f"wal-{window}" / "acked.json") as f:
        acked = json.load(f)["ops"]
    want = _ref_sums(CHILD.replay_reference(acked))
    assert C._index_sums(C.wal_replay(acked, device="cpu")) == want
    ref = JMutable.open(str(root / f"wal-{window}" / "idx"))
    assert _ref_sums(ref) == want
    ref.close()


def test_wal_crash_restart_upsert_mode(wal_matrix):
    """The torn-tail window again in upsert visibility: recovery parity
    holds when tombstones and newest-wins shadowing interact, in both
    packages."""
    from csvplus_tpu.storage import MutableIndex as JMutable
    from csvplus_tpu_torch.storage import MutableIndex

    _, _, (proc, workdir, acked_path) = wal_matrix
    assert proc.returncode == 0
    with open(acked_path) as f:
        acked = json.load(f)["ops"]
    assert len(acked) == 7
    mi = MutableIndex.open(workdir, ingest_device="cpu")
    assert mi.mode == "upsert" and mi.recovered_records == 3
    want = _ref_sums(CHILD.replay_reference(acked, mode="upsert"))
    assert C._index_sums(mi) == want
    assert C._index_sums(C.wal_replay(acked, mode="upsert", device="cpu")) == want
    mi.close()
    ref = JMutable.open(workdir)
    assert _ref_sums(ref) == want
    ref.close()


# -- the command line ----------------------------------------------------------


def test_the_gates_command_line_on_the_cpu(cli):
    """``python -m csvplus_tpu_torch.resilience.chaos --device cpu``: one
    JSON line with the reference's keys and the device, 10 of 10 cases,
    exit 0, the full record only where ``--out`` says."""
    proc, out = cli
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-2000:]
    line = json.loads(stdout.strip().splitlines()[-1])
    assert line["value"] == 10 and line["cases_total"] == 10 and line["failed"] == []
    assert line["device"] == "cpu" and line["overhead_pct"] <= 1.0
    assert {"metric", "value", "cases_total", "failed", "overhead_pct"} <= set(line)
    record = json.loads(out.read_text())
    assert set(record["cases"]) == set(C.CASES)
    assert not os.path.exists(os.path.join(ROOT, "CHAOS_torch.json"))


# -- the reference's chaos tests that had no port counterpart ------------------


def test_slow_plan_expires_later_plan_at_fresh_recheck(indexes):
    (idx, ids), _ = indexes
    pa = idx.find(f"c{int(ids[1])}").plan
    pb = idx.find(f"c{int(ids[2])}").plan
    # a fixed ticker coalesces both plans into one batch; the injected
    # delay makes plan a use up plan b's whole budget after the drain-time
    # sweep passed it: only the fresh per-plan re-check can expire it
    with C.running(LookupServer(idx, tick_us=5000)) as srv:
        with faults.active(FaultPlan([{"site": "exec:device", "kind": "delay", "at": [0],
                                       "delay_s": 0.2}])):
            a = srv.submit_plan(pa)
            b = srv.submit_plan(pb, deadline_s=0.05)
            got = a.result(timeout=WAIT)
            with pytest.raises(DeadlineExceeded):
                b.result(timeout=WAIT)
        assert T.take(got).to_rows() == idx.find(f"c{int(ids[1])}").to_rows()
        assert srv.snapshot()["expired"] == 1


def test_callback_error_counted_not_dropped(indexes, capfd):
    (idx, ids), _ = indexes
    probe = f"c{int(ids[9])}"
    with C.running(LookupServer(idx)) as srv:
        srv.submit(probe, callback=lambda fut: (_ for _ in ()).throw(
            RuntimeError("consumer bug")))
        deadline = time.perf_counter() + 5.0
        while srv.metrics.callback_errors == 0:
            assert time.perf_counter() < deadline, "callback error never counted"
            time.sleep(0.001)
        # the request itself completed normally despite the bad callback
        assert srv.submit(probe).result(timeout=WAIT) == idx.find(probe).to_rows()
        assert srv.snapshot()["callback_errors"] == 1
    assert "completion callback raised RuntimeError" in capfd.readouterr().err


def _small_csv(tmp_path, rows=400):
    p = tmp_path / "chaos.csv"
    p.write_text("\n".join(["k,v"] + [f"k{i},v{i * 3}" for i in range(rows)]) + "\n")
    return str(p)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_ingest_worker_crash_recovery_unobservable(k, tmp_path):
    """Crashed workers' chunks are re-run (on the worker at K = 1, by the
    reassembler at the head of the line at K > 1): the stream equals the
    fault-free run's, and the reference's under the same schedule."""
    path = _small_csv(tmp_path)
    oracle = C.stream_fold(path, workers=1, chunk_bytes=256)
    assert oracle[0] == "ok" and len(oracle[1]) > 4, "need a multi-chunk file"
    spec = [{"site": "ingest:worker", "at": [1, 3, 4], "error": "crash"}]
    with faults.active(FaultPlan(spec)) as plan:
        got = C.stream_fold(path, workers=k, chunk_bytes=256)
    with j_faults.active(j_faults.FaultPlan(spec)) as jplan:
        want = R._stream_fold(path, workers=k, chunk_bytes=256)
    assert plan.snapshot()["fired"]["ingest:worker"] >= 1
    assert got == oracle == want, f"worker crash observable at K={k}"
    assert plan.snapshot() == jplan.snapshot()


@pytest.mark.parametrize("k", [1, 3])
def test_ingest_worker_crash_exhaustion_surfaces_typed(k, tmp_path):
    from csvplus_tpu_torch.native import scanner as native

    path = _small_csv(tmp_path)
    with faults.active(FaultPlan([{"site": "ingest:worker", "every": 1, "error": "crash"}])):
        with pytest.raises(InjectedWorkerCrash):
            list(native.stream_encoded_chunks(T.from_file(path), path, chunk_bytes=256,
                                              workers=k))


def test_ingest_read_fault_typed_rows_k_independent(tmp_path):
    path = _small_csv(tmp_path)
    # an I/O failure mid-file: the chunks already cut still emit, then a
    # DataSourceError carries the absolute 1-based record number: the same
    # outcome (message and emitted prefix) for every K, and the reference's
    outcomes = {}
    for k in (1, 2):
        with faults.active(FaultPlan([{"site": "ingest:read", "at": [2], "error": "io"}])):
            outcomes[k] = C.stream_fold(path, workers=k, chunk_bytes=256)
    assert outcomes[1][0] == "exc" and outcomes[1][1] == "DataSourceError"
    assert outcomes[1] == outcomes[2]
    with j_faults.active(j_faults.FaultPlan([{"site": "ingest:read", "at": [2],
                                              "error": "io"}])):
        assert R._stream_fold(path, workers=1, chunk_bytes=256) == outcomes[1]
    # a failure on the very first read is numbered row 1, the typed shape
    # of a missing file
    with faults.active(FaultPlan([{"site": "ingest:read", "at": [0], "error": "io"}])):
        first = C.stream_fold(path, workers=1, chunk_bytes=256)
    assert first[0] == "exc" and first[1] == "DataSourceError"
    assert "row 1:" in first[2] and first[3] == []


def test_storage_compact_crash_served_reads_unaffected(indexes):
    """A compactor death mid-pass under a served mutable index: lookups
    keep answering from the pinned tier set, the set stays intact and
    retryable, and the loop's retry compacts to rebuild parity."""
    from csvplus_tpu_torch.row import Row
    from csvplus_tpu_torch.source import take_rows
    from csvplus_tpu_torch.storage import (Compactor, MutableIndex, index_checksums,
                                           rebuild_reference)

    (idx, ids), _ = indexes
    mi = MutableIndex.create(
        take_rows([Row({"k": f"k{i % 23:03d}", "v": f"v{i}"}) for i in range(300)]),
        ["k"], ingest_device="cpu")
    mi.append_rows([{"k": f"n{j}", "v": "x"} for j in range(10)])
    epoch0, deltas0 = mi.epoch, mi.delta_count
    with C.running(LookupServer(idx, indexes={"mut": mi})) as srv:
        serial = [[dict(r) for r in srv.lookup(p, index="mut")] for p in ("k001", "n3", "zz")]
        c = Compactor(mi, min_deltas=1, interval_s=0.002)
        with faults.active(FaultPlan([{"site": "storage:compact", "at": [0],
                                       "error": "fatal"}], seed=7)) as plan:
            with c:
                deadline = 400
                while mi.delta_count and deadline:
                    deadline -= 1
                    time.sleep(0.005)
                got = [[dict(r) for r in srv.lookup(p, index="mut")]
                       for p in ("k001", "n3", "zz")]
        assert got == serial
        assert plan.snapshot()["fired"]["storage:compact"] == 1
    snap = c.snapshot()
    assert snap["failures"] >= 1 and "InjectedFatalError" in snap["last_error"]
    assert snap["compactions"] >= 1
    assert mi.delta_count == 0
    assert mi.epoch > epoch0 and deltas0 == 1
    assert index_checksums(mi.tiers().base) == index_checksums(rebuild_reference(mi))


def test_compact_crash_case_on_a_given_served_index():
    """The gate's storage case on an index it is handed (the card's
    shape: a key column of its own, its own probes, served while it
    crashes)."""
    from csvplus_tpu_torch.row import Row
    from csvplus_tpu_torch.source import take_rows
    from csvplus_tpu_torch.storage import MutableIndex

    mi = MutableIndex.create(
        take_rows([Row({"cust_id": f"c{i}", "v": str(i)}) for i in range(500)]),
        ["cust_id"], ingest_device="cpu")
    rec = C.case_storage_compact_crash(device="cpu", mi=mi, key="cust_id", serve=True,
                                       probes=[("c3",), ("c499",), ("n5",), ("zz",)])
    assert rec["ok"] and rec["served"] and rec["retry_compacted_deltas"] == 2
    assert mi.delta_count == 0 and len(mi.find_rows_many([("m19",)])[0]) == 1
