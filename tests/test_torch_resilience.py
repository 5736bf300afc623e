"""The port's recovery ladder (``csvplus_tpu_torch.resilience`` and the
``LookupServer`` that threads it) held against the JAX package on the
CPU, as ``tests/test_chaos.py`` runs the reference's serving cases.

* the same seeded ``FaultPlan`` fires on the same hits in both packages,
  and ``RetryPolicy``'s jittered backoffs are the same numbers;
* the taxonomy classifies alike; the breaker walks closed -> open ->
  half-open -> closed alike;
* a transient fault at ``serve:bounds`` is retried (rows equal to the
  fault-free run, ``retried`` counted, no binary loaded again); retries
  exhausted degrade onto the host oracle with rows equal to the
  reference's and ``degraded`` counted, and the half-open probe
  recovers; a fatal fault fails its batch typed and the server lives;
* the oracle never materializes the primary's host rows, and an index
  over ``POINT_MIRROR_MAX_KEYS`` cells has none: there a transient
  fault past the retries fails typed and decodes no host rows;
* a dispatcher crash fails every pending and later request with
  ``ServerCrashed`` within a second and dumps the flight ring.
Every wait has a timeout."""

import contextlib
import json
import os
import time

import numpy as np
import pytest
import torch

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu.columnar.table import DeviceTable as JTable
from csvplus_tpu.resilience import faults as j_faults
from csvplus_tpu.resilience import retry as j_retry
from csvplus_tpu.resilience.degrade import CircuitBreaker as JBreaker
from csvplus_tpu.serve import LookupServer as JServer
from csvplus_tpu_torch.columnar.table import DeviceTable as TTable
from csvplus_tpu_torch.obs.recompile import RecompileWatch
from csvplus_tpu_torch.ops.join import DeviceIndex
from csvplus_tpu_torch.resilience import faults
from csvplus_tpu_torch.resilience.degrade import CircuitBreaker, HostLookupOracle
from csvplus_tpu_torch.resilience.faults import (
    FaultPlan,
    FaultSpec,
    InjectedDeviceError,
    InjectedFatalError,
    InjectedWorkerCrash,
    plan_from_env,
)
from csvplus_tpu_torch.resilience.retry import (
    DATA,
    FATAL,
    TRANSIENT,
    RetryPolicy,
    ServerCrashed,
    call_with_retry,
    classify,
)
from csvplus_tpu_torch.serve import DeadlineExceeded, LookupServer, PlanCache

FAST_RETRY = dict(max_attempts=3, base_s=1e-4, cap_s=1e-3)
WAIT = 30.0


@contextlib.contextmanager
def running(srv):
    """Start *srv* and stop it on exit; the port's drain is bounded, so a
    stalled dispatcher fails the test instead of hanging the suite."""
    srv.start()
    try:
        yield srv
    finally:
        if isinstance(srv, LookupServer):
            srv.stop(timeout=WAIT)
        else:
            srv.stop()  # the reference's stop takes no bound


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends with fault injection disarmed in both
    packages."""
    faults.deactivate()
    j_faults.deactivate()
    yield
    faults.deactivate()
    j_faults.deactivate()


def _build(pkg, table_cls, n=2000):
    ids = np.arange(n, dtype=np.int64) * 7 % (n * 3)
    t = table_cls.from_pylists({
        "id": np.char.add("c", ids.astype(np.str_)).tolist(),
        "v": np.arange(n).astype(np.str_).tolist(),
    }, device="cpu")
    return pkg.take(t).index_on("id").sync(), ids


@pytest.fixture(scope="module")
def served():
    return _build(T, TTable)


def _probes(ids, n, seed=0):
    rng = np.random.default_rng(seed)
    ps = [f"c{int(v)}" for v in rng.choice(ids, n)]
    ps[::17] = ["nope"] * len(ps[::17])
    return ps


def _pattern(plan, site, error_cls, n=40):
    out = []
    for _ in range(n):
        try:
            plan.fire(site)
            out.append(0)
        except error_cls:
            out.append(1)
    return out


@pytest.mark.parametrize("spec", [
    [{"site": "exec:device", "p": 0.5, "error": "device"}],
    [{"site": "serve:bounds", "every": 3, "error": "device"}],
    [{"site": "serve:bounds", "at": [0, 2, 7], "error": "device", "max_fires": 2}],
], ids=["probability", "every", "at-max-fires"])
@pytest.mark.parametrize("seed", [7, 8])
def test_fault_schedule_equals_reference(spec, seed):
    site = spec[0]["site"]
    got = _pattern(FaultPlan(spec, seed=seed), site, InjectedDeviceError)
    ref = _pattern(j_faults.FaultPlan(spec, seed=seed), site, j_faults.InjectedDeviceError)
    assert got == ref and sum(got) > 0


def test_fault_plan_env_and_validation():
    env = {"CSVPLUS_FAULTS": '{"seed": 7, "faults": [{"site": "serve:bounds",'
                             ' "at": [1], "error": "fatal"}]}'}
    plan = plan_from_env(env)
    assert plan.seed == 7 and plan.specs[0].site == "serve:bounds"
    assert plan_from_env({"CSVPLUS_FAULTS": '[{"site": "ingest:read"}]'}) is not None
    assert plan_from_env({}) is None
    assert faults.SITES == j_faults.SITES
    for bad in (lambda: FaultSpec("nope:where"), lambda: FaultSpec("serve:bounds", kind="explode"),
                lambda: FaultSpec("serve:bounds", at=[0], every=2)):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("seed", [0, 3])
def test_retry_backoff_schedule_equals_reference(seed):
    pol, ref = RetryPolicy(seed=seed), j_retry.RetryPolicy(seed=seed)
    a, b, sa, sb = [], [], pol.base_s, ref.base_s
    for _ in range(12):
        sa, sb = pol.next_backoff(sa), ref.next_backoff(sb)
        a.append(sa)
        b.append(sb)
    assert a == b


def test_classify_taxonomy_equals_reference():
    cases = [
        (InjectedDeviceError("x"), j_faults.InjectedDeviceError("x")),
        (InjectedWorkerCrash("x"), j_faults.InjectedWorkerCrash("x")),
        # the card running out of memory, as each runtime raises it
        (torch.cuda.OutOfMemoryError("CUDA out of memory"),
         RuntimeError("RESOURCE_EXHAUSTED: out of memory")),
        (InjectedFatalError("x"), j_faults.InjectedFatalError("x")),
        (ServerCrashed(RuntimeError("boom")), j_retry.ServerCrashed(RuntimeError("boom"))),
        (RuntimeError("segfault adjacent"),) * 2,
        (T.DataSourceError(3, "bad row"), J.DataSourceError(3, "bad row")),
        (OSError("disk"),) * 2,
        (ValueError("shape"),) * 2,
    ]
    for ours, theirs in cases:
        assert classify(ours) == j_retry.classify(theirs)
    assert classify(DeadlineExceeded(0.2, 0.1)) == DATA
    assert [classify(c[0]) for c in cases[:3]] == [TRANSIENT] * 3
    assert classify(cases[3][0]) == FATAL
    # torch raises no XLA status string: such a message is no device hiccup
    assert classify(RuntimeError("RESOURCE_EXHAUSTED: out of memory")) == FATAL


def test_call_with_retry_policy_bounds():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        raise InjectedDeviceError("always")

    with pytest.raises(InjectedDeviceError):
        call_with_retry(flaky, policy=RetryPolicy(**FAST_RETRY))
    assert calls["n"] == 3
    calls["n"] = 0

    def broken():
        calls["n"] += 1
        raise ValueError("bad input")

    with pytest.raises(ValueError):
        call_with_retry(broken, policy=RetryPolicy(**FAST_RETRY))
    assert calls["n"] == 1
    calls["n"] = 0
    with pytest.raises(InjectedDeviceError):
        call_with_retry(flaky, policy=RetryPolicy(**FAST_RETRY), time_left=lambda: 0.0)
    assert calls["n"] == 1


def test_circuit_breaker_states_equal_reference():
    def walk(cls):
        t = [0.0]
        br = cls(threshold=2, cooldown_s=1.0, clock=lambda: t[0])
        seen = [br.route(), br.state]
        br.on_failure()
        seen.append(br.state)
        br.on_failure()
        seen += [br.state, br.route()]
        t[0] = 1.5
        seen += [br.route(), br.route()]
        br.on_failure()
        seen += [br.state, br.route()]
        t[0] = 3.0
        seen.append(br.route())
        br.on_success()
        seen += [br.state, br.route(), br.snapshot()]
        return seen

    got = walk(CircuitBreaker)
    assert got == walk(JBreaker)
    assert got[-1]["opened_total"] == 2 and got[3] == "open"


def test_serve_retry_recovers_bitwise_no_reload(served):
    idx, ids = served
    probes = _probes(ids, 120)
    serial = [idx.find(p).to_rows() for p in probes]
    with running(LookupServer(idx)) as srv:
        srv.retry_policy = RetryPolicy(**FAST_RETRY)
        for f in [srv.submit(p) for p in probes[:20]]:
            f.result(timeout=WAIT)
        with RecompileWatch() as w:
            with faults.active(FaultPlan(
                    [{"site": "serve:bounds", "at": [0, 2], "error": "device"}], seed=3)) as plan:
                got = [f.result(timeout=WAIT) for f in [srv.submit(p) for p in probes]]
        w.assert_zero("retried serve lookups")
        snap = srv.snapshot()
    assert got == serial
    assert plan.snapshot()["fired"]["serve:bounds"] >= 1
    assert snap["retried"] >= 1 and snap["failed"] == 0 and snap["degraded"] == 0


def test_serve_breaker_degrades_to_host_like_reference_and_recovers(served):
    """Every primary pass fails at ``serve:bounds``: retries exhaust, the
    breaker opens and the host oracle serves the whole load, with rows
    equal to the reference's degraded run and ``degraded`` counted."""
    idx, ids = served
    probes = _probes(ids, 60, seed=4)
    serial = [idx.find(p).to_rows() for p in probes]
    results = {}
    for side, server, fmod, breaker, policy, (index, _) in (
        ("port", LookupServer, faults, CircuitBreaker, RetryPolicy, served),
        ("ref", JServer, j_faults, JBreaker, j_retry.RetryPolicy, _build(J, JTable)),
    ):
        with running(server(index)) as srv:
            srv.retry_policy = policy(max_attempts=2, base_s=1e-4, cap_s=1e-3)
            srv.breaker = breaker(threshold=2, cooldown_s=0.05)
            with fmod.active(fmod.FaultPlan(
                    [{"site": "serve:bounds", "every": 1, "error": "device"}])):
                got = [f.result(timeout=WAIT) for f in [srv.submit(p) for p in probes]]
            snap = srv.snapshot()
            results[side] = [[dict(r) for r in rows] for rows in got]
            assert snap["failed"] == 0 and snap["degraded"] >= len(probes)
            assert snap["retried"] >= 1
            assert srv.breaker.state == "open"
            assert srv.breaker.snapshot()["opened_total"] >= 1
            if side == "port":
                assert got == serial
                assert index._impl._rows is None  # the primary stays device-lazy
                time.sleep(0.06)  # past the cooldown: the half-open probe
                again = [srv.submit(p) for p in probes[:10]]
                assert [f.result(timeout=WAIT) for f in again] == serial[:10]
                assert srv.breaker.state == "closed"
    assert results["port"] == results["ref"]


def test_serve_fatal_surfaces_typed_server_survives(served):
    idx, ids = served
    probe = f"c{int(ids[5])}"
    with running(LookupServer(idx)) as srv:
        with faults.active(FaultPlan([{"site": "serve:bounds", "at": [0], "error": "fatal"}])):
            fut = srv.submit(probe)
            with pytest.raises(InjectedFatalError):
                fut.result(timeout=WAIT)
        assert srv.submit(probe).result(timeout=WAIT) == idx.find(probe).to_rows()
        assert srv.snapshot()["failed"] == 1


def test_plan_execute_retry_bitwise(served):
    idx, ids = served
    plan = idx.find(f"c{int(ids[3])}").plan
    pc = PlanCache()
    expected = T.take(pc.execute(plan)).to_rows()
    with RecompileWatch(plancache=pc) as w:
        with faults.active(FaultPlan([{"site": "exec:device", "at": [0], "error": "device"}])):
            got = call_with_retry(lambda: pc.execute(plan), policy=RetryPolicy(**FAST_RETRY))
    w.assert_zero("retried plan execution")
    assert T.take(got).to_rows() == expected


def test_host_oracle_leaves_primary_device_path_intact(served):
    idx, ids = served
    impl = idx._impl
    oracle = HostLookupOracle(impl)
    probes = [(p,) for p in _probes(ids, 30, seed=5)]
    dev_bounds = impl.bounds_many(probes)
    host_bounds = oracle.bounds_many(probes)
    assert [tuple(map(int, b)) for b in dev_bounds] == [tuple(map(int, b)) for b in host_bounds]
    assert impl.rows_for_bounds(dev_bounds) == oracle.rows_for_bounds(host_bounds)
    assert impl._rows is None


def test_host_oracle_serves_only_up_to_the_mirror_cap(monkeypatch):
    idx, _ = _build(T, TTable, n=200)  # 200 rows x 2 columns = 400 cells
    oracle = HostLookupOracle(idx._impl)
    assert oracle.available
    monkeypatch.setattr(DeviceIndex, "POINT_MIRROR_MAX_KEYS", 399)
    assert not oracle.available
    host = T.take(idx).index_on("id")  # a host-backed index keeps its oracle
    assert HostLookupOracle(host._impl).available


def test_transient_fault_above_the_cap_fails_typed_without_host_rows(monkeypatch):
    """An index over ``POINT_MIRROR_MAX_KEYS`` cells has no host oracle:
    a transient fault that outlasts the retries fails the batch with its
    own error, the breaker stays closed, no host row is decoded, and the
    next batch is served from the device path."""
    idx, ids = _build(T, TTable)
    monkeypatch.setattr(DeviceIndex, "POINT_MIRROR_MAX_KEYS", 100)
    probes = _probes(ids, 40, seed=6)
    serial = [idx.find(p).to_rows() for p in probes]
    with running(LookupServer(idx)) as srv:
        srv.retry_policy = RetryPolicy(**FAST_RETRY)
        srv.breaker = CircuitBreaker(threshold=1, cooldown_s=60.0)
        with faults.active(FaultPlan(
                [{"site": "serve:bounds", "every": 1, "error": "device"}])):
            futs = [srv.submit(p) for p in probes]
            for f in futs:
                with pytest.raises(InjectedDeviceError):
                    f.result(timeout=WAIT)
        snap = srv.snapshot()
        assert snap["failed"] == len(probes) and snap["degraded"] == 0
        assert snap["retried"] >= 1
        assert srv.breaker.snapshot() == {"state": "closed", "consecutive_failures": 0,
                                          "opened_total": 0}
        assert srv._registered(None).oracle._host is None
        assert idx._impl._rows is None
        assert [f.result(timeout=WAIT) for f in [srv.submit(p) for p in probes]] == serial
    assert srv.snapshot()["degraded"] == 0


def _flight_dumps(flight_dir, timeout_s=10.0):
    deadline = time.perf_counter() + timeout_s
    names: list = []
    while not names and time.perf_counter() < deadline:
        names = sorted(n for n in os.listdir(flight_dir)
                       if n.startswith("csvplus_flight.") and n.endswith(".json"))
        if not names:
            time.sleep(0.01)
    out = []
    for name in names:
        with open(os.path.join(flight_dir, name)) as f:
            out.append(json.load(f))
    return out


def test_dispatcher_crash_fails_pending_and_future_fast(served, tmp_path, monkeypatch):
    idx, ids = served
    flight_dir = str(tmp_path / "flight")
    os.makedirs(flight_dir)
    monkeypatch.setenv("CSVPLUS_FLIGHT_DIR", flight_dir)
    srv = LookupServer(idx, tick_us=20000)
    srv.start()
    try:
        with faults.active(FaultPlan([{"site": "serve:dispatch", "at": [0], "error": "fatal"}])):
            futs = []
            for v in ids[:8]:
                try:
                    futs.append(srv.submit(f"c{int(v)}"))
                except ServerCrashed:
                    break
            assert futs
            t0 = time.perf_counter()
            for f in futs:
                with pytest.raises(ServerCrashed) as ei:
                    f.result(timeout=1.0)
                assert isinstance(ei.value.cause, InjectedFatalError)
            assert time.perf_counter() - t0 < 1.0
        with pytest.raises(ServerCrashed):
            srv.submit(f"c{int(ids[0])}")
        dumps = _flight_dumps(flight_dir)
        crash = next(d for d in dumps if d["reason"] == "serve:dispatcher-crash")
        assert crash["schema_version"] == 1
        assert crash["error"]["type"] == "InjectedFatalError"
        assert any(ev.get("kind") == "fault:fired" and ev.get("site") == "serve:dispatch"
                   for d in dumps for ev in d["events"])
    finally:
        srv.stop(timeout=WAIT)


def test_straggler_expires_queued_deadline_at_drain(served):
    idx, ids = served
    probe = f"c{int(ids[7])}"
    with running(LookupServer(idx)) as srv:
        with faults.active(FaultPlan([{"site": "serve:dispatch", "kind": "delay", "at": [0],
                                       "delay_s": 0.08}])):
            a = srv.submit(probe)
            deadline = time.perf_counter() + WAIT
            while srv.metrics.ticks == 0 and time.perf_counter() < deadline:
                time.sleep(0.001)
            b = srv.submit(probe, deadline_s=0.005)
            assert a.result(timeout=WAIT) == idx.find(probe).to_rows()
            with pytest.raises(DeadlineExceeded):
                b.result(timeout=WAIT)
        assert srv.snapshot()["expired"] == 1
