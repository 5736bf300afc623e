"""The port's serving tier (``csvplus_tpu_torch.serve``: ``LookupServer``,
admission, serving metrics, the plan cache's ``Lookup`` keys) held
against the JAX package on the CPU, as the read-only cases of
``tests/test_serve.py`` run the reference.

The same seeded 4,000-row index is built in both packages; coalesced
lookups from one or many submitters equal serial ``find`` calls and the
reference's rows; overload sheds with ``ServerOverloaded``, deadlines
expire with ``DeadlineExceeded``, ``stop()`` drains, rejected plans are
never cached, the plan cache's keys, hits and evictions equal the
reference's and a warm pass lowers nothing; ``snapshot()`` has the
reference's keys; threaded ``find_many`` / ``bounds_many`` equal the
serial run; requests route by index name.  Every wait has a timeout."""

import contextlib
import json
import threading

import numpy as np
import pytest

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu import plan as JP
from csvplus_tpu.columnar.table import DeviceTable as JTable
from csvplus_tpu.serve import LookupServer as JServer
from csvplus_tpu.serve import PlanCache as JCache
from csvplus_tpu.serve import plan_cache_key as j_key
from csvplus_tpu_torch import plan as TP
from csvplus_tpu_torch.columnar.table import DeviceTable as TTable
from csvplus_tpu_torch.serve import (
    AdmissionController,
    DeadlineExceeded,
    LookupServer,
    PlanCache,
    PlanRejected,
    ServerOverloaded,
    plan_cache_key,
)

N_ROWS = 4000
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


def _build(pkg, table_cls, n=N_ROWS, extra_col=False):
    ids = np.arange(n, dtype=np.int64) * 7 % (n * 3)
    cols = {
        "id": np.char.add("c", ids.astype(np.str_)).tolist(),
        "v": np.arange(n).astype(np.str_).tolist(),
    }
    if extra_col:
        cols["w"] = ["x"] * n
    t = table_cls.from_pylists(cols, device="cpu")
    return pkg.take(t).index_on("id").sync(), ids


@pytest.fixture(scope="module")
def served():
    return _build(T, TTable)


@pytest.fixture(scope="module")
def ref_served():
    return _build(J, JTable)


def _probes(ids, n, seed=0):
    rng = np.random.default_rng(seed)
    ps = [f"c{int(v)}" for v in rng.choice(ids, n)]
    ps[::17] = ["nope"] * len(ps[::17])  # sprinkle misses
    return ps


def _dicts(groups):
    return [[dict(r) for r in rows] for rows in groups]


def test_coalesced_matches_serial_and_reference(served, ref_served):
    idx, ids = served
    probes = _probes(ids, 300)
    serial = [idx.find(p).to_rows() for p in probes]
    with running(LookupServer(idx)) as srv:
        got = [f.result(timeout=WAIT) for f in [srv.submit(p) for p in probes]]
    with JServer(ref_served[0]) as jsrv:
        ref = [f.result(timeout=WAIT) for f in [jsrv.submit(p) for p in probes]]
    assert got == serial
    assert _dicts(got) == _dicts(ref)


def test_concurrent_submitters_match_serial(served):
    idx, ids = served
    probes = _probes(ids, 400, seed=1)
    serial = [idx.find(p).to_rows() for p in probes]
    n_threads = 8
    per = len(probes) // n_threads
    results = [None] * n_threads
    with running(LookupServer(idx)) as srv:
        def worker(slot):
            chunk = probes[slot * per:(slot + 1) * per]
            futs = [srv.submit(p) for p in chunk]
            results[slot] = [f.result(timeout=WAIT) for f in futs]

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=WAIT)
    assert [rows for chunk in results for rows in chunk] == serial[: per * n_threads]


def test_callback_clients_and_cloned_rows(served):
    """Closed-loop clients resubmitting from their completion callbacks
    (on the dispatcher thread), and rows cloned on delivery: editing a
    delivered row changes no later answer."""
    idx, ids = served
    probes = _probes(ids, 64, seed=2)
    out = {}
    done = threading.Event()
    with running(LookupServer(idx)) as srv:
        def cb(pos):
            def on_done(fut):
                out[pos] = fut.value
                if fut.value:
                    fut.value[0]["v"] = "edited"
                if pos + 1 < len(probes):
                    srv.submit(probes[pos + 1], callback=cb(pos + 1))
                else:
                    done.set()
            return on_done

        srv.submit(probes[0], callback=cb(0))
        assert done.wait(WAIT)
        again = [srv.submit(p).result(timeout=WAIT) for p in probes]
    assert again == [idx.find(p).to_rows() for p in probes]
    assert all(r["v"] != "edited" for rows in again for r in rows)


def test_blocking_lookup_and_probe_validation(served):
    idx, ids = served
    with running(LookupServer(idx)) as srv:
        assert srv.lookup(f"c{int(ids[3])}") == idx.find(f"c{int(ids[3])}").to_rows()
        with pytest.raises(ValueError, match="too many columns"):
            srv.submit(("a", "b"))


def test_submit_requires_running_server(served):
    idx, _ = served
    srv = LookupServer(idx)
    with pytest.raises(RuntimeError, match="not running"):
        srv.submit("c7")
    srv.start()
    try:
        assert srv.submit("c7").result(timeout=WAIT) is not None
    finally:
        srv.stop(timeout=WAIT)
    with pytest.raises(RuntimeError, match="not running"):
        srv.submit("c7")


def test_stop_drains_admitted_requests(served):
    idx, ids = served
    srv = LookupServer(idx, tick_us=20_000).start()
    futs = [srv.submit(f"c{int(v)}") for v in ids[:200]]
    srv.stop(timeout=WAIT)  # must drain, not drop
    for f, v in zip(futs, ids[:200]):
        assert f.result(timeout=1.0) == idx.find(f"c{int(v)}").to_rows()


def test_stop_timeout_bounds_a_stalled_drain(served):
    """A dispatcher stuck in a caller's callback: ``stop(timeout)`` raises
    ``TimeoutError`` instead of waiting for ever, and a later ``stop``
    drains once the callback returns."""
    idx, ids = served
    release, entered = threading.Event(), threading.Event()

    def stall(fut):
        entered.set()
        release.wait(WAIT)

    srv = LookupServer(idx).start()
    try:
        srv.submit(f"c{int(ids[0])}", callback=stall)
        assert entered.wait(WAIT)
        with pytest.raises(TimeoutError, match="still draining"):
            srv.stop(timeout=0.05)
        with pytest.raises(RuntimeError, match="not running"):
            srv.submit(f"c{int(ids[0])}")
    finally:
        release.set()
        srv.stop(timeout=WAIT)
    assert srv.snapshot()["completed"] == 1


def test_overload_sheds_with_typed_error(served):
    idx, ids = served
    with running(LookupServer(idx, max_pending=4, tick_us=200_000)) as srv:
        shed, futs = 0, []
        for v in ids[:64]:
            try:
                futs.append(srv.submit(f"c{int(v)}"))
            except ServerOverloaded as e:
                shed += 1
                assert e.pending >= 4 and e.bound == 4
        assert shed > 0 and len(futs) >= 4
        for f in futs:  # every ADMITTED request still completes
            assert f.result(timeout=WAIT) is not None
        assert srv.snapshot()["shed"] == shed


def test_deadline_expires_before_dispatch(served):
    idx, ids = served
    with running(LookupServer(idx, tick_us=50_000)) as srv:
        fut = srv.submit(f"c{int(ids[0])}", deadline_s=0.0)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=WAIT)
        ok = srv.submit(f"c{int(ids[0])}")
        assert ok.result(timeout=WAIT) == idx.find(f"c{int(ids[0])}").to_rows()
        assert srv.snapshot()["expired"] == 1


def test_admission_controller_unit():
    ac = AdmissionController(max_pending=2)
    ac.admit(0)
    ac.admit(1)
    with pytest.raises(ServerOverloaded):
        ac.admit(2)
    assert AdmissionController.deadline_error(0.0, None, 100.0) is None
    assert AdmissionController.deadline_error(0.0, 5.0, 1.0) is None
    assert isinstance(AdmissionController.deadline_error(0.0, 5.0, 6.0), DeadlineExceeded)


class _Opaque:
    """A predicate no mask lowers: an error-severity diagnostic, so the
    cache rejects the plan."""

    __plan_expr__ = True

    def __call__(self, row):
        return True

    def __repr__(self):
        return "_Opaque()"


def test_lookup_key_identical_structure_different_data(served, ref_served):
    stats = {}
    for side, (idx, ids), P, key, cache_cls in (
        ("port", served, TP, plan_cache_key, PlanCache),
        ("ref", ref_served, JP, j_key, JCache),
    ):
        a = idx.find(f"c{int(ids[1])}").plan
        b = idx.find(f"c{int(ids[2])}").plan
        assert isinstance(a, P.Lookup) and a.lower != b.lower
        assert key(a) == key(b)
        cache = cache_cls(size=8)
        cache.execute(a)
        cache.execute(b)
        stats[side] = cache.stats()
    assert stats["port"] == stats["ref"]
    assert (stats["port"]["hits"], stats["port"]["misses"], stats["port"]["lowered"]) == (1, 1, 1)


def test_lookup_key_misses_on_op_and_schema_change(served):
    idx, ids = served
    leaf = idx.find(f"c{int(ids[1])}").plan
    filtered = TP.Filter(leaf, T.Like({"id": "c7"}))
    projected = TP.SelectCols(leaf, ("id",))
    assert len({plan_cache_key(leaf), plan_cache_key(filtered), plan_cache_key(projected)}) == 3
    assert plan_cache_key(filtered) != plan_cache_key(TP.Filter(leaf, T.Like({"id": "c9"})))
    other, _ = _build(T, TTable, extra_col=True)
    assert plan_cache_key(leaf) != plan_cache_key(other.find(f"c{int(ids[1])}").plan)


def test_rejected_plan_never_cached(served):
    idx, ids = served
    bad = TP.Filter(idx.find(f"c{int(ids[1])}").plan, _Opaque())
    cache = PlanCache(size=8)
    with pytest.raises(PlanRejected) as ei:
        cache.execute(bad)
    assert "unlowerable" in str(ei.value)
    assert len(cache) == 0 and cache.stats()["rejected"] == 1
    with pytest.raises(PlanRejected):
        cache.execute(bad)
    st = cache.stats()
    assert len(cache) == 0 and st["rejected"] == 2 and st["lowered"] == 0


def test_plancache_lru_eviction(served):
    idx, ids = served
    leaf = idx.find(f"c{int(ids[1])}").plan
    cache = PlanCache(size=2)
    for s in (leaf, TP.SelectCols(leaf, ("id",)), TP.SelectCols(leaf, ("v",))):
        cache.execute(s)
    st = cache.stats()
    assert len(cache) == 2 and st["evictions"] == 1 and st["misses"] == 3


def test_served_plans_zero_relowering_when_warm(served):
    idx, ids = served
    plans = [idx.find(f"c{int(v)}").plan for v in ids[:40]]
    with running(LookupServer(idx)) as srv:
        for f in [srv.submit_plan(p) for p in plans[:20]]:
            f.result(timeout=WAIT)
        cold = srv.plancache.stats()
        for f in [srv.submit_plan(p) for p in plans[20:]]:
            f.result(timeout=WAIT)
        warm = srv.plancache.stats()
        assert warm["lowered"] == cold["lowered"] == 1
        assert warm["hits"] - cold["hits"] == 20
        table = srv.submit_plan(plans[0]).result(timeout=WAIT)
        assert T.take(table).to_rows() == idx.find(f"c{int(ids[0])}").to_rows()


def test_metrics_snapshot_shape_equals_reference(served, ref_served):
    snaps = {}
    for side, (idx, ids), server in (("port", served, LookupServer),
                                     ("ref", ref_served, JServer)):
        with running(server(idx)) as srv:
            for f in [srv.submit(f"c{int(v)}") for v in ids[:50]]:
                f.result(timeout=WAIT)
            snaps[side] = srv.snapshot()
            snaps[side + "-breaker"] = srv.breaker.snapshot()

    def shape(d):
        return {k: shape(v) if isinstance(v, dict) and k not in ("by_index",) else
                ({n: sorted(c) for n, c in v.items()} if k == "by_index" else type(v).__name__)
                for k, v in d.items()}

    assert shape(snaps["port"]) == shape(snaps["ref"])
    snap = snaps["port"]
    assert snap["enqueued"] == snap["completed"] == 50
    assert snap["latency"]["count"] == 50 and snap["batch"]["requests"] == 50
    assert snap["degraded"] == 0 and snap["retried"] == 0
    assert snaps["port-breaker"] == snaps["ref-breaker"] == {
        "state": "closed", "consecutive_failures": 0, "opened_total": 0}
    json.dumps(snap)


@pytest.mark.parametrize("drop_lru", [False, True])
def test_find_many_threaded_bitwise_equal_serial(served, drop_lru):
    idx, ids = served
    probes = _probes(ids, 250, seed=3)
    serial = T.to_rows_many(idx.find_many(probes))
    mirror = idx._impl.dev.table
    n_threads = 8
    out = [None] * n_threads
    errs = []
    start = threading.Barrier(n_threads, timeout=WAIT)

    def worker(slot):
        try:
            start.wait()
            for _ in range(3):
                if drop_lru:
                    mirror._mirror_lru = None  # force concurrent decodes
                out[slot] = T.to_rows_many(idx.find_many(probes))
        except BaseException as e:
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT)
    assert not errs
    for got in out:
        assert got == serial


def test_bounds_many_threaded_equal_serial(served):
    idx, ids = served
    impl = idx._impl
    norm = [(p,) for p in _probes(ids, 200, seed=4)]
    serial = impl.bounds_many(norm)
    out = [None] * 6
    start = threading.Barrier(6, timeout=WAIT)

    def worker(slot):
        start.wait()
        out[slot] = impl.bounds_many(norm)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT)
    for got in out:
        assert got == serial


def test_multi_index_routing_and_per_index_metrics(served):
    idx, ids = served
    other = T.take_rows([T.Row({"k": f"k{i % 17:03d}", "v": f"v{i}"}) for i in range(200)]) \
        .on_device("cpu").index_on("k")
    with running(LookupServer(idx, indexes={"other": other})) as srv:
        assert srv.index_names() == ["default", "other"]
        assert srv.lookup("c7")[0]["v"] == "1"
        assert srv.lookup("k001", index="other") == other.find("k001").to_rows()
        with pytest.raises(ValueError, match="too many columns"):
            srv.submit(("a", "b"), index="other")
        with pytest.raises(KeyError, match="no index registered"):
            srv.lookup("c7", index="nope")
        srv.register("second", idx)
        assert srv.lookup("c7", index="second")[0]["v"] == "1"
        assert sorted(srv.registered()) == ["default", "other", "second"]
        snap = srv.snapshot()
    for name in ("default", "other", "second"):
        assert snap["by_index"][name]["lookups"] >= 1


def test_lookup_server_has_no_write_or_view_surface(served):
    """The server's write surface (the storage slice) and its views
    surface (the views slice) are both defined, as in the reference; the
    name dates from before either existed.  Their behaviour is held
    against the reference in ``test_torch_storage.py`` and
    ``test_torch_views.py``."""
    for name in ("register_view", "view", "view_names", "_refresh_views",
                 "submit_append", "append", "submit_delete", "delete"):
        assert hasattr(LookupServer, name) and hasattr(JServer, name), name
