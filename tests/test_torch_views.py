"""The port's live materialized views (``csvplus_tpu_torch/views/``) and
``LookupServer``'s views surface, held against the JAX package's on the
CPU: the cases of ``tests/test_views.py``, each driven through both
packages with the same seeded stream, comparing the ``ViewRejected``
diagnostics string for string, the positional checksums after EVERY step
(appends, deletes, resurrection, leveled compaction, the seeded random
interleavings), ``read()`` rows, the ``views:refresh`` fault-site retry,
zero warm lowerings, and the server's registration, routing, refresh
ordering and per-view metric cells.  Each side also holds its own
contract: the maintained contents equal a from-scratch execution after
every applied event.  A view over a source with no device runs on
``"cuda"`` unless told otherwise, and raises where no card is present."""

import contextlib
import importlib
import random
import time

import pytest
import torch

N_CUST, N_PROD = 20, 8
WAIT = 30.0


class _Pkg:
    """One package's surface for views."""

    def __init__(self, name):
        mod = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
        self.name = name
        self.P = mod("plan")
        ex = mod("exprs")
        self.Rename, self.SetValue, self.Update = ex.Rename, ex.SetValue, ex.Update
        self.create_index = mod("index").create_index
        self.RecompileWatch = mod("obs.recompile").RecompileWatch
        self.Like = mod("predicates").Like
        self.faults = mod("resilience.faults")
        self.Row = mod("row").Row
        self.PlanCache = mod("serve.plancache").PlanCache
        self.LookupServer = mod("serve").LookupServer
        self.take_rows = mod("source").take_rows
        self.MutableIndex = mod("storage").MutableIndex
        views = mod("views")
        self.MaterializedView = views.MaterializedView
        self.ViewRejected = views.ViewRejected
        self.check_view_plan = views.check_view_plan


TP = _Pkg("csvplus_tpu_torch")
JP = _Pkg("csvplus_tpu")
PKGS = (TP, JP)


@pytest.fixture(autouse=True)
def _disarmed():
    for p in PKGS:
        p.faults.deactivate()
    yield
    for p in PKGS:
        p.faults.deactivate()


def _order(pkg, i, cust=None, prod=None):
    return pkg.Row({
        "oid": f"o{i:05d}",
        "cust_id": cust if cust is not None else f"c{i % N_CUST:03d}",
        "prod_id": prod if prod is not None else f"p{i % N_PROD:03d}",
    })


def _dims(pkg):
    cust = pkg.create_index(
        pkg.take_rows([pkg.Row({"cust_id": f"c{i:03d}", "name": f"n{i:03d}"})
                       for i in range(N_CUST)]),
        ["cust_id"],
    )
    cust.on_device("cpu")
    prod = pkg.create_index(
        pkg.take_rows([pkg.Row({"prod_id": f"p{i:03d}", "label": f"l{i:03d}"})
                       for i in range(N_PROD)]),
        ["prod_id"],
    )
    prod.on_device("cpu")
    return cust, prod


def _source(pkg, n=64, mode="append", ingest_device="cpu"):
    return pkg.MutableIndex.create(
        pkg.take_rows([_order(pkg, i) for i in range(n)]), ["oid"],
        mode=mode, ingest_device=ingest_device,
    )


def _threeway(pkg, cust, prod):
    P = pkg.P
    return P.Join(P.Join(P.Scan(None), cust, ("cust_id",)), prod, ("prod_id",))


def _parity(view):
    """The view's own contract; returns the checksums for the cross-package
    comparison."""
    got = view.checksums()
    assert got == view.recompute_checksums()
    return got


def _rows(rows):
    return [dict(r) for r in rows]


def _both(scenario):
    """Run *scenario* through both packages; the observations must agree."""
    got = scenario(TP)
    want = scenario(JP)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# registration gate
# ---------------------------------------------------------------------------


def _rejections(pkg):
    P, Like = pkg.P, pkg.Like
    cust, prod = _dims(pkg)
    mi = _source(pkg, 8)
    scan = P.Scan(None)
    join = _threeway(pkg, cust, prod)
    cases = [
        P.Top(join, 5),
        P.DropRows(join, 2),
        P.TakeWhile(join, Like({"oid": "o00000"})),
        P.DropWhile(join, Like({"oid": "o00000"})),
        P.Validate(join, Like({"oid": "o00000"}), "boom"),
        P.SelectCols(join, ("name", "label")),
        P.DropCols(join, ("oid",)),
        P.MapExpr(scan, pkg.Rename({"oid": "order_id"})),
        P.MapExpr(scan, pkg.SetValue("oid", "X")),
        P.MapExpr(scan, pkg.Update(pkg.SetValue("note", "y"), pkg.SetValue("oid", "X"))),
    ]
    out = []
    for bad in cases:
        with pytest.raises(pkg.ViewRejected) as ei:
            pkg.MaterializedView("v", bad, mi)
        assert ei.value.diagnostics
        out.append((str(ei.value), ei.value.diagnostics))
    for call in (
        lambda: pkg.check_view_plan(P.Join(scan, _source(pkg, 8), ("oid",)), ["oid"]),
        lambda: pkg.check_view_plan(join, ["oid"], mode="upsert"),
        lambda: pkg.check_view_plan(
            P.Filter(P.Lookup(None, 0, 4), Like({"oid": "o00001"})), ["oid"]),
        lambda: pkg.MaterializedView("v", P.Top(join, 5), _source(pkg, 8, mode="upsert")),
    ):
        with pytest.raises(pkg.ViewRejected) as ei:
            call()
        out.append((str(ei.value), ei.value.diagnostics))
    # a rejected registration leaves no dangling subscription
    assert mi._listeners == ()
    return out


def test_rejected_shapes_raise_the_references_diagnostics():
    got = _both(_rejections)
    needles = ["Top", "DropRows", "TakeWhile", "DropWhile", "Validate", "projects away",
               "drops source key", "Rename touches", "SetValue overwrites",
               "SetValue overwrites", "MutableIndex", "upsert", "Lookup", "upsert"]
    for (msg, _), needle in zip(got, needles):
        assert needle in msg


def test_accepted_shapes_pass_the_gate():
    def scenario(pkg):
        P = pkg.P
        cust, prod = _dims(pkg)
        ok = P.MapExpr(
            P.Filter(_threeway(pkg, cust, prod), pkg.Like({"prod_id": "p001"})),
            pkg.Update(pkg.Rename({"label": "product"}), pkg.SetValue("src", "live")),
        )
        pkg.check_view_plan(ok, ["oid"])  # does not raise
        pkg.check_view_plan(P.Except(P.Scan(None), cust, ("cust_id",)), ["oid"])
        return [op.__name__ for op in importlib.import_module(f"{pkg.name}.views").DELTA_OPS]

    assert _both(scenario) == ["Filter", "MapExpr", "SelectCols", "DropCols", "Join", "Except"]


def test_delta_facts_match_the_reference():
    """``delta_safe`` / ``key_clobbers`` stage by stage."""
    def scenario(pkg):
        P = pkg.P
        PV = importlib.import_module(f"{pkg.name}.analysis.provenance")
        cust, prod = _dims(pkg)
        root = P.DropCols(P.SelectCols(P.MapExpr(P.Validate(P.Top(
            _threeway(pkg, cust, prod), 3), pkg.Like({"oid": "o1"}), "m"),
            pkg.SetValue("oid", "x")), ("oid", "name")), ("name",))
        return [(f.label, PV.delta_safe(f), PV.key_clobbers(f, ["oid", "name"]))
                for f in PV.plan_facts(root)]

    _both(scenario)


# ---------------------------------------------------------------------------
# incremental maintenance: parity after every batch
# ---------------------------------------------------------------------------


def test_initial_snapshot_parity_and_read():
    def scenario(pkg):
        cust, prod = _dims(pkg)
        view = pkg.MaterializedView("v", _threeway(pkg, cust, prod), _source(pkg, 64))
        obs = [_parity(view), view.snapshot().nrows, view.stats()]
        got = view.read("o00007")
        assert len(got) == 1
        assert got[0]["name"] == f"n{7 % N_CUST:03d}"
        assert got[0]["label"] == f"l{7 % N_PROD:03d}"
        assert view.read("zzz") == []
        return obs + [_rows(got), list(view.columns), _rows(view.rows())]

    assert _both(scenario)[1] == 64


def test_append_delete_resurrect_parity_each_step():
    def scenario(pkg):
        cust, prod = _dims(pkg)
        mi = _source(pkg, 32)
        view = pkg.MaterializedView("v", _threeway(pkg, cust, prod), mi)
        epoch0 = view.epoch
        obs = []
        mi.append_rows([_order(pkg, 100 + j) for j in range(5)])
        assert view.pending == 1
        assert view.refresh() == 1
        obs.append(_parity(view))
        assert view.epoch == epoch0 + 1
        assert len(view.read("o00100")) == 1

        mi.delete(("o00003",))
        mi.delete(("o00102",))
        assert view.refresh() == 2
        obs.append(_parity(view))
        assert view.read("o00003") == [] and view.read("o00102") == []

        # resurrection: the newer segment is untouched by the older tombstone
        mi.append_rows([_order(pkg, 3, cust="c001", prod="p001")])
        view.refresh()
        obs.append(_parity(view))
        assert [r["name"] for r in view.read("o00003")] == ["n001"]

        # append-mode multiset: duplicate keys both live, in tier order
        mi.append_rows([_order(pkg, 3, cust="c002", prod="p002")])
        view.refresh()
        obs.append(_parity(view))
        assert [r["name"] for r in view.read("o00003")] == ["n001", "n002"]
        return obs + [view.stats(), _rows(view.read("o00003")), _rows(view.read(("o0010",)))]

    _both(scenario)


def test_filter_map_chain_view_parity():
    def scenario(pkg):
        P = pkg.P
        cust, prod = _dims(pkg)
        root = P.MapExpr(
            P.Filter(_threeway(pkg, cust, prod), pkg.Like({"prod_id": "p002"})),
            pkg.SetValue("src", "live"),
        )
        mi = _source(pkg, 48)
        view = pkg.MaterializedView("v", root, mi)
        obs = [_parity(view)]
        assert all(r["src"] == "live" for r in view.rows())
        mi.append_rows([_order(pkg, 200, prod="p002"), _order(pkg, 201, prod="p003")])
        view.refresh()
        obs.append(_parity(view))
        assert len(view.read("o00200")) == 1
        assert view.read("o00201") == []
        mi.delete(("o00200",))
        view.refresh()
        obs.append(_parity(view))
        assert view.read("o00200") == []
        return obs + [_rows(view.rows())]

    _both(scenario)


def test_parity_through_leveled_compaction():
    """Compactions rewrite physical tiers but fire NO events: the view's
    segment replay stays a faithful image of the acked stream."""
    def scenario(pkg):
        cust, prod = _dims(pkg)
        mi = _source(pkg, 32)
        view = pkg.MaterializedView("v", _threeway(pkg, cust, prod), mi)
        for j in range(6):
            mi.append_rows([_order(pkg, 300 + 10 * j + k) for k in range(3)])
            mi.delete((f"o{300 + 10 * j:05d}",))
        view.refresh()
        obs = [_parity(view)]
        pend0, epoch0 = view.pending, view.epoch
        while mi.compact_step() is not None:
            assert view.pending == pend0
            obs.append(_parity(view))
        mi.compact_once()
        assert view.pending == pend0 and view.epoch == epoch0
        obs.append(_parity(view))
        assert view.read(f"o{300:05d}") == []
        return obs + [view.stats()]

    _both(scenario)


@pytest.mark.parametrize("seed", [7, 1912])
def test_property_random_interleavings_hold_parity(seed):
    """The reference's seeded property harness: random append/delete
    interleavings (resurrections, duplicate keys, deletes of
    never-present keys, interleaved compaction steps) hold parity at
    EVERY step, with the same checksums in both packages."""
    def scenario(pkg):
        rng = random.Random(seed)
        cust, prod = _dims(pkg)
        mi = _source(pkg, 16)
        view = pkg.MaterializedView("v", _threeway(pkg, cust, prod), mi)
        pool = [f"o{i:05d}" for i in range(24)]
        obs = []
        for _ in range(30):
            op = rng.random()
            if op < 0.55:
                batch = [
                    _order(pkg, int(rng.choice(pool)[1:]),
                           cust=f"c{rng.randrange(N_CUST):03d}",
                           prod=f"p{rng.randrange(N_PROD):03d}")
                    for _ in range(rng.randrange(1, 5))
                ]
                mi.append_rows(batch)
            elif op < 0.9:
                mi.delete((rng.choice(pool),))
            else:
                mi.compact_step()
            view.refresh()
            obs.append(_parity(view))
        mi.compact_once()
        obs.append(_parity(view))
        for key in rng.sample(pool, 6):
            expect = [r for r in view.rows() if r["oid"] == key]
            assert view.read(key) == expect
            obs.append(_rows(expect))
        return obs

    _both(scenario)


# ---------------------------------------------------------------------------
# zero warm recompiles
# ---------------------------------------------------------------------------


def test_view_refresh_zero_warm_recompiles():
    """Fixed-shape batches after one warm-up refresh lower nothing again:
    the binaries' build/load counts and the plan cache's ``lowered`` stay
    flat.  Parity runs outside the watch (recompute executes at a
    different table shape by design)."""
    def scenario(pkg):
        cust, prod = _dims(pkg)
        pc = pkg.PlanCache()
        mi = _source(pkg, 64)
        view = pkg.MaterializedView("v", _threeway(pkg, cust, prod), mi, plancache=pc)
        B = 8

        def batch(base):
            return [_order(pkg, 1000 + base + j,
                           cust=f"c{(base + j) % N_CUST:03d}",
                           prod=f"p{(base + j) % N_PROD:03d}")
                    for j in range(B)]

        mi.append_rows(batch(0))  # warm-up
        view.refresh()
        lowered = pc.stats()["lowered"]
        with pkg.RecompileWatch(plancache=pc) as watch:
            for i in range(1, 5):
                mi.append_rows(batch(i * B))
                if i == 3:
                    mi.delete((f"o{1000 + B:05d}",))
                assert view.refresh() >= 1
            watch.assert_zero()
            assert watch.delta() == {}
        assert pc.stats()["lowered"] == lowered
        return [_parity(view), lowered, pc.stats()["hits"]]

    _both(scenario)


# ---------------------------------------------------------------------------
# crash-safety: the views:refresh fault site
# ---------------------------------------------------------------------------


def test_refresh_fault_leaves_prior_snapshot_and_retries():
    def scenario(pkg):
        cust, prod = _dims(pkg)
        mi = _source(pkg, 32)
        view = pkg.MaterializedView("v", _threeway(pkg, cust, prod), mi)
        before = view.checksums()
        snap0, epoch0 = view.snapshot(), view.epoch
        mi.append_rows([_order(pkg, 400 + j) for j in range(4)])
        mi.delete(("o00001",))
        with pkg.faults.active(pkg.faults.FaultPlan([
            {"site": "views:refresh", "at": [0], "error": "crash"},
        ])):
            with pytest.raises(pkg.faults.InjectedWorkerCrash):
                view.refresh()
            assert view.snapshot() is snap0 and view.epoch == epoch0
            assert view.checksums() == before
            assert view.pending == 2
            assert view.refresh() == 2
        after = _parity(view)
        assert view.pending == 0
        assert view.read("o00001") == []
        return [before, after, view.stats()]

    _both(scenario)


def test_refresh_fault_mid_queue_keeps_failing_event():
    def scenario(pkg):
        cust, prod = _dims(pkg)
        mi = _source(pkg, 16)
        view = pkg.MaterializedView("v", _threeway(pkg, cust, prod), mi)
        mi.append_rows([_order(pkg, 500)])
        view.refresh()
        obs = [_parity(view)]
        mi.append_rows([_order(pkg, 501)])
        mi.append_rows([_order(pkg, 502)])
        with pkg.faults.active(pkg.faults.FaultPlan([
            {"site": "views:refresh", "at": [0], "error": "io"},
        ])):
            with pytest.raises(Exception) as ei:
                view.refresh()
            obs.append(type(ei.value).__name__)
            assert view.pending == 2
            assert view.refresh() == 2
        obs.append(_parity(view))
        assert len(view.read("o00502")) == 1
        return obs

    _both(scenario)


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------


def _host_source(pkg, n=16):
    """A MutableIndex over a host base with no ``ingest_device``: its
    device is None."""
    return pkg.MutableIndex(
        pkg.create_index(pkg.take_rows([_order(pkg, i) for i in range(n)]), ["oid"]))


def test_view_over_a_source_with_no_device_defaults_to_cuda():
    """The reference puts such a view on JAX's default device; the port
    puts it on ``"cuda"``, which raises without a card, never quietly on
    the CPU; no subscription is left behind."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cust, prod = _dims(TP)
    mi = _host_source(TP)
    assert mi.device is None
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TP.MaterializedView("v", _threeway(TP, cust, prod), mi)
    assert mi._listeners == ()
    srv = TP.LookupServer(indexes={"orders": mi})
    with pytest.raises(RuntimeError, match="no CUDA card"):
        srv.register_view("v", _threeway(TP, cust, prod), source="orders")
    assert srv.view_names() == []


def test_view_device_follows_the_source_else_the_callers():
    cust, prod = _dims(TP)
    mi = _source(TP, 16)
    view = TP.MaterializedView("v", _threeway(TP, cust, prod), mi, device="cuda")
    assert view.device == torch.device("cpu")  # the source's device wins
    host = _host_source(TP)
    hv = TP.MaterializedView("h", _threeway(TP, cust, prod), host, device="cpu")
    assert hv.device == torch.device("cpu")
    jcust, jprod = _dims(JP)
    jv = JP.MaterializedView("h", _threeway(JP, jcust, jprod), _host_source(JP))
    assert hv.checksums() == jv.checksums() == hv.recompute_checksums()
    assert _rows(hv.rows()) == _rows(jv.rows())


# ---------------------------------------------------------------------------
# serving integration
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def running(srv):
    srv.start()
    try:
        yield srv
    finally:
        if srv.__class__.__module__.startswith("csvplus_tpu_torch"):
            srv.stop(timeout=WAIT)
        else:
            srv.stop()


def _server_with_view(pkg):
    cust, prod = _dims(pkg)
    mi = _source(pkg, 64)
    srv = pkg.LookupServer(indexes={"orders": mi})
    view = srv.register_view("enriched", _threeway(pkg, cust, prod), source="orders")
    return srv, view, mi


def test_server_registration_gates_and_routes():
    def scenario(pkg):
        srv, view, mi = _server_with_view(pkg)
        assert srv.view_names() == ["enriched"]
        assert srv.view("enriched") is view
        obs = []
        with pytest.raises(KeyError, match="no view registered") as ei:
            srv.view("nope")
        obs.append(str(ei.value))
        cust, prod = _dims(pkg)
        with pytest.raises(pkg.ViewRejected, match="Top") as ei:
            srv.register_view("bad", pkg.P.Top(_threeway(pkg, cust, prod), 3),
                              source="orders")
        obs.append(str(ei.value))
        assert srv.view_names() == ["enriched"]
        imm = pkg.create_index(pkg.take_rows([_order(pkg, i) for i in range(4)]), ["oid"])
        srv2 = pkg.LookupServer(imm)
        with pytest.raises(TypeError, match="not a MutableIndex") as ei:
            srv2.register_view("v", _threeway(pkg, cust, prod))
        obs.append(str(ei.value))
        with pytest.raises(KeyError, match="no index registered") as ei:
            srv.register_view("v", _threeway(pkg, cust, prod), source="nope")
        obs.append(str(ei.value))
        return obs

    _both(scenario)


def _drain(view):
    deadline = time.time() + 10.0
    while view.pending and time.time() < deadline:
        time.sleep(0.005)
    assert view.pending == 0


def test_server_refresh_after_writes_and_metrics():
    def scenario(pkg):
        srv, view, mi = _server_with_view(pkg)
        obs = [_parity(view)]
        with running(srv):
            fs = [srv.submit_append([_order(pkg, 600 + j)], index="orders")
                  for j in range(3)]
            fd = srv.submit_delete(("o00600",), index="orders")
            for f in fs:
                assert f.result(timeout=WAIT) == 1
            assert fd.result(timeout=WAIT) == 1
            _drain(view)
            obs.append(_parity(view))
            assert view.read("o00600") == []
            assert len(view.read("o00601")) == 1
            snap = srv.snapshot()
        cell = snap["by_view"]["enriched"]
        assert cell["refreshes"] >= 1
        assert cell["events"] >= 2
        assert cell["rows_probed"] >= 3
        assert cell["rows_retracted"] >= 1
        assert cell["reads"] == 2
        assert cell["failures"] == 0
        assert cell["epoch"] == view.epoch
        assert snap["by_index"]["orders"]["delete_reqs"] == 1
        return obs + [sorted(cell), cell["reads"], cell["rows_read"]]

    _both(scenario)


def test_server_refresh_is_ordered_after_the_cycles_writes():
    """One dispatch cycle (a fixed 0.3 s tick) holding a write and a
    lookup: the view refreshes after the write landed and before the
    lookup is answered, and the lookup sees the write."""
    def scenario(pkg):
        cust, prod = _dims(pkg)
        mi = _source(pkg, 64)
        srv = pkg.LookupServer(indexes={"orders": mi}, tick_us=300_000)
        view = srv.register_view("enriched", _threeway(pkg, cust, prod), source="orders")
        seen = []
        refresh = view.refresh
        box = {}

        def spy():
            seen.append((len(mi), box["lookup"].done()))
            return refresh()

        view.refresh = spy
        with running(srv):
            fw = srv.submit_append([_order(pkg, 700)], index="orders")
            box["lookup"] = srv.submit("o00700", index="orders")
            assert fw.result(timeout=WAIT) == 1
            got = box["lookup"].result(timeout=WAIT)
            _drain(view)
            snap = srv.snapshot()
        return [seen, _rows(got), _parity(view), _rows(view.read("o00700")),
                snap["by_view"]["enriched"]["refreshes"]]

    got = _both(scenario)
    assert got[0] == [(65, False)] and len(got[1]) == 1 and got[4] == 1


def test_server_refresh_failure_is_counted_and_retried(tmp_path, monkeypatch):
    """A ``views:refresh`` crash inside the dispatcher: the view keeps its
    prior snapshot, the failure is counted in its cell, noted in the
    flight recorder and dumped, the write itself is acked, and the next
    cycle applies the queued event."""
    monkeypatch.setenv("CSVPLUS_FLIGHT_DIR", str(tmp_path))

    def scenario(pkg):
        srv, view, mi = _server_with_view(pkg)
        before = view.checksums()
        dumps0 = srv.plane.flight.snapshot()["dumps"]
        with running(srv):
            with pkg.faults.active(pkg.faults.FaultPlan([
                {"site": "views:refresh", "at": [0], "error": "crash"},
            ])):
                assert srv.submit_append([_order(pkg, 800)], index="orders").result(
                    timeout=WAIT) == 1
                # the write's future completes before its cycle refreshes;
                # the failure is counted, noted, then dumped
                deadline = time.time() + WAIT
                while (srv.plane.flight.snapshot()["dumps"] < dumps0 + 1
                       and time.time() < deadline):
                    time.sleep(0.005)
                assert view.pending == 1 and view.checksums() == before
                failed = [e for e in srv.plane.flight.events()
                          if e["kind"] == "views:refresh-failed"]
                assert srv.plane.flight.snapshot()["dumps"] == dumps0 + 1
                # the next cycle retries the queued event
                assert len(srv.submit("o00001", index="orders").result(timeout=WAIT)) == 1
                _drain(view)
            cell = srv.snapshot()["by_view"]["enriched"]
        assert cell["failures"] == 1 and cell["refreshes"] == 1
        assert len(view.read("o00800")) == 1
        return [before, _parity(view), cell["failures"], cell["events"],
                [(e["view"], e["error"]) for e in failed][-1:]]

    got = _both(scenario)
    assert got[-1] == [("enriched", "InjectedWorkerCrash")]
    assert any(tmp_path.iterdir())
