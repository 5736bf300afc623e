"""``chip_smoke.py``'s phases 4-16 and its stage tables rehearsed on the
CPU at a small size.

Each phase drives the port's public API on ``device="cpu"`` and holds it
against the script's own numpy oracles (row counts, positional
checksums, dictionaries, CSV and JSON bytes); the kernels' wrappers run
their plain versions here, so the launch counts they measure are 0 (and
are checked to be); the pack calls each device-encoding phase recorded
are still replayed against the plain version.  The device-parse tier, which is the card's default,
is forced on here (``CSVPLUS_DEVICE_PARSE=1``) where the card's run
takes it: phase 4's first leg, phase 5's first run and phases 6, 7, 10,
11 and 12, each of which must reach the device encode.  The
streamed phases lower ``CSVPLUS_STREAM_MIN_BYTES`` to 1 and the chunk size
to 64 KiB, so their small files stream in many chunks.  Phase 8 (the
plan cache, cascaded and fused) and phase 9 (point lookups and the
serving tier) run at the end of phase 5 on its streamed tables, and
alone here on whole-file tables; phase 9's over-the-cap half runs with
the mirror cap patched below its small table.  Phase 10 (BASELINE
config 4's dedup, write and reload) streams 200,000 rows with 180,000
distinct ids over a lane threshold of 50,000; phase 11 (config 1) runs
200,000 people; phase 12 (the mutable index and the server's writes)
10,000 rows in batches of 100; phase 13 (the live views) 2,000 rows, two
batches of 1,000 and two through the server, and ``certify(n=3)``; phase
14 (the flagship on phase 4's legs, then the partitioned probe, its skew
and wide tiers, the sample sort and the graft entry) an 8-shard CPU mesh
(eight shards, so the 90 %-one-value sort must retry as on the card) with
tens of thousands of probes; phase 15 (config 5 through the public API on
sharded tables) a 4-shard mesh over 20,003 streamed orders and 8,005 Zipf
orders, and (c) phase 4's legs on 7 shards; phase 16 (the analysis
suite) its payload against the committed snapshot and three CLI
commands with ``--device cpu``, and (b) inside phases 4 and 15.  The
stage tables printed by phases 4, 5, 9 and 10 must hold the stages of
what they time (phase 4's two feed the stage diff), and warm (a) must
synchronize nowhere with telemetry off; the ``kernels`` line names every
path."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PHASES = {
    "4-main": (False, lambda C, d: C.run_main_path(20_000, 1, "cpu", d)),
    "5-streamed": (True, lambda C, d: C.run_streamed_path(20_000, 1, "cpu", d, serve=SERVE)),
    "6-lane": (True, lambda C, d: C.run_lane_path(20_000, 2_000, 1, "cpu", d,
                                                  lane_threshold=5_000)),
    "7-host-dict": (True, lambda C, d: C.run_host_dict_path(30_000, 1, "cpu", d)),
    "8-plancache": (False, lambda C, d: _plancache(C, d)),
    "9-serving": (False, lambda C, d: _serving(C, d)),
    "10-dedup": (True, lambda C, d: _dedup(C, d)),
    "11-config1": (False, lambda C, d: C.run_config1_path(200_000, 1, "cpu", d)),
    "12-storage": (False, lambda C, d: _storage(C, d)),
    "13-views": (False, lambda C, d: _views(C, d)),
    "13-plancert": (False, lambda C, d: _plancert(C)),
    "14-multidevice": (False, lambda C, d: _multidevice(C)),
    "15-config5": (True, lambda C, d: _config5(C, d)),
    "16-analysis": (False, lambda C, d: _analysis(C)),
    "17-chaos": (False, lambda C, d: _chaos(C, d)),
}

NO_FILTER = {"10-dedup", "12-storage", "14-multidevice"}  # no filter: checked in their helper
DEVICE_PARSED = {"6-lane", "7-host-dict", "10-dedup", "11-config1", "12-storage"}


def _stages(table):
    return {s["stage"] for s in table["stages"]}


def _dedup(C, workdir):
    out = C.run_dedup_path(200_000, 180_000, 1, "cpu", workdir, n_find=2_000,
                           lane_threshold=50_000)
    assert out["callback dedup"]["calls"] == out["groups"] > 10_000
    assert out["callback dedup"]["rows_out"] == 180_000
    table = out["stage_table callback dedup"]
    # the compaction packs the kept rows' index again (its index:pack)
    assert _stages(table) == {"dedup:groups", "dedup:decode", "dedup:callback", "dedup:compact",
                              "index:pack"}
    assert out["write"]["bytes"] > 0 and out["find_many"]["probes"] == 2_000
    # the path runs no filter: no call reaches the mask kernel's wrapper
    assert out["launches"] == 0 and out["mask_check"] == {"cases": 0, "max_abs_err": 0}
    return out

def _storage(C, workdir):
    # The card's run has its merge readers probe without a pause.  Here
    # every probe is host numpy calls that drop and retake the interpreter
    # lock, which starves the merging thread (a 12K-row merge then takes
    # minutes, against a fiftieth of a second with no reader; PERF.md, open
    # questions), so the rehearsal's readers pause a millisecond a probe.
    out = C.run_storage_path(10_000, 1, "cpu", workdir, batch_rows=100, n_lookups=100,
                             reader_pause_s=0.001, f4=True)
    assert out["recompiles"] == 0
    assert set(out["lookups"]) == {"0", "4", "16"}
    assert out["steps"]["16 tiers + tombstones"]["deltas"] > 16
    assert out["steps"]["full merge"]["deltas"] == 0
    assert out["compaction"]["leveled_fold"]["kind"] == "partial"
    assert out["recovery"]["records"] == 2 and out["server"]["acks"] == [100, 1]
    assert out["append_csv"]["rows"] == 100
    assert out["steps"]["append_csv"]["deltas"] == out["steps"]["recovered"]["deltas"] + 1
    assert out["steps"]["quiet full merge"]["deltas"] == 0
    assert out["compaction"]["readers"] == 2 and out["compaction"]["quiet_full_merge_s"] > 0
    # F4: the same full merge on four recovered clones, quiet and under
    # each load, and one find_rows's host syncs (none on the CPU)
    f4 = out["f4"]
    assert f4["find_rows"]["syncs"] == 0 and f4["find_rows"]["tiers"] > 1
    rows = {(f4[name]["rows_in"], f4[name]["rows_out"]) for name in ("quiet", "readers",
                                                                     "python", "switch")}
    assert len(rows) == 1 and f4["quiet"]["host_syncs"] == 0
    for name in ("readers", "python", "switch"):
        assert f4[name]["calls_per_s_alone"] > 0 and f4[name]["full_merge_s"] > 0
    return out


def _views(C, workdir):
    out = C.run_views_path(2_000, 1, "cpu", workdir, batch_rows=1_000, n_batches=2,
                           n_reads=200, server_batches=2)
    # registration, warm-up, 2 batches, 2 server batches, a delete, the fault
    assert out["steps"] == 8 and out["deletes"] == 0
    assert out["launches"] == 0  # the plain version counts no launch
    # the filtered view's mask at a write batch's size and at the source's
    assert out["mask_calls_by_n"]["1000"] >= 4 and "2000" in out["mask_calls_by_n"]
    assert out["trace"]["problems"] == [] and out["trace"]["view_spans"]["view:refresh"] > 0
    cells = out["server"]["cells"]
    assert cells["orders_enriched"]["failures"] == 1 and cells["orders_filtered"]["failures"] == 0
    assert len(out["server"]["refresh_after_write_ms"]) == 3
    for name in ("orders_enriched", "orders_filtered"):
        assert out["summary"][name]["refresh_max_ms"] > 0
    assert out["reads"]["n"] == 200
    return out


def _config5(C, workdir):
    """Phase 15 (a), (b) and (e) on a 4-shard CPU mesh: 20,003 streamed
    orders (padded), then 8,005 Zipf orders over 3,000 customers with the
    partition threshold at 2,000 (the 1,000 products stay under it)."""
    out = C.run_config5_path(1, "cpu", workdir, "cpu", n_orders=20_003, shards=4,
                             n_skew=8_005, n_skew_cust=3_000, partition_min_keys=2_000, reps=1)
    assert out["ingest"]["shard_rows"] == {i: 5_001 for i in range(4)}
    assert out["join"]["rows"] == 20_003 and out["join"]["assemblies"] == 0
    assert out["e"] is None and out["launches"] == 0  # the plain version counts no launch
    runs = out["b"]["runs"]
    assert set(runs) == {"skew on", "skew off", "plan cache fused"}
    assert runs["skew on"]["hot_keys"] and not runs["skew off"]["hot_keys"]
    assert runs["plan cache fused"]["expand_path"] == ["multiway-unique-identity"]
    assert out["b"]["stored_rows"] == 8_008
    got = out["analysis"]  # phase 16 (b) on the sharded join
    assert got["ok"] and got["row_placement"].startswith("sharded")
    assert got["scans"] == [("Scan[0]", 20_003)]
    return out


def _multidevice(C):
    """Phase 14 (b)-(e) on an 8-shard CPU mesh, thousands of probes: every
    leg against its numpy oracle inside the script; here its evidence."""
    stats = {}
    out = C.run_multidevice_path(1, "cpu", stats, "cpu", shards=8, n_keys=40_000,
                                 n_probes=80_000, n_zipf=40_000, n_wide=24_000,
                                 n_wide_keys=10_000, n_sort=40_000, n_sort_wide=24_000,
                                 n_sort_skew=24_000)
    assert out["b1"]["hits"] > 0 and out["b1"]["absent"] > 0 and out["b1"]["invalid"] > 0
    assert out["b1"]["max_count"] > 1  # repeated build keys
    assert out["b2"]["hot_keys"] > 0 and out["b2"]["rows_broadcast"] > 0
    assert out["b2_naive"]["hot_keys"] == 0 and out["b2_naive"]["syncs"] == 1
    assert out["b3_zipf"]["hot_keys"] > 0
    assert out["c3"]["retries"] >= 1 and out["c1"]["retries"] == 0
    assert len(out["d_dryrun"]["paths"]) == 7 and out["e"] is None
    assert out["launches"] == {"mask": 0, "pack": 0}
    rows = {r["name"]: r for r in C.xla_rows(stats)}
    for name in ("threeway_step", "_probe_spmd", "_probe_spmd2", "_probe_spmd_dev",
                 "_probe_spmd_dev2", "broadcast_probe", "_dsort_spmd"):
        assert rows[name]["launches"] > 0 and rows[name]["bound_ms"] > 0, name
    return {"mask_check": {"cases": 0, "max_abs_err": 0}, **out}


def _plancert(C):
    out = C.run_plancert_path(3, "cpu")
    assert out["summary"]["ok"] and out["summary"]["plans_total"] == 366
    assert out["launches"] == 0
    return out


# phase 9 at a rehearsal size: (s1) 20,000 rows, (s2) over a cap of 1,000
SERVE = dict(n_rows=20_000, n_find=300, n_requests=640, n_plans=20, cap=1_000)


def _plancache(C, workdir):
    import csvplus_tpu_torch as T

    data = C.generate(workdir, 20_000, 1)
    orders = T.from_file(str(data["paths"]["orders"])).on_device("cpu")
    _, cust, prod = C._index_dims(data, "cpu")
    out = C.run_plancache_path(orders, cust, prod, data, "cpu", label="20K")
    for leg in ("cascaded", "fused"):
        st = out["legs"][leg]["stats"]
        assert st["optimize_failed"] == 0 and st["hits"] == 3 and st["lowered"] == 3
    assert out["legs"]["cascaded"]["stats"]["fused"] == 0
    assert out["legs"]["fused"]["stats"]["fused"] == 3
    assert "fused-unique-identity" in out["legs"]["fused"]["expand_paths"]
    assert "multiway-unique-identity" in out["legs"]["fused"]["expand_paths"]
    assert 0 < out["except"]["rows_out"] < 20_000
    return out


def _serving(C, workdir):
    import csvplus_tpu_torch as T

    data = C.generate(workdir, 20_000, 1)
    orders = T.from_file(str(data["paths"]["orders"])).on_device("cpu")
    out = C.run_serving_path(orders, data, "cpu", workdir, 1, **SERVE)
    batch = out["s2"]["stage_table_batch"]
    assert {"serve:dispatch", "serve:bounds", "serve:gather-decode", "serve:deliver"} <= _stages(
        batch)
    assert batch["counters"]["serve.dispatched"] == 32
    for part in ("s1", "s2"):
        snap = out[part]["server"]
        assert snap["completed"] == 640 and snap["degraded"] == 0 and snap["retried"] == 0
        assert snap["breaker"] == {"state": "closed", "consecutive_failures": 0,
                                   "opened_total": 0}
    plans = out["s2"]["plans"]
    assert plans["warm"]["hits"] == 20 and plans["warm"]["lowered"] == 0
    assert plans["cold"]["lowered"] == 1
    return out


def _chaos_state(C, workdir):
    """What phases 4, 9, 12 and 13 leave for phase 17, at a small size:
    phase 4's 20,000 orders, (s1)'s index over 20,000 rows, (s2)'s
    indexes over the orders with the mirror cap patched between them and
    (s1)'s, phase 12's durable index, and the view case's record."""
    import csvplus_tpu_torch as T
    from csvplus_tpu_torch.resilience import chaos as G
    from csvplus_tpu_torch.storage import MutableIndex

    data = C.generate(workdir, 20_000, 1)
    path, ids = C._serve_csv(workdir, 20_000)
    s1 = T.from_file(str(path)).on_device("cpu").unique_index_on("cust_id").sync()
    orders = T.from_file(str(data["paths"]["orders"])).on_device("cpu")
    pred = T.Any(*[T.Like({"prod_id": f"p{i}"}) for i in range(1, C.N_PLAN_PRODUCTS + 1)])
    plan = orders.index_on("cust_id").find(f"c{data['cust'][0]}").filter(pred).plan
    base = T.from_file(str(path)).on_device("cpu").index_on("cust_id").sync()
    mi = MutableIndex(base, mode="append", directory=str(workdir / "mutable"))
    mi.append_rows([{"cust_id": "d1", "v": "dv1"}])
    view = G.with_timeout("view_refresh_crash", lambda: G.case_view_refresh_crash(device="cpu"))
    return {"orders": data, "s1": (s1, ids),
            "s2": {"order_idx": orders.unique_index_on("order_id").sync(),
                   "order_probes": [f"o{i}" for i in range(0, 20_000, 331)] + ["o99999"],
                   "plan": plan, "cap": 50_000},
            "storage": {"mi": mi, "probes": [("c0",), ("c21",), ("d1",), ("n5",), ("zz",)]},
            "view": view}


def _chaos(C, workdir):
    """Phase 17 on the CPU: the ten cases on the small state, each
    ``ok``; the plan's mask calls and the device-parse leg's pack calls
    are recorded and replayed; the gate's scratch goes."""
    out = C.run_chaos_path(_chaos_state(C, workdir), "cpu", "cpu", serve_probes=2_000,
                           clients=8, pending=64, chunk_bytes=64 << 10, wal_base_rows=400,
                           workdir=workdir)
    cases = out["cases"]
    assert out["summary"]["value"] == 10 and out["summary"]["failed"] == []
    assert cases["serve_retry"]["plan"]["bitwise_equal"] and cases["serve_retry"]["requests"] == 2_000
    assert cases["serve_degrade"]["above_cap"]["ok"]
    assert cases["dispatcher_crash"]["pending_futures"] == 64
    legs = cases["ingest_crash_recovery"]["per_workers"]
    assert set(legs) == {"device-parse", "K=1", "K=2", "K=4"}
    assert legs["device-parse"]["workers"] == 1 and legs["K=4"]["workers"] == 4
    assert cases["ingest_crash_recovery"]["oracle_equal"]
    assert cases["mesh_join_under_ingest_faults"]["rows"] == 20_000
    assert cases["storage_compact_crash"]["served"]
    assert cases["wal_crash_matrix"]["windows_total"] == 8
    assert out["launches"] == out["pack_launches"] == 0  # the plain versions launch nothing
    assert out["mask_check"]["cases"] > 0 and out["pack_check"]["cases"] > 0
    assert not [p for p in workdir.iterdir() if p.name.startswith("chaos-")]
    return out


def test_chaos_phase_fails_when_a_case_fails(tmp_path, monkeypatch):
    """A failed case, or one that raises, fails phase 17: nothing
    catches it and carries on."""
    from csvplus_tpu_torch.resilience import chaos as G

    C = _chip_smoke()
    state = _chaos_state(C, tmp_path)
    monkeypatch.setattr(G, "case_disarmed_overhead", lambda *a, **k: {"ok": False})
    monkeypatch.setattr(G, "case_wal_crash_matrix", lambda *a, **k: 1 / 0)
    with pytest.raises(AssertionError, match="disarmed_overhead.*wal_crash_matrix"):
        C.run_chaos_path(state, "cpu", "cpu", serve_probes=500, clients=4, pending=16,
                         chunk_bytes=64 << 10, workdir=tmp_path)


def _analysis(C):
    """Phase 16 (a) and (c) on the CPU: the payload against the committed
    snapshot, and the three CLI commands with ``--device cpu``."""
    out = C.run_analysis_path("cpu", ROOT, "cpu")
    assert out["launches"] == 0  # the plain version counts no launch
    assert out["plan_cert_cli"]["ok"] and out["plan_cert_cli"]["plans_total"] == 366
    return out


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_chip_smoke_phase_rehearses_on_the_cpu(phase, tmp_path, monkeypatch):
    streamed, run = PHASES[phase]
    monkeypatch.delenv("CSVPLUS_INGEST_WORKERS", raising=False)
    monkeypatch.delenv("CSVPLUS_DEVICE_PARSE", raising=False)
    if phase in DEVICE_PARSED:
        monkeypatch.setenv("CSVPLUS_DEVICE_PARSE", "1")
    from csvplus_tpu_torch.ops import parse as P

    encodes = []
    real = P.encode_column_device
    monkeypatch.setattr(P, "encode_column_device",
                        lambda *a: encodes.append(1) or real(*a))
    if streamed:
        monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")
        monkeypatch.setenv("CSVPLUS_STREAM_CHUNK_BYTES", str(64 << 10))
    else:
        monkeypatch.delenv("CSVPLUS_STREAM_MIN_BYTES", raising=False)
    if phase == "4-main":  # phase 15 (c)'s index build takes the sample sort at any size
        from csvplus_tpu_torch.ops import sort as TS

        monkeypatch.setattr(TS, "DSORT_MIN_ROWS", 1)
    out = run(_chip_smoke(), tmp_path)
    if phase in DEVICE_PARSED:
        assert encodes, "the phase never reached the device encode"
    if phase in DEVICE_PARSED - {"12-storage"}:
        assert out["pack_launches"] == 0  # the plain version counts no launch
        # every call the device encode made, replayed against the plain version
        assert out["pack_check"]["cases"] > 0 and out["pack_check"]["max_abs_err"] == 0
    if phase not in NO_FILTER and phase != "4-main":
        assert out["mask_check"]["cases"] > 0 and out["mask_check"]["max_abs_err"] == 0
    if phase == "5-streamed":
        assert out["plancache"]["mask_check"]["max_abs_err"] == 0
        assert out["serving"]["mask_check"]["cases"] > 0
        assert {"ingest:streamed", "ingest:scan", "ingest:place", "ingest:cut",
                "ingest:encode"} <= _stages(out["stage_table_ingest"])
        ingest = out["ingest"]
        assert ingest["default"]["workers"] == 1 and ingest["auto"]["workers"] >= 1
        assert ingest["default"]["pack_launches"] == ingest["auto"]["pack_launches"] == 0
    if phase == "4-main":
        legs = out["legs"]
        assert encodes  # the device-parsed leg
        for name, leg in legs.items():
            assert set(leg["ingest_tiers"].values()) == {name}
            assert leg["mask_check"]["cases"] > 0 and leg["mask_check"]["max_abs_err"] == 0
            assert leg["pack_launches"] == 0  # the plain version counts no launch
            assert (leg["pack_check"]["cases"] > 0) == (name == "device-parsed")
            assert leg["pack_check"]["max_abs_err"] == 0
            assert {"Filter", "Join", "join:translate", "join:probe", "join:expand",
                    "join:merge"} <= _stages(leg["stage_table"])
        diff = _chip_smoke().check_stage_diff(out)
        assert set(diff) == {"flagged", "only_in_a", "only_in_b"}
        warm = legs["native-encoded"]["stage_table"]
        assert "join:pack" in _stages(warm)
        assert warm["counters"]["verify.plans"] >= 1
        assert legs["native-encoded"]["telemetry_cost"]["synchronizes"]["off"] == 0
        for name, leg in legs.items():  # phase 15 (c): the leg's file on 7 shards
            sh = leg["sharded"]
            assert sh["shard_rows"] == {i: 2_858 for i in range(7)}
            assert sh["flagship_paths"]["padded"] >= 1 and sh["mask_check"]["cases"] >= 7
            assert (sh["pack_check"]["cases"] > 0) == (name == "device-parsed")
        # phase 16 (b) on the native leg's pipeline (a)
        got = legs["native-encoded"]["analysis"]
        assert got["ok"] and got["row_placement"] == "device"
        assert got["scans"] == [("Scan[0]", 20_000)] and got["analysis_ms"] > 0
        assert legs["device-parsed"]["analysis"] is None
        for leg in legs.values():  # phase 14 (a): the flagship on each leg's tables
            flag = leg["flagship"]
            assert 0 < flag["partial_rows"] < 20_000
            assert flag["run_warm_s"] > 0 and flag["plain_warm_s"] > 0


def test_kernels_line_lists_every_path():
    """The ``kernels`` line's keys and its paths, the views and plancert
    paths among them, from stand-in phase results."""
    C = _chip_smoke()
    timing = {"ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5, "bound_by": "bytes"}
    mask = {"max_abs_err": 0, "timings": [dict(timing, n=10, k=2, mode="all", library_ms=None)]}
    pack = {"max_abs_err": 0, "timing": dict(timing, m=10, lanes=2)}
    names = ["10M device-parsed", "10M native-encoded", "50M streamed", "50M plan cache",
             "serving", "14M lane dictionary", "13M host dictionary", "50M config 4 dedup",
             "10M config 1", "1M views", "plancert", C.C5_MAIN_PATH, C.C5_PACK_PATH,
             "phase 15 (c) 10M native-encoded, 7 shards", C.CHAOS_PATH]
    paths = {n: {"launches": i, "pack_launches": 0, "mask_check": {"max_abs_err": 0}}
             for i, n in enumerate(names)}
    streamed = {"ingest": {"default": {"pack_launches": 0}, "auto": {"pack_launches": 0}}}
    plancache = {"legs": {"cascaded": {"launches": 4}, "fused": {"launches": 4}},
                 "except": {"launches": 1}}
    multidevice = {"launches": {"mask": 0, "pack": 0}}
    kernels = C.kernels_line(mask, pack, paths, streamed, plancache, multidevice)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for k in kernels:
        assert keys <= set(k) and k["route"] == "cuda" and (ROOT / k["source"]).exists()
    by_path = kernels[0]["launches_by_path"]
    assert by_path[C.C5_MAIN_PATH] == kernels[0]["launches"] == names.index(C.C5_MAIN_PATH)
    assert by_path["1M views"] == names.index("1M views")
    assert by_path["plancert"] == names.index("plancert")
    assert by_path[C.CHAOS_PATH] == names.index(C.CHAOS_PATH)
    assert C.CHAOS_PATH in kernels[1]["launches_by_path"]
    assert set(names) <= set(by_path)
    assert by_path["phase 14 multi-device"] == 0
    assert kernels[1]["launches_by_path"]["phase 14 multi-device"] == 0
