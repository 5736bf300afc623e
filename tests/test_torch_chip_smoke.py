"""``chip_smoke.py``'s phases 4-11 and its stage tables rehearsed on the
CPU at a small size.

Each phase drives the port's public API on ``device="cpu"`` and holds it
against the script's own numpy oracles (row counts, positional
checksums, dictionaries, CSV and JSON bytes); the mask kernel's wrapper
runs its plain version here, so the launch counts are not checked.  The
streamed phases lower ``CSVPLUS_STREAM_MIN_BYTES`` to 1 and the chunk size
to 64 KiB, so their small files stream in many chunks.  Phase 8 (the
plan cache, cascaded and fused) and phase 9 (point lookups and the
serving tier) run at the end of phase 5 on its streamed tables, and
alone here on whole-file tables; phase 9's over-the-cap half runs with
the mirror cap patched below its small table.  Phase 10 (BASELINE
config 4's dedup, write and reload) streams 200,000 rows with 180,000
distinct ids over a lane threshold of 50,000; phase 11 (config 1) runs
200,000 people.  The stage tables printed by phases 4, 5, 9 and 10 must
hold the stages of what they time, and warm (a) must synchronize
nowhere with telemetry off."""

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
}

NO_FILTER = {"10-dedup"}  # phases that run no filter, checked in their own helper


def _stages(table):
    return {s["stage"] for s in table["stages"]}


def _dedup(C, workdir):
    out = C.run_dedup_path(200_000, 180_000, 1, "cpu", workdir, n_find=2_000,
                           lane_threshold=50_000)
    assert out["callback dedup"]["calls"] == out["groups"] > 10_000
    assert out["callback dedup"]["rows_out"] == 180_000
    table = out["stage_table callback dedup"]
    assert _stages(table) == {"dedup:groups", "dedup:decode", "dedup:callback", "dedup:compact"}
    assert out["write"]["bytes"] > 0 and out["find_many"]["probes"] == 2_000
    # the path runs no filter: no call reaches the mask kernel's wrapper
    assert out["launches"] == 0 and out["mask_check"] == {"cases": 0, "max_abs_err": 0}
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


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_chip_smoke_phase_rehearses_on_the_cpu(phase, tmp_path, monkeypatch):
    streamed, run = PHASES[phase]
    monkeypatch.delenv("CSVPLUS_INGEST_WORKERS", raising=False)
    if streamed:
        monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")
        monkeypatch.setenv("CSVPLUS_STREAM_CHUNK_BYTES", str(64 << 10))
    else:
        monkeypatch.delenv("CSVPLUS_STREAM_MIN_BYTES", raising=False)
    out = run(_chip_smoke(), tmp_path)
    if phase not in NO_FILTER:
        assert out["mask_check"]["cases"] > 0 and out["mask_check"]["max_abs_err"] == 0
    if phase == "5-streamed":
        assert out["plancache"]["mask_check"]["max_abs_err"] == 0
        assert out["serving"]["mask_check"]["cases"] > 0
        assert {"ingest:streamed", "ingest:scan", "ingest:place", "ingest:cut",
                "ingest:encode"} <= _stages(out["stage_table_ingest"])
    if phase == "4-main":
        warm = out["stage_table"]
        assert {"Filter", "Join", "join:translate", "join:pack", "join:probe", "join:expand",
                "join:merge"} <= _stages(warm)
        assert warm["counters"]["verify.plans"] >= 1
        assert out["telemetry_cost"]["synchronizes"]["off"] == 0
