"""``chip_smoke.py``'s phases 4-12 and its stage tables rehearsed on the
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
10,000 rows in batches of 100.  The stage tables printed by phases 4, 5,
9 and 10 must hold the stages of what they time, and warm (a) must
synchronize nowhere with telemetry off."""

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
}

NO_FILTER = {"10-dedup", "12-storage"}  # no filter: checked in their own helper
DEVICE_PARSED = {"6-lane", "7-host-dict", "10-dedup", "11-config1", "12-storage"}


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

def _storage(C, workdir):
    # The card's run has its merge readers probe without a pause.  Here
    # every probe is host numpy calls that drop and retake the interpreter
    # lock, which starves the merging thread (a 12K-row merge then takes
    # minutes, against a fiftieth of a second with no reader; PERF.md, open
    # questions), so the rehearsal's readers pause a millisecond a probe.
    out = C.run_storage_path(10_000, 1, "cpu", workdir, batch_rows=100, n_lookups=100,
                             reader_pause_s=0.001)
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
        warm = legs["native-encoded"]["stage_table"]
        assert "join:pack" in _stages(warm)
        assert warm["counters"]["verify.plans"] >= 1
        assert legs["native-encoded"]["telemetry_cost"]["synchronizes"]["off"] == 0
