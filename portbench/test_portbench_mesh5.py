"""The cell ``mesh5-100m.partitioned`` at a tiny size on the CPU, its
four shards on ``cpu``: set-up, the window, the check and the metrics;
the control of its comparison; and runs with the program broken
underneath (the stream order of the shards, half the rows, the hot-key
tier's answers), which must come out not correct.  The partitioned
tier's threshold is lowered on the class so that, as at 100M orders,
the customers join (1,500 keys here) takes the all-to-all tier with
its hot-key broadcast and the products join (1,000) the replicated one.

    python3 -m pytest portbench/test_portbench_mesh5.py -q
"""

from __future__ import annotations

from pathlib import Path

import pytest

from portbench.control import readings
from portbench.harness import Device, load_cell, run_cell, set_up

ROOT = Path(__file__).resolve().parent.parent
NAME = "mesh5-100m.partitioned"
SCALE = {"orders": {"rows": 20_000}, "customers": {"rows": 1_500}}
SEED = 2**31 + 977  # larger than 32 signed bits hold
#: Metrics no CPU run can give: device time, and bytes between two cards.
CARD_ONLY = {"exchange_link_pct", "peer_mb_per_query"}


@pytest.fixture(autouse=True)
def _partitioned(monkeypatch):
    from csvplus_tpu_torch.obs.joinskew import joinskew
    from csvplus_tpu_torch.ops.join import DeviceIndex

    monkeypatch.setattr(DeviceIndex, "PARTITION_MIN_KEYS", 1_200)
    joinskew.reset()
    yield
    joinskew.reset()


def _run(trace: bool, seed: int = SEED) -> dict:
    return run_cell(load_cell(ROOT, NAME), seed, 0.3, trace, device="cpu", scale=SCALE)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_with_its_metrics(trace, capfd):
    cell = load_cell(ROOT, NAME)
    res = _run(trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["units_checked"]["value"] >= 1
    assert res["device"]["count"] == 4
    metrics = cell.per_layer if trace else cell.end_to_end
    if not trace:
        assert set(res["metrics"]) == {"join_rows_per_s", "query_p95_ms", "setup_s"}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        want = {m["name"] for m in metrics} - CARD_ONLY
        assert want == {"ingest_s", "exchange_ms", "skew_broadcast_pct"}
        assert set(res["metrics"]) == want
        assert 0 < res["metrics"]["skew_broadcast_pct"]["value"] < 100
    err = capfd.readouterr().err
    # every unit of the window took both tiers and broadcast a hot key
    window = next(line for line in err.splitlines() if line.startswith("window:"))
    assert "partitioned_probes 1.000" in window and "replicated_probes 1.000" in window
    assert "units_shown 1.000" in window
    assert "re-laid 20000 orders rows over Mesh" in err


def test_same_seed_draws_the_same_units():
    cell = load_cell(ROOT, NAME)
    draws = []
    for _ in range(2):
        unit = set_up(cell, SEED, Device("cpu"), SCALE)
        draws.append([unit.draw(i) for i in range(10)])
    assert draws[0] == draws[1] and len({str(d) for d in draws[0]}) == 10


def test_control_fails_and_program_passes():
    cell = load_cell(ROOT, NAME)
    for seed in (11, 12):
        for program, control in readings(cell, seed, 2, device="cpu", scale=SCALE):
            assert program == {"rows_off": 0, "columns_off": 0, "cells_off": 0}
            assert control["cells_off"] > 0


def _plant(monkeypatch, fault: str) -> None:
    import torch

    from csvplus_tpu_torch.columnar.table import DeviceTable
    from csvplus_tpu_torch.parallel import pjoin
    from csvplus_tpu_torch.parallel.mesh import ShardedRows
    from csvplus_tpu_torch.source import DataSource

    to_table = DataSource.to_device_table
    if fault == "shards_swapped":
        def swapped(self, *a):
            t = to_table(self, *a)
            cols = {}
            for n, c in t.columns.items():
                st = c.storage
                order = list(st.shards[1:]) + [st.shards[0]]
                cols[n] = c.with_storage(ShardedRows(st.mesh, order))
            return DeviceTable(cols, t.nrows, t.device)
        monkeypatch.setattr(DataSource, "to_device_table", swapped)
    elif fault == "half_rows":
        def half(self, *a):
            t = to_table(self, *a)
            mesh = t.mesh
            sel = ShardedRows(mesh, [torch.arange(n // 2) for n in t.shard_lens()])
            return t.gather(sel)
        monkeypatch.setattr(DataSource, "to_device_table", half)
    elif fault == "hot_answers_lost":
        hot = pjoin._hot_answers_device

        def lost(mesh, keys, prepared, wide):
            vals, lo, ct = hot(mesh, keys, prepared, wide)
            return vals, lo, type(ct)(torch.zeros_like(c) for c in ct)
        monkeypatch.setattr(pjoin, "_hot_answers_device", lost)


@pytest.mark.parametrize("fault", ["shards_swapped", "half_rows", "hot_answers_lost"])
def test_broken_program_is_not_correct(monkeypatch, fault):
    _plant(monkeypatch, fault)
    res = _run(False)
    assert res["correct"] is False
    assert any(c["value"] > c["at_most"] for c in res["checks"].values() if "at_most" in c)
