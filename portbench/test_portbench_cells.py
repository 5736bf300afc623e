"""Each cell of BENCHMARK.json at a tiny size on the CPU: set-up, the
window, the check and the metrics; the control of each comparison; and
a run with the program broken underneath, which must come out not
correct.

    python3 -m pytest portbench -q
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from portbench.control import readings
from portbench.harness import load_cell, run_cell

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]

#: Test sizes by configuration (the command line never passes one).
SCALE = {
    "join3-10m": {"orders": {"rows": 20_000}, "customers": {"rows": 500}},
    "dedup4-50m": {"orders": {"rows": 30_000, "distinct_order_ids": 27_000,
                              "customers": 500}},
}
SEED = 2**31 + 977  # larger than 32 signed bits hold, as the driver's are


def _run(name: str, trace: bool, seed: int = SEED) -> dict:
    cell = load_cell(ROOT, name)
    return run_cell(cell, seed, 0.3, trace, device="cpu", scale=SCALE[cell.config["name"]])


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_runs_correct_with_its_metrics(name, trace):
    cell = load_cell(ROOT, name)
    res = _run(name, trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks" and res["checks"]["units_checked"]["value"] >= 1
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device"}
    metrics = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in metrics}
    assert set(res["metrics"]) <= names
    if not trace:  # the host-clock metrics exist on any device
        assert set(res["metrics"]) == names
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:  # no device metric is read off a CPU run, and every other one is
        assert {m["name"] for m in metrics if m["source"] != "device_trace"} \
            == set(res["metrics"])
        assert "breakdown" in res and {"busy_s", "window_s"} <= set(res["device"])


@pytest.mark.parametrize("name", WORKLOADS)
def test_same_seed_draws_the_same_units(name):
    cell = load_cell(ROOT, name)
    from portbench.harness import Device, set_up

    draws = []
    for _ in range(2):
        unit = set_up(cell, SEED, Device("cpu"), SCALE[cell.config["name"]])
        draws.append([unit.draw(i) for i in range(20)])
    assert draws[0] == draws[1]
    if draws[0][0] is not None:  # fresh predicates: no repeat in a run
        assert len({json.dumps(d) for d in draws[0]}) == 20


@pytest.mark.parametrize("name", WORKLOADS)
def test_control_fails_and_program_passes(name):
    cell = load_cell(ROOT, name)
    for seed in (11, 12, 13):
        for program, control in readings(cell, seed, 2, device="cpu",
                                         scale=SCALE[cell.config["name"]]):
            assert program == {"rows_off": 0, "columns_off": 0, "cells_off": 0}
            assert control["cells_off"] > 0


# -- faults planted under the timed path -------------------------------------


def _alter_first(table, column: str) -> None:
    """Change row 0's value of *column* where the result is produced."""
    col = table.columns[column]
    st = col.storage.clone()
    if col.kind == "int":
        st[0] += 1
        table.columns[column] = col.with_storage(st)
    else:
        st[0] = (st[0] + 1) % col.dict_size
        table.columns[column] = col.with_codes(st)


def _half(table):
    return table.gather(torch.arange(table.nrows // 2))


def _plant(monkeypatch, fault: str) -> None:
    from csvplus_tpu_torch.index import Index
    from csvplus_tpu_torch.source import DataSource

    to_table, resolve = DataSource.to_device_table, Index.resolve_duplicates
    if fault == "filter_unchanged":
        monkeypatch.setattr(DataSource, "filter", lambda self, pred: self)
    elif fault == "dedup_unchanged":
        monkeypatch.setattr(Index, "resolve_duplicates", lambda self, how: None)
    elif fault == "join_half_rows":
        monkeypatch.setattr(DataSource, "to_device_table",
                            lambda self, *a: _half(to_table(self, *a)))
    elif fault == "join_value_altered":
        def altered(self, *a):
            t = to_table(self, *a)
            _alter_first(t, "name")
            return t
        monkeypatch.setattr(DataSource, "to_device_table", altered)
    elif fault == "dedup_half_rows":
        def half(self, how):
            resolve(self, how)
            self.device_table.table = _half(self.device_table.table)
        monkeypatch.setattr(Index, "resolve_duplicates", half)
    elif fault == "dedup_value_altered":
        def altered_index(self, how):
            resolve(self, how)
            _alter_first(self.device_table.table, "qty")
        monkeypatch.setattr(Index, "resolve_duplicates", altered_index)


FAULTS = [
    # the all-pass filter drops ~1 row in 100,000: at the test size a
    # query left unfiltered often drops none, so the selective cell
    # carries the unchanged-state fault of the filter
    ("join3-10m.selective", "filter_unchanged"),
    ("join3-10m.all", "join_half_rows"),
    ("join3-10m.selective", "join_half_rows"),
    ("join3-10m.all", "join_value_altered"),
    ("join3-10m.selective", "join_value_altered"),
    ("dedup4-50m.first", "dedup_unchanged"),
    ("dedup4-50m.first", "dedup_half_rows"),
    ("dedup4-50m.first", "dedup_value_altered"),
]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_broken_program_is_not_correct(monkeypatch, name, fault):
    _plant(monkeypatch, fault)
    res = _run(name, False)
    assert res["correct"] is False
    assert any(c["value"] > c["at_most"] for c in res["checks"].values() if "at_most" in c)
