"""The harness is driven by data: a configuration, a traffic mix, a unit
kind and a metric added as new files and new BENCHMARK.json entries are
found and run, with no file that is already there edited."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: A unit kind that only filters, as a later mix might bring it.
FILTER_ONLY = """
import numpy as np

from portbench.reference.predicate import evaluate
from portbench.units import Unit as Base
from portbench.units import draw_predicate, no_span, to_program


class Unit(Base):
    KEYS = frozenset({"filter"})

    def draw(self, i, stream=0):
        rng = np.random.default_rng([self.env.seed, 1 + stream, i])
        return draw_predicate(self.env.traffic["filter"], self.env.config["domains"], rng)

    def run(self, pred, span=no_span):
        with span("filter"):
            return self.env.fact.filter(to_program(pred, self.env.T)).to_device_table()

    def rows(self, pred):
        return self.env.data["n"]

    @staticmethod
    def output_table(out):
        return out

    def expected(self, pred):
        e, fact = self.env, self.env.config["fact"]
        keep = np.flatnonzero(evaluate(pred, lambda c: e.ref.column_cells(e.data, fact, c),
                                       e.data["n"]))
        return {c: e.ref.column_cells(e.data, fact, c).take(keep)
                for c in ("order_id", "cust_id", "prod_id", "qty")}
"""


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("kind", ["filter_join", "filter_only"])
def test_new_config_traffic_and_metric_need_no_edit(tmp_path, kind):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    config = json.loads((HERE / "configs" / "join3-10m.json").read_text())
    config.update(name="tiny3", tables={"orders": {"rows": 3000}, "customers": {"rows": 50},
                                        "products": {"rows": 1000}})
    (tmp_path / "portbench" / "configs" / "tiny3.json").write_text(json.dumps(config))
    traffic = {"unit": kind, "filter": {"any": [{"like": ["prod_id", "qty"]}, {"like": ["qty"]}]},
               "warmup": 1, "check_sample": 1}
    if kind == "filter_join":
        traffic["joins"] = [["customers", "cust_id"], ["products"]]
    else:
        (tmp_path / "portbench" / "kinds" / f"{kind}.py").write_text(FILTER_ONLY)
    (tmp_path / "portbench" / "traffic" / "qty_pairs.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench" / "metrics" / "rows_per_query.py").write_text(
        "def read(run):\n    return run.rows / len(run.latencies_s) if run.latencies_s else None\n")
    bench["configs"].append({"name": "tiny3", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny3.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny3.qty_pairs", "config": "tiny3",
                               "traffic": "qty_pairs", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "join3-10m.all" in m["workloads"]:
            m["workloads"].append("tiny3.qty_pairs")
    bench["end_to_end"].append({"name": "rows_per_query", "unit": "rows", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["tiny3.qty_pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = (
        "import json; from pathlib import Path\n"
        "from portbench.harness import load_cell, run_cell\n"
        "cell = load_cell(Path('.'), 'tiny3.qty_pairs')\n"
        "print(json.dumps(run_cell(cell, 5, 0.2, False, device='cpu')))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert set(res["metrics"]) == {"join_rows_per_s", "query_p95_ms", "setup_s",
                                   "rows_per_query"}
    assert res["metrics"]["rows_per_query"]["value"] == 3000

    after = _digests(tmp_path)
    changed = [p for p, h in before.items() if after.get(p) != h and p.name != "BENCHMARK.json"]
    assert changed == []


def test_a_traffic_key_no_code_reads_is_refused(tmp_path):
    """A mix that sets a key its unit kind does not read (such as a
    number of clients the harness does not run) is refused, not run as
    if the key were not there."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    mix = tmp_path / "portbench" / "traffic" / "all.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()), clients=32)))
    code = (
        "from pathlib import Path\n"
        "from portbench.harness import load_cell, run_cell\n"
        "cell = load_cell(Path('.'), 'join3-10m.all')\n"
        "run_cell(cell, 5, 0.2, False, device='cpu', scale={'orders': {'rows': 2000},"
        " 'customers': {'rows': 50}})\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "['clients'] are read by no code" in out.stderr
