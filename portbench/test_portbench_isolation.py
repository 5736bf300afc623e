"""The benchmark stands apart from JAX and from the JAX package.

Top-level module names are compared whole: the port's package name
begins with the JAX package's, so a prefix match would be wrong.
"""

from __future__ import annotations

import ast
import re
import shutil
import subprocess
import sys
from pathlib import Path

from portbench.run import FORBIDDEN

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SOURCES = sorted(HERE.rglob("*.py"))


def _imports(path: Path) -> set:
    """Top-level names of every module *path* imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".", 1)[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    assert len(SOURCES) > 10
    for path in SOURCES:
        assert not (_imports(path) & FORBIDDEN), path


def test_whole_name_comparison():
    assert "csvplus_tpu_torch".split(".", 1)[0] not in FORBIDDEN
    assert "csvplus_tpu.ops".split(".", 1)[0] in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        assert not (_imports(path) & {"csvplus_tpu_torch", "torch"}), path


def test_nothing_reads_the_jax_package_benches():
    pattern = re.compile(r"\bbench(_\w+)?\.py|BENCH_|NORTHSTAR_|MULTICHIP_|bench_\w+_floor")
    for path in SOURCES:
        if path.name.startswith("test_"):
            continue
        assert not pattern.search(path.read_text()), path


def test_a_cpu_run_loads_no_jax():
    """A run's process, once the window has closed, holds none of the
    forbidden top-level names."""
    code = (
        "import sys, json; from pathlib import Path\n"
        "from portbench.harness import load_cell, run_cell\n"
        "from portbench.run import forbidden_modules\n"
        "cell = load_cell(Path('.'), 'join3-10m.all')\n"
        "res = run_cell(cell, 3, 0.2, False, device='cpu', scale={'orders': {'rows': 5000},"
        " 'customers': {'rows': 200}})\n"
        "print(json.dumps([res['correct'], forbidden_modules()]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[true, []]"


def test_no_card_means_no_result():
    """The command line finds no card here: it exits non-zero and prints
    nothing on standard output."""
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "join3-10m.all",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ has no
    program to run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "join3-10m.all",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
