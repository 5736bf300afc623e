"""The port's lint (``csvplus_tpu_torch/analysis/astlint.py`` and
``jitlint.py``) held against the JAX package's on the reference's own
fixtures, and its torch rules on fixtures of their own.

The framework-free rules (CTYPES001, THREAD001, LOCK001, FAULT001, IO001,
ENV001-R) give the same ``(code, line)`` findings in both packages on
every fixture of ``tests/test_analysis.py`` and ``tests/test_static_cert.py``
for them.  CTYPES001 also reads the port's two other ``argtypes`` shapes.
SYNC001 and EAGER001, redesigned for eager torch, fire on their shapes,
stay silent on accounted or host-only code, and hold their allowlists to
a written citation and a live site.  COMPILE001 keeps torch.compile,
torch.jit and torch._dynamo out of the port (JIT001, TRACE001 and
RETRACE002 do not apply while nothing traces).  Over the whole tree the
port's CLI exits 0, and the reference's lint finds nothing in the port."""

import subprocess
import sys
from pathlib import Path

import pytest

import test_analysis as RA
from csvplus_tpu.analysis import astlint as JA
from csvplus_tpu_torch.analysis import astlint as TA
from csvplus_tpu_torch.analysis import jitlint as TJ

ROOT = Path(__file__).resolve().parent.parent
HOT = "csvplus_tpu_torch/ops/zz_fake.py"
COLD = "csvplus_tpu_torch/utils/zz_fake.py"

_WAL_SRC = (
    "class W:\n"
    "    def append_record(self, lsn, doc):\n"
    "        self.total = self.total + 1\n"
)

#: ``(source, path)`` of every reference fixture of the framework-free rules.
FRAMEWORK_FREE = {
    "ctypes-bad": (RA.CTYPES_BAD, "<string>"),
    "ctypes-guarded": (RA.CTYPES_GUARDED, "<string>"),
    "ctypes-suppressed": (RA.CTYPES_SUPPRESSED, "<string>"),
    "fault-bad": (RA.FAULT_BAD, "<string>"),
    "fault-tuple-continue": (RA.FAULT_BAD_TUPLE_CONTINUE, "<string>"),
    "fault-ok": (RA.FAULT_OK, "<string>"),
    "fault-suppressed": (RA.FAULT_SUPPRESSED, "<string>"),
    "thread-shared": (RA.THREAD_SHARED_STATE, "scanner.py"),
    "thread-locked": (RA.THREAD_LOCKED_OK, "scanner.py"),
    "thread-no-entry": (RA.THREAD_SHARED_STATE.replace("_scan_encode_chunk", "f"), "<string>"),
    "thread-wal": (_WAL_SRC, "wal.py"),
    "thread-tombstone": (_WAL_SRC.replace("append_record", "delete"), "lsm.py"),
    "io-bare": (RA.IO_BARE_WRITE, "csvplus_tpu/storage/x.py"),
    "io-append-kwarg": (RA.IO_BARE_WRITE.replace('open(path, "w")', 'open(path, mode="ab")'),
                        "csvplus_tpu/storage/x.py"),
    "io-fsync": (RA.IO_FSYNC_OK, "csvplus_tpu/storage/x.py"),
    "io-rename": (RA.IO_RENAME_OK, "csvplus_tpu/storage/x.py"),
    "io-read": ('def load(p):\n    return open(p, "rb").read()\n', "csvplus_tpu/storage/x.py"),
    "io-outside-storage": (RA.IO_BARE_WRITE, "csvplus_tpu/serve/x.py"),
    "lock-nested": (RA.LOCK_NESTED, "joinskew.py"),
    "lock-one-with": (RA.LOCK_NESTED.replace(
        "    with _reg_lock:\n        with _sketch_lock:\n",
        "    with _reg_lock, _sketch_lock:\n        if True:\n"), "joinskew.py"),
    "lock-rounds": (RA.LOCK_ROUNDS_OK, "joinskew.py"),
    "lock-attr-nested": (RA.LOCK_ATTR_NESTED, "serve.py"),
    "lock-canonical": (RA.LOCK_CANONICAL_OK, "view.py"),
    "lock-canonical-reversed": (RA.LOCK_CANONICAL_REVERSED, "view.py"),
    "lock-nested-def": (RA.LOCK_NESTED_DEF_OK, "joinskew.py"),
    "lock-suppressed": (RA.LOCK_SUPPRESSED, "joinskew.py"),
    # tests/test_static_cert.py's ENV001-R fixtures
    "env-direct-read": ("import os\n\nFOO = os.environ.get('CSVPLUS_ZZ', '')\n",
                        "csvplus_tpu/utils/zz_fake.py"),
    "env-unregistered": ("from ..utils.env import env_str\n\n"
                         "X = env_str('CSVPLUS_ZZ_NOT_REGISTERED', 'x')\n",
                         "csvplus_tpu/utils/zz_fake.py"),
    "env-computed-name": ("from ..utils.env import env_int\n\nX = env_int(NAME, 1)\n",
                          "csvplus_tpu/utils/zz_fake.py"),
    "env-registered": ("from ..utils.env import env_int\n\n"
                       "X = env_int('CSVPLUS_SCAN_THREADS', 16)\n",
                       "csvplus_tpu/utils/zz_fake.py"),
}

#: Fixtures that must find something (the rest must find nothing).
FIRING = {"ctypes-bad", "fault-bad", "fault-tuple-continue", "thread-shared", "thread-wal",
          "thread-tombstone", "io-bare", "io-append-kwarg", "lock-nested", "lock-one-with",
          "lock-attr-nested", "lock-canonical-reversed", "env-direct-read",
          "env-unregistered", "env-computed-name"}


def _codes(findings):
    return [(f.code, f.line) for f in findings]


@pytest.mark.parametrize("case", sorted(FRAMEWORK_FREE))
def test_framework_free_rules_match_the_reference(case):
    source, path = FRAMEWORK_FREE[case]
    got, want = _codes(TA.lint_source(source, path)), _codes(JA.lint_source(source, path))
    assert got == want
    assert bool(got) == (case in FIRING), got


def test_framework_free_allowance_lists_are_empty():
    for name in ("THREAD001_ALLOWED", "FAULT001_ALLOWED", "IO001_ALLOWED", "LOCK001_ALLOWED"):
        assert getattr(TA, name) == frozenset() == getattr(JA, name)
    assert TA.LOCK001_CANONICAL_ORDER == JA.LOCK001_CANONICAL_ORDER
    assert TA._WORKER_ENTRY_NAMES == JA._WORKER_ENTRY_NAMES


# -- CTYPES001: the port's other argtypes shapes ---------------------------------

CTYPES_BOUND_FN = """
import ctypes

def setup(lib):
    fn = lib.f
    fn.argtypes = [ctypes.c_void_p, ctypes.c_char]

def call(lib, d):
    lib.f(0, d.encode("utf-8"))
"""

CTYPES_TABLE = """
import ctypes

_CH = ctypes.c_char
_SIGNATURES = {
    "f": (ctypes.c_int64, [ctypes.c_void_p, _CH, _CH]),
    "g": (None, [ctypes.c_void_p]),
}

def setup(lib):
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes

def call(lib, d, c):
    db = d.encode("utf-8")
    if len(db) != 1:
        raise ValueError(d)
    lib.f(0, db, c.encode("utf-8"))
"""


def test_ctypes_reads_a_bound_function_and_a_signature_table():
    (f,) = TA.lint_source(CTYPES_BOUND_FN)
    assert f.code == "CTYPES001" and f.line == 9
    (g,) = TA.lint_source(CTYPES_TABLE)  # the gated delimiter passes, the comment does not
    assert g.code == "CTYPES001" and "parameter 2 of f" in g.message
    gated = CTYPES_TABLE.replace('c.encode("utf-8"))', 'c.encode("utf-8")[0:1])')
    assert TA.lint_source(gated) == []


def test_ctypes_positions_cover_the_ports_native_modules():
    import ast

    pos = TA._c_char_positions(ast.parse((ROOT / "csvplus_tpu_torch/native/scanner.py")
                                         .read_text()))
    ref = TA._c_char_positions(ast.parse((ROOT / "csvplus_tpu/native/scanner.py").read_text()))
    assert pos == ref and pos["csv_scan"] == (2, 3)
    for mod in ("ops/mask.py", "ops/parse.py", "ops/cubuild.py"):  # no c_char parameter
        assert TA._c_char_positions(ast.parse((ROOT / "csvplus_tpu_torch" / mod)
                                              .read_text())) == {}


# -- SYNC001 --------------------------------------------------------------------

_SYNC_FORMS = {
    "np.asarray": "np.asarray(y)",
    "bool": "bool(y)",
    "int": "int(y)",
    "float": "float(y)",
    "len": "len(y)",
    ".item": "y.item()",
    ".tolist": "y.tolist()",
    ".cpu": "y.cpu()",
    ".numpy": "y.numpy()",
    ".nonzero": "y.nonzero()",
    "torch.nonzero": "torch.nonzero(y)",
}


def _sync_src(expr, seed="y = torch.abs(x)"):
    return (
        "import numpy as np\n"
        "import torch\n\n\n"
        "def f(x):\n"
        f"    {seed}\n"
        f"    return {expr}\n"
    )


@pytest.mark.parametrize("form", sorted(_SYNC_FORMS))
def test_sync001_flags_every_form_in_hot_modules_only(form):
    src = _sync_src(_SYNC_FORMS[form])
    assert [f.code for f in TA.lint_source(src, HOT)] == ["SYNC001"]
    assert TA.lint_source(src, COLD) == []


def test_sync001_proves_torch_values_only():
    for seed in ("y = [r for r in x]",  # host values
                 "y = np.abs(x)",
                 "y = torch.zeros(4)",  # a host tensor: no device=
                 "y = torch.from_numpy(x)"):
        assert TA.lint_source(_sync_src("int(y[0]) + len(y)", seed), HOT) == [], seed
    # evidence: a tensor method, an annotated parameter, a class field, a
    # torch argument, a device constructor
    assert TA.lint_source(_sync_src("y.item()", "y = x.to(torch.int32)"), HOT)
    assert TA.lint_source(_sync_src("int(y.sum())", "y = torch.zeros(4, device='cuda')"), HOT)
    assert TA.lint_source("def f(x: torch.Tensor):\n    return x.tolist()\n", HOT)
    assert TA.lint_source("def f(x: 'Optional[torch.Tensor]'):\n    return int(x)\n", HOT)
    assert TA.lint_source("def f(xs: 'Sequence[torch.Tensor]'):\n    return len(xs)\n",
                          HOT) == []
    cls = ("import torch\n\nclass K:\n    keys: Optional[torch.Tensor] = None\n\n"
           "    def host(self):\n        return self.keys.cpu()\n")
    assert [f.code for f in TA.lint_source(cls, HOT)] == ["SYNC001"]
    assert TA.lint_source(_sync_src("x.tolist()", "y = torch.cat([x, x])"), HOT)
    assert TA.lint_source(_sync_src("y.nonzero(size=4)"), HOT) == []


def test_sync001_silent_under_count_sync():
    src = (
        "import numpy as np\n"
        "import torch\n"
        "from ..utils.observe import telemetry\n\n\n"
        "def f(x):\n"
        "    y = torch.abs(x)\n"
        "    out = y.cpu().numpy()\n"
        "    telemetry.count_sync(out.size)\n"
        "    return out\n"
    )
    assert TA.lint_source(src, HOT) == []


def test_sync001_allowlist_entry_blesses_its_site():
    # ops/sort.py:run_starts is a real pinned allowance: the same shape
    # under that file and function name lints clean
    src = _sync_src("y.cpu()").replace("def f(", "def run_starts(")
    assert TA.lint_source(src, "csvplus_tpu_torch/ops/sort.py") == []
    matched = set()
    TA.lint_source(src, "csvplus_tpu_torch/ops/sort.py", matched)
    assert ("SYNC001_ALLOWED", "sort.py:run_starts") in matched


def test_allowlist_citation_free_entry_is_a_finding(monkeypatch):
    monkeypatch.setitem(TJ.SYNC001_ALLOWED, "zz_fake.py:f", "")
    findings = TA.lint_source(_sync_src("int(y)"), HOT)
    assert any("no written citation" in f.message for f in findings)
    monkeypatch.setitem(TJ.SYNC001_ALLOWED, "zz_fake.py:f", "seems fine to me")
    findings = TA.lint_source(_sync_src("int(y)"), HOT)
    assert any("host_sync_elements" in f.message for f in findings)
    # "no transfer" only counts as the opening claim, not as a word match
    monkeypatch.setitem(TJ.SYNC001_ALLOWED, "zz_fake.py:f", "one scalar; no transfer of rows")
    findings = TA.lint_source(_sync_src("int(y)"), HOT)
    assert any("host_sync_elements" in f.message for f in findings)
    monkeypatch.setitem(TJ.SYNC001_ALLOWED, "zz_fake.py:f",
                        "moves one scalar, uncounted in host_sync_elements")
    findings = TA.lint_source(_sync_src("int(y)"), HOT)
    assert not any("host_sync_elements" in f.message for f in findings)
    monkeypatch.setitem(TA.EAGER001_ALLOWED, "zz_fake.py:g", " ")
    findings = TA.lint_source("def g(x):\n    return x\n", HOT)
    assert any(f.code == "EAGER001" and "no written citation" in f.message for f in findings)


def test_allowlist_stale_entry_is_a_global_finding():
    every = ({("SYNC001_ALLOWED", k) for k in TJ.SYNC001_ALLOWED}
             | {("EAGER001_ALLOWED", k) for k in TA.EAGER001_ALLOWED})
    assert TJ.allowlist_global_findings(every) == []
    stale = TJ.allowlist_global_findings(every - {("SYNC001_ALLOWED", "sort.py:run_starts"),
                                                  ("EAGER001_ALLOWED", "join.py:_pack_qk")})
    assert sorted((f.code, f.path) for f in stale) == [("EAGER001", "join.py"),
                                                      ("SYNC001", "sort.py")]
    assert all("stale" in f.message for f in stale)


def test_every_allowance_carries_its_citation():
    for key, citation in TJ.SYNC001_ALLOWED.items():
        assert TJ._cites_accounting(citation), key
        # only the three sites that move nothing say so
        assert citation.startswith("no transfer:") == (
            key in {"mesh.py:_as_tensor", "mesh.py:relayout", "pjoin.py:_search"}), key
    for key, citation in TA.EAGER001_ALLOWED.items():
        assert "ROADMAP.md" in citation and "csvplus_tpu" not in key, key


# -- EAGER001 -------------------------------------------------------------------

EAGER_PACK = """
import torch


def build(cols, shifts):
    key = torch.zeros(4, dtype=torch.int32)
    for c, s in zip(cols, shifts):
        key = key | (c.codes.to(torch.int32) << s)
    return key
"""

EAGER_TRANSLATE = """
import torch


def _translate_by_values(cols, table):
    out = []
    for c in cols:
        pos = torch.searchsorted(table, c.codes)
        hit = torch.index_select(table, 0, pos) == c.codes
        out.append(torch.where(hit, pos, -1))
    return out
"""


def test_eager001_fires_on_eager_per_column_loops_in_hot_modules():
    for src in (EAGER_PACK, EAGER_TRANSLATE):
        (f,) = TA.lint_source(src, "csvplus_tpu_torch/ops/x.py")
        assert f.code == "EAGER001" and "unfused torch" in f.message
        (g,) = TA.lint_source(src, "csvplus_tpu_torch/columnar/table.py")
        assert g.code == "EAGER001"
        assert TA.lint_source(src, "csvplus_tpu_torch/columnar/ingest.py") == []


def test_eager001_silent_on_one_op_per_iteration_and_on_moves():
    one = ("import torch\n\ndef f(cols, dev):\n    out = []\n    for c in cols:\n"
           "        out.append(c.to(dev) + 1)\n    return out\n")
    assert TA.lint_source(one, "csvplus_tpu_torch/ops/x.py") == []
    stacked = ("import torch\n\ndef f(cols):\n"
               "    return torch.where(torch.stack(cols) >= 0, 1, 0)\n")
    assert TA.lint_source(stacked, "csvplus_tpu_torch/ops/x.py") == []


def test_eager001_allowlist_entry_blesses_its_loop():
    src = EAGER_PACK.replace("def build(", "def _pack_qk(")
    matched = set()
    assert TA.lint_source(src, "csvplus_tpu_torch/ops/join.py", matched) == []
    assert ("EAGER001_ALLOWED", "join.py:_pack_qk") in matched


# -- COMPILE001: nothing in the port traces -------------------------------------

@pytest.mark.parametrize("src", [
    "import torch\n\nf = torch.compile(lambda x: x)\n",
    "import torch\n\ng = torch.jit.script(f)\n",
    "import torch._dynamo\n",
    "from torch import compile\n",
    "from torch.jit import trace\n",
])
def test_compile001_flags_every_tracer(src):
    assert [f.code for f in TA.lint_source(src, COLD)] == ["COMPILE001"]


def test_compile001_is_silent_on_eager_torch():
    assert TA.lint_source("import torch\n\nx = torch.compile_fn if False else 1\n", COLD) == []


# -- the whole tree -------------------------------------------------------------

def test_the_ports_tree_lints_clean_through_its_cli():
    res = subprocess.run([sys.executable, "-m", "csvplus_tpu_torch.analysis"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout == ""


def test_the_references_lint_finds_nothing_in_the_port():
    assert JA.lint_paths([ROOT / "csvplus_tpu_torch"]) == []
