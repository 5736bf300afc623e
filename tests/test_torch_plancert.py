"""The port's plan-space certifier (``csvplus_tpu_torch/analysis/
plancert.py``) held against the JAX package's on the CPU.

With both packages' build-side sketch registries empty, ``certify`` at
n = 2 and n = 3 gives the same ``summary_json`` in both (28 and 366
plans), and both are ``ok``.  With the same hot build-side sketches
installed in both, the cost model ranks ``join_dim`` / ``join_cat`` ahead
of ``except_dim`` and the certifier refuses the rewriter's permutation
in both alike: that is the known defect of the reference, which its
``tests/test_static_cert.py::test_plancert_default_space_certifies_with_
rejections`` meets when earlier tests in its worker left such sketches
behind.  The port reproduces it and does not repair it.

Every test restores the sketches, environment variables and fault plans
it touches, in both packages."""

import importlib

import pytest

#: The sketches that reproduce the reference's failure: 32 distinct keys
#: at equal counts under each corpus join's build label ("id" for
#: ``join_dim``, "cat" for ``join_cat``).  A build side that flat and
#: that wide prices each join's fan-out under the 0.5 survival the cost
#: model gives an ``Except`` (8 x 1/32 and 3 x 1/32), so the rewriter's
#: join ranking moves the ``Join`` ahead of the ``Except``.
HOT_SKETCHES = {
    "id": [str(i) for i in range(32)],
    "cat": [f"k{i}" for i in range(32)],
}

#: What the certifier reports under :data:`HOT_SKETCHES`, in both packages.
HOT_FAILURES = [
    "scan>except_dim>join_dim: permute moves non-mover Join[2]",
    "scan>except_dim>join_cat: permute moves non-mover Join[2]",
    "lookup>except_dim>join_dim: permute moves non-mover Join[2]",
]


class _Pkg:
    def __init__(self, name):
        self.name = name
        self.pc = importlib.import_module(f"{name}.analysis.plancert")
        self.joinskew = importlib.import_module(f"{name}.obs.joinskew").joinskew
        self.faults = importlib.import_module(f"{name}.resilience.faults")
        self.P = importlib.import_module(f"{name}.plan")
        an = importlib.import_module(f"{name}.analysis")
        self.verify_plan, self.optimize_plan = an.verify_plan, an.optimize_plan

    def certify(self, **kw):
        if self.name == "csvplus_tpu_torch":
            kw["device"] = "cpu"
        return self.pc.certify(**kw)

    def corpus(self):
        if self.name == "csvplus_tpu_torch":
            return self.pc._corpus("cpu")
        return self.pc._corpus()


TP = _Pkg("csvplus_tpu_torch")
JP = _Pkg("csvplus_tpu")
PKGS = (TP, JP)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Empty sketch registries and no fault plan in both packages for the
    test; whatever sketches were there before come back after it."""
    saved = []
    for p in PKGS:
        with p.joinskew._lock:
            saved.append((dict(p.joinskew._build_sketches),
                          {k: dict(v) for k, v in p.joinskew._counters.items()}))
        p.joinskew.reset()
        p.faults.deactivate()
    monkeypatch.delenv("CSVPLUS_PLANCERT_N", raising=False)
    monkeypatch.delenv("CSVPLUS_PLANCERT_BUDGET_S", raising=False)
    yield
    for p, (sketches, counters) in zip(PKGS, saved):
        p.joinskew.reset()
        with p.joinskew._lock:
            p.joinskew._build_sketches.update(sketches)
            p.joinskew._counters.update(counters)
        p.faults.deactivate()


def _counts(s):
    return (s.plans_total, s.verified_ok, s.verifier_rejected, s.predicts_empty,
            s.rewritten, s.executed_pairs, s.raised_pairs, s.refusals_checked)


@pytest.mark.parametrize("n,total", [(2, 28), (3, 366)])
def test_certify_summary_equals_the_references(n, total):
    got = TP.certify(n=n, budget_s=600.0)
    want = JP.certify(n=n, budget_s=600.0)
    assert got.ok and want.ok, (got.describe(), want.describe())
    assert TP.pc.summary_json(got) == JP.pc.summary_json(want)
    assert _counts(got) == _counts(want)
    assert got.plans_total == total
    assert got.describe() == want.describe()
    if n == 3:
        assert got.verifier_rejected > 0 and got.raised_pairs > 0
        assert got.refusals_checked > 0


def test_certify_reads_the_environment_bounds(monkeypatch):
    monkeypatch.setenv("CSVPLUS_PLANCERT_N", "2")
    monkeypatch.setenv("CSVPLUS_PLANCERT_BUDGET_S", "600")
    got, want = TP.certify(), JP.certify()
    assert got.n == want.n == 2 and got.budget_s == want.budget_s == 600.0
    assert TP.pc.summary_json(got) == JP.pc.summary_json(want)


def test_hot_build_sketches_break_certify_in_both_packages():
    """The reference defect, pinned: the same live sketches give the same
    three refused permutations in both packages."""
    for p in PKGS:
        for label, keys in HOT_SKETCHES.items():
            p.joinskew.offer_build(label, keys, [1] * len(keys))
    got = TP.certify(n=3, budget_s=600.0)
    want = JP.certify(n=3, budget_s=600.0)
    assert got.failures == want.failures == HOT_FAILURES
    assert not got.ok and not want.ok
    assert TP.pc.summary_json(got) == JP.pc.summary_json(want)


def test_plancert_leaves_include_lookup():
    for p in PKGS:
        names = [name for name, _ in (p.pc._enumerate_plans(1, "cpu") if p is TP
                                      else p.pc._enumerate_plans(1))]
        assert names == ["scan", "lookup"]


def test_plancert_handles_empty_projection_schema():
    out = []
    for p in PKGS:
        leaves, _stages = p.corpus()
        root = p.P.SelectCols(leaves[0][1](), ())
        report = p.verify_plan(root)
        result = p.optimize_plan(root, report)
        assert result.report.ok == report.ok
        kind_a, _ = p.pc._execute(root)
        kind_b, _ = p.pc._execute(result.root)
        assert kind_a == kind_b
        out.append((report.ok, kind_a, kind_b))
    assert out[0] == out[1]


def test_plancert_budget_exceeded_fails_the_run():
    got = TP.certify(n=3, budget_s=0.0)
    want = JP.certify(n=3, budget_s=0.0)
    assert got.budget_exceeded and not got.ok
    assert want.budget_exceeded and not want.ok
    assert TP.pc.summary_json(got) == JP.pc.summary_json(want)
    assert "budget" in got.describe()


def test_certify_on_cuda_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TP.pc.certify(n=1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TP.pc._corpus("cuda")
