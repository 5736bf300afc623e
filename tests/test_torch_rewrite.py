"""The port's verifier-checked rewriter (``csvplus_tpu_torch/analysis/
rewrite.py``, with the provenance and cost domains under it) held against
the JAX package's on the CPU.

Every shape of the reference's own rewrite suite that needs no mesh runs
through both packages on the same seeded tables: predicate pushdown,
filter reordering, projection pushdown, join ordering, the multiway fuse
and the probe fuse with their hatches, blocked diagnostics and the
presence obligations.  The recipes (steps, join order, obligations), the
applied and blocked rules, and the rewritten plan's result must be equal
in both packages, and the rewritten result bitwise the unrewritten one
(row count, column order, positional checksums).  The cost domain's
estimates and operator choices must be equal when both get equal
sketches."""

from types import SimpleNamespace

import numpy as np
import pytest

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu import plan as JP
from csvplus_tpu.analysis import cost as JC
from csvplus_tpu.analysis import rewrite as JR
from csvplus_tpu.analysis.verify import verify_plan as j_verify
from csvplus_tpu.columnar.exec import execute_plan_view as j_exec
from csvplus_tpu.columnar.table import DeviceTable as JTable
from csvplus_tpu.obs.joinskew import joinskew as j_skew
from csvplus_tpu.obs.sketch import SpaceSaving as JSketch
from csvplus_tpu.utils.checksum import checksum_device_table as j_checksum
from csvplus_tpu_torch import plan as TP
from csvplus_tpu_torch.analysis import cost as TC
from csvplus_tpu_torch.analysis import rewrite as TR
from csvplus_tpu_torch.analysis.verify import verify_plan as t_verify
from csvplus_tpu_torch.columnar.exec import execute_plan_view as t_exec
from csvplus_tpu_torch.columnar.table import DeviceTable as TTable
from csvplus_tpu_torch.obs.joinskew import joinskew as t_skew
from csvplus_tpu_torch.obs.sketch import SpaceSaving as TSketch
from csvplus_tpu_torch.utils.checksum import checksum_device_table as t_checksum

N = 400

KITS = {
    "ref": SimpleNamespace(pkg=J, P=JP, Table=JTable, R=JR, C=JC, verify=j_verify,
                           run=lambda root: j_exec(root).materialize(), checksum=j_checksum,
                           Sketch=JSketch),
    "port": SimpleNamespace(pkg=T, P=TP, Table=TTable, R=TR, C=TC, verify=t_verify,
                            run=lambda root: t_exec(root).materialize(), checksum=t_checksum,
                            Sketch=TSketch),
}


class Opaque:
    """A predicate with no lowering and a stable repr."""

    def __call__(self, row):
        return True

    def __repr__(self):
        return "Opaque()"


@pytest.fixture(autouse=True)
def fresh_sketches():
    """The cost model reads the process-global build-side sketches; each
    case starts from empty registries in both packages."""
    j_skew.reset()
    t_skew.reset()
    yield
    j_skew.reset()
    t_skew.reset()


# -- tables, made the same way in both packages ------------------------


def fact(k, n=N, absent_ids=False, zipf=False):
    if zipf:
        ids = [str(int(i)) for i in np.random.default_rng(7).zipf(1.1, size=n) % 50]
    else:
        ids = [None if absent_ids and i % 7 == 0 else str(i % 50) for i in range(n)]
    return k.Table.from_pylists(
        {"id": ids, "cat": [f"k{i % 8}" for i in range(n)],
         "pad1": [str(i) for i in range(n)], "pad2": ["p"] * n},
        device="cpu",
    )


def index(k, data, key):
    return k.pkg.take(k.Table.from_pylists(data, device="cpu")).index_on(key)


def dim(k, n=50):
    return index(k, {"id": [str(i) for i in range(n)],
                     "region": [f"r{i % 5}" for i in range(n)]}, "id")


def cat_dim(k, n=8):
    return index(k, {"cat": [f"k{i}" for i in range(n)],
                     "label": [f"L{i}" for i in range(n)]}, "cat")


def cat_anti(k, n=2):
    return index(k, {"cat": [f"k{i}" for i in range(n)], "tag": ["t"] * n}, "cat")


def region_dim(k):
    return index(k, {"region": [f"r{i}" for i in range(5)],
                     "zone": [f"z{i}" for i in range(5)]}, "region")


def served_shape(k, table):
    P = k.P
    return P.Filter(P.Join(P.Scan(table), dim(k), ("id",)), k.pkg.Like({"cat": "k1"}))


def fused_shape(k, table):
    P = k.P
    return P.Join(
        P.MapExpr(P.Filter(P.Scan(table), k.pkg.Like({"cat": "k1"})), k.pkg.SetValue("flag", "x")),
        dim(k), ("id",),
    )


def _pushdown_map_join(k):
    P = k.P
    return P.Filter(P.Join(P.MapExpr(P.Scan(fact(k)), k.pkg.SetValue("flag", "x")),
                           dim(k), ("id",)), k.pkg.Like({"cat": "k1"}))


def _pushdown_except(k):
    P = k.P
    return P.Except(P.MapExpr(P.Scan(fact(k)), k.pkg.SetValue("flag", "x")), dim(k, 10), ("id",))


def _filter_reorder(k):
    P = k.P
    return P.Filter(P.Filter(P.Scan(fact(k)), k.pkg.Like({"cat": "k1"})), k.pkg.Like({"id": "7"}))


def _projection(k):
    P = k.P
    return P.SelectCols(P.Join(P.Scan(fact(k)), dim(k), ("id",)), ("id", "region"))


def _all_three(k):
    P, L = k.P, k.pkg.Like
    return P.SelectCols(
        P.Filter(P.Filter(P.Join(P.MapExpr(P.Scan(fact(k)), k.pkg.SetValue("note", "n")),
                                 dim(k), ("id",)), L({"cat": "k1"})), L({"id": "7"})),
        ("id", "region", "note"),
    )


def _blocked_top(k):
    P = k.P
    return P.Filter(P.Top(P.Scan(fact(k)), 100), k.pkg.Like({"cat": "k1"}))


def _blocked_validate(k):
    P = k.P
    return P.Filter(P.Validate(P.Scan(fact(k)), k.pkg.Like({"cat": "k1"}), "bad"),
                    k.pkg.Like({"id": "7"}))


def _noop(k):
    return k.P.Filter(k.P.Scan(fact(k)), k.pkg.Like({"cat": "k1"}))


def _join_order(k):
    P = k.P
    return P.Except(P.Join(P.Scan(fact(k)), dim(k), ("id",)), cat_anti(k), ("cat",))


def _multiway(k):
    P = k.P
    return P.Join(P.Join(P.Scan(fact(k)), dim(k), ("id",)), cat_dim(k), ("cat",))


def _multiway_absent(k):
    """Absent ids: the later key (cat) is still PRESENT, so it fuses."""
    P = k.P
    return P.Join(P.Join(P.Scan(fact(k, absent_ids=True)), dim(k), ("id",)),
                  cat_dim(k), ("cat",))


def _multiway_unstable(k):
    P = k.P
    return P.Join(P.Join(P.Scan(fact(k)), dim(k), ("id",)), region_dim(k), ("region",))


def _probe_fuse(k):
    return fused_shape(k, fact(k))


def _probe_fuse_zipf(k):
    return fused_shape(k, fact(k, zipf=True))


def _probe_fuse_three_way(k):
    P = k.P
    return P.Join(P.Join(P.Filter(P.Scan(fact(k)), k.pkg.Like({"cat": "k1"})),
                         dim(k), ("id",)), cat_dim(k), ("cat",))


def _probe_fuse_empty_fact(k):
    P = k.P
    empty = k.Table.from_pylists({"id": [], "cat": [], "pad1": [], "pad2": []}, device="cpu")
    return P.Join(P.Filter(P.Scan(empty), k.pkg.Like({"cat": "k1"})), dim(k), ("id",))


def _probe_fuse_zero_selection(k):
    P = k.P
    return P.Join(P.Filter(P.Scan(fact(k)), k.pkg.Like({"cat": "nope"})), dim(k), ("id",))


def _probe_fuse_opaque(k):
    P = k.P
    return P.Join(P.Filter(P.Scan(fact(k)), Opaque()), dim(k), ("id",))


def _probe_fuse_identity_refused(k):
    """A projection before the probe over an identity stream: staged
    materialize is free, so the pricing rule refuses."""
    P = k.P
    return P.Join(P.SelectCols(P.Scan(fact(k)), ("id", "cat")), dim(k), ("id",))


def _windows(k):
    P, L = k.P, k.pkg.Like
    return P.Filter(P.DropWhile(P.TakeWhile(P.DropRows(P.Scan(fact(k)), 3), L({"pad2": "p"})),
                                L({"cat": "k3"})), L({"cat": "k1"}))


# name -> (plan factory, rules that must apply, rules that must be blocked)
SHAPES = {
    "pushdown-map-join": (_pushdown_map_join, {"predicate-pushdown", "probe-fuse"}, set()),
    "pushdown-except": (_pushdown_except, {"predicate-pushdown"}, set()),
    "filter-reorder": (_filter_reorder, {"filter-reorder"}, set()),
    "projection": (_projection, {"projection-pushdown"}, set()),
    "all-three": (_all_three, {"predicate-pushdown", "filter-reorder", "projection-pushdown"},
                  set()),
    "blocked-top": (_blocked_top, set(), {"predicate-pushdown"}),
    "blocked-validate": (_blocked_validate, set(), {"predicate-pushdown"}),
    "noop": (_noop, set(), set()),
    "join-order": (_join_order, {"join-order"}, set()),
    "multiway": (_multiway, {"multiway-fuse"}, set()),
    "multiway-absent-ids": (_multiway_absent, {"multiway-fuse"}, set()),
    "multiway-unstable-key": (_multiway_unstable, set(), {"multiway-fuse"}),
    "probe-fuse": (_probe_fuse, {"probe-fuse"}, set()),
    "probe-fuse-zipf": (_probe_fuse_zipf, {"probe-fuse"}, set()),
    "probe-fuse-three-way": (_probe_fuse_three_way, {"probe-fuse", "multiway-fuse"}, set()),
    "probe-fuse-empty-fact": (_probe_fuse_empty_fact, set(), set()),
    "probe-fuse-zero-selection": (_probe_fuse_zero_selection, {"probe-fuse"}, set()),
    "probe-fuse-opaque": (_probe_fuse_opaque, set(), {"probe-fuse"}),
    "probe-fuse-identity-refused": (_probe_fuse_identity_refused, set(), {"probe-fuse"}),
    "windows": (_windows, set(), {"predicate-pushdown"}),
}

HATCHES = {
    "defaults": {},
    "multiway-off": {"CSVPLUS_MULTIWAY": "0"},
    "fuse-off": {"CSVPLUS_FUSE": "0"},
}


def _rules(items):
    return {r.split(":")[0] for r in items}


def _blocked(result):
    return [(d.rule, d.stage, d.message) for d in result.blocked]


def _same_tables(t_table, j_table):
    assert t_table.nrows == j_table.nrows
    assert list(t_table.columns) == list(j_table.columns)
    assert t_checksum(t_table, positional=True) == j_checksum(j_table, positional=True)


def _ops(k, root):
    return [type(n).__name__ for n in k.P.linearize(root)]


def _outcome(k, root):
    """The result table, or the error (type, message) the run raised."""
    try:
        return k.run(root)
    except Exception as e:  # compared across packages below
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("hatch", sorted(HATCHES))
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_rewrite_matches_reference(name, hatch, monkeypatch):
    for var, value in HATCHES[hatch].items():
        monkeypatch.setenv(var, value)
    build, applies, blocks = SHAPES[name]
    out = {}
    for side, k in KITS.items():
        plan = build(k)
        result = k.R.optimize_plan(plan)
        executable = k.verify(plan).ok
        out[side] = SimpleNamespace(
            k=k, plan=plan, result=result,
            recipe=None if result.recipe is None else (
                result.recipe.steps, result.recipe.require_present, result.recipe.join_order),
            applied=list(result.applied), blocked=_blocked(result),
            ops=_ops(k, result.root),
            verdict=(result.report.ok, result.report.predicts_empty,
                     result.original_report.ok, result.original_report.predicts_empty),
            rewritten=_outcome(k, result.root) if executable else None,
            unrewritten=_outcome(k, plan) if executable else None,
        )
    ref, port = out["ref"], out["port"]
    assert port.recipe == ref.recipe
    assert port.applied == ref.applied
    assert port.blocked == ref.blocked
    assert port.ops == ref.ops
    assert port.verdict == ref.verdict
    if hatch == "defaults":
        assert applies <= _rules(port.applied), port.applied
        assert blocks <= {b[0] for b in port.blocked}, port.blocked
    if hatch == "multiway-off":
        assert "MultiwayJoin" not in port.ops
    if hatch == "fuse-off":
        assert "FusedProbe" not in port.ops
    if isinstance(port.rewritten, tuple):  # the run errs: the same error everywhere
        assert port.rewritten == port.unrewritten == ref.rewritten == ref.unrewritten
    elif port.rewritten is not None:
        _same_tables(port.rewritten, ref.rewritten)
        # the rewrite is bitwise invisible
        assert t_checksum(port.rewritten, positional=True) == \
            t_checksum(port.unrewritten, positional=True)
        assert list(port.rewritten.columns) == list(port.unrewritten.columns)
        assert port.rewritten.to_rows() == port.unrewritten.to_rows()


def test_optimize_disabled_is_the_identity(monkeypatch):
    monkeypatch.setenv("CSVPLUS_OPTIMIZE", "0")
    assert not TR.optimize_enabled() and not TR.multiway_enabled() and not TR.fuse_enabled()
    assert not JR.optimize_enabled()


@pytest.mark.parametrize("case", ["present", "absent", "empty", "missing"])
def test_leaf_presence_ok_matches_reference(case):
    cols, absent = {"present": (("id", "cat"), False), "absent": (("id",), True),
                    "empty": ((), True), "missing": (("nope",), False)}[case]
    got = {side: k.R.leaf_presence_ok(k.P.Scan(fact(k, absent_ids=absent)), cols)
           for side, k in KITS.items()}
    assert got["port"] == got["ref"] == (case in ("present", "empty"))


@pytest.mark.parametrize("step", [("teleport", ()), ("fuse_joins", 1, 2), ("fuse_chain", 1, 2)])
def test_apply_recipe_refuses_what_the_reference_refuses(step):
    for k in KITS.values():
        with pytest.raises(ValueError):
            k.R.apply_recipe(k.P.Filter(k.P.Scan(fact(k)), k.pkg.Like({"cat": "k1"})),
                             k.R.PlanRecipe((step,)))


def _skewed(k):
    sk = k.Sketch(k=8)
    sk.offer_many(["3"] * 900 + [str(i) for i in range(100)])
    return {"id": sk}


@pytest.mark.parametrize("sketches", ["none", "empty", "skewed"])
@pytest.mark.parametrize("name", ["multiway", "probe-fuse", "join-order", "all-three",
                                  "probe-fuse-three-way", "windows"])
def test_cost_estimates_match_reference(name, sketches):
    """Equal sketches in, equal estimates, rankings and operator choices
    out.  ``none`` reads each package's process registry, which the
    probes of the table builds never fed (no probe has run)."""
    build = SHAPES[name][0]
    got = {}
    for side, k in KITS.items():
        plan = build(k)
        sk = {"none": None, "empty": {}, "skewed": _skewed(k)}[sketches]
        got[side] = (
            [e.as_dict() for e in k.C.estimate_plan(plan, sketches=sk)],
            k.C.rank_join_orders(plan, k.verify(plan), sketches=sk),
            k.C.choose_join_operator(plan, sketches=sk),
            k.C.choose_fusion(plan, sketches=sk),
        )
    assert got["port"] == got["ref"]


def test_sketch_fed_by_the_first_probe_matches_reference():
    """Each package's index offers its strided build sample once, on its
    first probe: the sketches, and the estimates read from them, agree."""
    for k in KITS.values():
        plan = k.P.Join(k.P.Scan(fact(k)), dim(k), ("id",))
        k.run(plan)
        k.run(plan)
    t_sk, j_sk = t_skew.build_sketches(), j_skew.build_sketches()
    assert sorted(t_sk) == sorted(j_sk) == ["id"]
    assert t_sk["id"].snapshot() == j_sk["id"].snapshot()
    assert t_sk["id"].observed == 50
    ests = {side: [e.as_dict() for e in k.C.estimate_plan(_multiway(k))]
            for side, k in KITS.items()}
    assert ests["port"] == ests["ref"]
