"""The port's static verifier (``csvplus_tpu_torch/analysis/verify.py``
and ``schema.py``) and its executor hook held against the JAX package's
on the CPU.

* ``verify_plan`` on the reference suite's plan shapes (static fakes,
  real tables and indexes, the rewriter's physical nodes) gives the same
  diagnostics (rule, severity, stage, message), the same verdicts and the
  same final abstract state in both packages.
* Placement: a torch tensor (CPU or not) is ``PLACE_DEVICE``, a numpy
  array ``PLACE_HOST``, ``None`` unknown; columns read their codes or
  value lanes, lane-dictionary columns included.
* ``device_index_static_info`` equals the reference's.
* The executor hook: plans the reference's ``verify_before_lower``
  rejects (a ``Validate`` before the last stage, a map expression it
  cannot lower, a join whose index has no device copy) fall back in the
  port before any device work, with the reference's outcome through the
  public API — the same rows, or the same error with the same row
  number."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu import plan as JP
from csvplus_tpu.analysis import schema as JS
from csvplus_tpu.analysis import verify as JV
from csvplus_tpu.ops.join import device_index_static_info as j_static
from csvplus_tpu_torch import plan as TP
from csvplus_tpu_torch.analysis import schema as TS
from csvplus_tpu_torch.analysis import verify as TV
from csvplus_tpu_torch.ops.join import device_index_static_info as t_static

KITS = {
    "ref": SimpleNamespace(pkg=J, P=JP, V=JV, S=JS,
                           keys=lambda n: __import__("jax.numpy").numpy.arange(n, dtype="int32")),
    "port": SimpleNamespace(pkg=T, P=TP, V=TV, S=TS,
                            keys=lambda n: torch.arange(n, dtype=torch.int32)),
}


class Opaque:
    """A predicate / map expression with no lowering and a stable repr;
    it opts into the plan (``__plan_expr__``), so only the verifier
    stops it."""

    __plan_expr__ = True

    def __call__(self, row):
        return row

    def __repr__(self):
        return "Opaque()"


class FakeCol:
    def __init__(self, kind="str", has_absent=None, placement=None):
        self.kind = kind
        if has_absent is not None:
            self._has_absent = has_absent
        if placement is not None:
            self.placement = placement


def PRESENT(placement=None):
    return FakeCol("str", has_absent=False, placement=placement)


def fake_scan(k, columns, nrows):
    return k.P.Scan(SimpleNamespace(columns=columns, nrows=nrows))


def fake_index(columns, keys, supported=True, packed=None, min_keys=None):
    dev = SimpleNamespace(table=SimpleNamespace(columns=columns),
                          key_columns=tuple(keys), supported=supported)
    if packed is not None:
        dev.packed_i32 = packed
    if min_keys is not None:
        dev.PARTITION_MIN_KEYS = min_keys
    return SimpleNamespace(device_table=dev)


def real_fact(k, n=60, absent=False):
    return k.pkg.take(k.pkg.take_rows([
        k.pkg.Row({"id": str(i % 9), "cat": f"k{i % 4}", **({} if absent and i % 5 == 0
                                                             else {"v": str(i)})})
        for i in range(n)
    ])).on_device("cpu").plan.table


def real_index(k):
    t = k.pkg.take_rows([k.pkg.Row({"id": str(i), "region": f"r{i % 3}"}) for i in range(9)])
    return t.on_device("cpu").index_on("id")


def _shapes(k):
    """name -> (plan, executor model or None)."""
    P, L = k.P, k.pkg.Like
    Not, Rename, SetValue = k.pkg.Not, k.pkg.Rename, k.pkg.SetValue
    scan = fake_scan(k, {"a": PRESENT(), "b": PRESENT()}, 5)
    one_row = fake_scan(k, {"b": PRESENT()}, 1)
    placeholder = P.Filter(P.SelectCols(P.Filter(one_row, L({"a": "x"})), ("a",)), L({"a": "x"}))
    deep = scan
    for _ in range(5):
        deep = P.Filter(deep, L({"a": "x"}))
    idx = fake_index({"k": PRESENT(), "v": PRESENT()}, ("k",))
    placed = lambda place, **kw: PRESENT(place) if not kw else FakeCol(placement=place, **kw)  # noqa: E731
    sharded = fake_scan(k, {"k": placed("sharded"), "p": placed("sharded")}, 8)
    fact, dim = real_fact(k), real_index(k)
    afact = real_fact(k, absent=True)
    out = {
        "clean": P.SelectCols(P.Filter(scan, L({"a": "x"})), ("a",)),
        "select-missing-nonempty": P.SelectCols(fake_scan(k, {"b": PRESENT()}, 3), ("a",)),
        "select-missing-empty": P.SelectCols(fake_scan(k, {"b": PRESENT()}, 0), ("a",)),
        "opaque-filter": P.Filter(scan, Opaque()),
        "opaque-map": P.MapExpr(scan, Opaque()),
        "validate-mid-chain": P.Top(P.Validate(scan, L({"a": "x"}), "bad"), 1),
        "validate-last": P.Validate(P.Top(scan, 1), L({"a": "x"}), "bad"),
        "typed-key-dict-index": P.Join(
            fake_scan(k, {"k": FakeCol("int"), "p": PRESENT()}, 4), idx, ("k",)),
        "dict-key-dict-index": P.Join(fake_scan(k, {"k": PRESENT(), "p": PRESENT()}, 4),
                                      idx, ("k",)),
        "rename-merge-lanes": P.MapExpr(fake_scan(
            k, {"s": FakeCol("str", has_absent=True), "i": FakeCol("int")}, 4), Rename({"s": "i"})),
        "setvalue-typed": P.MapExpr(fake_scan(k, {"i": FakeCol("int")}, 4), SetValue("i", "k")),
        "filter-over-placeholder": placeholder,
        "constant-false": P.Filter(fake_scan(k, {"b": PRESENT()}, 9), L({"missing": "x"})),
        "constant-true": P.Filter(fake_scan(k, {"b": PRESENT()}, 9), Not(L({"missing": "x"}))),
        "top-zero": P.Top(scan, 0),
        "deep-chain": deep,
        "windows": P.DropWhile(P.TakeWhile(P.DropRows(scan, 2), L({"a": "x"})), L({"b": "y"})),
        "unsupported-index": P.Join(scan, fake_index({}, ("a",), supported=False), ("a",)),
        "no-device-index": P.Except(scan, SimpleNamespace(device_table=None), ("a",)),
        "sharded-small-index": P.Join(sharded, fake_index(
            {"k": PRESENT(), "v": PRESENT()}, ("k",), packed=k.keys(4)), ("k",)),
        "sharded-partitioned": P.Join(sharded, fake_index(
            {"k": PRESENT(), "v": PRESENT()}, ("k",), packed=k.keys(4), min_keys=1), ("k",)),
        "host-stream-device-index": P.Join(
            fake_scan(k, {"k": placed("host")}, 8),
            fake_index({"k": PRESENT()}, ("k",), packed=k.keys(4)), ("k",)),
        "device-stream-host-index": P.Join(
            fake_scan(k, {"k": placed("device")}, 8),
            fake_index({"k": PRESENT()}, ("k",), packed=np.arange(4, dtype=np.int32)), ("k",)),
        "unknown-placement": P.Join(fake_scan(k, {"k": PRESENT()}, 8), fake_index(
            {"k": PRESENT()}, ("k",), packed=k.keys(4)), ("k",)),
        "rename-across-placements": P.MapExpr(fake_scan(
            k, {"s": placed("host", has_absent=True), "i": placed("device")}, 4),
            Rename({"s": "i"})),
        # real tables and indexes: placement and presence from the columns
        "real-join": P.Filter(P.Join(P.Scan(fact), dim, ("id",)), L({"region": "r1"})),
        "real-absent-select": P.SelectCols(P.Scan(afact), ("id", "v")),
        "real-except": P.Except(P.Scan(fact), dim, ("id",)),
        "real-multiway": P.MultiwayJoin(P.Scan(fact), ((dim, ("id",)), (dim, ("id",)))),
        "real-fused": P.FusedProbe(
            P.Scan(fact), (("filter", L({"cat": "k1"})), ("map", SetValue("f", "x")),
                           ("select", ("id", "f")), ("drop", ("f",))),
            ((dim, ("id",)),)),
        "real-fused-bad-op": P.FusedProbe(P.Scan(fact), (("teleport", None),), ((dim, ("id",)),)),
        # a Lookup leaf: a range of the index's sorted table, its
        # cardinality exact (non-empty, or empty for an empty range)
        "real-lookup": P.Filter(P.Lookup(dim.device_table.table, 1, 6), L({"region": "r1"})),
        "real-lookup-empty-join": P.Join(P.Lookup(dim.device_table.table, 4, 4), dim, ("id",)),
    }
    models = {"placeholder-no-empty-masks": (placeholder, k.V.ExecutorModel(empty_selection_masks=False)),
              "sharded-stale-broadcast": (out["sharded-small-index"],
                                          k.V.ExecutorModel(broadcast_replication_on_device=False)),
              "join-empty-total-off": (out["real-join"],
                                       k.V.ExecutorModel(join_empty_total=False)),
              "except-empty-total-off": (out["real-except"],
                                         k.V.ExecutorModel(except_empty_total=False))}
    return {**{n: (p, None) for n, p in out.items()}, **models}


SHAPE_NAMES = sorted(_shapes(KITS["port"]))


def _summary(k, plan, model):
    report = k.V.verify_plan(plan) if model is None else k.V.verify_plan(plan, model)
    return {
        "diagnostics": [(d.rule, d.severity, d.stage, d.message) for d in report.diagnostics],
        "ok": report.ok, "predicts_empty": report.predicts_empty,
        "states": [(repr(s.card), {n: repr(i) for n, i in s.schema.items()})
                   for s in report.states],
        "describe": report.describe(),
    }


@pytest.mark.parametrize("name", SHAPE_NAMES)
def test_verify_plan_matches_reference(name):
    got = {side: _summary(k, *_shapes(k)[name]) for side, k in KITS.items()}
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("name", ["opaque-filter", "opaque-map", "validate-mid-chain",
                                  "unsupported-index", "no-device-index", "validate-last"])
def test_verify_before_lower_matches_reference(name, monkeypatch):
    from csvplus_tpu.columnar.exec import UnsupportedPlan as JUnsupported
    from csvplus_tpu_torch.columnar.exec import UnsupportedPlan as TUnsupported

    outcome = {}
    for side, k in KITS.items():
        plan = _shapes(k)[name][0]
        try:
            k.V.verify_before_lower(plan)
            outcome[side] = "lowerable"
        except (JUnsupported, TUnsupported) as e:
            outcome[side] = str(e)
    assert outcome["port"] == outcome["ref"]
    assert (outcome["port"] == "lowerable") == (name == "validate-last")
    monkeypatch.setenv("CSVPLUS_VERIFY", "0")
    assert TV.verify_before_lower(_shapes(KITS["port"])[name][0]) is None


# -- placement ----------------------------------------------------------


@pytest.mark.parametrize("arr, want", [
    (torch.zeros(3, dtype=torch.int32), "device"),
    (torch.zeros(0, dtype=torch.int64), "device"),
    (np.zeros(3, dtype=np.int32), "host"),
    (None, "unknown"),
    ("not an array", "unknown"),
])
def test_placement_of_array(arr, want):
    assert TS.placement_of_array(arr).kind == want


def test_placement_of_array_matches_reference_on_single_device_arrays():
    import jax.numpy as jnp

    assert TS.placement_of_array(torch.arange(4)) == TS.PLACE_DEVICE
    assert JS.placement_of_array(jnp.arange(4)).kind == "device"
    assert JS.placement_of_array(np.arange(4)).kind == TS.placement_of_array(np.arange(4)).kind


@pytest.mark.parametrize("kind", ["codes", "typed", "lanes", "explicit"])
def test_placement_of_column(kind, tmp_path, monkeypatch):
    path = tmp_path / "t.csv"
    path.write_text("id,name\n" + "".join(f"x{i},n{i % 7}\n" for i in range(300)))
    if kind == "codes":
        monkeypatch.setenv("CSVPLUS_TYPED_LANES", "0")
    if kind == "lanes":
        for var, value in {"CSVPLUS_TYPED_LANES": "0", "CSVPLUS_STREAM_MIN_BYTES": "1",
                           "CSVPLUS_STREAM_CHUNK_BYTES": "1024",
                           "CSVPLUS_DICT_DEVICE_MIN_DISTINCT": "1"}.items():
            monkeypatch.setenv(var, value)
    tables = {side: k.pkg.from_file(str(path)).on_device("cpu").plan.table
              for side, k in KITS.items()}
    col = tables["port"].columns["id"]
    assert col.kind == ("int" if kind in ("typed", "explicit") else "str")
    assert (col.dev_dictionary is not None) == (kind == "lanes")
    if kind == "explicit":
        col.placement = "host"
        tables["ref"].columns["id"].placement = "host"
    got = {side: {n: repr(k.S.placement_of_column(c)) for n, c in tables[side].columns.items()}
           for side, k in KITS.items()}
    assert got["port"] == got["ref"]
    assert got["port"]["id"] == ("host" if kind == "explicit" else "device")
    # the whole scan state, presence and lanes included
    states = {side: repr(k.S.scan_state(tables[side]).schema) for side, k in KITS.items()}
    assert states["port"] == states["ref"]


@pytest.mark.parametrize("case", ["unique", "two-keys", "wide", "unsupported", "none"])
def test_device_index_static_info_matches_reference(case, monkeypatch):
    def build(k):
        if case == "none":
            return SimpleNamespace(device_table=None)
        if case == "unsupported":
            return fake_index({}, ("a",), supported=False)
        n = 70_000 if case == "wide" else 40
        rows = [k.pkg.Row({"a": f"a{i}", "b": f"b{i % 7}", "c": str(i)}) for i in range(n)]
        keys = ("a",) if case == "unique" else ("a", "b")
        return k.pkg.take_rows(rows).on_device("cpu").index_on(*keys)

    if case == "wide":
        from csvplus_tpu.ops.join import DeviceIndex as JIdx
        from csvplus_tpu_torch.ops.join import DeviceIndex as TIdx

        # a tiny key universe cap forces two 17-bit key lanes
        monkeypatch.setattr(JIdx, "DIRECT_MAX_BITS", 0)
        monkeypatch.setattr(TIdx, "DIRECT_MAX_BITS", 0)
    got = {"ref": j_static(build(KITS["ref"])), "port": t_static(build(KITS["port"]))}
    if got["port"] is not None and got["port"][3] is not None:
        assert got["port"][3]["placement"] == TS.PLACE_DEVICE
        got = {s: (v[0], v[1], v[2], {m: repr(x) for m, x in v[3].items()})
               for s, v in got.items()}
    assert got["port"] == got["ref"]


# -- the executor hook through the public API ---------------------------


def _outcome(fn):
    """Rows, or the error's (type, message) — message carries the row."""
    try:
        return ("rows", [dict(r) for r in fn()])
    except Exception as e:
        return ("error", type(e).__name__, str(e))


def _orders(pkg, people_csv):
    return pkg.from_file(people_csv).on_device("cpu")


REPAIRS = {
    # a Validate before the last stage: host push semantics
    "validate-mid-chain": lambda pkg, src, idx: src.validate(
        pkg.Like({"name": "Amelia"}), "not Amelia").top(5),
    "validate-mid-chain-passes": lambda pkg, src, idx: src.filter(
        pkg.Like({"name": "Amelia"})).validate(pkg.Like({"name": "Amelia"}), "x").top(3),
    # a map expression the executor cannot lower, then a column error
    "opaque-map": lambda pkg, src, idx: src.filter(pkg.Like({"name": "Amelia"})).map(
        Opaque()).select_columns("name", "surname"),
    "opaque-map-error": lambda pkg, src, idx: src.map(Opaque()).select_columns("name", "nope"),
    # a join whose index lost its device copy after the plan was built
    "join-no-device-copy": lambda pkg, src, idx: src.filter(
        pkg.Like({"surname": "Smith"})).join(idx, "name"),
}


@pytest.mark.parametrize("name", sorted(REPAIRS))
def test_unlowerable_plans_fall_back_before_device_work(name, people_csv, monkeypatch):
    """The rejected plan's own lowering runs no stage: the verifier raises
    before the first.  (The host fallback then drives the chain's parent,
    whose own plan may lower, as in the reference.)"""
    import csvplus_tpu_torch.columnar.exec as TE

    roots = []  # the root of the execution each stage belongs to
    stages = []
    real_view, real_stage = TE.execute_plan_view, TE._exec_stage

    def view_spy(root, preverified=False):
        roots.append(root)
        try:
            return real_view(root, preverified)
        finally:
            roots.pop()

    def stage_spy(view, node):
        stages.append(roots[-1])
        return real_stage(view, node)

    monkeypatch.setattr(TE, "execute_plan_view", view_spy)
    monkeypatch.setattr(TE, "_exec_stage", stage_spy)
    got = {}
    for side, k in KITS.items():
        pkg = k.pkg
        src = _orders(pkg, people_csv)
        names = pkg.take_rows([pkg.Row({"name": n, "nick": n[:3]})
                               for n in ("Amelia", "Olivia", "Emily")])
        idx = names.on_device("cpu").unique_index_on("name")
        chain = REPAIRS[name](pkg, src, idx)
        if name == "join-no-device-copy":
            assert chain.plan is not None
            idx.device_table = None  # the plan's Join now has no device index
        stages.clear()
        got[side] = (_outcome(chain.to_rows), chain.plan is not None)
        if side == "port":
            assert not any(root is chain.plan for root in stages)
            assert chain._plan_unsupported
    assert got["port"] == got["ref"]
    assert got["port"][1]  # the chain was symbolic: the fallback was the verifier's
