"""The port's plan cache (``csvplus_tpu_torch/serve/plancache.py``) held
against the JAX package's on the CPU.

Both caches take the same sequence of plan shapes over tables made the
same way: their ``stats()`` (hits, misses, lowered, optimized,
reordered, fused, fused_chains, fusion_refused, rejected, evictions,
optimize_failed) must be equal after every submission, every result
bitwise equal (row count, column order, positional checksums), the same
plans rejected with the same message, the LRU must evict at the same
bound, and ``CSVPLUS_OPTIMIZE`` / ``CSVPLUS_MULTIWAY`` / ``CSVPLUS_FUSE``
off must give bitwise the defaults' results.  The fusion decisions for
the shapes of ``chip_smoke.py``'s phase 8 (pipelines (a), (b) and the
unfiltered 3-table join, through the public API on ingested files) are
pinned here, on both packages, at the phase's own dimension tables and
predicates, as the phase asserts them on the card."""

import pytest

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu.serve import PlanCache as JCache
from csvplus_tpu.serve import PlanRejected as JRejected
from csvplus_tpu_torch.columnar.exec import execute_plan_view as t_exec
from csvplus_tpu_torch.serve import PlanCache as TCache
from csvplus_tpu_torch.serve import PlanRejected as TRejected
from csvplus_tpu_torch.utils.checksum import checksum_device_table as t_checksum
from test_torch_chip_smoke import _chip_smoke
from test_torch_rewrite import (  # the shared table and plan factories
    KITS,
    SHAPES,
    Opaque,
    _same_tables,
    dim,
    fact,
    fused_shape,
    fresh_sketches,  # noqa: F401  (autouse fixture)
    region_dim,
    served_shape,
)

CACHES = {"ref": (JCache, JRejected), "port": (TCache, TRejected)}

# the submission sequence: (shape, plan factory) pairs; repeats hit
SEQUENCE = [
    ("served", lambda k: served_shape(k, fact(k))),
    ("served-other-data", lambda k: served_shape(k, fact(k, n=300))),
    ("multiway", SHAPES["multiway"][0]),
    ("fused", lambda k: fused_shape(k, fact(k))),
    ("fused-other-data", lambda k: fused_shape(k, fact(k, n=256))),
    ("join-order", SHAPES["join-order"][0]),
    ("identity-refused", SHAPES["probe-fuse-identity-refused"][0]),
    ("three-way", SHAPES["probe-fuse-three-way"][0]),
    ("zero-selection", SHAPES["probe-fuse-zero-selection"][0]),
    ("windows", SHAPES["windows"][0]),
    ("served-again", lambda k: served_shape(k, fact(k, n=128))),
    # a Lookup leaf (what Index.find_many results carry): its bounds are
    # data, so another range of the same index hits the same entry
    ("lookup", lambda k: k.P.Filter(k.P.Lookup(dim(k).device_table.table, 3, 17),
                                    k.pkg.Like({"region": "r1"}))),
    ("lookup-other-bounds", lambda k: k.P.Filter(k.P.Lookup(dim(k).device_table.table, 20, 41),
                                                 k.pkg.Like({"region": "r1"}))),
    ("lookup-join", lambda k: k.P.Join(k.P.Lookup(dim(k).device_table.table, 0, 25),
                                       region_dim(k), ("region",))),
]

REJECTED = {
    "opaque": lambda k: k.P.Filter(k.P.Scan(fact(k)), Opaque()),
    "validate-mid-chain": lambda k: k.P.Top(
        k.P.Validate(k.P.Scan(fact(k)), k.pkg.Like({"cat": "k1"}), "bad"), 3),
}


def _submit(side, cache, build):
    k = KITS[side]
    plan = build(k)
    return cache.execute(plan), plan


@pytest.mark.parametrize("hatch", [{}, {"CSVPLUS_OPTIMIZE": "0"}, {"CSVPLUS_MULTIWAY": "0"},
                                   {"CSVPLUS_FUSE": "0"}],
                         ids=["defaults", "optimize-off", "multiway-off", "fuse-off"])
def test_plan_sequence_stats_and_results_match_reference(hatch, monkeypatch):
    for var, value in hatch.items():
        monkeypatch.setenv(var, value)
    caches = {side: cls(size=64) for side, (cls, _) in CACHES.items()}
    for name, build in SEQUENCE:
        got = {side: _submit(side, caches[side], build) for side in CACHES}
        _same_tables(got["port"][0], got["ref"][0])
        # the cache's answer is bitwise the unrewritten plan's
        plain = t_exec(got["port"][1]).materialize()
        assert t_checksum(got["port"][0], positional=True) == t_checksum(plain, positional=True)
        assert list(got["port"][0].columns) == list(plain.columns)
        assert caches["port"].stats() == caches["ref"].stats(), name
    st = caches["port"].stats()
    assert st["optimize_failed"] == 0 and st["rejected"] == 0
    assert st["hits"] == 4 and st["lowered"] == len(SEQUENCE) - 4
    if not hatch:
        assert st["fused"] >= 2 and st["fused_chains"] >= 2
        assert st["reordered"] == 1 and st["fusion_refused"] >= 1
    if hatch.get("CSVPLUS_OPTIMIZE") == "0":
        assert st["optimized"] == 0
    if hatch.get("CSVPLUS_MULTIWAY") == "0":
        assert st["fused"] == 0
    if hatch.get("CSVPLUS_FUSE") == "0":
        assert st["fused_chains"] == 0 and st["fusion_refused"] == 0


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_rejected_plans_match_reference(name):
    msgs = {}
    for side, (cls, rejected) in CACHES.items():
        cache = cls(size=8)
        with pytest.raises(rejected) as ei:
            cache.execute(REJECTED[name](KITS[side]))
        msgs[side] = str(ei.value)
        st = cache.stats()
        assert st["rejected"] == 1 and st["size"] == 0 and st["lowered"] == 0
    assert msgs["port"] == msgs["ref"] and "unlowerable" in msgs["port"]


def test_lru_eviction_matches_reference():
    order = ["served", "multiway", "fused", "served", "join-order", "multiway"]
    builds = dict(SEQUENCE)
    stats = {}
    for side, (cls, _) in CACHES.items():
        cache = cls(size=2)
        for name in order:
            _submit(side, cache, builds[name])
        stats[side] = cache.stats()
    assert stats["port"] == stats["ref"]
    assert stats["port"]["evictions"] == 4 and stats["port"]["size"] == 2


def test_plancache_size_from_env(monkeypatch):
    monkeypatch.setenv("CSVPLUS_PLANCACHE_SIZE", "3")
    assert TCache().size == JCache().size == 3


def test_presence_obligation_fallback_matches_reference():
    """A submission of the same shape whose leaf presence cache was never
    seeded runs unrewritten (counted), in both packages."""
    runs = {}
    for side, (cls, _) in CACHES.items():
        k = KITS[side]
        cache = cls(size=8)
        plan = served_shape(k, fact(k))
        cache.execute(plan)
        exe = cache.executable_for(plan)
        assert "id" in exe.recipe.require_present
        unseeded = fact(k, n=300)
        unseeded.columns["id"]._has_absent = None
        got = cache.execute(served_shape(k, unseeded))
        runs[side] = (exe.unoptimized_runs, exe.runs, got)
    assert runs["port"][:2] == runs["ref"][:2] == (1, 2)
    _same_tables(runs["port"][2], runs["ref"][2])


def test_optimize_failure_is_counted_and_runs_unrewritten(monkeypatch):
    """The cache swallows a rewriter failure, as the reference's does:
    counted in ``optimize_failed``, and the shape runs unrewritten."""
    import csvplus_tpu_torch.analysis.rewrite as TR

    def broken(*a, **kw):
        raise RuntimeError("prover bug")

    monkeypatch.setattr(TR, "optimize_plan", broken)
    k = KITS["port"]
    cache = TCache(size=8)
    got = cache.execute(served_shape(k, fact(k)))
    st = cache.stats()
    assert st["optimize_failed"] == 1 and st["optimized"] == 0 and st["lowered"] == 1
    assert cache.executable_for(served_shape(k, fact(k))).recipe is None
    plain = t_exec(served_shape(k, fact(k))).materialize()
    assert t_checksum(got, positional=True) == t_checksum(plain, positional=True)


# -- chip_smoke.py phase 8's shapes, through the public API ---------------

#: Orders in the phase-8 decision test.  The dimension tables, the
#: predicates and the order columns' distinct counts are phase 8's own
#: (100,000 customers, 1,000 products, the 50-id IN-list of (b)); only the
#: row count of the orders is cut from 50M.  The cost model compares
#: byte estimates that are each linear in that row count.
PHASE8_ORDERS = 2_000_000


@pytest.fixture(scope="module")
def phase8(tmp_path_factory):
    C = _chip_smoke()
    return C, C.generate(tmp_path_factory.mktemp("phase8"), PHASE8_ORDERS, 1)


def _phase8_plans(pkg, data):
    """Phase 8's plans over freshly ingested tables.  As on the card,
    pipelines (a) and (b) first run once through the plain fluent API
    (phase 5), which feeds the indexes' build-side sketches."""
    paths = {k: str(v) for k, v in data["paths"].items()}
    orders = pkg.from_file(paths["orders"]).on_device("cpu")
    cust = pkg.from_file(paths["cust"]).on_device("cpu").unique_index_on("id")
    prod = pkg.from_file(paths["prod"]).on_device("cpu").unique_index_on("prod_id")
    preds = {
        "a": pkg.Not(pkg.Like({"prod_id": "p0", "qty": "1"})),
        "b": pkg.Any(*[pkg.Like({"prod_id": f"p{i}"}) for i in range(1, 51)],
                     pkg.Like({"qty": "7"})),
    }
    srcs = {n: orders.filter(p).join(cust, "cust_id").join(prod) for n, p in preds.items()}
    for src in srcs.values():
        src.to_device_table(*(("cpu",) if pkg is T else ()))
    plans = {n: src.plan for n, src in srcs.items()}
    plans["c"] = orders.join(cust, "cust_id").join(prod).plan
    return plans


@pytest.mark.parametrize("leg", ["cascaded", "fused"])
def test_phase8_shapes_fuse_as_the_reference(phase8, monkeypatch, leg):
    """Both packages' plan caches decide phase 8's fusions alike, and as
    ``chip_smoke.PLANCACHE_DECISIONS`` says, at phase 8's shapes."""
    C, data = phase8
    for name, value in C.PLANCACHE_LEGS[leg].items():
        monkeypatch.setenv(name, value)
    plans = {"ref": _phase8_plans(J, data), "port": _phase8_plans(T, data)}
    n_b = int(C._pipelines(data)["b"][1].sum())
    for name in ("a", "b", "c"):
        got = {}
        for side, (cls, _) in CACHES.items():
            cache = cls()
            table = cache.execute(plans[side][name])
            st = cache.stats()
            got[side] = (table, (st["fused"], st["fused_chains"], st["fusion_refused"]),
                         st["optimize_failed"])
        assert got["port"][1] == got["ref"][1] == C.PLANCACHE_DECISIONS[leg][name], name
        assert got["port"][2] == got["ref"][2] == 0
        if name == "b":
            assert got["port"][0].nrows == n_b
        _same_tables(got["port"][0], got["ref"][0])
