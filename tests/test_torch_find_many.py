"""The port's batched point-lookup engine (``Index.find_many``,
``FindMany``, ``sub_index``, ``to_rows_many``, ``Lookup`` plans) held
against the JAX package on the CPU, case by case as
``tests/test_find_many.py`` runs it on the reference.

Every case builds the same index in both packages from the same bytes
and compares the rows of ``find_many`` (which must also equal the loop of
single ``find`` calls) across the host row tier, the device mirror tier,
the tier above the mirror cap (the cap patched to a small value in BOTH
packages' ``DeviceIndex``), the two-lane (int64) key tier, typed and
lane-dictionary key columns; plus the LRU regressions and ``Lookup``
plans through filter / map / join, with equal rows and errors.

The repairs of the port's key tiers: with the cap below the table size, a device-lazy
index builds no host key mirror in either package and both return the
same bounds (the port used to mirror every table, widened to int64)."""

import numpy as np
import pytest

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu.columnar.table import DeviceTable as JTable
from csvplus_tpu.ops.join import DeviceIndex as JDevIndex
from csvplus_tpu_torch.columnar.table import DeviceTable as TTable
from csvplus_tpu_torch.columnar.table import from_reference_arrays
from csvplus_tpu_torch.ops.join import DeviceIndex as TDevIndex

PKGS = {"ref": (J, JTable, JDevIndex), "port": (T, TTable, TDevIndex)}

PROBES = [
    "Amelia",  # bare string = one-column prefix
    ("Amelia", "Hill"),  # full-width
    (),  # empty prefix: whole index
    ("nobody",),  # miss
    "Amelia",  # duplicate probe
    ("Amelia", "nope"),  # present prefix, missing suffix
    ("Zoe",),
]


def _norm(p):
    return (p,) if isinstance(p, str) else tuple(p)


def batched_and_looped(pkg, index, probes):
    """``to_rows_many(find_many)`` after checking it equals the loop of
    single finds; rows as plain dicts."""
    batched = pkg.to_rows_many(index.find_many(probes))
    looped = [index.find(*_norm(p)).to_rows() for p in probes]
    assert batched == looped
    return [[dict(r) for r in g] for g in batched]


def both(build, probes):
    """Rows of *probes* against ``build(pkg, table_cls)`` in both
    packages; asserts they are equal and returns them."""
    got = {}
    for side, (pkg, table_cls, _) in PKGS.items():
        got[side] = batched_and_looped(pkg, build(pkg, table_cls), probes)
    assert got["port"] == got["ref"]
    return got["port"]


def host_index(pkg, people_csv):
    return pkg.take(pkg.from_file(people_csv)).index_on("name", "surname")


def dev_index(pkg, people_csv):
    return pkg.from_file(people_csv).on_device("cpu").index_on("name", "surname")


def test_host_tier_parity(people_csv):
    groups = both(lambda pkg, _: host_index(pkg, people_csv), PROBES)
    assert len(groups[0]) == 12 and groups[3] == [] and len(groups[2]) == 120


def test_device_mirror_tier_parity(people_csv):
    idx = dev_index(T, people_csv)
    groups = both(lambda pkg, _: dev_index(pkg, people_csv), PROBES)
    assert len(groups[0]) == 12 and groups[3] == []
    batched_and_looped(T, idx, PROBES)
    assert idx._impl.is_lazy  # lookups never materialize host rows
    assert idx._impl.dev._packed_host.dtype == np.int32  # the int32 mirror


def test_device_above_mirror_cap_parity(people_csv, monkeypatch):
    # the one-gather tier: the cells gate fails at cap 1 in both packages
    for _, _, dev_cls in PKGS.values():
        monkeypatch.setattr(dev_cls, "POINT_MIRROR_MAX_KEYS", 1)
    both(lambda pkg, _: dev_index(pkg, people_csv), PROBES)


def test_above_cap_bounds_come_from_the_device_search(monkeypatch):
    """The repair of the port's key tiers: with the cap (8) below the
    index size, neither package builds a host mirror of the packed keys,
    and the bounds of every probe (misses, prefixes and the empty probe
    included) are equal; at or under the cap both build one."""
    n = 40
    rows = [{"k": f"k{i % 13:02d}", "j": f"j{i % 5}", "v": str(i)} for i in range(n)]
    probes = [("k03",), ("k03", "j3"), ("k12",), ("zz",), (), ("k00", "j4"), ("k05", "nope")]
    for cap, mirrored in ((8, False), (1_000, True)):
        out = {}
        for side, (pkg, _, dev_cls) in PKGS.items():
            monkeypatch.setattr(dev_cls, "POINT_MIRROR_MAX_KEYS", cap)
            idx = pkg.take_rows([pkg.Row(r) for r in rows]).on_device("cpu").index_on("k", "j")
            out[side] = [tuple(map(int, b)) for b in idx._impl.bounds_many(probes)]
            single = [tuple(map(int, idx._impl.dev.point_bounds(list(p)))) for p in probes]
            assert single == out[side]
            assert (getattr(idx._impl.dev, "_packed_host", None) is not None) is mirrored, side
        assert out["port"] == out["ref"]
        assert out["port"][4] == (0, n) and out["port"][3] == (0, 0)


def test_wide_key_i64_tier_parity():
    # two columns of 40,000 distinct values: 32 packed bits, over the
    # int32 tier, so the two-lane tier with its int64 host keys
    n = 70_000
    a = [f"a{i % 40000:05d}" for i in range(n)]
    b = [f"b{(i * 7) % 40000:05d}" for i in range(n)]

    def build(pkg, table_cls):
        idx = pkg.take(table_cls.from_pylists({"a": a, "b": b}, device="cpu")).index_on("a", "b")
        dev = idx._impl.dev
        assert dev.packed_i32 is None and dev.packed_hi is not None
        return idx

    probes = ["a00017", ("a00017", "b00119"), ("a39999",), ("zz",), "a00017"]
    both(build, probes)


def test_typed_int_key_parity(tmp_path):
    path = tmp_path / "typed.csv"
    path.write_text("cust_id,v\n" + "".join(f"c{i % 500},{i}\n" for i in range(2000)))
    srcs = {side: pkg.from_file(str(path)).on_device("cpu") for side, (pkg, _, _) in PKGS.items()}
    assert srcs["port"].plan.table.columns["cust_id"].kind == "int"
    assert srcs["port"].plan.table.columns["v"].kind == "int"
    probes = ["c3", "c499", "c500", "cX", "c3", ("c42",)]
    both(lambda pkg, _: srcs["ref" if pkg is J else "port"].index_on("cust_id"), probes)


def test_lane_dictionary_key_parity():
    """A key column whose dictionary is device lanes (unsorted until the
    index build sorts it) answers like the reference's."""
    rng = np.random.default_rng(5)
    vals = np.array([f"id{v:05d}".encode() for v in rng.permutation(300)], dtype="S")
    other = np.array([b"x", b"y", b"z"], dtype="S")
    ocodes = (np.arange(300) % 3).astype(np.int32)
    jt = JTable.from_pylists({"k": [v.decode() for v in vals],
                              "o": [other[c].decode() for c in ocodes]}, device="cpu")
    from csvplus_tpu_torch.ops.lanes import lanes_for_width, pack_host

    # an unsorted lane dictionary in row order: row i holds slot i
    lanes = pack_host(vals, lanes_for_width(7))
    codes = np.arange(300, dtype=np.int32)
    tt = from_reference_arrays({"k": ("lanes", lanes, codes, False), "o": (other, ocodes)}, "cpu")
    assert tt.columns["k"].dev_dictionary is not None
    assert not tt.columns["k"]._dev_dict_sorted
    probes = ["id00007", "id00299", "id99999", ("id00150",), "id00007"]
    got = {"ref": batched_and_looped(J, J.take(jt).index_on("k"), probes),
           "port": batched_and_looped(T, T.take(tt).index_on("k"), probes)}
    assert got["port"] == got["ref"] and len(got["port"][0]) == 1


def test_empty_probe_list(people_csv):
    for pkg, _, _ in PKGS.values():
        assert host_index(pkg, people_csv).find_many([]) == []
        assert dev_index(pkg, people_csv).find_many([]) == []
        assert pkg.to_rows_many([]) == []


@pytest.mark.parametrize("tier", ["host", "device"])
def test_prefix_length_mix_and_duplicates(people_csv, tier):
    probes = [(), "Amelia", ("Amelia", "Hill"), (), ("Amelia", "Hill"), "Amelia"]
    build = host_index if tier == "host" else dev_index
    got = both(lambda pkg, _: build(pkg, people_csv), probes)
    assert got[1] == got[5] and got[2] == got[4]  # duplicate probes agree


def test_too_many_columns(people_csv):
    msgs = []
    for pkg, _, _ in PKGS.values():
        for idx in (host_index(pkg, people_csv), dev_index(pkg, people_csv)):
            with pytest.raises(ValueError, match="too many columns") as ei:
                idx.find_many([("a", "b", "c")])
            msgs.append(str(ei.value))
    assert len(set(msgs)) == 1


def test_go_style_aliases(people_csv):
    assert T.Index.FindMany is T.Index.find_many
    assert T.Index.SubIndex is T.Index.sub_index
    assert T.ToRowsMany is T.to_rows_many
    idx = dev_index(T, people_csv)
    assert T.to_rows_many(idx.FindMany(["Amelia"])) == [idx.find("Amelia").to_rows()]


@pytest.mark.parametrize("chain", ["filter", "map", "select", "join", "join-missing",
                                   "validate-error"])
def test_find_many_sources_carry_device_plan(people_csv, chain):
    """A device index's results carry a ``Lookup`` leaf; a stage applied
    to one lowers to the device and equals the host path and the
    reference, rows or error (type, message, row number)."""
    out = {}
    for side, (pkg, _, _) in PKGS.items():
        idx = dev_index(pkg, people_csv)
        dim = pkg.take_rows([pkg.Row({"surname": s, "tag": f"t{i}"})
                             for i, s in enumerate(["Smith", "Jones", "Taylor"])])
        dim_idx = dim.on_device("cpu").unique_index_on("surname")
        srcs = idx.find_many(["Amelia", ("nobody",)])
        assert all(type(s.plan).__name__ == "Lookup" for s in srcs)
        chains = {
            "filter": lambda s: s.filter(pkg.Like({"surname": "Jones"})),
            "map": lambda s: s.map(pkg.SetValue("born", "x")),
            "select": lambda s: s.select_columns("name", "id"),
            "join": lambda s: s.join(dim_idx, "surname"),
            "join-missing": lambda s: s.join(dim_idx, "nope"),
            "validate-error": lambda s: s.validate(pkg.Like({"surname": "Smith"}), "not a Smith"),
        }
        res = []
        for s in srcs:
            derived = chains[chain](s)
            assert derived.plan is not None
            try:
                res.append(("rows", [dict(r) for r in derived.to_rows()]))
            except Exception as e:  # noqa: BLE001 - the error is the outcome
                res.append(("error", type(e).__name__, str(e)))
        out[side] = res
    assert out["port"] == out["ref"]
    if chain == "filter":
        assert len(out["port"][0][1]) == 1


def test_find_many_host_tier_has_no_plan(people_csv):
    for pkg, _, _ in PKGS.values():
        assert host_index(pkg, people_csv).find_many(["Amelia"])[0].plan is None


def test_lru_eviction_keeps_results_correct(people_csv, monkeypatch):
    # a one-row LRU: every lookup evicts, results must not change
    monkeypatch.setenv("CSVPLUS_MIRROR_LRU_ROWS", "1")
    for _ in range(2):
        both(lambda pkg, _: dev_index(pkg, people_csv), PROBES)


def test_lru_repeat_hits_same_rows(people_csv):
    idx = dev_index(T, people_csv)
    first = T.to_rows_many(idx.find_many(["Amelia", "Amelia"]))
    second = T.to_rows_many(idx.find_many(["Amelia"]))
    assert first[0] == first[1] == second[0]
    # delivered rows are clones: editing one leaves the cached block intact
    first[0][0]["name"] = "edited"
    assert T.to_rows_many(idx.find_many(["Amelia"]))[0][0]["name"] == "Amelia"


@pytest.mark.parametrize("policy", ["first", "callback-last"])
def test_lru_not_stale_after_dedup(people_csv, policy):
    """Dedup must never leave pre-dedup decoded blocks behind: a policy
    rebuilds the device index over a new table, a callback drops the
    device copy (the host tier answers after it)."""
    out = {}
    for side, (pkg, _, _) in PKGS.items():
        di = pkg.from_file(people_csv).on_device("cpu").index_on("name")
        pre = pkg.to_rows_many(di.find_many(["Amelia", "Zoe"]))  # warm the LRU
        assert len(pre[0]) == 12
        di.resolve_duplicates("first" if policy == "first" else (lambda g: g[-1]))
        out[side] = [[dict(r) for r in g] for g in pkg.to_rows_many(di.find_many(["Amelia", "Zoe"]))]
    assert out["port"] == out["ref"] and len(out["port"][0]) == 1


def test_find_routed_through_engine(people_csv):
    idx = dev_index(T, people_csv)
    assert T.to_rows_many(idx.find_many([("Amelia", "Hill")])) == [idx.find("Amelia", "Hill").to_rows()]


def test_find_many_accepts_lists_and_tuples(people_csv):
    for pkg, _, _ in PKGS.values():
        idx = host_index(pkg, people_csv)
        assert pkg.to_rows_many(idx.find_many([["Amelia", "Hill"]])) == \
            pkg.to_rows_many(idx.find_many([("Amelia", "Hill")]))


def test_rows_from_mirror_many_empty_and_dup_ranges():
    t = TTable.from_pylists({"k": ["a", "b", "c", "d"]}, device="cpu")
    got = t.rows_from_mirror_many([(1, 3), (0, 0), (1, 3), (3, 4)])
    assert got[0] == [T.Row({"k": "b"}), T.Row({"k": "c"})]
    assert got[1] == [] and got[2] == got[0] and got[3] == [T.Row({"k": "d"})]
    assert t.rows_from_mirror(1, 3) == got[0]


@pytest.mark.parametrize("tier", ["mirror", "above-cap", "host"])
def test_sub_index_parity(people_csv, monkeypatch, tier):
    if tier == "above-cap":
        for _, _, dev_cls in PKGS.values():
            monkeypatch.setattr(dev_cls, "POINT_MIRROR_MAX_KEYS", 1)
    build = host_index if tier == "host" else dev_index
    out = {}
    for side, (pkg, _, _) in PKGS.items():
        sub = build(pkg, people_csv).sub_index("Amelia")
        assert sub.columns == ["surname"]
        assert (sub._impl.dev is not None) is (tier != "host")
        out[side] = (len(sub), batched_and_looped(pkg, sub, ["Hill", "nope", ()]))
        with pytest.raises(ValueError, match="too many values"):
            build(pkg, people_csv).sub_index("Amelia", "Hill")
    assert out["port"] == out["ref"] and out["port"][0] == 12


@pytest.mark.parametrize("cap", [1_000, 1], ids=["under-cap", "over-cap"])
def test_decode_tier_follows_the_cells_gate_like_reference(people_csv, monkeypatch, cap):
    """Matched rows decode from host mirrors of the columns while the
    index table holds at most ``POINT_MIRROR_MAX_KEYS`` cells, and from
    one device gather per batch above it, in both packages (the port
    used to gather on the device at every size)."""
    mirrored = {}
    for side, (pkg, _, dev_cls) in PKGS.items():
        monkeypatch.setattr(dev_cls, "POINT_MIRROR_MAX_KEYS", cap)
        idx = pkg.from_file(people_csv).on_device("cpu").index_on("name", "surname")
        pkg.to_rows_many(idx.find_many(["Amelia", ("Zoe", "Smith")]))
        cols = idx._impl.dev.table.columns.values()
        mirrored[side] = [getattr(c, "_codes_host", None) is not None
                          or getattr(c, "_values_host", None) is not None for c in cols]
    assert mirrored["port"] == mirrored["ref"]
    assert any(mirrored["port"]) is (cap == 1_000)


def test_validate_after_empty_selection_matches_reference():
    """A terminal ``Validate`` over an empty selection (a filter that
    keeps nothing, or an empty ``Lookup``) finds nothing to check, as in
    the reference; the port used to raise from ``torch.argmax`` of an
    empty tensor."""
    out = {}
    for side, (pkg, _, _) in PKGS.items():
        src = pkg.take_rows([pkg.Row({"a": str(i)}) for i in range(5)]).on_device("cpu")
        chain = src.filter(pkg.Like({"a": "9"})).validate(pkg.Like({"a": "1"}), "bad")
        out[side] = [dict(r) for r in chain.to_rows()]
    assert out["port"] == out["ref"] == []
