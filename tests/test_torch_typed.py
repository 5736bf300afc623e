"""Typed affix-int32 columns in the port (``csvplus_tpu_torch/columnar/
typed.py`` and the typed paths of table, filter, join, checksum and the
sinks) held bitwise against the JAX package on the CPU: the same numpy
inputs and the same CSV bytes through both, at small sizes.  The slice
test runs the 3-table join with ``CSVPLUS_TYPED_LANES`` at 1 and at 0
and checks that the orders columns stay typed and are never demoted."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import csvplus_tpu as J
import csvplus_tpu.columnar.typed as JT
import csvplus_tpu_torch as T
import csvplus_tpu_torch.columnar.typed as TT
from csvplus_tpu.columnar.table import DeviceTable as JTable
from csvplus_tpu.ops.pallas_mask import fused_equality_mask as jax_mask
from csvplus_tpu.utils.checksum import checksum_device_table as j_checksum
from csvplus_tpu.utils.checksum import fnv1a_affix_int_device as j_affix_hash
from csvplus_tpu.utils.checksum import fnv1a_values
from csvplus_tpu_torch.columnar.table import StringColumn, from_reference_arrays
from csvplus_tpu_torch.ops import mask as M
from csvplus_tpu_torch.utils.checksum import checksum_device_table as t_checksum
from csvplus_tpu_torch.utils.checksum import fnv1a_affix_int_device as t_affix_hash

I32_MAX = 2**31 - 1
PREFIXES = [b"", b"o", b"id-"]


def _values(seed: int, n: int = 600, negative: bool = True) -> np.ndarray:
    """Seeded int32 values with the extremes a typed cell can hold."""
    rng = np.random.default_rng(seed)
    lo = -I32_MAX if negative else 0
    vals = rng.integers(lo, I32_MAX + 1, n).astype(np.int32)
    small = rng.integers(-50 if negative else 0, 50, n).astype(np.int32)
    vals = np.where(rng.random(n) < 0.5, small, vals)
    edge = [0, 1, 9, 10, I32_MAX]
    if negative:
        edge += [-1, -10, -I32_MAX]
    vals[: len(edge)] = edge
    return vals


def _cols(prefix: bytes, vals: np.ndarray):
    """The same typed column in both packages."""
    return JT.IntColumn(prefix, jnp.asarray(vals)), TT.IntColumn(prefix, torch.from_numpy(vals))


QUERIES = ["0", "-0", "7", "-7", "07", "+7", " 7", "7 ", "2147483647", "2147483648",
           "-2147483647", "-2147483648", "", "-", "o", "o7", "o-7", "o07", "o0",
           "id-12", "id-012", "id--1", "abc", "٣", "1e3"]


@pytest.mark.parametrize("prefix", PREFIXES, ids=repr)
def test_equality_term_matches_reference(prefix):
    jc, tc = _cols(prefix, _values(1, 10))
    for q in QUERIES:
        assert tc.equality_term(q) == jc.equality_term(q), q


def _dictionary(prefix: bytes) -> np.ndarray:
    entries = {prefix + str(v).encode() for v in _values(2, 300).tolist()}
    entries |= {b"-0", b"007", prefix + b"01", prefix + b"-5", b"x", prefix,
                prefix + b"2147483648", prefix + b"99999999999", b"-", b"zz9"}
    return np.array(sorted(entries), dtype="S")


@pytest.mark.parametrize("prefix", PREFIXES, ids=repr)
def test_parse_affix_dictionary_matches_reference(prefix):
    d = _dictionary(prefix)
    got = TT.parse_affix_dictionary(d, prefix)
    want = JT.parse_affix_dictionary(d, prefix)
    assert all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want))
    assert got[0].size > 100
    empty = TT.parse_affix_dictionary(np.empty(0, dtype="S1"), prefix)
    assert [a.size for a in empty] == [0, 0]


@pytest.mark.parametrize("prefix", PREFIXES, ids=repr)
def test_format_affix_matches_reference(prefix):
    vals = _values(3)
    got = TT.format_affix(prefix, vals)
    want = JT.format_affix(prefix, vals)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.tolist() == [prefix + str(int(v)).encode() for v in vals]


def _with_pads(vals: np.ndarray) -> np.ndarray:
    out = vals.copy()
    out[3::97] = TT.PAD_VALUE
    return out


TRANSLATIONS = {
    # build values in a compact range: the dense table
    "dense": lambda: (np.arange(-40, 60, 3, dtype=np.int32), "dense"),
    # build values near 2^31 - 1: PAD_VALUE - lo would wrap into the table's range
    "dense-high": lambda: (np.arange(I32_MAX - 600, I32_MAX, 7, dtype=np.int32), "dense"),
    # spread values: searchsorted over the sorted build values
    "sorted": lambda: (np.unique(_values(4, 200)), "sorted"),
    "empty": lambda: (np.empty(0, dtype=np.int32), "sorted"),
}


@pytest.mark.parametrize("case", sorted(TRANSLATIONS))
def test_translations_match_reference(case):
    build, kind = TRANSLATIONS[case]()
    rng = np.random.default_rng(5)
    codes = rng.permutation(build.size).astype(np.int32)  # build slot per value
    probe = np.concatenate([build, _values(6, 400)]).astype(np.int32)
    if build.size:
        probe = np.concatenate([probe, build.min() - 1 + np.zeros(3, np.int32)])
    probe = _with_pads(rng.permutation(probe).astype(np.int32))
    state = TT.IntColumn._build_translation(build, codes, torch.device("cpu"))
    assert state[0] == kind
    got = TT.IntColumn(b"", torch.from_numpy(probe))._translate_by_values(state)
    jstate = JT.IntColumn._build_translation(build, codes)
    want = JT.IntColumn(b"", jnp.asarray(probe))._translate_by_values(jstate)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[probe == TT.PAD_VALUE] == -2).all()


@pytest.mark.parametrize("prefix", PREFIXES, ids=repr)
def test_renumbered_to_matches_reference(prefix):
    """A typed probe column translated into a string build dictionary
    (the join's probe translation), and a string column into a typed
    build column's demoted dictionary."""
    d = _dictionary(prefix)
    jc, tc = _cols(prefix, _values(7))
    assert np.array_equal(tc.renumbered_to(d).numpy(), np.asarray(jc.renumbered_to(d)))
    build = StringColumn(d, torch.zeros(d.size, dtype=torch.int32))
    assert np.array_equal(tc.renumbered_to_col(build).numpy(), np.asarray(jc.renumbered_to(d)))
    assert tc._demoted is None  # the probe side is never demoted
    sc = StringColumn(d, torch.arange(d.size, dtype=torch.int32))
    got = sc.renumbered_to_col(tc)
    want = np.asarray(
        J.columnar.table.StringColumn(d, jnp.arange(d.size, dtype=jnp.int32)).renumbered_to_col(jc)
    )
    assert np.array_equal(got.numpy(), want)


DEMOTE_CASES = {
    "mixed-sign": lambda: (b"", _values(8)),
    "prefixed": lambda: (b"o", _values(9, negative=False)),
    "with-pads": lambda: (b"c", _with_pads(_values(10, negative=False))),
    "one-value": lambda: (b"p", np.full(5, 7, np.int32)),
    "empty": lambda: (b"p", np.empty(0, np.int32)),
}


@pytest.mark.parametrize("case", sorted(DEMOTE_CASES))
def test_demote_matches_reference(case, monkeypatch):
    prefix, vals = DEMOTE_CASES[case]()
    monkeypatch.setattr(TT, "demotions", [])
    jc, tc = _cols(prefix, vals)
    got, want = tc._demote(), jc._demote()
    assert got.dictionary.dtype == want.dictionary.dtype
    assert np.array_equal(got.dictionary, want.dictionary)
    assert np.array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert tc._demote() is got  # cached: one demotion
    assert TT.demotions == [(prefix, vals.size)]
    assert got.decode() == [None if c < 0 else v for c, v in zip(got.codes.tolist(), jc.decode())]


@pytest.mark.parametrize("prefix", PREFIXES, ids=repr)
def test_affix_hash_matches_reference(prefix):
    vals = _values(11)
    got = t_affix_hash(prefix, torch.from_numpy(vals))
    want = np.asarray(j_affix_hash(prefix, jnp.asarray(vals)))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert np.array_equal(want, fnv1a_values(JT.format_affix(prefix, vals)))


def _typed_table(seed: int, n: int = 500):
    vals = {
        "a": (b"", _values(seed, n)),
        "b": (b"o", _values(seed + 1, n, negative=False)),
        "c": (b"id-", np.abs(_values(seed + 2, n)) % 1000),
    }
    rng = np.random.default_rng(seed)
    d = np.array([b"x", b"y", b"zz"], dtype="S")
    data = {k: ("int", p, v.astype(np.int32)) for k, (p, v) in vals.items()}
    data["s"] = (d, rng.integers(0, 3, n).astype(np.int32))
    return data


@pytest.mark.parametrize("positional", [False, True])
def test_typed_checksums_and_rows_match_reference(positional):
    data = _typed_table(12)
    jt = JTable.from_encoded(data, 500, device="cpu")
    tt = from_reference_arrays(data, "cpu")
    assert {n: c.kind for n, c in tt.columns.items()} == {"a": "int", "b": "int",
                                                          "c": "int", "s": "str"}
    assert t_checksum(tt, positional=True) == j_checksum(jt, positional=True)
    assert t_checksum(tt, limit=77, positional=positional) == j_checksum(
        jt, limit=77, positional=positional)
    assert tt.to_rows() == jt.to_rows()
    sel = np.array([5, 0, 499, 5], dtype=np.int64)
    assert tt.to_rows(torch.from_numpy(sel)) == jt.to_rows(sel)
    assert all(c._demoted is None for c in tt.columns.values() if c.kind == "int")


@pytest.mark.parametrize("data, match", [
    ({"a": ("int", "o", np.zeros(2, np.int32))}, "prefix must be bytes"),
    ({"a": ("int", b"o", np.array([TT.PAD_VALUE], np.int32))}, "INT32_MIN"),
    ({"a": ("int", b"o", np.zeros((2, 2), np.int32))}, "one-dimensional"),
    ({"a": ("int", b"o", np.zeros(2, np.int32)),
      "b": (np.array([b"x"]), np.zeros(3, np.int32))}, "expected 2"),
])
def test_from_reference_arrays_rejects_bad_typed_input(data, match):
    with pytest.raises(ValueError, match=match):
        from_reference_arrays(data, "cpu")


TYPED_MASKS = {
    "negative-targets": ([-7, 0], "all"),
    "int32-extremes": ([I32_MAX, -I32_MAX], "any"),
    "absent-target": ([123456789, 5], "all"),
    "in-lists": ([[-1, 0, 1, I32_MAX], [-I32_MAX, -50]], "any"),
}


@pytest.mark.parametrize("case", sorted(TYPED_MASKS))
def test_mask_on_typed_lanes_matches_pallas_kernel(case):
    """Arbitrary int32 value lanes: no negative value is taken as absent."""
    targets, mode = TYPED_MASKS[case]
    cols = [_values(13, 3001), _values(14, 3001)]
    cols[0][100:110] = -7
    cols[1][100:105] = 0
    want = np.asarray(jax_mask([jnp.asarray(c) for c in cols], targets, 3001, mode=mode))
    tcols = [torch.from_numpy(c) for c in cols]
    got = M.fused_equality_mask(tcols, targets, 3001, mode=mode)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(M.fused_equality_mask_plain(tcols, targets, mode).numpy(), want)
    if case != "absent-target":
        assert want.any()


# -- the slice: typed 3-table join through both packages ---------------------


@pytest.fixture
def typed_files(tmp_path):
    rng = np.random.default_rng(21)
    n = 3000
    # customers c40..c43 do not exist: those orders miss the first join,
    # so the stream side is gathered, not passed through
    cust, prod, qty = rng.integers(0, 44, n), rng.integers(0, 6, n), rng.integers(-5, 6, n)
    orders = tmp_path / "orders.csv"
    orders.write_text("order_id,cust_id,prod_id,qty\n" + "".join(
        f"o{i},c{c},p{p},{q}\n" for i, (c, p, q) in enumerate(zip(cust, prod, qty))))
    custs = tmp_path / "cust.csv"
    custs.write_text("id,name\n" + "".join(f"c{i},name{i % 9}\n" for i in range(40)))
    prods = tmp_path / "prod.csv"
    prods.write_text("prod_id,product,price\n" + "".join(
        f"p{i},prod{i},{i}.99\n" for i in range(6)))
    return str(orders), str(custs), str(prods)


SLICE_FILTERS = {
    "not-like-2col": lambda pkg: pkg.Not(pkg.Like({"prod_id": "p0", "qty": "1"})),
    "negative-value": lambda pkg: pkg.Like({"qty": "-3"}),
    "any-inlist": lambda pkg: pkg.Any(
        *[pkg.Like({"prod_id": f"p{p}"}) for p in (1, 2, 5)], pkg.Like({"qty": "-5"})),
    "absent-value": lambda pkg: pkg.Not(pkg.Like({"cust_id": "c07"})),
}
ORDERS_COLS = ("order_id", "cust_id", "prod_id", "qty")


def _slice(pkg, files, pred):
    o, c, p = files
    orders = pkg.from_file(o).on_device("cpu")
    cust = pkg.from_file(c).on_device("cpu").unique_index_on("id")
    prod = pkg.from_file(p).on_device("cpu").unique_index_on("prod_id")
    return orders, orders.filter(pred(pkg)).join(cust, "cust_id").join(prod)


@pytest.mark.parametrize("typed", ["1", "0"])
@pytest.mark.parametrize("name", sorted(SLICE_FILTERS))
def test_typed_join_matches_reference(typed_files, tmp_path, monkeypatch, name, typed):
    monkeypatch.setenv("CSVPLUS_TYPED_LANES", typed)
    monkeypatch.setattr(TT, "demotions", [])
    pred = SLICE_FILTERS[name]
    j_orders, j_src = _slice(J, typed_files, pred)
    t_orders, t_src = _slice(T, typed_files, pred)
    build_demotions = list(TT.demotions)
    want, got = j_src.to_rows(), t_src.to_rows()
    assert len(got) > 0 and got == want
    jt, tt = j_src.to_device_table(), t_src.to_device_table()
    cols = sorted(tt.columns)
    assert t_checksum(tt, cols, positional=True) == j_checksum(jt, cols, positional=True)
    assert t_src.top(3).to_rows() == j_src.top(3).to_rows()
    out = {}
    for pkg, src in (("j", j_src), ("t", t_src)):
        path = tmp_path / f"{name}_{typed}_{pkg}.csv"
        src.to_csv_file(str(path), "order_id", "name", "product", "price", "qty")
        out[pkg] = path.read_bytes()
    assert out["t"] == out["j"]

    # the orders side stays typed, and nothing of it is ever demoted
    for orders, table in ((j_orders, jt), (t_orders, tt)):
        for c in ORDERS_COLS:
            for col in (orders.plan.table.columns[c], table.columns[c]):
                assert col.kind == ("int" if typed == "1" else "str")
                assert getattr(col, "_demoted", None) is None
    assert TT.demotions == build_demotions  # only the index builds demoted
    if typed == "1":
        assert sorted(build_demotions) == [(b"c", 40), (b"p", 6)]
