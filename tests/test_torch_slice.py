"""The port's main path (``csvplus_tpu_torch``) held bitwise against the
JAX package on the CPU: BASELINE config 1 (filter + map + CSV file) and
the 3-table join with a two-column filter, on the conftest corpus (120
people, 8 products, 10 000 orders).  Both packages read the same files;
rows, CSV bytes, positional checksums, and error types with their row
numbers must be equal.  The module-level tests feed one encoded table to
both packages through ``from_reference_arrays`` and cover each hazard of
the port (int32 prefix sums, out-of-range indices, multi-key sorts, join
output order and collisions)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu.columnar.table import DeviceTable as JTable
from csvplus_tpu.utils.checksum import checksum_device_table as j_checksum
from csvplus_tpu_torch.columnar.table import from_reference_arrays
from csvplus_tpu_torch.utils.checksum import (
    checksum_device_table as t_checksum,
    checksum_host_rows as t_checksum_rows,
)

CPU = torch.device("cpu")


def _both(fn):
    """Run *fn(pkg)* against both packages; the JAX side on its CPU device."""
    return fn(J, "cpu"), fn(T, "cpu")


def _err(fn):
    with pytest.raises(Exception) as ei:
        fn()
    e = ei.value
    return type(e).__name__, str(e), getattr(e, "line", None)


# -- BASELINE config 1: Filter(Like).Map(SetValue).ToCsvFile ----------------


def test_config1_filter_map_csv_file(people_csv, tmp_path):
    def run(pkg, dev):
        out = tmp_path / f"{pkg.__name__}.csv"
        src = pkg.from_file(people_csv).on_device(dev)
        src.filter(pkg.Like({"name": "Amelia"})).map(
            pkg.SetValue("name", "Julia")
        ).to_csv_file(str(out), "name", "surname")
        return out.read_bytes()

    want, got = _both(run)
    assert got == want
    assert got.count(b"\n") == 13 and b"Julia,Smith" in got


def test_config1_rows_and_host_path(people_csv):
    def run(pkg, dev):
        src = pkg.from_file(people_csv).on_device(dev).select_columns("name", "surname", "id")
        return src.filter(pkg.Like({"name": "Amelia"})).map(pkg.SetValue("name", "Julia")).to_rows()

    want, got = _both(run)
    assert got == want
    host = T.take(T.from_file(people_csv)).select_columns("name", "surname", "id").filter(
        T.Like({"name": "Amelia"})
    ).map(T.SetValue("name", "Julia")).to_rows()
    assert got == host


# -- the 3-table join with a two-column filter ------------------------------

FILTERS = {
    "not-like-2col": lambda pkg: pkg.Not(pkg.Like({"prod_id": "0", "qty": "1"})),
    "like-2col": lambda pkg: pkg.Like({"prod_id": "3", "qty": "7"}),
    "any-inlist": lambda pkg: pkg.Any(
        *[pkg.Like({"prod_id": str(p)}) for p in (1, 2, 5)], pkg.Like({"qty": "7"})
    ),
}


def _join3(pkg, dev, corpus, pred):
    orders = pkg.from_file(corpus["orders_csv"]).on_device(dev)
    cust = pkg.from_file(corpus["people_csv"]).on_device(dev).unique_index_on("id")
    prod = pkg.from_file(corpus["stock_csv"]).on_device(dev).unique_index_on("prod_id")
    return orders.filter(pred(pkg)).join(cust, "cust_id").join(prod)


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_three_table_join_rows_and_checksums(corpus, name):
    pred = FILTERS[name]
    want_src, got_src = _both(lambda pkg, dev: _join3(pkg, dev, corpus, pred))
    want = want_src.to_rows()
    got = got_src.to_rows()
    assert len(got) > 0 and got == want
    cols = sorted(got[0])
    want_sums = j_checksum(want_src.to_device_table(), cols, positional=True)
    table = got_src.to_device_table()
    assert all(c.storage.device == CPU for c in table.columns.values())
    assert t_checksum(table, cols, positional=True) == want_sums
    assert t_checksum_rows(got, cols, positional=True) == want_sums


def test_three_table_join_csv_bytes(corpus, tmp_path):
    cols = ("order_id", "name", "surname", "product", "price", "qty")

    def run(pkg, dev):
        out = tmp_path / f"join_{pkg.__name__}.csv"
        _join3(pkg, dev, corpus, FILTERS["not-like-2col"]).to_csv_file(str(out), *cols)
        return out.read_bytes()

    want, got = _both(run)
    assert got == want


def test_join_matches_host_path(corpus):
    pred = FILTERS["any-inlist"]
    got = _join3(T, "cpu", corpus, pred).to_rows()
    cust = T.take(T.from_file(corpus["people_csv"])).unique_index_on("id")
    prod = T.take(T.from_file(corpus["stock_csv"])).unique_index_on("prod_id")
    host = T.take(T.from_file(corpus["orders_csv"])).filter(pred(T)).join(
        cust, "cust_id").join(prod).to_rows()
    assert got == host


def test_fanout_join_order_matches_reference(corpus):
    """A non-unique index: each stream row's matches come out in index
    order, stream order kept, then a Top cuts the stream."""
    def run(pkg, dev):
        orders = pkg.from_file(corpus["orders_csv"]).on_device(dev).select_columns(
            "cust_id", "order_id", "qty")
        by_cust = orders.index_on("cust_id")
        people = pkg.from_file(corpus["people_csv"]).on_device(dev)
        return people.filter(pkg.Like({"name": "Ava"})).join(by_cust, "id").top(500).to_rows()

    want, got = _both(run)
    assert len(got) == 500 and got == want


def test_join_collision_keeps_index_cell_where_stream_lacks_it():
    """On a name collision the stream wins only where it has the cell."""
    rows = [{"k": "a", "v": "s1"}, {"k": "b"}, {"k": "a"}, {"k": "c", "v": "s4"}]
    build = [{"k": "a", "v": "i1", "w": "x"}, {"k": "b", "v": "i2", "w": "y"},
             {"k": "c", "v": "i3", "w": "z"}]

    def run(pkg, dev):
        idx = pkg.take_rows([pkg.Row(r) for r in build]).on_device(dev).unique_index_on("k")
        return pkg.take_rows([pkg.Row(r) for r in rows]).on_device(dev).join(idx).to_rows()

    want, got = _both(run)
    assert got == want
    assert [r["v"] for r in got] == ["s1", "i2", "i1", "s4"]


def test_index_find_and_resolve_duplicates(corpus):
    def run(pkg, dev):
        orders = pkg.from_file(corpus["orders_csv"]).on_device(dev)
        idx = orders.index_on("cust_id", "prod_id")
        found = idx.find("17").to_rows() + idx.find("17", "3").to_rows()
        idx.resolve_duplicates("last")
        return found, len(idx), idx.find("5").to_rows()

    want, got = _both(run)
    assert got == want


def test_try_execute_plan(people_csv):
    """Symbolic chains execute to rows; an opaque stage cannot lower."""
    from csvplus_tpu.columnar.exec import try_execute_plan as j_try
    from csvplus_tpu_torch.columnar.exec import try_execute_plan as t_try

    def run(pkg, dev):
        src = pkg.from_file(people_csv).on_device(dev)
        sym = src.filter(pkg.Like({"name": "Ava"})).drop_columns("born").top(4)
        opaque = src.filter(lambda row: row["name"] == "Ava")
        return j_try(sym.plan) if pkg is J else t_try(sym.plan), opaque.plan

    (want, want_plan), (got, got_plan) = _both(run)
    assert got == want and len(got) == 4
    assert want_plan is None and got_plan is None and t_try(None) is None


# -- errors carry the reference's types and row numbers ---------------------


def test_error_missing_join_column(corpus):
    def run(pkg, dev):
        cust = pkg.from_file(corpus["people_csv"]).on_device(dev).unique_index_on("id")
        src = pkg.from_file(corpus["orders_csv"]).on_device(dev).filter(
            pkg.Like({"prod_id": "3", "qty": "2"}))
        return _err(lambda: src.join(cust, "nope").to_rows())

    want, got = _both(run)
    assert got == want and got[2] is not None


def test_error_missing_key_cell_in_heterogeneous_stream():
    rows = [{"k": "a"}, {"k": "b"}, {"x": "1"}, {"k": "a"}]

    def run(pkg, dev):
        idx = pkg.take_rows([pkg.Row({"k": "a", "v": "1"})]).on_device(dev).unique_index_on("k")
        src = pkg.take_rows([pkg.Row(r) for r in rows]).on_device(dev)
        return _err(lambda: src.join(idx).to_rows())

    want, got = _both(run)
    assert got == want and got[2] == 2


def test_error_ragged_row(tmp_path):
    path = tmp_path / "ragged.csv"
    path.write_text("a,b\n1,2\n3,4\n5\n6,7\n")
    want, got = _both(lambda pkg, dev: _err(lambda: pkg.from_file(str(path)).on_device(dev)))
    assert got == want and got[2] == 4


def test_error_duplicate_unique_key(people_csv):
    want, got = _both(
        lambda pkg, dev: _err(
            lambda: pkg.from_file(people_csv).on_device(dev).unique_index_on("name")
        )
    )
    assert got == want and "duplicate value" in got[1]


def test_error_select_missing_column(people_csv):
    want, got = _both(
        lambda pkg, dev: _err(
            lambda: pkg.from_file(people_csv).on_device(dev).filter(
                pkg.Like({"name": "Ava", "surname": "Brown"})
            ).select_columns("name", "nope").to_rows()
        )
    )
    assert got == want and got[2] is not None


def test_error_deferred_validate(people_csv):
    def run(pkg, dev):
        src = pkg.from_file(people_csv).on_device(dev)
        v = src.validate(pkg.Not(pkg.Like({"name": "Isla", "surname": "Evans"})), "no Isla Evans")
        seen = []

        def take5(row):
            seen.append(row)
            if len(seen) == 5:
                raise pkg.StopPipeline

        v(take5)  # stops before the failing row: no error
        return len(seen), _err(lambda: v.to_rows())

    want, got = _both(run)
    assert got == want and got[1][2] is not None


# -- one encoded table fed to both packages ---------------------------------


def _encoded(rng, n, spec):
    """name -> (sorted 'S' dictionary, int32 codes) from a seed."""
    out = {}
    for name, (card, absent) in spec.items():
        d = np.unique(np.char.add(name, rng.integers(0, 10 * card, card).astype(np.str_)))
        d = np.char.encode(d, "utf-8")
        codes = rng.integers(0, d.size, n).astype(np.int32)
        if absent:
            codes[rng.random(n) < absent] = -1
        out[name] = (d, codes)
    return out


def _jtable(data, n):
    return JTable.from_encoded(data, n, device="cpu")


def test_from_reference_arrays_round_trip():
    rng = np.random.default_rng(3)
    data = _encoded(rng, 500, {"a": (40, 0.0), "b": (7, 0.1)})
    jt = _jtable(data, 500)
    carried = {n: (c.dictionary, c.codes_host()) for n, c in jt.columns.items()}
    tt = from_reference_arrays(carried, "cpu")
    assert tt.nrows == 500 and tt.device == CPU
    assert tt.to_rows() == jt.to_rows()
    assert t_checksum(tt, positional=True) == j_checksum(jt, positional=True)


@pytest.mark.parametrize(
    "data, match",
    [
        ({"a": (np.array([b"y", b"x"]), np.zeros(2, np.int32))}, "not sorted"),
        ({"a": (np.array([b"x"]), np.array([1], np.int32))}, "out of dictionary"),
        ({"a": (np.array([b"x"]), np.zeros(2, np.int32)),
          "b": (np.array([b"x"]), np.zeros(3, np.int32))}, "expected 2"),
    ],
)
def test_from_reference_arrays_rejects_bad_input(data, match):
    with pytest.raises(ValueError, match=match):
        from_reference_arrays(data, "cpu")


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        from_reference_arrays({"a": (np.array([b"x"]), np.zeros(1, np.int32))}, "cuda")


def test_encode_strings_dictionary_order():
    from csvplus_tpu.columnar.table import encode_strings as j_enc
    from csvplus_tpu_torch.columnar.table import encode_strings as t_enc

    vals = ["b", "a", None, "é", "B", "a", "", None, "zz"]
    (jd, jc), (td, tc) = j_enc(vals), t_enc(vals)
    assert np.array_equal(jd, td) and np.array_equal(jc, tc)
    assert tc.dtype == np.int32


# -- hazards ----------------------------------------------------------------


def test_hazard_multikey_stable_sort():
    """lax.sort(num_keys=3, is_stable=True) vs the port's LSD passes."""
    from csvplus_tpu.ops.sort import _sort_kernel
    from csvplus_tpu_torch.ops.sort import sort_permutation

    rng = np.random.default_rng(5)
    n = 4000
    keys = [rng.integers(0, m, n).astype(np.int32) for m in (3, 5, 4)]
    iota = jnp.arange(n, dtype=jnp.int32)
    want = np.asarray(_sort_kernel(tuple(jnp.asarray(k) for k in keys) + (iota,), num_keys=3)[-1])
    got = sort_permutation([torch.from_numpy(k) for k in keys])
    assert np.array_equal(got.numpy(), want)


def test_hazard_direct_cum_int32_and_dropped_slots():
    """int32 cumsum, and keys outside the universe dropped as
    ``.at[].add(mode="drop")`` drops them."""
    from csvplus_tpu.ops.join import _build_direct_cum as j_cum
    from csvplus_tpu_torch.ops.join import _build_direct_cum as t_cum

    keys = np.array([0, 0, 3, 5, 5, 5, 7, 9, 40, -3], dtype=np.int32)
    want = np.asarray(j_cum(jnp.asarray(keys), total_bits=3))
    got = t_cum(torch.from_numpy(keys), 3)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_hazard_direct_probe_clips_out_of_range_queries():
    from csvplus_tpu.ops.join import direct_probe_parts as j_probe
    from csvplus_tpu_torch.ops.join import direct_probe_parts as t_probe

    cum = np.array([0, 2, 2, 3, 5, 6, 6, 7, 8], dtype=np.int32)
    qk = np.array([-1, 0, 3, 7, 8, 12, 2**30], dtype=np.int32)
    for r in (1, 2, 4):
        want = jax.jit(j_probe)(jnp.asarray(cum), jnp.asarray(qk), jnp.int32(r))
        got = t_probe(torch.from_numpy(cum), torch.from_numpy(qk), r)
        for w, g in zip(want, got):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), np.asarray(w))


def test_hazard_expand_masks_empty_segments():
    """Empty segments scatter out of bounds in the reference (dropped);
    the port masks them.  Zero counts at both ends and in the middle."""
    from csvplus_tpu.ops.join import expand_matches_device as j_exp
    from csvplus_tpu_torch.ops.join import expand_matches_device as t_exp

    counts = np.array([0, 3, 0, 0, 1, 2, 0, 4, 0], dtype=np.int32)
    lower = np.array([5, 0, 9, 1, 7, 2, 3, 10, 4], dtype=np.int32)
    want = j_exp(jnp.asarray(lower), jnp.asarray(counts))
    got = t_exp(torch.from_numpy(lower), torch.from_numpy(counts))
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_hazard_code_translation_keeps_negative_codes():
    from csvplus_tpu.columnar.table import _apply_code_translation as j_tr
    from csvplus_tpu_torch.columnar.table import apply_code_translation as t_tr

    codes = np.array([2, -1, 0, -2, 1, 2], dtype=np.int32)
    trans = np.array([4, -1, 0], dtype=np.int32)
    want = np.asarray(j_tr(jnp.asarray(codes), jnp.asarray(trans)))
    got = t_tr(torch.from_numpy(codes), torch.from_numpy(trans))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "tier, spec, direct_max",
    [
        ("direct", {"k1": (50, 0.0), "k2": (30, 0.0)}, 23),
        ("i32", {"k1": (50, 0.0), "k2": (30, 0.0)}, 0),
        ("i32pair", {"k1": (70000, 0.0), "k2": (70000, 0.0)}, 23),
    ],
)
def test_probe_tiers_match_reference(tier, spec, direct_max, monkeypatch):
    """The same sorted build table and the same probe codes through each
    key tier of both packages: equal (lower, counts), full and prefix."""
    from csvplus_tpu.ops.join import DeviceIndex as JIdx
    from csvplus_tpu.ops.sort import sort_table as j_sort
    from csvplus_tpu_torch.ops.join import DeviceIndex as TIdx

    monkeypatch.setattr(JIdx, "DIRECT_MAX_BITS", direct_max)
    monkeypatch.setattr(TIdx, "DIRECT_MAX_BITS", direct_max)
    rng = np.random.default_rng(11)
    build = _encoded(rng, 3000, spec)
    jb = j_sort(_jtable(build, 3000), ["k1", "k2"])
    carried = {n: (c.dictionary, c.codes_host()) for n, c in jb.columns.items()}
    tb = from_reference_arrays(carried, "cpu")
    ji, ti = JIdx.build(jb, ["k1", "k2"]), TIdx.build(tb, ["k1", "k2"])
    assert (ti.packed_i32 is not None) == (ji.packed_i32 is not None)
    assert (ti.direct_bits is None) == (ji.direct_bits is None)
    assert {"direct": ti.direct_bits is not None,
            "i32": ti.packed_i32 is not None and ti.direct_bits is None,
            "i32pair": ti.packed_hi is not None}[tier]
    # probe rows: half are build rows, half draw from the whole
    # dictionaries, so both hits and misses occur
    hit = rng.random(2000) < 0.5
    rows = rng.integers(0, 3000, 2000)
    pj = {}
    for name, (d, c) in carried.items():
        codes = np.where(hit, c[rows], rng.integers(0, d.size, 2000)).astype(np.int32)
        pj[name] = (d, codes)
    js = _jtable(pj, 2000)
    ts = from_reference_arrays(pj, "cpu")
    for k in (2, 1):
        names = ["k1", "k2"][:k]
        jl, jc = ji.probe([js.columns[n] for n in names], 2000)
        tl, tc = ti.probe([ts.columns[n] for n in names], 2000)
        assert np.array_equal(tl.numpy(), np.asarray(jl))
        assert np.array_equal(tc.numpy(), np.asarray(jc))
        assert int(tc.sum()) > 0
