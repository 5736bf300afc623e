"""Device-lane dictionaries in the port (``csvplus_tpu_torch/ops/lanes.py``
and the lane paths of ``columnar/table.py``, sort, join, checksum and the
streamed ingest) held bitwise against the JAX package on the CPU: every
function of ``ops/lanes.py`` on seeded numpy inputs (widths 1-32,
duplicates across chunks, empty chunks, a union the reference pads to a
power of two), and lane columns end to end under
``CSVPLUS_DICT_DEVICE_MIN_DISTINCT`` of 1 and 100: they stay in lanes, a
payload column never sorts its union, filters, finds and joins (lanes on
the build side, the probe side and both) give the reference's rows, and
the on-device lane checksums equal the reference's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import csvplus_tpu as J
import csvplus_tpu.ops.lanes as JL
import csvplus_tpu_torch as T
import csvplus_tpu_torch.columnar.table as TB
import csvplus_tpu_torch.ops.lanes as TL
from csvplus_tpu.columnar.table import StringColumn as JString
from csvplus_tpu.utils.checksum import checksum_device_table as j_checksum
from csvplus_tpu.utils.checksum import fnv1a_lanes_device as j_lane_hash
from csvplus_tpu_torch.utils.checksum import checksum_device_table as t_checksum
from csvplus_tpu_torch.utils.checksum import fnv1a_lanes_device as t_lane_hash

WIDTHS = [1, 3, 4, 5, 8, 9, 12, 16, 17, 24, 31, 32]


def _rand_dict(rng, n, width):
    """*n* distinct sorted byte strings of 1..width printable bytes (a
    few at exactly *width*; at most 94 of width 1)."""
    n = min(n, 94) if width == 1 else n
    vals = set()
    while len(vals) < n:
        k = int(rng.integers(1, width + 1)) if len(vals) % 5 else width
        vals.add(bytes(rng.integers(33, 127, k).astype(np.uint8)))
    return np.sort(np.array(sorted(vals), dtype="S"))


def _t(lanes):
    return tuple(torch.from_numpy(np.asarray(x)) for x in lanes)


def _j(lanes):
    return tuple(jnp.asarray(np.asarray(x)) for x in lanes)


def _same(got, want):
    assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("width", WIDTHS)
def test_pack_unpack_extend_match_reference(width):
    rng = np.random.default_rng(width)
    d = _rand_dict(rng, 200, width)
    n_lanes = TL.lanes_for_width(d.dtype.itemsize)
    assert n_lanes == JL.lanes_for_width(d.dtype.itemsize)
    got = TL.pack_host(d, n_lanes)
    want = JL.pack_host(d, n_lanes)
    assert len(got) == len(want) and all(g.dtype == np.int32 for g in got)
    for g, w in zip(got, want):
        _same(g, w)
    back = TL.unpack_host(got)
    assert back.dtype == JL.unpack_host(want).dtype and back.tolist() == d.tolist()
    for g, w in zip(TL.extend_lanes_host(got, 8), JL.extend_lanes_host(want, 8)):
        _same(g, w)
    for g, w in zip(TL.widen_lanes_device(_t(got), 8), JL.widen_lanes_device(_j(want), 8)):
        assert g.dtype == torch.int32
        _same(g, w)


def test_lane_widths_and_empty_packs_match_reference():
    for w in range(0, 40):
        assert TL.lanes_for_width(w) == JL.lanes_for_width(w)
    empty = np.empty(0, dtype="S1")
    for g, w in zip(TL.pack_host(empty, 2), JL.pack_host(empty, 2)):
        assert g.shape == w.shape == (0,)
    assert TL.unpack_host(TL.pack_host(empty, 2)).shape == (0,)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("width", WIDTHS)
def test_searchsorted_lanes_matches_reference(width, side):
    rng = np.random.default_rng(100 + width)
    d = _rand_dict(rng, 300, width)
    n_lanes = TL.lanes_for_width(d.dtype.itemsize)
    keys = TL.pack_host(d, n_lanes)
    probes = np.concatenate([d[::3], _rand_dict(rng, 60, width)]).astype(d.dtype)
    q = TL.pack_host(probes, n_lanes)
    got = TL.searchsorted_lanes(_t(keys), _t(q), side=side)
    assert got.dtype == torch.int32
    _same(got, JL.searchsorted_lanes(_j(keys), _j(q), side=side))
    _same(got, np.searchsorted(d, probes, side=side))
    # an empty key set: every position is 0
    empty = TL.pack_host(np.empty(0, dtype="S1"), n_lanes)
    _same(TL.searchsorted_lanes(_t(empty), _t(q), side=side), np.zeros(len(probes)))


UNION_CASES = {
    # chunk sizes (0 = an empty chunk) and the widest entry
    "dups-across-chunks": ([40, 200, 7, 130], 12),
    "empty-chunks": ([0, 50, 0, 20, 0], 8),
    "pow2-exact": ([32, 32], 4),  # 64 entries: no padding
    "pow2-padding": ([33, 31, 1], 30),  # 65 entries: the reference pads to 128
    "one-entry": ([1], 3),
    "all-empty": ([0, 0], 5),
}


@pytest.mark.parametrize("case", sorted(UNION_CASES))
def test_union_device_matches_reference(case):
    sizes, width = UNION_CASES[case]
    rng = np.random.default_rng(len(case))
    pool = _rand_dict(rng, 260, width)
    # chunks draw from one pool, so entries repeat across chunks
    chunks = [np.sort(rng.choice(pool, size=min(n, pool.size), replace=False)) for n in sizes]
    w = max(c.dtype.itemsize for c in chunks)
    n_lanes = TL.lanes_for_width(w)
    lane_sets = [TL.pack_host(c.astype(f"S{w}"), n_lanes) for c in chunks]
    t_union, t_tables = TL.union_device([_t(x) for x in lane_sets])
    j_union, j_tables = JL.union_device([_j(x) for x in lane_sets])
    assert len(t_union) == len(j_union)
    for g, want in zip(t_union, j_union):
        _same(g, want)
    for g, want in zip(t_tables, j_tables):
        assert g.dtype == torch.int32
        _same(g, want)
    union = TL.unpack_host([x.numpy() for x in t_union])
    want = np.unique(np.concatenate([c.astype(f"S{w}") for c in chunks]))
    assert union.tolist() == want.tolist()


def test_union_device_sorts_the_entries_unpadded(monkeypatch):
    """The port sorts the concatenated entries as they are: no padding to
    a power of two (the reference's bound on XLA recompiles)."""
    seen = []
    kernel = TL._union_kernel

    def spy(concat, n_lanes, k_real):
        seen.append((int(concat[0].shape[0]), k_real))
        return kernel(concat, n_lanes, k_real)

    monkeypatch.setattr(TL, "_union_kernel", spy)
    rng = np.random.default_rng(5)
    chunks = [np.sort(_rand_dict(rng, n, 9)) for n in (33, 31, 1)]
    TL.union_device([_t(TL.pack_host(c.astype("S9"), 4)) for c in chunks])
    assert seen == [(65, 65)]


def test_union_kernel_matches_reference():
    """The kernel alone, on a concatenation padded with lane maxima."""
    rng = np.random.default_rng(3)
    d = _rand_dict(rng, 50, 10)
    both = np.concatenate([d, d[::2], d[1::3]])  # unsorted, with duplicates
    lanes = TL.pack_host(both, 4)
    pad = [np.concatenate([x, np.full(128 - x.size, 2**31 - 1, np.int32)]) for x in lanes]
    t_map, t_uniq, t_size = TL._union_kernel(_t(pad), 4, both.size)
    j_map, j_uniq, j_size = JL._union_kernel(_j(pad), 4, both.size)
    _same(t_map, j_map)
    assert int(t_size) == int(j_size) == d.size
    for g, want in zip(t_uniq, j_uniq):
        _same(g[: d.size], np.asarray(want)[: d.size])


@pytest.mark.parametrize("widths", [(20, 6), (6, 20), (32, 32), (4, 9)])
def test_translate_lanes_matches_reference(widths):
    rng = np.random.default_rng(sum(widths))
    build = _rand_dict(rng, 300, widths[0])
    query = np.unique(np.concatenate([build[::4].astype(f"S{max(widths)}"),
                                      _rand_dict(rng, 80, widths[1]).astype(f"S{max(widths)}")]))
    query = query[np.char.str_len(query) <= widths[1]].astype(f"S{widths[1]}")
    bl = TL.pack_host(build, TL.lanes_for_width(build.dtype.itemsize))
    ql = TL.pack_host(query, TL.lanes_for_width(query.dtype.itemsize))
    got = TL.translate_lanes(_t(bl), _t(ql))
    assert got.dtype == torch.int32
    _same(got, JL.translate_lanes(_j(bl), _j(ql)))
    n = max(len(bl), len(ql))
    _same(TL._translate_kernel(TL.widen_lanes_device(_t(bl), n), TL.widen_lanes_device(_t(ql), n)),
          JL._translate_kernel(JL.widen_lanes_device(_j(bl), n),
                               JL.widen_lanes_device(_j(ql), n)))
    empty = TL.pack_host(np.empty(0, dtype="S1"), len(ql))
    assert (TL.translate_lanes(_t(empty), _t(ql)) == -1).all()


@pytest.mark.parametrize("width", WIDTHS)
def test_lane_hash_matches_reference(width):
    rng = np.random.default_rng(7 * width)
    d = _rand_dict(rng, 120, width)
    lanes = TL.pack_host(d, TL.lanes_for_width(d.dtype.itemsize))
    got = t_lane_hash(_t(lanes))
    _same(got, np.asarray(j_lane_hash(_j(lanes))).astype(np.int64))
    assert t_lane_hash(_t(TL.pack_host(np.empty(0, "S1"), 2))).shape == (0,)


@pytest.mark.parametrize("sorted_", [True, False])
def test_lane_columns_from_reference_arrays(sorted_):
    """The same lane column fed to both packages (unsorted: a duplicated,
    shuffled concatenation as the streamed tier makes it): equal
    checksums, rows, find results, and one deferred sort in the port."""
    rng = np.random.default_rng(11)
    d = _rand_dict(rng, 90, 14)
    entries = d if sorted_ else np.concatenate([d[40:], d[:60]])
    lanes = TL.pack_host(entries, 4)
    codes = rng.integers(-1, entries.size, 400).astype(np.int32)
    TB.lane_sorts.clear()
    tt = TB.from_reference_arrays({"k": ("lanes", lanes, codes, sorted_)}, "cpu")
    jc = JString(None, jnp.asarray(codes), dev_dictionary=_j(lanes), dev_dict_sorted=sorted_)
    from csvplus_tpu.columnar.table import DeviceTable as JTable

    jt = JTable({"k": jc}, 400, None)
    for positional in (False, True):
        assert t_checksum(tt, positional=positional) == j_checksum(jt, positional=positional)
    assert TB.lane_sorts == []  # a checksum never sorts
    col = tt.columns["k"]
    for v in [d[5].decode(), d[70].decode(), "absent", "x" * 40]:
        assert col.find_code(v) == jc.find_code(v)
    assert TB.lane_sorts == ([] if sorted_ else [entries.size])
    assert tt.to_rows() == jt.to_rows()


@pytest.fixture
def lane_env(monkeypatch, tmp_path):
    """A streamed high-cardinality orders file (order_id unique per row),
    small chunks, and the lane threshold as given."""
    monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")
    monkeypatch.setenv("CSVPLUS_STREAM_CHUNK_BYTES", "1024")
    monkeypatch.setenv("CSVPLUS_INGEST_WORKERS", "2")
    p = tmp_path / "orders.csv"
    p.write_text("order_id,cust,qty\n" + "".join(
        f"ord-{i:06d},c{i % 9},{i % 5}\n" for i in range(400)))

    def setup(threshold):
        monkeypatch.setenv("CSVPLUS_DICT_DEVICE_MIN_DISTINCT", str(threshold))
        return str(p)

    return setup


THRESHOLDS = [1, 100]


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_lane_column_stays_in_lanes(lane_env, threshold):
    path = lane_env(threshold)
    tt = T.from_file(path).on_device("cpu").plan.table
    jt = J.from_file(path).on_device("cpu").plan.table
    for name in ("order_id", "cust", "qty"):
        tc, jc = tt.columns[name], jt.columns[name]
        assert tc.kind == jc.kind
        assert (tc.dev_dictionary is None) == (jc.dev_dictionary is None)
    col = tt.columns["order_id"]
    assert col.dev_dictionary is not None and col._dictionary is None
    assert not col._dev_dict_sorted and col.dict_size == jt.columns["order_id"].dict_size
    for t_lane, j_lane in zip(col.dev_dictionary, jt.columns["order_id"].dev_dictionary):
        _same(t_lane, j_lane)
    _same(col.codes, jt.columns["order_id"].codes)


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_payload_lane_column_never_sorts(lane_env, tmp_path, threshold):
    """Checksums and a join keyed on another column carry the lane column
    as payload: its union is never sorted, and the checksums equal the
    reference's (on-device lane hashes, no download)."""
    path = lane_env(threshold)
    (tmp_path / "q.csv").write_text("qty,label\n" + "".join(f"{i},l{i}\n" for i in range(5)))
    TB.lane_sorts.clear()
    src = T.from_file(path).on_device("cpu")
    col = src.plan.table.columns["order_id"]
    jsrc = J.from_file(path).on_device("cpu")
    assert t_checksum(src.plan.table, positional=True) == j_checksum(
        jsrc.plan.table, positional=True)
    t_idx = T.from_file(str(tmp_path / "q.csv")).on_device("cpu").unique_index_on("qty")
    j_idx = J.from_file(str(tmp_path / "q.csv")).on_device("cpu").unique_index_on("qty")
    t_join = src.join(t_idx, "qty").to_device_table()
    j_join = jsrc.join(j_idx, "qty").to_device_table()
    assert t_checksum(t_join, positional=True) == j_checksum(j_join, positional=True)
    assert TB.lane_sorts == [] and not col._dev_dict_sorted
    assert t_join.columns["order_id"]._dictionary is None


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_lane_filter_and_find(lane_env, threshold):
    path = lane_env(threshold)
    TB.lane_sorts.clear()
    for value in ("ord-000123", "ord-000399", "zzz", "ord-0001234"):
        got = T.from_file(path).on_device("cpu").filter(T.Like({"order_id": value})).to_rows()
        want = J.from_file(path).on_device("cpu").filter(J.Like({"order_id": value})).to_rows()
        assert got == want and len(got) == (1 if value in ("ord-000123", "ord-000399") else 0)
    t_idx = T.from_file(path).on_device("cpu").unique_index_on("order_id")
    j_idx = J.from_file(path).on_device("cpu").unique_index_on("order_id")
    assert len(t_idx) == len(j_idx) == 400
    for value in ("ord-000007", "ord-000399", "nope"):
        assert t_idx.find(value).to_rows() == j_idx.find(value).to_rows()
    # one sort per ingested lane column that was keyed or searched
    assert 1 <= len(TB.lane_sorts) <= 5


def _notes(tmp_path, wide=False):
    p = tmp_path / "notes.csv"
    p.write_text("order_id,note\n" + "".join(f"ord-{i:06d},n{i}\n" for i in range(0, 420, 7))
                 + (f"{'W' * 48},wide1\n{'X' * 33},wide2\n" if wide else ""))
    return str(p)


@pytest.mark.parametrize("side", ["build", "probe", "both"])
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_lane_joins_match_reference(lane_env, tmp_path, monkeypatch, threshold, side):
    """A join keyed on order_id with the lane dictionary on the build
    side, on the probe side, or on both (a second streamed lane file)."""
    path = lane_env(threshold)
    notes = _notes(tmp_path, wide=side == "build")

    def run(pkg):
        if side == "build":
            idx = pkg.from_file(path).on_device("cpu").unique_index_on("order_id")
            return pkg.from_file(notes).on_device("cpu").join(idx, "order_id")
        if side == "probe":
            monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", str(1 << 30))
            idx = pkg.from_file(notes).on_device("cpu").unique_index_on("order_id")
            monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")
            return pkg.from_file(path).on_device("cpu").join(idx, "order_id")
        idx = pkg.from_file(path).on_device("cpu").unique_index_on("order_id")
        return pkg.from_file(path).on_device("cpu").join(idx, "order_id")

    t_src, j_src = run(T), run(J)
    t_table, j_table = t_src.to_device_table(), j_src.to_device_table()
    assert t_table.nrows == j_table.nrows > 0
    assert t_checksum(t_table, positional=True) == j_checksum(j_table, positional=True)
    assert t_src.to_rows() == j_src.to_rows()
