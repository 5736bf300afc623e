"""The single-pass multiway join, the fused probe over a selection and
the anti-join mask of the port (``csvplus_tpu_torch/ops/join.py``) held
bitwise against the JAX package's on the CPU.

Both packages ingest the same seeded CSV files, so the key columns come
out as dictionary codes, typed affix-int32 value lanes or device-lane
dictionaries alike in both.  Each shape reaches one expansion path —
unique-identity, unique-partial (stream keys missing from a build side)
and fan-out (non-unique build sides holding 0-4 rows per key) — and each
result must equal the reference's (row count, column order, positional
checksums of every column) and the port's own cascade of ``join_tables``.
Then: an empty stream, a zero selection and absent key cells (error
type and row number)."""

import numpy as np
import pytest
import torch

import csvplus_tpu as J
import csvplus_tpu.ops.join as JJ
import csvplus_tpu_torch as T
import csvplus_tpu_torch.ops.join as TJ
from csvplus_tpu.obs.joinskew import joinskew as j_skew
from csvplus_tpu.utils.checksum import checksum_device_table as j_checksum
from csvplus_tpu_torch.obs.joinskew import joinskew as t_skew
from csvplus_tpu_torch.utils.checksum import checksum_device_table as t_checksum

N = 500
KINDS = {
    # env for the orders file: dictionary codes, typed value lanes, or
    # device-lane dictionaries on the streamed tier
    "codes": {"CSVPLUS_TYPED_LANES": "0"},
    "typed": {},
    "lanes": {"CSVPLUS_TYPED_LANES": "0", "CSVPLUS_STREAM_MIN_BYTES": "1",
              "CSVPLUS_STREAM_CHUNK_BYTES": "2048", "CSVPLUS_DICT_DEVICE_MIN_DISTINCT": "1"},
}
SHAPES = {
    # (stream customer ids drawn from, rows per build key)
    "unique-identity": (50, "one"),
    "unique-partial": (60, "one"),
    "fan-out": (50, "0-4"),
}


@pytest.fixture(autouse=True)
def _fresh_sketches():
    j_skew.reset()
    t_skew.reset()
    yield
    j_skew.reset()
    t_skew.reset()


def _write(path, header, rows):
    path.write_text(header + "\n" + "".join(",".join(r) + "\n" for r in rows))
    return str(path)


def _files(tmp_path, seed, cust_from, per_key):
    rng = np.random.default_rng(seed)
    cust = rng.integers(0, cust_from, N)
    prod = rng.integers(0, 10, N)
    orders = _write(tmp_path / "orders.csv", "order_id,cust_id,prod_id,qty", [
        (f"o{i}", f"c{c}", f"p{p}", str(q))
        for i, (c, p, q) in enumerate(zip(cust, prod, rng.integers(1, 9, N)))
    ])
    reps = (np.ones(50, int) if per_key == "one" else rng.integers(0, 5, 50))
    preps = (np.ones(10, int) if per_key == "one" else rng.integers(0, 5, 10))
    cust_csv = _write(tmp_path / "cust.csv", "id,name", [
        (f"c{k}", f"n{k}-{j}") for k in rng.permutation(50) for j in range(reps[k])
    ])
    prod_csv = _write(tmp_path / "prod.csv", "prod_id,product,qty", [
        (f"p{k}", f"x{k}-{j}", str(j)) for k in range(10) for j in range(preps[k])
    ])
    return orders, cust_csv, prod_csv


def _load(pkg, files, kind, monkeypatch):
    """(orders table, [(DeviceIndex, key columns), ...]) in *pkg*."""
    orders, cust_csv, prod_csv = files
    with monkeypatch.context() as m:
        for k, v in KINDS[kind].items():
            m.setenv(k, v)
        stream = pkg.from_file(orders).on_device("cpu").plan.table
    cust = pkg.from_file(cust_csv).on_device("cpu").index_on("id")
    prod = pkg.from_file(prod_csv).on_device("cpu").index_on("prod_id")
    return stream, [(cust.device_table, ("cust_id",)), (prod.device_table, ("prod_id",))]


def _same(t_table, j_table):
    assert t_table.nrows == j_table.nrows
    assert list(t_table.columns) == list(j_table.columns)
    assert t_checksum(t_table, positional=True) == j_checksum(j_table, positional=True)


def _cascade(stream, specs):
    for dev_index, cols in specs:
        stream = TJ.join_tables(stream, dev_index, list(cols))
    return stream


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_multiway_join_matches_reference_and_cascade(tmp_path, monkeypatch, kind, shape):
    files = _files(tmp_path, 7, *SHAPES[shape])
    t_stream, t_specs = _load(T, files, kind, monkeypatch)
    j_stream, j_specs = _load(J, files, kind, monkeypatch)
    if kind == "lanes":
        assert t_stream.columns["cust_id"].dev_dictionary is not None
    if kind == "typed":
        assert t_stream.columns["cust_id"].kind == "int"
    TJ.expand_paths.clear()
    got = TJ.multiway_join(t_stream, t_specs)
    assert TJ.expand_paths == {f"multiway-{shape}": 1}
    _same(got, JJ.multiway_join(j_stream, j_specs))
    cascade = _cascade(t_stream, t_specs)
    assert list(got.columns) == list(cascade.columns)
    assert t_checksum(got, positional=True) == t_checksum(cascade, positional=True)
    assert got.to_rows()[:5] == cascade.to_rows()[:5]
    # the multiway counters of both packages saw the same run
    assert t_skew.counters_snapshot() == j_skew.counters_snapshot()


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("identity", [False, True], ids=["sel", "identity"])
def test_multiway_join_selected_matches_reference(tmp_path, monkeypatch, kind, shape, identity):
    """The fused probe over a selection (every third row, or the whole
    range) equals the reference's and the port's ``multiway_join`` of the
    gathered stream."""
    files = _files(tmp_path, 11, *SHAPES[shape])
    t_stream, t_specs = _load(T, files, kind, monkeypatch)
    j_stream, j_specs = _load(J, files, kind, monkeypatch)
    sel = np.arange(N) if identity else np.arange(0, N, 3)
    t_sel = torch.from_numpy(sel.astype(np.int64))
    got = TJ.multiway_join_selected(t_stream.columns, t_sel, t_stream.device, t_specs,
                                    identity=identity)
    import jax.numpy as jnp

    want = JJ.multiway_join_selected(j_stream.columns, jnp.asarray(sel.astype(np.int32)),
                                     j_stream.device, j_specs, identity=identity)
    _same(got, want)
    staged = TJ.multiway_join(t_stream.gather(t_sel), t_specs)
    assert t_checksum(got, positional=True) == t_checksum(staged, positional=True)
    # one build side: the fused probe equals the binary join
    one = TJ.multiway_join_selected(t_stream.columns, t_sel, t_stream.device, t_specs[:1],
                                    identity=identity)
    binary = TJ.join_tables(t_stream.gather(t_sel), *t_specs[0])
    assert t_checksum(one, positional=True) == t_checksum(binary, positional=True)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_except_mask_matches_reference(tmp_path, monkeypatch, kind):
    files = _files(tmp_path, 3, 60, "one")
    t_stream, t_specs = _load(T, files, kind, monkeypatch)
    j_stream, j_specs = _load(J, files, kind, monkeypatch)
    for (ti, cols), (ji, _) in zip(t_specs, j_specs):
        got = TJ.except_mask(t_stream, ti, list(cols))
        want = np.asarray(JJ.except_mask(j_stream, ji, list(cols)))
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), want)
    assert 0 < int(TJ.except_mask(t_stream, *t_specs[0]).sum()) < N


def test_empty_stream_folds_like_the_cascade(tmp_path, monkeypatch):
    files = _files(tmp_path, 5, 50, "0-4")
    t_stream, t_specs = _load(T, files, "typed", monkeypatch)
    j_stream, j_specs = _load(J, files, "typed", monkeypatch)
    t_empty = t_stream.gather(torch.zeros(0, dtype=torch.int64))
    import jax.numpy as jnp

    j_empty = j_stream.gather(jnp.zeros(0, dtype=jnp.int32))
    got = TJ.multiway_join(t_empty, t_specs)
    _same(got, JJ.multiway_join(j_empty, j_specs))
    cascade = _cascade(t_empty, t_specs)
    assert got.nrows == 0 and list(got.columns) == list(cascade.columns)
    assert [c.kind for c in got.columns.values()] == [c.kind for c in cascade.columns.values()]
    assert TJ.except_mask(t_empty, *t_specs[0]).shape == (0,)


def _absent_key_stream(pkg):
    rows = [pkg.Row({"cust_id": f"c{i % 50}", "prod_id": f"p{i % 10}", "v": str(i)})
            for i in range(40)]
    del rows[17]["prod_id"]
    return pkg.take_rows(rows).on_device("cpu").plan.table


def test_absent_key_cells_raise_the_cascade_error(tmp_path, monkeypatch):
    files = _files(tmp_path, 5, 50, "one")
    _, t_specs = _load(T, files, "codes", monkeypatch)
    _, j_specs = _load(J, files, "codes", monkeypatch)

    def err(fn):
        with pytest.raises(Exception) as ei:
            fn()
        return type(ei.value).__name__, str(ei.value)

    t_err = err(lambda: TJ.multiway_join(_absent_key_stream(T), t_specs))
    j_err = err(lambda: JJ.multiway_join(_absent_key_stream(J), j_specs))
    assert t_err == j_err and "17" in t_err[1]
    assert err(lambda: _cascade(_absent_key_stream(T), t_specs)) == t_err
    assert err(lambda: TJ.except_mask(_absent_key_stream(T), t_specs[1][0], ["prod_id"])) == \
        err(lambda: JJ.except_mask(_absent_key_stream(J), j_specs[1][0], ["prod_id"]))


def test_multiway_stats_and_expand_match_reference():
    """The fan-out statistics and the mixed-radix expansion on seeded
    counts of 0-4 per build side, against the reference's jitted kernels
    (their pow2-padded outputs sliced to the total)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    counts = [rng.integers(0, 5, 300).astype(np.int32) for _ in range(3)]
    lowers = [rng.integers(0, 50, 300).astype(np.int32) for _ in range(3)]
    t_counts = [torch.from_numpy(c) for c in counts]
    total, maxp, inter = TJ._multiway_stats(t_counts)
    want = [int(v) for v in np.asarray(JJ._multiway_stats(tuple(jnp.asarray(c) for c in counts)))]
    assert [total, maxp, inter] == want
    probe, builds = TJ._multiway_expand([torch.from_numpy(lo) for lo in lowers], t_counts, total)
    padded = 1 << max(total - 1, 0).bit_length()
    jp, jb = JJ._multiway_expand_kernel(tuple(jnp.asarray(lo) for lo in lowers),
                                        tuple(jnp.asarray(c) for c in counts), padded)
    assert np.array_equal(probe.numpy(), np.asarray(jp)[:total])
    for got, exp in zip(builds, jb):
        assert np.array_equal(got.numpy(), np.asarray(exp)[:total])
