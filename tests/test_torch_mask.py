"""The port's fused mask (``csvplus_tpu_torch/ops/mask.py``) against the
JAX package's Pallas kernel, run in interpret mode on the CPU as
``tests/test_pallas.py`` runs it.  Inputs are seeded numpy arrays handed
to both packages; the tolerance is bitwise equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from csvplus_tpu.ops.pallas_mask import fused_equality_mask as jax_mask
from csvplus_tpu_torch.ops import mask as M

N = 3001  # not a multiple of the TPU kernel's 1024-row tile


def _codes(rng, k, n=N, hi=20):
    """k int32 code columns in [0, hi) with about 5 % absent (-1) cells."""
    cols = []
    for _ in range(k):
        c = rng.integers(0, hi, n).astype(np.int32)
        c[rng.random(n) < 0.05] = -1
        cols.append(c)
    return cols


def _targets(rng, k, shape, hi=20):
    if shape == "one":
        return [int(rng.integers(0, hi)) for _ in range(k)]
    return [sorted(rng.choice(hi, size=int(rng.integers(2, 7)), replace=False).tolist())
            for _ in range(k)]


@pytest.mark.parametrize("shape", ["one", "inlist"])
@pytest.mark.parametrize("mode", ["all", "any"])
@pytest.mark.parametrize("k", list(range(1, M.MAX_COLS + 1)))
def test_mask_matches_pallas_kernel(k, mode, shape):
    rng = np.random.default_rng(1000 * k + (mode == "any") * 10 + (shape == "inlist"))
    cols = _codes(rng, k)
    targets = _targets(rng, k, shape)
    want = np.asarray(jax_mask([jnp.asarray(c) for c in cols], targets, N, mode=mode))
    tcols = [torch.from_numpy(c) for c in cols]
    got = M.fused_equality_mask(tcols, targets, N, mode=mode)
    plain = M.fused_equality_mask_plain(tcols, targets, mode=mode)
    assert got.dtype == torch.bool and got.shape == (N,)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(plain.numpy(), want)


def test_absent_cells_never_match():
    a = torch.tensor([0, -1, 2, -1], dtype=torch.int32)
    b = torch.tensor([5, 5, 5, 5], dtype=torch.int32)
    got = M.fused_equality_mask([a, b], [2, 5], 4, mode="all")
    assert got.tolist() == [False, False, True, False]
    want = jax_mask([jnp.asarray(a.numpy()), jnp.asarray(b.numpy())], [2, 5], 4)
    assert got.tolist() == np.asarray(want).tolist()


def test_cpu_wrapper_counts_no_launch():
    before = M.launches
    a = torch.zeros(10, dtype=torch.int32)
    M.fused_equality_mask([a, a], [0, 1], 10, mode="any")
    assert M.launches == before


@pytest.mark.parametrize(
    "cols, targets, nrows, mode, match",
    [
        ([], [], 4, "all", "1..8 columns"),
        ([torch.zeros(4, dtype=torch.int32)] * 9, [0] * 9, 4, "all", "1..8 columns"),
        ([torch.zeros(4, dtype=torch.int64)], [0], 4, "all", "int32"),
        ([torch.zeros(5, dtype=torch.int32)], [0], 4, "all", "int32"),
        ([torch.zeros(4, dtype=torch.int32)], [[]], 4, "any", "empty target"),
        ([torch.zeros(4, dtype=torch.int32)], [0], 4, "xor", "mode"),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(cols, targets, nrows, mode, match):
    with pytest.raises(ValueError, match=match):
        M.fused_equality_mask(cols, targets, nrows, mode=mode)


def test_wide_like_chunks_match_reference(people_csv):
    """A 9-column conjunction is wider than one kernel launch: the port
    ANDs two launches, the reference falls back to jnp; same mask."""
    from csvplus_tpu.ops.filter import build_mask as jax_build
    from csvplus_tpu.predicates import Like as JLike
    from csvplus_tpu_torch.ops.filter import build_mask as t_build
    from csvplus_tpu_torch.predicates import Like as TLike
    from csvplus_tpu.columnar.table import StringColumn as JCol
    from csvplus_tpu_torch.columnar.table import StringColumn as TCol

    rng = np.random.default_rng(7)
    n = 2000
    jcols, tcols, match = {}, {}, {}
    for j in range(9):
        vals = np.char.add("v", rng.integers(0, 2, n).astype(np.str_))
        jcols[f"c{j}"] = JCol.from_values(vals, None)
        tcols[f"c{j}"] = TCol.from_values(vals, torch.device("cpu"))
        match[f"c{j}"] = "v1"
    want = np.asarray(jax_build(jcols, n, JLike(match)))
    got = t_build(tcols, n, TLike(match), torch.device("cpu"))
    assert want.any() and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "spec",
    [
        [{"c0": "v1"}],  # one Like on one column
        [{"c0": "v1"}, {"c0": "v3"}, {"c0": "v4"}],  # one-column IN-list
        [{"c0": "v2"}, {"nope": "v1"}],  # the missing column drops out
    ],
)
def test_single_term_filters_go_through_the_kernel_wrapper(spec, monkeypatch):
    """A filter that collapses to one column still goes through the fused
    mask (k = 1), never through per-target tensor ops; same mask as the
    reference."""
    from csvplus_tpu.columnar.table import StringColumn as JCol
    from csvplus_tpu.ops.filter import build_mask as jax_build
    from csvplus_tpu.predicates import Any_ as JAny, Like as JLike
    from csvplus_tpu_torch.columnar.table import StringColumn as TCol
    from csvplus_tpu_torch.ops import filter as F
    from csvplus_tpu_torch.predicates import Any_ as TAny, Like as TLike

    calls = []

    def counted(cols, targets, nrows, mode="all"):
        calls.append((len(cols), mode))
        return M.fused_equality_mask(cols, targets, nrows, mode)

    monkeypatch.setattr(F, "fused_equality_mask", counted)
    rng = np.random.default_rng(11)
    n = 1500
    vals = np.char.add("v", rng.integers(0, 6, n).astype(np.str_))
    jcols = {"c0": JCol.from_values(vals, None)}
    tcols = {"c0": TCol.from_values(vals, torch.device("cpu"))}
    if len(spec) == 1:
        jpred, tpred, mode = JLike(spec[0]), TLike(spec[0]), "all"
    else:
        jpred = JAny(*[JLike(m) for m in spec])
        tpred = TAny(*[TLike(m) for m in spec])
        mode = "any"
    want = np.asarray(jax_build(jcols, n, jpred))
    got = F.build_mask(tcols, n, tpred, torch.device("cpu"))
    assert want.any() and np.array_equal(got.numpy(), want)
    assert calls == [(1, mode)]


def test_unaligned_view_matches_pallas_kernel():
    """A contiguous column that starts one element into its buffer (the
    layout that takes the CUDA kernel's row-at-a-time path)."""
    rng = np.random.default_rng(5)
    buf = _codes(rng, 1, n=N + 1)[0]
    col = torch.from_numpy(buf)[1:]
    assert col.is_contiguous() and col.storage_offset() == 1
    want = np.asarray(jax_mask([jnp.asarray(buf[1:])], [[3, 5, 8]], N, mode="any"))
    got = M.fused_equality_mask([col], [[3, 5, 8]], N, mode="any")
    assert np.array_equal(got.numpy(), want)
