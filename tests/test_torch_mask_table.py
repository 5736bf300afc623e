"""The mask kernel's target table (``csvplus_tpu_torch/ops/mask.py``
``build_table``) and its device cache.

A small decoder here reads the table as ``csrc/mask.cu`` reads it and
applies each column's test (a register compare, a bitmap, a branchless
sorted search, staged or in global memory) with numpy.  It is held
bitwise against the plain PyTorch version and against the JAX package's
Pallas kernel in interpret mode on the CPU (as ``tests/test_pallas.py``
runs it), on seeded numpy inputs handed to all three."""

import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from csvplus_tpu.ops.pallas_mask import fused_equality_mask as jax_mask
from csvplus_tpu_torch.ops import mask as M

N = 3001  # not a multiple of the TPU kernel's 1024-row tile
I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _search(body: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The kernel's search: the last index whose target is <= v (0 when
    none is), then one equality test."""
    base = np.zeros(v.shape, dtype=np.int64)
    n = body.size
    while n > 1:
        half = n >> 1
        base = np.where(body[base + half] <= v, base + half, base)
        n -= half
    return body[base] == v


def decode_mask(table: np.ndarray, n_stage: int, cols, mode: str) -> np.ndarray:
    """The mask as the kernel computes it from *table*, in numpy."""
    assert table.dtype == np.int32 and M.HDR_WORDS <= n_stage <= min(table.size, M.SMEM_MAX_WORDS)
    acc = None
    for j, v in enumerate(cols):
        kind, off, count, value = (int(x) for x in table[4 * j : 4 * j + 4])
        glob = bool(kind & M.KIND_GLOBAL)
        kind &= 3
        if kind != M.KIND_ONE:  # a body lies wholly in the staged head or past it
            size = (count + 31) // 32 if kind == M.KIND_BITMAP else count
            assert off >= M.HDR_WORDS and off + size <= table.size
            assert (off >= n_stage) if glob else (off + size <= n_stage)
        if kind == M.KIND_ONE:
            hit = v == value
        elif kind == M.KIND_BITMAP:
            d = v.astype(np.uint32) - np.uint32(value & 0xFFFFFFFF)
            inside = d < np.uint32(count)
            words = table.view(np.uint32)[off : off + (count + 31) // 32]
            w = np.where(inside, words[np.where(inside, d >> 5, 0)], 0)
            hit = ((w >> (d & 31)) & 1).astype(bool)
        else:
            assert kind == M.KIND_SEARCH
            hit = _search(table[off : off + count], v)
        acc = hit if acc is None else (acc & hit if mode == "all" else acc | hit)
    return acc


def _kinds(table: np.ndarray, k: int):
    return [int(table[4 * j]) for j in range(k)]


def _all_three(cols, targets, mode, jax_ref=True):
    """The decoder, the plain version and (unless *jax_ref* is False) the
    Pallas kernel on the same inputs; returns the decoded mask."""
    n = cols[0].size
    table, n_stage = M.build_table(M.canonical_targets(targets))
    got = decode_mask(table, n_stage, cols, mode)
    tcols = [torch.from_numpy(c) for c in cols]
    plain = M.fused_equality_mask_plain(tcols, targets, mode).numpy()
    assert np.array_equal(got, plain)
    wrapper = M.fused_equality_mask(tcols, targets, n, mode).numpy()
    assert np.array_equal(wrapper, plain)
    if jax_ref:
        want = np.asarray(jax_mask([jnp.asarray(c) for c in cols], targets, n, mode=mode))
        assert np.array_equal(got, want)
    return got, table, n_stage


def _typed(rng, k, n=N):
    """Typed value lanes: int32 in [-1000, 1000) with ~1 % each of
    +(2^31 - 1), -(2^31 - 1) and INT32_MIN."""
    cols = []
    for _ in range(k):
        c = rng.integers(-1000, 1000, n).astype(np.int32)
        r = rng.random(n)
        c[r < 0.01] = I32_MAX
        c[(r >= 0.01) & (r < 0.02)] = -I32_MAX
        c[r > 0.99] = I32_MIN
        cols.append(c)
    return cols


def _codes(rng, k, n=N, hi=60):
    cols = []
    for _ in range(k):
        c = rng.integers(0, hi, n).astype(np.int32)
        c[rng.random(n) < 0.05] = -1
        cols.append(c)
    return cols


@pytest.mark.parametrize("mode", ["all", "any"])
@pytest.mark.parametrize("k", list(range(1, M.MAX_COLS + 1)))
def test_every_column_test_matches_the_pallas_kernel(k, mode):
    """k = 1..8 columns mixing the three tests: one target, a bitmap (a
    dictionary-code IN-list), a sorted search (typed values spread over
    int32), with duplicated, unsorted lists and -1 absent cells."""
    rng = np.random.default_rng(100 * k + (mode == "any"))
    codes = _codes(rng, k)
    typed = _typed(rng, k)
    cols, targets = [], []
    for j in range(k):
        which = (j + k) % 3
        if which == 0:
            cols.append(codes[j])
            targets.append([int(rng.integers(0, 60))])
        elif which == 1:
            t = rng.integers(0, 60, 9).tolist()
            cols.append(codes[j])
            targets.append(t + t[:3])  # duplicated, unsorted
        else:
            t = [I32_MAX, -7, I32_MIN, -I32_MAX, 500, -7] + rng.integers(-1000, 1000, 5).tolist()
            cols.append(typed[j])
            targets.append(t)
        # every 11th row matches this column, so "all" keeps some rows too
        pick = np.asarray(targets[j], dtype=np.int32)
        cols[j][::11] = pick[rng.integers(0, pick.size, cols[j][::11].size)]
    got, table, _ = _all_three(cols, targets, mode)
    want_kinds = [(M.KIND_ONE, M.KIND_BITMAP, M.KIND_SEARCH)[(j + k) % 3] for j in range(k)]
    assert _kinds(table, k) == want_kinds
    assert 0 < got.sum() < N


def test_typed_extremes_and_absent_cells():
    """Targets at +-(2^31 - 1) and INT32_MIN, negative typed values, and a
    -1 target on a typed column (where -1 is a value, not an absent cell)."""
    rng = np.random.default_rng(3)
    cols = _typed(rng, 2)
    cols[0][:50], cols[1][:50] = -999, -1
    cols[0][50:60], cols[1][50:60] = I32_MIN, I32_MIN
    for targets, mode in [([[I32_MAX], [I32_MIN]], "any"),
                          ([[I32_MIN, I32_MAX], [-1, -I32_MAX]], "any"),
                          ([[-999, -1, -500], [-1]], "all"),
                          ([[I32_MIN], [I32_MIN, -1]], "all")]:
        got, _, _ = _all_three(cols, targets, mode)
        assert got.any()


@pytest.mark.parametrize("extra, kind", [(0, M.KIND_BITMAP), (1, M.KIND_SEARCH)])
def test_span_at_the_bitmap_limit_and_one_past_it(extra, kind):
    lo = -12_345
    span = M.BITMAP_MIN_BITS + extra
    rng = np.random.default_rng(4 + extra)
    t = [lo, lo + span - 1] + (lo + rng.integers(0, span, 20)).tolist()
    c = (lo - 3 + rng.integers(0, span + 6, N)).astype(np.int32)
    c[::7] = np.asarray(t, dtype=np.int32)[np.arange(c[::7].size) % len(t)]
    got, table, _ = _all_three([c], [t], "any")
    assert _kinds(table, 1) == [kind]
    assert int(table[2]) == (span if kind == M.KIND_BITMAP else len(set(t)))
    # the first and last bit of the span, and one past either end
    assert got[c == lo].all() and got[c == lo + span - 1].all()
    assert not got[(c == lo - 1) | (c == lo + span)].any()


def test_a_dense_long_list_is_a_bitmap():
    """12,300 targets over a span of 24,600 (phase 3's long IN-list): a
    769-word bitmap, where a linear scan took 12,300 compares a row."""
    targets = [list(range(0, 24_600, 2))]
    table, n_stage = M.build_table(M.canonical_targets(targets))
    assert _kinds(table, 1) == [M.KIND_BITMAP] and n_stage == M.HDR_WORDS + 769
    rng = np.random.default_rng(5)
    c = rng.integers(-10, 25_000, N).astype(np.int32)
    got = decode_mask(table, n_stage, [c], "any")
    assert np.array_equal(got, (c >= 0) & (c < 24_600) & (c % 2 == 0))


def test_a_list_longer_than_shared_memory_is_searched_in_global_memory():
    """~60,000 typed values spread across int32: more than the 227 KB a
    block can stage, so the search reads global memory.  Held against the
    plain version and numpy (the Pallas kernel unrolls one compare a
    target: too slow to trace at this length)."""
    rng = np.random.default_rng(6)
    t = rng.integers(I32_MIN, I32_MAX, 60_000, endpoint=True).tolist() + [I32_MIN, I32_MAX]
    c = rng.integers(I32_MIN, I32_MAX, 4001, endpoint=True).astype(np.int32)
    c[::3] = np.asarray(t, dtype=np.int32)[rng.integers(0, len(t), c[::3].size)]
    table, n_stage = M.build_table(M.canonical_targets([t]))
    assert table[0] == M.KIND_SEARCH | M.KIND_GLOBAL and n_stage == M.HDR_WORDS
    got = decode_mask(table, n_stage, [c], "any")
    assert np.array_equal(got, np.isin(c, t))
    plain = M.fused_equality_mask_plain([torch.from_numpy(c)], [t], "any").numpy()
    assert np.array_equal(got, plain) and got[::3].all()


def test_staging_fills_shared_memory_smallest_body_first(monkeypatch):
    """With the staging limit cut to 300 words, a 200-target search list
    stays staged and a 400-target one goes to global memory, whichever
    column holds it; both against the Pallas kernel."""
    monkeypatch.setattr(M, "SMEM_MAX_WORDS", 300)
    rng = np.random.default_rng(7)
    big = rng.integers(I32_MIN, I32_MAX, 400).tolist()
    small = rng.integers(I32_MIN, I32_MAX, 200).tolist()
    cols = [rng.integers(-5, 5, N).astype(np.int32) for _ in range(2)]
    cols[0][::5] = np.asarray(big[:100], dtype=np.int32)[np.arange(cols[0][::5].size) % 100]
    cols[1][::4] = np.asarray(small[:50], dtype=np.int32)[np.arange(cols[1][::4].size) % 50]
    for mode in ("all", "any"):
        got, table, n_stage = _all_three(cols, [big, small], mode)
        assert _kinds(table, 2) == [M.KIND_SEARCH | M.KIND_GLOBAL, M.KIND_SEARCH]
        assert n_stage == M.HDR_WORDS + 200 and table[5] == M.HDR_WORDS
        assert table[1] == n_stage
    assert got.any()


def test_a_single_target_stages_nothing_but_the_header():
    table, n_stage = M.build_table(M.canonical_targets([[5], [-1], [I32_MIN]]))
    assert table.size == n_stage == M.HDR_WORDS
    assert table[:12].reshape(3, 4).tolist() == [[0, 0, 1, 5], [0, 0, 1, -1], [0, 0, 1, I32_MIN]]


def test_targets_outside_int32_raise():
    with pytest.raises(ValueError, match="int32"):
        M.build_table([(0, 2**31)])


# -- the device-table cache ---------------------------------------------------


@pytest.fixture
def fresh_cache():
    M.clear_table_cache()
    yield
    M.clear_table_cache()


def test_same_targets_give_the_same_cached_table(fresh_cache):
    """Unsorted, duplicated and canonical forms of one IN-list share one
    table; the form as given is filed too, so a repeat does not sort."""
    cpu = torch.device("cpu")
    a = M.device_table(((3, 1, 2, 1), (9,)), cpu)
    b = M.device_table(((1, 2, 3), (9, 9)), cpu)
    assert a is b and a.tensor.device == cpu
    assert M.device_table(((1, 2, 3), (9,)), cpu) is a
    assert set(M._tables) == {(cpu, ((3, 1, 2, 1), (9,))), (cpu, ((1, 2, 3), (9, 9))),
                              (cpu, ((1, 2, 3), (9,)))}
    table, n_stage = M.build_table(M.canonical_targets([[1, 2, 3], [9]]))
    assert np.array_equal(a.tensor.numpy(), table) and a.n_stage == n_stage


def test_other_targets_or_another_device_give_another_table(fresh_cache):
    cpu, meta = torch.device("cpu"), torch.device("meta")
    t = M.canonical_targets([[1, 2, 3]])
    a = M.device_table(t, cpu)
    assert M.device_table(M.canonical_targets([[1, 2, 4]]), cpu) is not a
    m = M.device_table(t, meta)
    assert m is not a and m.tensor.device == meta
    assert M.device_table(t, cpu) is a


def test_the_cache_is_a_bounded_lru(fresh_cache, monkeypatch):
    monkeypatch.setattr(M, "TABLE_CACHE_SIZE", 3)
    cpu = torch.device("cpu")
    first = M.device_table(((0,),), cpu)
    for v in (1, 2):
        M.device_table(((v,),), cpu)
    assert M.device_table(((0,),), cpu) is first  # a hit moves it to the end
    M.device_table(((3,),), cpu)  # evicts (1,)
    assert len(M._tables) == 3 and M.device_table(((0,),), cpu) is first
    assert (cpu, ((1,),)) not in M._tables


def test_eight_threads_get_one_table_and_equal_masks(fresh_cache):
    rng = np.random.default_rng(8)
    cols = [torch.from_numpy(c) for c in _codes(rng, 2)]
    targets = [rng.integers(0, 60, 12).tolist(), [int(rng.integers(0, 60))]]
    key = M.canonical_targets(targets)
    barrier = threading.Barrier(8)
    tables, masks, errs = [None] * 8, [None] * 8, []

    def work(i):
        try:
            barrier.wait(timeout=30)
            tables[i] = M.device_table(key, torch.device("cpu"))
            masks[i] = M.fused_equality_mask(cols, targets, N, mode="any")
        except BaseException as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errs and all(t is tables[0] for t in tables)
    assert all(torch.equal(m, masks[0]) for m in masks)
    want = decode_mask(tables[0].tensor.numpy(), tables[0].n_stage, [c.numpy() for c in cols],
                       "any")
    assert np.array_equal(masks[0].numpy(), want)


def test_the_cpu_path_never_touches_the_cache(fresh_cache, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the CPU path built a device table")

    monkeypatch.setattr(M, "device_table", boom)
    monkeypatch.setattr(M, "build_table", boom)
    a = torch.tensor([0, 1, 2, -1], dtype=torch.int32)
    got = M.fused_equality_mask([a, a], [[1, 2], [2]], 4, mode="any")
    assert got.tolist() == [False, True, True, False] and not M._tables
