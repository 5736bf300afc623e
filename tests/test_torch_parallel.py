"""The port's partitioned probe (``csvplus_tpu_torch/parallel/pjoin.py``)
and its mesh held bitwise against the JAX package's on the CPU: the port
on an 8-shard mesh of CPU devices (``devices=["cpu"] * 8``), the
reference on the 8 virtual CPU devices ``tests/conftest.py`` sets up,
the same seeded inputs through both.

Covered: ``partition_build_keys``; ``partitioned_probe`` on uniform,
heavy-build-key, forced-retry (capacity 8), single-heavy-key,
empty-index, wide and 2-D (2, 4) inputs, with every answer, the stage
rows and their extras, the counted host syncs and the ``joinskew``
counters equal; the hot-key short circuit in one attempt; the
device-resident probes and ``broadcast_probe``; ``_detect_hot`` (hot set,
share) and ``_skew_capacity``; ``_searchsorted2`` on both sides; the env
registry; the mesh's collectives."""

import numpy as np
import pytest
import torch

import jax

import csvplus_tpu.ops.join as JJ
import csvplus_tpu.parallel.pjoin as JP
import csvplus_tpu_torch.ops.join as TJ
import csvplus_tpu_torch.parallel.pjoin as TP
from csvplus_tpu.obs.joinskew import joinskew as j_skew
from csvplus_tpu.parallel.mesh import make_mesh as j_make_mesh
from csvplus_tpu.parallel.mesh import make_mesh_2d as j_make_mesh_2d
from csvplus_tpu.parallel.mesh import replicate as j_replicate
from csvplus_tpu.parallel.mesh import shard_rows as j_shard_rows
from csvplus_tpu.utils.observe import telemetry as j_tel
from csvplus_tpu_torch.obs.joinskew import JoinSkewStats, joinskew as t_skew
from csvplus_tpu_torch.parallel import mesh as TM
from csvplus_tpu_torch.utils.observe import telemetry as t_tel

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def meshes():
    return j_make_mesh(8), TM.make_mesh(8, devices=CPU8)


@pytest.fixture(scope="module")
def meshes2d():
    return j_make_mesh_2d(2, 4), TM.make_mesh_2d(2, 4, devices=CPU8)


@pytest.fixture(autouse=True)
def _fresh_skew():
    j_skew.reset()
    t_skew.reset()
    yield
    j_skew.reset()
    t_skew.reset()


def _records(tel):
    return [(r.stage, r.rows_in, r.rows_out, dict(r.extra)) for r in tel.merged_stages()]


def _both(meshes, fn):
    """fn(package module, mesh) under telemetry in both packages: {side:
    (result, stage rows, host-sync elements)}."""
    out = {}
    for side, mod, tel, mesh in (("ref", JP, j_tel, meshes[0]), ("port", TP, t_tel, meshes[1])):
        with tel.collect():
            res = fn(mod, mesh)
            out[side] = (res, _records(tel), tel.host_sync_elements)
    return out


def _oracle(keys, queries):
    lo = np.searchsorted(keys, queries, side="left")
    ct = np.searchsorted(keys, queries, side="right") - lo
    ct[queries < 0] = 0
    return lo, ct


# -- partition_build_keys ----------------------------------------------------


def _build_inputs(case):
    rng = np.random.default_rng(1)
    if case == "int32":
        return np.sort(rng.integers(0, 100, 1000).astype(np.int32))
    if case == "int64":
        return np.sort(rng.integers(1 << 32, 1 << 40, 700).astype(np.int64))
    if case == "empty":
        return np.empty(0, np.int32)
    heavy = np.full(5000, 77, dtype=np.int32)  # one key owning half the rows
    return np.sort(np.concatenate([heavy, rng.integers(0, 1000, 5000).astype(np.int32)]))


@pytest.mark.parametrize("case", ["int32", "int64", "empty", "heavy"])
def test_partition_build_keys_equals_reference(case):
    keys = _build_inputs(case)
    want = JP.partition_build_keys(keys, 8)
    got = TP.partition_build_keys(keys, 8)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# -- partitioned_probe ---------------------------------------------------------


def _probe_case(case):
    """(stream keys, sorted index keys, capacity, mesh kind)."""
    rng = np.random.default_rng({"uniform": 2, "heavy-build": 7, "retry": 3, "single-heavy": 3,
                                 "empty-index": 4, "wide": 9, "2d": 5}[case])
    if case in ("uniform", "2d"):
        keys = np.sort(rng.integers(0, 5000, size=20_000).astype(np.int32))
        q = rng.integers(-10, 6000, size=30_001).astype(np.int32)
        q[q < 0] = -1
        return q, keys, None
    if case == "heavy-build":
        keys = np.sort(np.concatenate([np.full(10_000, 1234, np.int32),
                                       rng.integers(0, 3000, 10_000).astype(np.int32)]))
        q = rng.integers(-5, 3500, size=20_001).astype(np.int32)
        q[q < 0] = -1
        return q, keys, None
    if case == "retry":
        # every source shard routes all its probes into shard 0's range
        return (np.arange(512, dtype=np.int32) % 64), np.arange(800, dtype=np.int32), 8
    if case == "single-heavy":
        keys = np.sort(rng.integers(0, 1000, size=8_000).astype(np.int32))
        return np.full(4_000, keys[50], dtype=np.int32), keys, None
    if case == "empty-index":
        return np.arange(100, dtype=np.int32), np.empty(0, np.int32), None
    keys = np.sort(rng.integers(1 << 32, 1 << 40, size=20_000).astype(np.int64))
    q = rng.choice(np.concatenate([keys, rng.integers(1 << 32, 1 << 40, size=5000)]),
                   size=30_001).astype(np.int64)
    q[::97] = -1
    return q, keys, None


PROBE_CASES = ["uniform", "heavy-build", "retry", "single-heavy", "empty-index", "wide", "2d"]


@pytest.mark.parametrize("case", PROBE_CASES)
def test_partitioned_probe_equals_reference(meshes, meshes2d, case):
    """Answers, stage rows with their extras, counted host syncs and the
    joinskew counters, each equal to the reference's; answers equal
    numpy's searchsorted."""
    q, keys, cap = _probe_case(case)
    out = _both(meshes2d if case == "2d" else meshes,
                lambda mod, mesh: mod.partitioned_probe(mesh, q, keys, capacity=cap))
    (w_lo, w_ct), w_rows, w_syncs = out["ref"]
    (g_lo, g_ct), g_rows, g_syncs = out["port"]
    assert g_lo.dtype == np.int32 and g_ct.dtype == np.int32
    assert np.array_equal(g_lo, np.asarray(w_lo)) and np.array_equal(g_ct, np.asarray(w_ct))
    assert g_rows == w_rows and g_syncs == w_syncs
    assert t_skew.counters_snapshot() == j_skew.counters_snapshot()
    olo, oct_ = _oracle(keys, q)
    assert (g_ct == oct_).all() and (g_lo[g_ct > 0] == olo[g_ct > 0]).all()
    if case == "retry":
        retries = [r[3]["retries"] for r in g_rows if r[0] == "join:all_to_all"]
        assert retries == [3] and g_syncs == 512 + 4


def test_hot_key_skew_rows_and_counters_equal_reference(meshes, monkeypatch):
    """A 30 %-heavy probe key at threshold 0.01: the hot tier engages, the
    ``join:skew`` row carries hot keys, rows broadcast and repartitioned,
    capacity and threshold, and the labelled counters match."""
    monkeypatch.setenv("CSVPLUS_JOIN_SKEW_THRESHOLD", "0.01")
    rng = np.random.default_rng(23)
    keys = np.sort(rng.integers(0, 2000, size=8000).astype(np.int32))
    q = rng.integers(0, 2000, size=8192).astype(np.int32)
    q[rng.random(8192) < 0.3] = keys[4000]

    def run(mod, mesh):
        prepared = mod.prepare_partitioned(mesh, keys)
        qd = (j_shard_rows(mesh, q) if mod is JP else TM.shard_rows(mesh, q))
        lo, ct = mod.partitioned_probe_device(mesh, qd, prepared, label="k")
        return np.asarray(lo.numpy() if mod is TP else lo), np.asarray(
            ct.numpy() if mod is TP else ct)

    out = _both(meshes, run)
    assert all(np.array_equal(g, w) for g, w in zip(out["port"][0], out["ref"][0]))
    assert out["port"][1] == out["ref"][1] and out["port"][2] == out["ref"][2]
    stages = [r[0] for r in out["port"][1]]
    assert stages == ["join:partition", "join:skew-detect", "join:broadcast", "join:all_to_all",
                      "join:skew"]
    skew = out["port"][1][-1][3]
    assert skew["hot_keys"] >= 1 and skew["rows_broadcast"] > 0
    snap = t_skew.counters_snapshot()
    assert snap == j_skew.counters_snapshot() and snap["k"]["joins"] == 1


@pytest.mark.parametrize("entry", ["partitioned_probe", "partitioned_probe_device"])
def test_hot_key_short_circuit_one_attempt(meshes, monkeypatch, entry):
    """Heavy probe keys are answered by the hot tier: the hot values take
    one exchange of their own and the main exchange runs once."""
    calls = {"hot": 0, "main": 0}
    hot, main = TP._probe_spmd, TP._probe_spmd_dev

    def count_hot(*a, **k):
        calls["hot"] += 1
        return hot(*a, **k)

    def count_main(*a, **k):
        calls["main"] += 1
        return main(*a, **k)

    monkeypatch.setattr(TP, "_probe_spmd", count_hot)
    monkeypatch.setattr(TP, "_probe_spmd_dev", count_main)
    rng = np.random.default_rng(9)
    keys = np.sort(rng.integers(0, 2000, size=16_000).astype(np.int32))
    cold = rng.integers(-5, 2500, size=6_000).astype(np.int32)
    cold[cold < 0] = -1
    q = np.concatenate([np.full(10_000, keys[777], np.int32), cold])
    rng.shuffle(q)
    mesh = meshes[1]
    if entry == "partitioned_probe":
        lo, ct = TP.partitioned_probe(mesh, q, keys)
    else:
        prepared = TP.prepare_partitioned(mesh, keys)
        lo, ct = TP.partitioned_probe_device(mesh, TM.shard_rows(mesh, q), prepared)
        lo, ct = lo.numpy(), ct.numpy()
    olo, oct_ = _oracle(keys, q)
    assert (ct == oct_).all() and (lo[ct > 0] == olo[ct > 0]).all()
    assert calls == {"hot": 1, "main": 1}


@pytest.mark.parametrize("layout", ["sharded", "one-tensor"])
def test_partitioned_probe_device_equals_reference(meshes, layout):
    """Narrow and wide device probes: answers come back as ShardedRows of
    the probe length and equal the reference's, for an evenly sharded
    probe and for one tensor of a length the mesh does not divide."""
    jm, tm = meshes
    rng = np.random.default_rng(23)
    keys = np.sort(rng.integers(0, 5000, size=20_000).astype(np.int32))
    q = rng.integers(-10, 6000, size=30_001).astype(np.int32)
    q[q < 0] = -1
    if layout == "sharded":
        q = q[:30_000]
    wkeys = np.sort(rng.integers(1 << 32, 1 << 40, size=3000).astype(np.int64))
    wq = wkeys[rng.integers(0, 3000, size=q.size)].copy()
    wq[::7] = -1
    wh, wl = TP.split_lanes(wq)

    def tput(a):
        return TM.shard_rows(tm, a) if layout == "sharded" else torch.from_numpy(a)

    def jput(a):
        return j_shard_rows(jm, a) if layout == "sharded" else jax.device_put(a)

    t_lo, t_ct = TP.partitioned_probe_device(tm, tput(q), TP.prepare_partitioned(tm, keys))
    j_lo, j_ct = JP.partitioned_probe_device(jm, jput(q), JP.prepare_partitioned(jm, keys))
    assert isinstance(t_lo, TM.ShardedRows) and t_lo.nrows == q.size
    assert np.array_equal(t_lo.numpy(), np.asarray(j_lo))
    assert np.array_equal(t_ct.numpy(), np.asarray(j_ct))
    t_lo, t_ct = TP.partitioned_probe_device_wide(tm, tput(wh), tput(wl),
                                                  TP.prepare_partitioned(tm, wkeys))
    j_lo, j_ct = JP.partitioned_probe_device_wide(jm, jput(wh), jput(wl),
                                                  JP.prepare_partitioned(jm, wkeys))
    assert np.array_equal(t_lo.numpy(), np.asarray(j_lo))
    assert np.array_equal(t_ct.numpy(), np.asarray(j_ct))
    olo, oct_ = _oracle(wkeys, wq)
    assert (t_ct.numpy() == oct_).all()


def test_broadcast_probe_equals_reference(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(4)
    keys = np.sort(rng.integers(0, 500, size=2_000).astype(np.int32))
    q = rng.integers(-3, 700, size=8_000).astype(np.int32)
    j_lo, j_ct = JP.broadcast_probe(j_replicate(jm, keys), j_shard_rows(jm, q))
    t_lo, t_ct = TP.broadcast_probe(TM.replicate(tm, keys), TM.shard_rows(tm, q))
    assert np.array_equal(t_lo.numpy(), np.asarray(j_lo))
    assert np.array_equal(t_ct.numpy(), np.asarray(j_ct))
    one_lo, one_ct = TP.broadcast_probe(torch.from_numpy(keys), torch.from_numpy(q))
    assert np.array_equal(one_ct.numpy(), np.asarray(j_ct))


# -- the skew tier's pieces -------------------------------------------------------


@pytest.mark.parametrize("case", ["hot-30", "threshold-0.8", "disabled", "never-match", "wide",
                                  "zipf"])
def test_detect_hot_equals_reference(meshes, monkeypatch, case):
    """The hot set and its share equal the reference's."""
    jm, tm = meshes
    rng = np.random.default_rng(59)
    m = 64_000
    qk = rng.integers(0, 10_000, size=m).astype(np.int32)
    qk[: int(m * 0.3)] = 777
    rng.shuffle(qk)
    if case == "threshold-0.8":
        monkeypatch.setenv("CSVPLUS_JOIN_SKEW_THRESHOLD", "0.8")
    elif case == "disabled":
        monkeypatch.setenv("CSVPLUS_JOIN_SKEW", "0")
    elif case == "never-match":
        qk = np.full(m, -1, np.int32)
    elif case == "zipf":
        monkeypatch.setenv("CSVPLUS_JOIN_SKEW_THRESHOLD", "0.002")
        qk = ((rng.zipf(1.1, size=m) - 1) % 50_000).astype(np.int32)
    if case == "wide":
        wide = qk.astype(np.int64) << 33
        hi, lo = TP.split_lanes(wide)
        want = JP._detect_hot((j_shard_rows(jm, hi), j_shard_rows(jm, lo)), 8, wide=True)
        got = TP._detect_hot((TM.shard_rows(tm, hi), torch.from_numpy(lo)), 8, wide=True)
    else:
        want = JP._detect_hot(j_shard_rows(jm, qk), 8, wide=False)
        got = TP._detect_hot(TM.shard_rows(tm, qk), 8, wide=False)
    if want[0] is None:
        assert got == (None, 0.0)
    else:
        assert got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])
        assert got[1] == want[1]
    if case == "hot-30":
        assert 777 in got[0].tolist() and 0.2 < got[1] < 0.45


def test_skew_capacity_equals_reference():
    for m in (0, 1, 100, 10_000, 10_000_000, 100_000_000):
        for n in (1, 2, 8):
            assert TP._default_capacity(m, n) == JP._default_capacity(m, n)
            for share in (0.0, 0.1, 0.5, 0.97, 1.0, 2.0):
                assert TP._skew_capacity(m, n, share) == JP._skew_capacity(m, n, share)
    full = TP._default_capacity(10_000_000, 8)
    assert 64 <= TP._skew_capacity(10_000_000, 8, 0.0) <= full
    assert TP._skew_capacity(10_000_000, 8, 0.5) <= full // 2
    assert TP._skew_capacity(10_000_000, 8, 1.0) == 64


def test_joinskew_on_join_folds_like_reference():
    st = JoinSkewStats(sketch_k=8)
    st.on_join("a", 2, 100, 900)
    st.on_join("a", 1, 50, 950)
    st.on_join("b", 0, 0, 10)
    st.on_multiway("b", 2, 10, 10, 0)
    assert st.counters_snapshot() == {
        "a": {"joins": 2, "hot_keys_detected": 3, "rows_broadcast": 150,
              "rows_repartitioned": 1850},
        "b": {"joins": 1, "hot_keys_detected": 0, "rows_broadcast": 0,
              "rows_repartitioned": 10, "multiway_joins": 1, "multiway_dims": 2,
              "multiway_rows_in": 10, "multiway_rows_out": 10,
              "multiway_intermediate_rows_avoided": 0},
    }


def test_metrics_plane_exports_the_join_counters():
    from csvplus_tpu_torch.obs.metrics import TelemetryPlane

    t_skew.on_join("k", 1, 30, 70)
    text = TelemetryPlane().registry.render()
    assert 'csvplus_join_hot_keys_detected_total{index="k"} 1' in text
    assert 'csvplus_join_rows_broadcast_total{index="k"} 30' in text
    assert 'csvplus_join_rows_repartitioned_total{index="k"} 70' in text


# -- small repairs -------------------------------------------------------------------


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted2_equals_reference(side):
    rng = np.random.default_rng(31)
    keys = np.sort(rng.integers(0, 1 << 40, size=3000).astype(np.int64))
    keys[100:140] = keys[100]  # a run of equal keys
    keys = np.sort(keys)
    q = np.concatenate([keys[rng.integers(0, 3000, 500)], rng.integers(0, 1 << 40, 500)])
    kh, kl = TP.split_lanes(keys)
    qh, ql = TP.split_lanes(q)
    want = np.asarray(JJ._searchsorted2(kh, kl, qh, ql, side=side))
    got = TJ._searchsorted2(*(torch.from_numpy(a) for a in (kh, kl, qh, ql)), side=side)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, np.searchsorted(keys, q, side=side))


def test_env_registry_matches_reference_for_every_knob_the_port_reads():
    import pathlib
    import re

    from csvplus_tpu.utils.env import ENV_REGISTRY as J_REG
    from csvplus_tpu_torch.utils.env import ENV_REGISTRY as T_REG

    root = pathlib.Path(TP.__file__).resolve().parent.parent
    read = set()
    for path in root.rglob("*.py"):
        read |= set(re.findall(r"CSVPLUS_[A-Z0-9_]+", path.read_text()))
    assert read == set(T_REG)
    for name, var in T_REG.items():
        ref = J_REG[name]
        assert (var.kind, var.default, var.description) == (ref.kind, ref.default, ref.description)
    for name in ("CSVPLUS_JOIN_SKEW", "CSVPLUS_JOIN_SKEW_THRESHOLD", "CSVPLUS_JOIN_SKEW_SAMPLE"):
        assert T_REG[name].default == J_REG[name].default


# -- the mesh ------------------------------------------------------------------------


def test_mesh_layout_and_collectives():
    mesh = TM.make_mesh_2d(2, 4, devices=CPU8)
    assert mesh.shape == (2, 4) and mesh.axis_names == (TM.SLICE_AXIS, TM.AXIS)
    x = np.arange(16, dtype=np.int32)
    rows = TM.shard_rows(mesh, x)
    assert [s.tolist() for s in rows.shards] == [[2 * i, 2 * i + 1] for i in range(8)]
    with pytest.raises(ValueError, match="split evenly"):
        TM.shard_rows(mesh, np.arange(9))
    rep = TM.replicate(mesh, x)
    assert len({id(t) for t in rep}) == 1  # one copy per distinct device
    # tiled all_to_all: shard d receives block d of every source, in order
    blocks = [torch.arange(8 * 3, dtype=torch.int32).view(8, 3) + 100 * s for s in range(8)]
    recv = TM.all_to_all(mesh, blocks)
    pairs = TM._all_to_all_pairs(mesh, blocks)  # the several-device route, here on one
    for d in range(8):
        assert torch.equal(recv[d], torch.stack([blocks[s][d] for s in range(8)]))
        assert torch.equal(pairs[d], recv[d])
    gathered = TM.all_gather(mesh, [torch.tensor([i]) for i in range(8)])
    assert gathered[3].tolist() == list(range(8))
    parts = [torch.tensor(i) for i in range(8)]
    within = TM.psum(mesh, parts, TM.AXIS)
    assert [int(t) for t in within] == [6] * 4 + [22] * 4
    across = TM.psum(mesh, parts, TM.SLICE_AXIS)
    assert [int(t) for t in across] == [4, 6, 8, 10] * 2


def test_mesh_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="devices="):
        TM.make_mesh(2)
    with pytest.raises(RuntimeError, match="devices="):
        TM.make_mesh()
    with pytest.raises(RuntimeError, match="devices="):
        TM.make_mesh_2d(2, 2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TM.make_mesh(2, devices=["cuda:0"] * 2)
