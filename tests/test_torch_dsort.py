"""The port's distributed sample sort (``csvplus_tpu_torch/parallel/
dsort.py``) held bitwise against the JAX package's on the CPU: the port
on an 8-shard mesh of CPU devices, the reference on its 8 virtual CPU
devices, the same seeded inputs.  Sorted values, the payload permutation
and the counted host syncs (one an attempt) must be equal, and the
permutation must be numpy's stable argsort."""

import numpy as np
import pytest
import torch

from csvplus_tpu.parallel.dsort import distributed_sort as j_sort
from csvplus_tpu.parallel.dsort import distributed_sort_device as j_sort_device
from csvplus_tpu.parallel.mesh import make_mesh as j_make_mesh
from csvplus_tpu.parallel.mesh import make_mesh_2d as j_make_mesh_2d
from csvplus_tpu.parallel.mesh import shard_rows as j_shard_rows
from csvplus_tpu.utils.observe import telemetry as j_tel
from csvplus_tpu_torch.parallel import mesh as TM
from csvplus_tpu_torch.parallel.dsort import distributed_sort as t_sort
from csvplus_tpu_torch.parallel.dsort import distributed_sort_device as t_sort_device
from csvplus_tpu_torch.utils.observe import telemetry as t_tel

CPU8 = ["cpu"] * 8
I32_MAX = np.iinfo(np.int32).max


@pytest.fixture(scope="module")
def meshes():
    return {"1d": (j_make_mesh(8), TM.make_mesh(8, devices=CPU8)),
            "2d": (j_make_mesh_2d(2, 4), TM.make_mesh_2d(2, 4, devices=CPU8))}


def _case(name):
    """(values, payload, capacity, mesh kind)."""
    rng = np.random.default_rng({"random": 11, "skewed": 12, "payload": 13, "tiny": 0,
                                 "int32-max": 0, "wide": 17, "2d": 24, "2d-skewed": 24,
                                 "ragged": 19}[name])
    if name == "random":
        return rng.integers(0, 10_000, 4096).astype(np.int32), None, None, "1d"
    if name == "skewed":  # 60 % one value: the balanced estimate overflows
        x = rng.integers(0, 1000, 2048).astype(np.int32)
        x[: int(0.6 * x.size)] = 77
        rng.shuffle(x)
        return x, None, None, "1d"
    if name == "payload":
        return (rng.integers(0, 50, 1000).astype(np.int32),
                np.arange(1000, 2000, dtype=np.int32), None, "1d")
    if name == "tiny":
        return np.array([5, 3, 9], dtype=np.int32), None, None, "1d"
    if name == "int32-max":
        return np.array([5, I32_MAX, 3, I32_MAX], dtype=np.int32), None, None, "1d"
    if name == "wide":
        return rng.integers(1 << 32, 1 << 45, size=3000).astype(np.int64), None, None, "1d"
    if name == "ragged":  # negatives, INT32_MAX and a length the mesh does not divide
        x = rng.integers(-(2**31), 2**31 - 1, 3001, dtype=np.int64).astype(np.int32)
        x[::50] = I32_MAX
        return x, None, None, "1d"
    x = rng.integers(0, 5000, size=4096).astype(np.int32)
    if name == "2d-skewed":
        x[rng.random(4096) < 0.6] = 777
        return x, None, 16, "2d"
    return x, None, None, "2d"


CASES = ["random", "skewed", "payload", "tiny", "int32-max", "wide", "ragged", "2d", "2d-skewed"]


@pytest.mark.parametrize("name", CASES)
def test_distributed_sort_equals_reference(meshes, name):
    x, payload, cap, kind = _case(name)
    jm, tm = meshes[kind]
    with j_tel.collect():
        w_vals, w_perm = j_sort(jm, x, payload, capacity=cap)
        w_syncs = j_tel.host_sync_elements
    with t_tel.collect():
        g_vals, g_perm = t_sort(tm, x, payload, capacity=cap)
        g_syncs = t_tel.host_sync_elements
    assert g_vals.dtype == x.dtype and g_perm.dtype == np.int32
    assert np.array_equal(g_vals, np.asarray(w_vals))
    assert np.array_equal(g_perm, np.asarray(w_perm))
    assert g_syncs == w_syncs
    order = np.argsort(x, kind="stable")
    assert np.array_equal(g_vals, x[order])
    want_perm = order.astype(np.int32) if payload is None else payload[order]
    assert np.array_equal(g_perm, want_perm)
    if name in ("skewed", "2d-skewed"):
        assert g_syncs >= 2  # the capacity retry fired


def test_distributed_sort_empty(meshes):
    _, tm = meshes["1d"]
    vals, perm = t_sort(tm, np.array([], dtype=np.int32))
    assert vals.size == 0 and perm.size == 0


@pytest.mark.parametrize("values, payload", [
    (np.array([1 << 62, 1], dtype=np.int64), None),
    (np.array([-5, 1], dtype=np.int64), None),
    (np.array([1.5, 2.0]), None),
    (np.array([3, 1], dtype=np.int32), np.array([0, 1], dtype=np.int64)),
])
def test_distributed_sort_refuses_what_the_reference_refuses(meshes, values, payload):
    jm, tm = meshes["1d"]
    with pytest.raises(TypeError):
        j_sort(jm, values, payload)
    with pytest.raises(TypeError):
        t_sort(tm, values, payload)


def test_distributed_sort_device_returns_sharded_rows(meshes):
    """The device entry keeps everything on the mesh and returns dense
    ShardedRows of the input length, equal to the reference's arrays."""
    jm, tm = meshes["1d"]
    rng = np.random.default_rng(41)
    x = rng.integers(0, 300, 1000).astype(np.int32)
    pay = np.arange(1000, dtype=np.int32)
    (w_vals,), w_pay = j_sort_device(jm, (j_shard_rows(jm, x),), j_shard_rows(jm, pay))
    (g_vals,), g_pay = t_sort_device(tm, (TM.shard_rows(tm, x),), torch.from_numpy(pay))
    assert isinstance(g_vals, TM.ShardedRows) and g_vals.nrows == 1000
    assert [int(s.shape[0]) for s in g_vals.shards] == [125] * 8
    assert np.array_equal(g_vals.numpy(), np.asarray(w_vals))
    assert np.array_equal(g_pay.numpy(), np.asarray(w_pay))
