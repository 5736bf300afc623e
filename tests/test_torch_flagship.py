"""The port's flagship (``csvplus_tpu_torch/models/flagship.py``), its
canned workloads (``models/workloads.py``) and the graft entry
(``graft.py``) held bitwise against the JAX package's on the CPU.

* The four flagship functions on seeded inputs with -1 and out-of-range
  keys and ids.
* ``ThreewayJoin.run`` on the corpus, all-matched and with unmatched
  stream keys, through the dictionary-direct route and the search route,
  over tables fed to both packages through ``from_reference_arrays``.
* ``example_step_args``, BASELINE configs 1-4 through ``workloads``.
* ``graft.dryrun_multichip(8, devices=["cpu"] * 8)``, whose path 3c host
  syncs equal the reference's; ``entry``, ``make_mesh(2)`` and
  ``dryrun_multichip(2)`` raise where no card is present."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import csvplus_tpu as J
import csvplus_tpu.ops.join as JJ
import csvplus_tpu_torch as T
import csvplus_tpu_torch.ops.join as TJ
from csvplus_tpu.columnar.exec import execute_plan as j_execute
from csvplus_tpu.columnar.table import DeviceTable as JTable
from csvplus_tpu.models import flagship as JF
from csvplus_tpu.models import workloads as JW
from csvplus_tpu.parallel.mesh import make_mesh as j_make_mesh
from csvplus_tpu.parallel.pjoin import partitioned_probe as j_partitioned_probe
from csvplus_tpu.utils.checksum import checksum_device_table as j_checksum
from csvplus_tpu.utils.observe import telemetry as j_tel
from csvplus_tpu_torch import graft
from csvplus_tpu_torch.columnar.table import from_reference_arrays
from csvplus_tpu_torch.models import flagship as TF
from csvplus_tpu_torch.models import workloads as TW
from csvplus_tpu_torch.parallel.mesh import make_mesh
from csvplus_tpu_torch.utils.checksum import checksum_device_table as t_checksum


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# -- the four functions --------------------------------------------------------


@pytest.fixture(scope="module")
def step_inputs():
    rng = np.random.default_rng(101)
    cust_keys = np.sort(rng.choice(300, 120, replace=False)).astype(np.int32)
    prod_keys = np.sort(rng.choice(40, 15, replace=False)).astype(np.int32)
    qk_c = rng.integers(-2, 320, 5000).astype(np.int32)
    qk_p = rng.integers(-1, 45, 5000).astype(np.int32)
    qk_c[::13] = -1
    return cust_keys, prod_keys, qk_c, qk_p


def test_threeway_step_equals_reference(step_inputs):
    args = step_inputs
    want = JF.threeway_step(*(jnp.asarray(a) for a in args))
    got = TF.threeway_step(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        _same(g, w)


def test_gather_columns_equals_reference_with_out_of_range_ids():
    rng = np.random.default_rng(103)
    codes = [rng.integers(-1, 50, 64).astype(np.int32), rng.integers(0, 9, 64).astype(np.int32)]
    ids = rng.integers(-80, 80, 3000).astype(np.int32)  # negative and past the end
    valid = rng.random(3000) < 0.7
    want = JF.gather_columns(jnp.asarray(ids), jnp.asarray(valid), *map(jnp.asarray, codes))
    got = TF.gather_columns(torch.from_numpy(ids), torch.from_numpy(valid),
                            *map(torch.from_numpy, codes))
    for g, w in zip(got, want):
        _same(g, w)


def _cum(keys: np.ndarray, bits: int) -> np.ndarray:
    return np.searchsorted(keys, np.arange((1 << bits) + 1)).astype(np.int32)


def test_fused_direct_functions_equal_reference():
    rng = np.random.default_rng(107)
    kc = np.sort(rng.choice(1 << 9, 200, replace=False)).astype(np.int32)
    kp = np.sort(rng.choice(1 << 6, 30, replace=False)).astype(np.int32)
    cum_c, cum_p = _cum(kc, 9), _cum(kp, 6)
    qc = rng.integers(-3, (1 << 9) + 20, 4000).astype(np.int32)  # -1s and past the universe
    qp = rng.integers(-3, (1 << 6) + 5, 4000).astype(np.int32)
    codes_c = (rng.integers(0, 99, 200).astype(np.int32), rng.integers(-1, 7, 200).astype(np.int32))
    codes_p = (rng.integers(0, 5, 30).astype(np.int32),)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    t = torch.from_numpy
    want = JF._fused_unique_join(j(cum_c), j(cum_p), j(qc), j(qp), tuple(map(j, codes_c)),
                                 tuple(map(j, codes_p)))
    got = TF._fused_unique_join(t(cum_c), t(cum_p), t(qc), t(qp), tuple(map(t, codes_c)),
                                tuple(map(t, codes_p)))
    assert int(got[0]) == int(want[0])
    for g, w in zip(got[1:4], want[1:4]):
        _same(g, w)
    for gs, ws in zip(got[4:], want[4:]):
        for g, w in zip(gs, ws):
            _same(g, w)
    want = JF._fused_direct_probe(j(cum_c), j(cum_p), j(qc), j(qp))
    got = TF._fused_direct_probe(t(cum_c), t(cum_p), t(qc), t(qp))
    for g, w in zip(got, want):
        _same(g, w)


def test_example_step_args_equal_reference():
    for g, w in zip(TF.example_step_args(device="cpu"), JF.example_step_args()):
        _same(g, w)
    for g, w in zip(TF.threeway_step(*TF.example_step_args(device="cpu")),
                    JF.threeway_step(*JF.example_step_args())):
        _same(g, w)


# -- ThreewayJoin over the corpus ----------------------------------------------


def _carry(jt):
    """The JAX table's columns as numpy, into the port."""
    cols = {}
    for name, c in jt.columns.items():
        if c.kind == "int":
            cols[name] = ("int", c.prefix, np.asarray(c.values))
        else:
            cols[name] = (c.dictionary, c.codes_host())
    return from_reference_arrays(cols, "cpu")


def _port_index(j_index):
    di = j_index.device_table
    return TJ.DeviceIndex.build(_carry(di.table), di.key_columns)


def _dims(corpus):
    cust = J.from_file(corpus["people_csv"]).on_device("cpu") \
        .select_columns("id", "name", "surname").unique_index_on("id")
    prod = J.from_file(corpus["stock_csv"]).on_device("cpu") \
        .select_columns("prod_id", "product", "price").unique_index_on("prod_id")
    return cust, prod


@pytest.fixture(params=["direct", "search"])
def route(request, monkeypatch):
    """The dictionary-direct route, or the search route (no ``direct_cum``:
    ``step`` + ``gather_columns``), in both packages."""
    if request.param == "search":
        monkeypatch.setattr(JJ.DeviceIndex, "DIRECT_MAX_BITS", 0)
        monkeypatch.setattr(TJ.DeviceIndex, "DIRECT_MAX_BITS", 0)
    return request.param


def _run_both(j_orders, cust, prod, route):
    j_tw = JF.ThreewayJoin.build(j_orders, cust.device_table, prod.device_table)
    t_tw = TF.ThreewayJoin.build(_carry(j_orders), _port_index(cust), _port_index(prod))
    assert (t_tw.cust.direct_cum is None) == (route == "search")
    for g, w in zip(t_tw.step(), j_tw.step()):
        _same(g, w)
    want, got = j_tw.run(), t_tw.run()
    assert got.nrows == want.nrows and list(got.columns) == list(want.columns)
    assert t_checksum(got, positional=True) == j_checksum(want, positional=True)
    assert got.to_rows() == want.to_rows()
    return got


def test_threeway_join_all_matched_equals_reference(corpus, route):
    cust, prod = _dims(corpus)
    j_orders = j_execute(J.from_file(corpus["orders_csv"]).on_device("cpu")
                         .select_columns("cust_id", "prod_id", "qty", "ts").plan)
    got = _run_both(j_orders, cust, prod, route)
    host = (J.take(J.from_file(corpus["orders_csv"]).select_columns("cust_id", "prod_id", "qty",
                                                                       "ts"))
            .join(J.take(J.from_file(corpus["people_csv"]).select_columns("id", "name", "surname"))
                  .unique_index_on("id"), "cust_id")
            .join(J.take(J.from_file(corpus["stock_csv"])
                         .select_columns("prod_id", "product", "price")).unique_index_on("prod_id"))
            .to_rows())
    assert got.nrows == j_orders.nrows and got.to_rows() == host


def test_threeway_join_partial_matches_equals_reference(corpus, route):
    rows = [
        J.Row({"cust_id": "5", "prod_id": "1", "qty": "2"}),
        J.Row({"cust_id": "99999", "prod_id": "1", "qty": "3"}),  # no customer
        J.Row({"cust_id": "7", "prod_id": "777", "qty": "4"}),  # no product
        J.Row({"cust_id": "8", "prod_id": "0", "qty": "5"}),
        J.Row({"cust_id": "-1", "prod_id": "2", "qty": "6"}),  # no customer
    ]
    cust, prod = _dims(corpus)
    got = _run_both(JTable.from_rows(rows, device="cpu"), cust, prod, route)
    assert got.nrows == 2


# -- workloads -------------------------------------------------------------------


def test_workload_configs_1_to_4_equal_reference(corpus, tmp_path):
    def run(pkg, W, tag):
        out = {}
        people = pkg.from_file(corpus["people_csv"]).on_device("cpu")
        W.filter_map(people, {"name": "Amelia"}, "name", "Julia") \
            .to_csv_file(str(tmp_path / f"{tag}.csv"), "name", "surname")
        out["1"] = (tmp_path / f"{tag}.csv").read_bytes()
        idx, found = W.index_build(people, "id", [("5",), ("119",), ("nope",)])
        out["2"] = (len(idx), found)
        cust = pkg.from_file(corpus["people_csv"]).on_device("cpu").unique_index_on("id")
        prod = pkg.from_file(corpus["stock_csv"]).on_device("cpu").unique_index_on("prod_id")
        out["3"] = W.threeway(pkg.from_file(corpus["orders_csv"]).on_device("cpu"), cust,
                              prod).to_rows()
        out["4"] = pkg.take(W.dedup(people, "name")).to_rows()
        return out

    want, got = run(J, JW, "ref"), run(T, TW, "port")
    assert got == want
    assert len(got["4"]) == 10 and got["2"][0] == 120


# -- graft -------------------------------------------------------------------------


def test_dryrun_multichip_on_a_cpu_mesh_equals_reference_syncs():
    res = graft.dryrun_multichip(8, devices=["cpu"] * 8)
    assert [p.split()[0] for p in res["paths"]] == ["1", "2", "3", "3b", "3c", "4", "5"]
    # the reference's path 3c inputs through its own probe
    jm = j_make_mesh(8)
    rng = np.random.default_rng(7)
    for low, high, size in ((-2, 45, 128), (-1, 10, 128), (0, 50, 400), (-3, 60, 128),
                            (0, 300, 1024)):  # the draws paths 1-3b make before 3c
        rng.integers(low, high, size=size)
    keys = np.arange(0, 800, dtype=np.int32)
    with j_tel.collect():
        j_partitioned_probe(jm, (np.arange(512, dtype=np.int32) % 64), keys, capacity=8)
        retry = j_tel.host_sync_elements
    hot_q = rng.integers(0, 800, size=8192).astype(np.int32)
    hot_q[rng.random(8192) < 0.3] = np.int32(17)
    with j_tel.collect():
        j_partitioned_probe(jm, hot_q, keys)
        hot = j_tel.host_sync_elements
    assert (res["retry_syncs"], res["hot_syncs"]) == (retry, hot)


def test_entry_on_the_cpu_and_refusals_without_a_card():
    step, args = graft.entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    _, _, valid = step(*args)
    assert int(valid.sum()) == int(np.asarray(JF.threeway_step(*JF.example_step_args())[2]).sum())
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        graft.entry()
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="devices="):
        graft.dryrun_multichip(2)
