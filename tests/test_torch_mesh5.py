"""BASELINE config 5 through the port's public path on a mesh of four
CPU shards: the orders ingested on one device, re-laid over the mesh by
``DataSource.reshard`` (the path ``on_device(shards=)`` takes for a
resident source), then ``filter(pred).join(customers, "cust_id")
.join(products)``.

The orders' customer keys are Zipf(1.1) over the customers
(``portbench/reference/mesh5.py``), and ``DeviceIndex.PARTITION_MIN_KEYS``
is lowered on the class so that, at this size as at 100M orders, the
customers join takes the range-partitioned all-to-all tier with its
hot-key broadcast and the products join the replicated tier.  Covered:
the result against the plain reference cell by cell (all-pass and
selective predicates) and against the same query on one device; the
hot-key tier; the re-lay itself (row for row, no host round trip, the
row numbering, views that hold no more than they use); and the counts of
bytes copied between cards (``peer_bytes``), which a mesh of one device
never copies, checked on their own.
"""

import numpy as np
import pytest
import torch

import csvplus_tpu_torch as T
from csvplus_tpu_torch.columnar.ingest import source_from_table
from csvplus_tpu_torch.columnar.table import DeviceTable, _own_blocks
from csvplus_tpu_torch.obs.joinskew import joinskew
from csvplus_tpu_torch.ops import join as TJ
from csvplus_tpu_torch.parallel import mesh as TM
from csvplus_tpu_torch.utils.observe import telemetry
from portbench import check
from portbench.reference import mesh5
from portbench.reference.predicate import evaluate
from portbench.units import draw_predicate, to_program

SHARDS = 4
TABLES = {"orders": {"rows": 12_000, "cust_zipf_s": 1.1}, "customers": {"rows": 1_500},
          "products": {"rows": 1_000}}
DOMAINS = {"prod_id": {"prefix": "p", "low": 0, "high": 1000},
           "qty": {"prefix": "", "low": 1, "high": 101}}
SPECS = {"all": {"not": {"like": ["prod_id", "qty"]}},
         "selective": {"any": [{"each": {"like": "prod_id", "count": 50}}, {"like": ["qty"]}]}}
# between the products' 1,000 keys and the customers' 1,500
MIN_KEYS = 1_200


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The generated tables, the resident orders, the sharded orders and
    both indexes, with the partitioned tier's threshold lowered."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TJ.DeviceIndex, "PARTITION_MIN_KEYS", MIN_KEYS)
        data = mesh5.generate(tmp_path_factory.mktemp("mesh5"), TABLES, 20160914)
        src = {t: T.from_file(str(p)).on_device("cpu") for t, p in data["paths"].items()}
        mesh = TM.make_mesh(SHARDS, devices=["cpu"] * SHARDS)
        yield {"data": data, "resident": src["orders"], "mesh": mesh,
               "sharded": src["orders"].reshard(mesh=mesh),
               "cust": src["customers"].unique_index_on("id"),
               "prod": src["products"].unique_index_on("prod_id")}


@pytest.fixture(autouse=True)
def _fresh_skew():
    joinskew.reset()
    yield
    joinskew.reset()


def _query(world, orders, pred):
    return (orders.filter(to_program(pred, T)).join(world["cust"], "cust_id")
            .join(world["prod"]).to_device_table())


def _against_reference(world, table, pred) -> dict:
    data = world["data"]
    keep = evaluate(pred, lambda c: mesh5.column_cells(data, "orders", c), data["n"])
    want = mesh5.expected_filter_join(data, keep)
    whole = DeviceTable({n: c.with_storage(TM.assemble(c.storage))
                         for n, c in table.columns.items()}, table.nrows, table.device)
    got, n = check.read_table(whole, want)
    return check.compare_columns(got, n, want)


def _pred(kind: str, seed: int) -> list:
    return draw_predicate(SPECS[kind], DOMAINS, np.random.default_rng(seed))


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("kind", ["all", "selective"])
def test_sharded_join_equals_the_reference(world, kind, seed):
    tiers = dict(TJ.probe_tiers)
    pred = _pred(kind, seed)
    table = _query(world, world["sharded"], pred)
    assert table.mesh is world["mesh"]
    assert _against_reference(world, table, pred) == {"rows_off": 0, "columns_off": 0,
                                                      "cells_off": 0}
    # the customers join took the all-to-all tier, the products join the
    # replicated one
    assert TJ.probe_tiers["partitioned"] == tiers.get("partitioned", 0) + 1
    assert TJ.probe_tiers["replicated-direct"] == tiers.get("replicated-direct", 0) + 1


def test_the_control_is_not_the_reference(world):
    """A result in hash-join order (rows grouped by customer) differs
    from the reference: the comparison sees stream order."""
    pred = _pred("all", 3)
    table = _query(world, world["sharded"], pred)
    order = np.argsort(TM.assemble(table.columns["cust_id"].storage).numpy(), kind="stable")
    shuffled = table.gather(torch.from_numpy(order))
    assert _against_reference(world, shuffled, pred)["cells_off"] > 0


def test_hot_key_tier_broadcasts(world):
    pred = _pred("all", 4)
    with telemetry.collect():
        _query(world, world["sharded"], pred)
        recs = list(telemetry.records)
    stages = [r.stage for r in recs]
    assert stages.count("join:all_to_all") == 1 and "join:broadcast" in stages
    skew = [r for r in recs if r.stage == "join:skew"]
    assert len(skew) == 1
    assert skew[0].extra["hot_keys"] >= 1 and skew[0].extra["rows_broadcast"] > 0
    assert skew[0].extra["rows_repartitioned"] > 0
    # the hottest customer's share: every row of it was broadcast
    keep = evaluate(pred, lambda c: mesh5.column_cells(world["data"], "orders", c),
                    world["data"]["n"])
    counts = np.bincount(world["data"]["cust"][keep])
    assert skew[0].extra["rows_broadcast"] >= counts.max()
    snap = joinskew.counters_snapshot()["id"]
    assert snap["hot_keys_detected"] >= 1 and snap["joins"] == 1


def test_sharded_equals_one_device(world):
    pred = _pred("all", 5)
    one = _query(world, world["resident"], pred)
    many = _query(world, world["sharded"], pred)
    assert one.mesh is None and many.mesh is world["mesh"]
    assert many.nrows == one.nrows
    assert many.to_rows() == one.to_rows()


@pytest.mark.parametrize("via", ["reshard", "on_device"])
def test_reshard_is_row_for_row_and_never_through_the_host(world, monkeypatch, via):
    resident = world["resident"]

    def no_rows(self):
        raise AssertionError("to_rows() called")

    monkeypatch.setattr(T.DataSource, "to_rows", no_rows)
    with telemetry.collect():
        if via == "reshard":
            got = resident.reshard("cpu", shards=SHARDS)
        else:
            got = resident.on_device("cpu", shards=SHARDS)
        recs = list(telemetry.records)
    assert [r.stage for r in recs] == ["shard:relayout"]
    assert recs[0].rows_in == world["data"]["n"]
    monkeypatch.undo()
    table, base = got.plan.table, resident.plan.table
    assert table.mesh.size == SHARDS and table.shard_lens() == [3000] * SHARDS
    assert {n: c.kind for n, c in table.columns.items()} == \
        {n: c.kind for n, c in base.columns.items()}
    assert table.to_rows() == base.to_rows()


def test_reshard_keeps_the_row_numbering_of_on_device(world):
    """Row numbers of errors downstream count from 0, as the rows path
    of ``on_device`` numbers them."""
    resident = world["resident"]
    mesh = world["mesh"]
    old = source_from_table(DeviceTable.from_rows(resident.to_rows(), "cpu").with_sharding(mesh))
    new = resident.reshard(mesh=mesh)
    assert new.plan.table.row_base == old.plan.table.row_base == 0
    errors = []
    for src in (old, new):
        with pytest.raises(Exception) as e:
            src.validate(T.Like({"qty": "1"}), "not qty 1").to_rows()
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "row " in errors[0]


def test_reshard_refuses_a_chain_and_a_missing_mesh(world):
    with pytest.raises(ValueError, match="device table as it stands"):
        world["resident"].filter(T.Like({"qty": "1"})).reshard(mesh=world["mesh"])
    with pytest.raises(ValueError, match="shards= or mesh="):
        world["resident"].reshard("cpu")


def test_blocks_keep_no_view_larger_than_they_use():
    """A block that alone views a column (block 0 of a table re-laid
    from one card over several) is copied into storage of its own; views
    that together cover more than half their storage stay views."""
    col = torch.arange(100, dtype=torch.int32)
    alone = [col[0:25], torch.arange(25, 50, dtype=torch.int32),
             torch.arange(50, 75, dtype=torch.int32), torch.arange(75, 100, dtype=torch.int32)]
    got = _own_blocks(alone)
    assert got[0].untyped_storage().nbytes() == 25 * 4
    assert got[0].data_ptr() != col.data_ptr() and torch.equal(got[0], col[0:25])
    assert all(a is b for a, b in zip(got[1:], alone[1:]))
    shared = [col[0:30], col[30:60], torch.arange(60, 100, dtype=torch.int32)]
    assert all(a is b for a, b in zip(_own_blocks(shared), shared))
    # the one-device mesh keeps its views: blocks 0-2 view the column
    t = DeviceTable.from_pylists({"a": [str(i) for i in range(10)]}, "cpu")
    st = t.with_sharding(TM.make_mesh(4, devices=["cpu"] * 4))
    assert st.columns["a"].storage.shards[0].data_ptr() == t.columns["a"].storage.data_ptr()


@pytest.mark.parametrize("a,b,peer", [
    ("cuda:0", "cuda:1", True), ("cuda:1", "cuda:0", True), ("cuda:0", "cuda:0", False),
    ("cpu", "cuda:0", False), ("cuda:2", "cpu", False), ("cpu", "cpu", False)])
def test_a_peer_copy_is_between_two_cards(a, b, peer):
    assert TM.is_peer(torch.device(a), torch.device(b)) is peer


def test_peer_bytes_land_on_the_innermost_live_stage(monkeypatch):
    monkeypatch.setattr(TM, "peer_copies", type(TM.peer_copies)())
    with telemetry.collect():
        with telemetry.stage("outer", 1):
            TM.note_peer(100)
            with telemetry.stage("inner", 1):
                TM.note_peer(7)
                TM.note_peer(5)
        TM.note_peer(1000)  # no stage open: the process count only
        recs = {r.stage: r.extra for r in telemetry.records}
    assert recs == {"inner": {"peer_bytes": 12}, "outer": {"peer_bytes": 100}}
    assert TM.peer_copies == {"count": 4, "bytes": 1112}
    # outside a collection nothing is recorded, and nothing raises
    with telemetry.stage("quiet", 1):
        TM.note_peer(3)
    assert TM.peer_copies["bytes"] == 1115


def test_a_one_device_mesh_copies_nothing_between_cards(world, monkeypatch):
    monkeypatch.setattr(TM, "peer_copies", type(TM.peer_copies)())
    with telemetry.collect():
        _query(world, world["sharded"], _pred("all", 6))
        recs = list(telemetry.records)
    assert not TM.peer_copies and not any("peer_bytes" in r.extra for r in recs)


def test_generated_keys_are_zipf_over_a_permutation(tmp_path):
    tables = {"orders": {"rows": 200_000, "cust_zipf_s": 1.1}, "customers": {"rows": 10_000},
              "products": {"rows": 1_000}}
    a = mesh5.generate(tmp_path, tables, 7)
    b = mesh5.generate(tmp_path, tables, 7)
    assert all(np.array_equal(a[k], b[k]) for k in ("cust", "prod", "qty"))
    counts = np.sort(np.bincount(a["cust"], minlength=10_000))[::-1]
    cdf = mesh5.zipf_cdf(10_000, 1.1)
    share = counts[:3] / counts.sum()
    assert np.allclose(share, [1 / cdf[-1], 2 ** -1.1 / cdf[-1], 3 ** -1.1 / cdf[-1]], rtol=0.05)
    # the hottest customer is not customer 0: ranks go through a permutation
    assert int(np.argmax(np.bincount(a["cust"]))) != 0
    assert a["prod"].min() >= 0 and a["prod"].max() < 1_000
    assert a["qty"].min() >= 1 and a["qty"].max() <= 100
    head = (tmp_path / "orders.csv").read_text().splitlines()[:2]
    assert head[0] == "order_id,cust_id,prod_id,qty"
    assert head[1] == f"o0,c{a['cust'][0]},p{a['prod'][0]},{a['qty'][0]}"
