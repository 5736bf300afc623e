"""Sharded tables behind the port's public API, held against the JAX
package's on the CPU: the port on an 8-shard mesh of CPU devices
(``on_device("cpu", shards=8)`` / ``devices=["cpu"] * 8``), the reference
on the 8 virtual CPU devices ``tests/conftest.py`` sets up, the same
inputs (the conftest corpus or seeded numpy) through both.

Covered: ``with_sharding`` and its padding; filter / select / top /
join / except / index builds / dedup / ``SetValue`` on sharded and padded
streams; the 2-D mesh; the executor's partitioned tier (narrow, wide,
randomized) with its stage rows, extras and host syncs; the skew tier
through the executor and the multiway join (one ``part_info``); the
flagship's padded branch; the dsort route (narrow and wide); checksums,
sinks and row-numbered errors across shards; the typed pads; config 5's
``sharded_join``; ``shard_row_counts`` on a repeated-device mesh; the
``shards=`` resolution rules; ``placement_of_column``; and the assembly
counter (zero on the sharded three-way join)."""

import io

import numpy as np
import pytest
import torch

import csvplus_tpu as J
import csvplus_tpu.ops.join as JJ
import csvplus_tpu.ops.sort as JS
import csvplus_tpu_torch as T
import csvplus_tpu_torch.ops.join as TJ
import csvplus_tpu_torch.ops.sort as TS
from csvplus_tpu.columnar.ingest import source_from_table as j_source
from csvplus_tpu.columnar.table import DeviceTable as JTable
from csvplus_tpu.models import workloads as JW
from csvplus_tpu.models.flagship import ThreewayJoin as JThreeway
from csvplus_tpu.obs.joinskew import joinskew as j_skew
from csvplus_tpu.parallel.mesh import make_mesh as j_make_mesh
from csvplus_tpu.parallel.mesh import make_mesh_2d as j_make_mesh_2d
from csvplus_tpu.utils.checksum import checksum_device_table as j_checksum
from csvplus_tpu.utils.observe import telemetry as j_tel
from csvplus_tpu_torch.columnar.ingest import source_from_table as t_source
from csvplus_tpu_torch.columnar.table import DeviceTable as TTable
from csvplus_tpu_torch.models import flagship as TF
from csvplus_tpu_torch.models import workloads as TW
from csvplus_tpu_torch.obs.joinskew import joinskew as t_skew
from csvplus_tpu_torch.parallel import mesh as TM
from csvplus_tpu_torch.utils.checksum import checksum_device_table as t_checksum
from csvplus_tpu_torch.utils.observe import telemetry as t_tel
from test_torch_telemetry import port_only_stages, reference_view

CPU8 = ["cpu"] * 8
PKGS = {"ref": J, "port": T}


@pytest.fixture(autouse=True)
def _fresh():
    """Fresh skew sketches in both packages, and the assembly tally."""
    j_skew.reset()
    t_skew.reset()
    TM.assemblies.clear()
    yield
    j_skew.reset()
    t_skew.reset()


def _mesh(side: str, n: int = 8):
    return j_make_mesh(n) if side == "ref" else TM.make_mesh(n, devices=["cpu"] * n)


def _dicts(rows):
    return [dict(r) for r in rows]


def _records(tel):
    """*tel*'s records as the reference records them (the port-only items
    left out; :func:`port_only_stages` checks them)."""
    return [(r.stage, r.rows_in, r.rows_out, dict(r.extra)) for r in reference_view(tel.records)]


def _port_only_translations() -> int:
    """The port-only items of the port's last collection checked: no
    port-only stage, and host counts on every translation; returns the
    number of translations."""
    assert port_only_stages(t_tel.records) == []
    return sum(r.stage == "join:translate" for r in t_tel.records)


def _port_extra_syncs(records, shards: int) -> int:
    """Host-sync elements the port counts beyond the reference's, which
    does not count its join statistics transfer: a sharded join's carries
    one total a shard and the max (shards + 1), multiway the avoided rows
    as well (shards + 2) -- the unsharded transfer's 2 and 3 at one
    shard."""
    return sum(shards + (2 if "dims" in r[3] else 1) for r in records if r[0] == "join:expand")


def _both(fn):
    return {side: fn(pkg, side) for side, pkg in PKGS.items()}


# -- tables, padding, layout ---------------------------------------------------------


@pytest.mark.parametrize("shards", [8, 7, 3])
def test_with_sharding_roundtrip_pads_invisibly(people_csv, shards):
    def run(pkg, side):
        table = pkg.from_file(people_csv).on_device("cpu").plan.table
        st = table.with_sharding(_mesh(side, shards))
        col = next(iter(st.columns.values()))
        return st.nrows, len(col.storage) % shards, _dicts(st.to_rows()), _dicts(table.to_rows())

    got = _both(run)
    assert got["port"] == got["ref"]
    n, rem, rows, base = got["port"]
    assert n == 120 and rem == 0 and rows == base


def test_shard_row_counts_keys_by_shard_index_on_a_repeated_device():
    t = TTable.from_pylists({"a": [str(i) for i in range(10)]}, "cpu")
    st = t.with_sharding(TM.make_mesh(4, devices=["cpu"] * 4))
    # the reference keys by str(device); four shards on one device would
    # collide there, so the port keys by shard index
    assert st.shard_row_counts() == {0: 3, 1: 3, 2: 3, 3: 3}
    assert st.shard_lens() == [3, 3, 3, 1] and st.stored_len == 12
    assert t.shard_row_counts() == {}
    # a block on its own device is a view of the column
    base = t.columns["a"].storage
    assert st.columns["a"].storage.shards[0].data_ptr() == base.data_ptr()


def test_placement_of_column_reports_sharded():
    from csvplus_tpu_torch.analysis.schema import placement_of_column

    t = TTable.from_pylists({"a": ["x", "y", "z"]}, "cpu")
    st = t.with_sharding(TM.make_mesh(2, devices=["cpu"] * 2))
    assert str(placement_of_column(st.columns["a"])) == "sharded(shards)"
    assert str(placement_of_column(t.columns["a"])) == "device"
    one = t.with_sharding(TM.make_mesh(1, devices=["cpu"]))
    assert str(placement_of_column(one.columns["a"])) == "device"


def test_shards_resolution_rules(people_csv):
    from csvplus_tpu_torch.columnar.ingest import resolve_mesh

    m = resolve_mesh("cpu", 4)
    assert m.size == 4 and m.devices == (torch.device("cpu"),) * 4
    explicit = TM.make_mesh(2, devices=["cpu"] * 2)
    assert resolve_mesh("cuda", 8, explicit) is explicit  # mesh= wins
    assert resolve_mesh("cpu", None) is None
    src = T.from_file(people_csv).on_device("cpu", shards=4)
    assert src.plan.table.mesh.size == 4
    src = T.from_file(people_csv).on_device(mesh=explicit)  # made on the mesh's device
    assert src.plan.table.mesh is explicit
    if torch.cuda.device_count() >= 2:
        pytest.skip("enough CUDA cards are present")
    with pytest.raises(RuntimeError, match="mesh="):
        T.from_file(people_csv).on_device("cuda", shards=2)
    with pytest.raises(RuntimeError, match="mesh="):
        T.take(T.from_file(people_csv)).on_device("cuda", shards=2)


# -- the executor over sharded streams ------------------------------------------------


def _cust(pkg, people_csv):
    return pkg.from_file(people_csv).select_columns("id", "name", "surname").on_device(
        "cpu").unique_index_on("id")


PIPELINES = {
    "filter": lambda pkg, src, idx: src.filter(pkg.Like({"name": "Amelia"})),
    "select-top": lambda pkg, src, idx: src.select_columns("id", "name").top(17),
    "drop-top": lambda pkg, src, idx: src.drop(5).top(30),
    "take-while": lambda pkg, src, idx: src.take_while(pkg.Not(pkg.Like({"name": "Jack"}))),
    "drop-while": lambda pkg, src, idx: src.drop_while(pkg.Not(pkg.Like({"name": "Jack"}))),
    "setvalue-filter": lambda pkg, src, idx: src.map(pkg.SetValue("flag", "1")).filter(
        pkg.All(pkg.Like({"name": "Amelia"}), pkg.Like({"flag": "1"}))),
    "rename": lambda pkg, src, idx: src.map(pkg.Rename({"name": "surname"})),
    "join": lambda pkg, src, idx: src.select_columns("cust_id", "qty").join(idx, "cust_id"),
    "filter-join": lambda pkg, src, idx: src.filter(pkg.Not(pkg.Like({"qty": "3"}))).join(
        idx, "cust_id"),
    "except": lambda pkg, src, idx: src.select_columns("cust_id", "qty").except_(idx, "cust_id"),
    "validate": lambda pkg, src, idx: src.validate(pkg.Not(pkg.Like({"qty": "7"})), "bad qty"),
}


def _run(src):
    try:
        return "rows", _dicts(src.to_rows())
    except Exception as e:  # both packages must fail the same way
        return "error", f"{type(e).__name__}: {e}"


@pytest.mark.parametrize("shards", [8, 7])
@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_sharded_pipeline_equals_reference(people_csv, orders_csv, name, shards):
    fn = PIPELINES[name]

    def run(pkg, side):
        idx = _cust(pkg, people_csv)
        f = orders_csv if name in ("join", "filter-join", "except", "validate") else people_csv
        host = _run(fn(pkg, pkg.take(pkg.from_file(f)), idx))
        dev = _run(fn(pkg, pkg.from_file(f).on_device("cpu", shards=shards), idx))
        return host, dev

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"][1] == got["port"][0]


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_one_shard_mesh_equals_unsharded(people_csv, orders_csv, name):
    """A 1-shard mesh runs the sharded code on one block: every pipeline
    equals the unsharded device run, the port's and the reference's."""
    fn = PIPELINES[name]
    f = orders_csv if name in ("join", "filter-join", "except", "validate") else people_csv

    def run(pkg, side):
        return _run(fn(pkg, pkg.from_file(f).on_device("cpu"), _cust(pkg, people_csv)))

    got = _both(run)
    src = T.from_file(f).on_device("cpu", shards=1)
    assert src.plan.table.mesh.size == 1
    assert _run(fn(T, src, _cust(T, people_csv))) == got["port"] == got["ref"]


def test_sharded_errors_name_the_first_global_row():
    # streamed row 40 (of 4 shards x 16) lacks the key cell: the errors
    # name it, counted across shards
    rows = [{"k": f"k{i % 9}", "v": str(i)} if i != 40 else {"v": str(i)} for i in range(64)]
    idx_rows = [{"k": f"k{i}", "w": str(i)} for i in range(9)]

    def run(pkg, side):
        idx = pkg.take_rows([pkg.Row(r) for r in idx_rows]).unique_index_on("k")
        idx.on_device("cpu")
        out = []
        for shards in (4, 8, 7):
            src = pkg.take_rows([pkg.Row(r) for r in rows]).on_device("cpu", shards=shards)
            out.append(_run(src.join(idx, "k")))
            out.append(_run(src.select_columns("k", "v")))
            out.append(_run(src.validate(pkg.Not(pkg.Like({"v": "50"})), "v is 50")))
            out.append(_run(src.filter(pkg.Not(pkg.Like({"v": "3"}))).join(idx, "k")))
        return out

    got = _both(run)
    assert got["port"] == got["ref"]
    assert all(kind == "error" for kind, _ in got["port"])
    assert "row 40" in got["port"][0][1] and "row 50" in got["port"][2][1]


@pytest.mark.parametrize("shards", [8, 7])
def test_sharded_index_build_unique_and_dedup(people_csv, shards):
    def run(pkg, side):
        dev = pkg.from_file(people_csv).on_device("cpu", shards=shards)
        idx = dev.index_on("surname", "name")
        out = [_dicts(pkg.take(idx).to_rows()), _dicts(idx.find("Jones").to_rows()),
               len(dev.unique_index_on("id"))]
        with pytest.raises(pkg.CsvPlusError):
            dev.unique_index_on("name")
        d = dev.index_on("name")
        d.resolve_duplicates("first")
        out += [len(d), _dicts(pkg.take(d).to_rows())]
        return out

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"][2] == 120 and got["port"][3] == 10


def test_two_d_mesh_pipeline(people_csv, orders_csv):
    def run(pkg, side):
        mesh2 = j_make_mesh_2d(2, 4) if side == "ref" else TM.make_mesh_2d(2, 4, devices=CPU8)
        idx = pkg.take(pkg.from_file(people_csv)).unique_index_on("id")
        idx.on_device("cpu")
        return _dicts(pkg.from_file(orders_csv).on_device("cpu", mesh=mesh2)
                      .select_columns("cust_id", "qty").join(idx, "cust_id").top(500).to_rows())

    got = _both(run)
    assert got["port"] == got["ref"] and len(got["port"]) == 500


def test_sinks_and_checksums_of_a_sharded_result(people_csv, orders_csv):
    def run(pkg, side):
        idx = _cust(pkg, people_csv)
        src = (pkg.from_file(orders_csv).on_device("cpu", shards=7)
               .filter(pkg.Not(pkg.Like({"qty": "3"}))).join(idx, "cust_id"))
        csv_out, json_out = io.StringIO(), io.StringIO()
        src.to_csv(csv_out, "cust_id", "name", "qty")
        src.top(40).to_json(json_out)
        table = src.to_device_table() if side == "port" else None
        chk = j_checksum if side == "ref" else t_checksum
        if side == "ref":
            from csvplus_tpu.columnar.exec import execute_plan

            table = execute_plan(src.plan)
        cols = sorted(table.columns)
        return (csv_out.getvalue(), json_out.getvalue(), chk(table, cols, positional=True),
                chk(table, cols, limit=100), chk(table, cols))

    got = _both(run)
    assert got["port"] == got["ref"]


# -- the join tiers, stage rows, host syncs, assemblies -------------------------------


def _write_orders(tmp_path, n=1003, seed=1):
    rng = np.random.default_rng(seed)
    paths = {k: tmp_path / f"{k}.csv" for k in ("orders", "cust", "prod")}
    paths["orders"].write_text("order_id,cust_id,prod_id,qty\n" + "".join(
        f"o{i},c{rng.integers(0, 50)},p{rng.integers(0, 9)},{rng.integers(1, 10)}\n"
        for i in range(n)))
    paths["cust"].write_text("cust_id,name\n" + "".join(f"c{i},n{i % 7}\n" for i in range(45)))
    paths["prod"].write_text("prod_id,pname\n" + "".join(f"p{i},x{i}\n" for i in range(9)))
    return {k: str(v) for k, v in paths.items()}


@pytest.mark.parametrize("min_keys", [4_000_000, 1])
@pytest.mark.parametrize("shards", [8, 7])
def test_three_way_join_stages_syncs_and_no_assembly(tmp_path, monkeypatch, shards, min_keys):
    """The plain filter -> join -> join on a sharded stream: the same rows,
    stage rows (tiers, paths, capacities, retries, hot keys), verifier
    counters (the placement flow sees a sharded stream) and host syncs as
    the reference, the broadcast tier below the partition threshold and
    the partitioned tier at it; no column is assembled."""
    paths = _write_orders(tmp_path)
    monkeypatch.setattr(JJ.DeviceIndex, "PARTITION_MIN_KEYS", min_keys)
    monkeypatch.setattr(TJ.DeviceIndex, "PARTITION_MIN_KEYS", min_keys)
    out = {}
    for side, pkg in PKGS.items():
        tel = j_tel if side == "ref" else t_tel
        cust = pkg.from_file(paths["cust"]).on_device("cpu").unique_index_on("cust_id")
        prod = pkg.from_file(paths["prod"]).on_device("cpu").unique_index_on("prod_id")
        with tel.collect():
            src = pkg.from_file(paths["orders"]).on_device("cpu", shards=shards)
            rows = src.filter(pkg.Like({"qty": "3"})).join(cust, "cust_id").join(prod).to_rows()
            out[side] = (_dicts(rows), _records(tel), tel.host_sync_elements, dict(tel.counters))
    (rows, recs, syncs, ctr), (want_rows, want_recs, want_syncs, want_ctr) = (out["port"],
                                                                              out["ref"])
    assert rows == want_rows and len(rows) > 0
    assert recs == want_recs
    assert ctr == want_ctr and ctr["verify.plans"] >= 1
    stages = [r[0] for r in recs]
    assert ("join:all_to_all" in stages) == (min_keys == 1)
    assert ("join:probe" in stages) == (min_keys > 1)
    assert syncs == want_syncs + _port_extra_syncs(recs, shards)
    assert TM.assemblies["count"] == 0
    assert _port_only_translations() == 2


def test_executor_partitioned_path_and_unsharded_stays_broadcast(people_csv, orders_csv,
                                                                 monkeypatch):
    import csvplus_tpu_torch.parallel.pjoin as TP

    monkeypatch.setattr(TJ.DeviceIndex, "PARTITION_MIN_KEYS", 1)
    monkeypatch.setattr(JJ.DeviceIndex, "PARTITION_MIN_KEYS", 1)
    calls = {"n": 0}
    orig = TP.partitioned_probe_device

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(TP, "partitioned_probe_device", counting)

    def run(pkg, side):
        cust = _cust(pkg, people_csv)
        out = []
        for kw in ({"shards": 8}, {}):
            out.append(_dicts(pkg.from_file(orders_csv).on_device("cpu", **kw)
                              .select_columns("cust_id", "qty").join(cust, "cust_id").to_rows()))
        out.append(_dicts(cust.find("55").to_rows()))  # a prefix probe broadcasts
        return out

    got = _both(run)
    assert got["port"] == got["ref"]
    assert calls["n"] == 1  # the sharded stream only


def test_wide_composite_key_join_sharded(monkeypatch):
    """A 2 x 33K-cardinality composite key (16 + 16 packed bits, over 31)
    through the wide partitioned tier on a sharded stream; a prefix probe
    whose upper-bound lane sum hits 2^31."""
    import csvplus_tpu_torch.parallel.pjoin as TP

    monkeypatch.setattr(TJ.DeviceIndex, "PARTITION_MIN_KEYS", 1)
    monkeypatch.setattr(JJ.DeviceIndex, "PARTITION_MIN_KEYS", 1)
    calls = {"n": 0}
    orig = TP.partitioned_probe_device_wide

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(TP, "partitioned_probe_device_wide", counting)
    rng = np.random.default_rng(13)
    n = 33_000
    a_vals = np.char.add("a", np.char.zfill(np.arange(n).astype(str), 6))
    b_vals = np.char.add("b", np.char.zfill(np.arange(n).astype(str), 6))
    pa = rng.integers(0, n, size=4000)
    probes = {"a": a_vals[pa].tolist(),
              "b": [b_vals[i if i % 3 else (i + 1) % n] for i in pa.tolist()]}
    edge = {"a": [a_vals[32767], a_vals[32768]]}  # (32767 << 16) + (1 << 16) == 2^31

    def run(pkg, side):
        Table = JTable if side == "ref" else TTable
        src_of = j_source if side == "ref" else t_source
        idx = src_of(Table.from_pylists({"a": a_vals.tolist(), "b": b_vals.tolist(),
                                         "v": np.arange(n).astype(str).tolist()},
                                        "cpu")).index_on("a", "b")
        assert idx.device_table.packed_hi is not None  # the wide tier
        table = Table.from_pylists(probes, "cpu").with_sharding(_mesh(side))
        got = _dicts(src_of(table).join(idx, "a", "b").to_rows())
        e = _dicts(src_of(Table.from_pylists(edge, "cpu").with_sharding(_mesh(side, 2)))
                   .join(idx, "a").to_rows())
        return got, e

    got = _both(run)
    assert got["port"] == got["ref"]
    assert len(got["port"][1]) == 2 and calls["n"] >= 1


@pytest.mark.parametrize("trial", range(10))
def test_partitioned_executor_join_randomized(monkeypatch, trial):
    import random

    monkeypatch.setattr(TJ.DeviceIndex, "PARTITION_MIN_KEYS", 1)
    monkeypatch.setattr(JJ.DeviceIndex, "PARTITION_MIN_KEYS", 1)
    rng = random.Random(13 + trial)
    n_idx, n_stream = [(8, 0), (8, 16), (40, 16), (40, 64), (8, 64)][trial % 5]
    vocab = [f"k{v}" for v in range(rng.randint(1, 20))]
    idx_rows = [{"k": rng.choice(vocab), "v": str(i)} for i in range(n_idx)]
    stream_rows = [{"k": rng.choice(vocab + ["miss1", "miss2"]), "s": str(i)}
                   for i in range(n_stream)]

    def run(pkg, side):
        Table = JTable if side == "ref" else TTable
        src_of = j_source if side == "ref" else t_source
        idx = pkg.take_rows([pkg.Row(r) for r in idx_rows]).index_on("k")
        host = _dicts(pkg.take_rows([pkg.Row(r) for r in stream_rows]).join(idx, "k").to_rows())
        idx.on_device("cpu")
        table = Table.from_rows([pkg.Row(r) for r in stream_rows], "cpu")
        if table.nrows:
            table = table.with_sharding(_mesh(side))
        return host, _dicts(src_of(table).join(idx, "k").to_rows())

    got = _both(run)
    assert got["port"] == got["ref"] and got["port"][0] == got["port"][1]


def test_partitioned_join_sync_telemetry(people_csv, orders_csv, monkeypatch):
    monkeypatch.setattr(TJ.DeviceIndex, "PARTITION_MIN_KEYS", 1)
    monkeypatch.setattr(JJ.DeviceIndex, "PARTITION_MIN_KEYS", 1)
    out = {}
    for side, pkg in PKGS.items():
        tel = j_tel if side == "ref" else t_tel
        cust = _cust(pkg, people_csv)
        with tel.collect():
            rows = (pkg.from_file(orders_csv).on_device("cpu", shards=8)
                    .select_columns("cust_id", "qty").filter(pkg.Not(pkg.Like({"qty": "never"})))
                    .join(cust, "cust_id").to_rows())
            out[side] = (_dicts(rows), _records(tel), tel.host_sync_elements)
    (rows, recs, syncs), (want_rows, want_recs, want_syncs) = out["port"], out["ref"]
    assert rows == want_rows and recs == want_recs
    assert 0 < want_syncs <= 4096 + 16
    assert syncs == want_syncs + _port_extra_syncs(recs, 8)
    assert _port_only_translations() == 1


# -- skew: the executor and the multiway join ----------------------------------------


def _zipf_cust(n_rows, n_keys, s, seed):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_keys)
    w = np.arange(1, n_keys + 1, dtype=np.float64) ** -float(s)
    w /= w.sum()
    return perm[rng.choice(n_keys, size=n_rows, p=w)]


def _single_key_cust(n_rows, n_keys, share, seed):
    rng = np.random.default_rng(seed)
    n_heavy = int(n_rows * share)
    cust = np.concatenate([np.zeros(n_heavy, dtype=np.int64),
                           rng.integers(1, n_keys, size=n_rows - n_heavy)])
    rng.shuffle(cust)
    return cust


def _stream(side, cust, prod=None):
    Table = JTable if side == "ref" else TTable
    data = {"k": np.char.add("c", cust.astype(str)).tolist(),
            "qty": (cust % 9).astype(str).tolist()}
    if prod is not None:
        data["p"] = np.char.add("p", prod.astype(str)).tolist()
    return Table.from_pylists(data, "cpu")


def _dim(side, prefix, key, payload, n_keys, drop=()):
    pkg = PKGS[side]
    rows = [pkg.Row({key: f"{prefix}{i}", payload: f"v{i % 37}"})
            for i in range(n_keys) if i not in drop]
    idx = pkg.take_rows(rows).index_on(key)
    idx.on_device("cpu")
    return idx


SKEW_CASES = {
    "zipf-1.05": lambda: (_zipf_cust(8_000, 1_500, 1.05, 17), 1_500, ()),
    "zipf-1.3": lambda: (_zipf_cust(8_000, 1_500, 1.3, 17), 1_500, ()),
    "single-key": lambda: (_single_key_cust(8_000, 400, 0.9, 23), 400, ()),
    "heavy-key-absent": lambda: (_single_key_cust(8_000, 400, 0.9, 29), 400, (0,)),
    "uniform": lambda: (np.random.default_rng(31).integers(0, 2_000, 8_000), 2_000, ()),
}


@pytest.mark.parametrize("skew", ["1", "0"])
@pytest.mark.parametrize("case", sorted(SKEW_CASES))
def test_skew_tier_through_the_executor(monkeypatch, case, skew):
    monkeypatch.setattr(TJ.DeviceIndex, "PARTITION_MIN_KEYS", 1)
    monkeypatch.setattr(JJ.DeviceIndex, "PARTITION_MIN_KEYS", 1)
    monkeypatch.setenv("CSVPLUS_JOIN_SKEW", skew)
    cust, n_keys, drop = SKEW_CASES[case]()
    out = {}
    for side, pkg in PKGS.items():
        tel = j_tel if side == "ref" else t_tel
        src_of = j_source if side == "ref" else t_source
        chk = j_checksum if side == "ref" else t_checksum
        idx = _dim(side, "c", "k", "name", n_keys, drop)
        table = _stream(side, cust)
        whole = src_of(table).join(idx, "k").to_device_table()
        with tel.collect():
            res = src_of(table.with_sharding(_mesh(side))).join(idx, "k").to_device_table()
            recs = _records(tel)
        cols = sorted(res.columns)
        out[side] = (chk(res, cols, positional=True), res.nrows, recs,
                     chk(whole, cols, positional=True),
                     (j_skew if side == "ref" else t_skew).counters_snapshot())
    assert out["port"][:3] == out["ref"][:3]
    assert out["port"][0] == out["port"][3]  # sharded == unsharded
    assert out["port"][4] == out["ref"][4]  # the csvplus_join_* counters
    assert _port_only_translations() == 1
    stages = {r[0] for r in out["port"][2]}
    if skew == "0" or case in ("uniform", "heavy-key-absent"):
        assert "join:skew" not in stages
    else:
        assert "join:skew" in stages


@pytest.mark.parametrize("dist", ["uniform", "zipf", "hot-both"])
@pytest.mark.parametrize("shards", [8, 4])
def test_multiway_join_sharded_one_part_info(monkeypatch, dist, shards):
    """The single-pass multiway join over a sharded stream: rows, stage rows
    (the second dimension's first attempt starts at the first's settled
    capacity), counters and checksums equal the reference's, and equal the
    cascade."""
    monkeypatch.setattr(TJ.DeviceIndex, "PARTITION_MIN_KEYS", 1)
    monkeypatch.setattr(JJ.DeviceIndex, "PARTITION_MIN_KEYS", 1)
    n = 8_000 if dist == "hot-both" else 4_000
    if dist == "zipf":
        cust, prod = _zipf_cust(n, 500, 1.3, 31), _zipf_cust(n, 60, 1.3, 32)
    elif dist == "hot-both":
        cust, prod = _single_key_cust(n, 400, 0.9, 41), _single_key_cust(n, 60, 0.9, 43)
    else:
        rng = np.random.default_rng(33)
        cust, prod = rng.integers(0, 500, n), rng.integers(0, 60, n)
    out = {}
    for side, pkg in PKGS.items():
        tel = j_tel if side == "ref" else t_tel
        Jn = JJ if side == "ref" else TJ
        chk = j_checksum if side == "ref" else t_checksum
        specs = [(_dim(side, "c", "k", "name", 500).device_table, ("k",)),
                 (_dim(side, "p", "p", "price", 60).device_table, ("p",))]
        t = _stream(side, cust, prod).with_sharding(_mesh(side, shards))
        with tel.collect():
            got = Jn.multiway_join(t, specs)
            recs = _records(tel)
        cascade = Jn.join_tables(Jn.join_tables(t, *specs[0]), *specs[1])
        cols = sorted(got.columns)
        out[side] = (chk(got, cols, positional=True), got.nrows, recs,
                     chk(cascade, cols, positional=True),
                     (j_skew if side == "ref" else t_skew).counters_snapshot())
    assert out["port"] == out["ref"]
    assert out["port"][0] == out["port"][3]
    assert _port_only_translations() == 2


def test_fused_plan_on_a_sharded_stream_through_the_plan_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(TJ.DeviceIndex, "PARTITION_MIN_KEYS", 1)
    monkeypatch.setattr(JJ.DeviceIndex, "PARTITION_MIN_KEYS", 1)
    from csvplus_tpu.serve import PlanCache as JCache
    from csvplus_tpu_torch.serve import PlanCache as TCache

    paths = _write_orders(tmp_path)
    out = {}
    for side, pkg in PKGS.items():
        tel = j_tel if side == "ref" else t_tel
        cust = pkg.from_file(paths["cust"]).on_device("cpu").unique_index_on("cust_id")
        prod = pkg.from_file(paths["prod"]).on_device("cpu").unique_index_on("prod_id")
        src = (pkg.from_file(paths["orders"]).on_device("cpu", shards=8)
               .filter(pkg.Not(pkg.Like({"qty": "3"}))).join(cust, "cust_id").join(prod))
        cache = (JCache if side == "ref" else TCache)()
        with tel.collect():
            t = cache.execute(src.plan)
            # the reference's cost model demotes typed columns to count
            # their distinct values; the port counts them without demoting
            # (ROADMAP section 3)
            recs = [r for r in _records(tel) if r[0] != "typed:demote"]
        chk = j_checksum if side == "ref" else t_checksum
        out[side] = (chk(t, sorted(t.columns), positional=True), t.nrows, recs,
                     cache.stats()["fused_chains"])
    assert out["port"] == out["ref"]
    assert out["port"][3] == 1
    assert _port_only_translations() == 2


# -- the flagship, the sort route, typed pads, config 5 ------------------------------


@pytest.mark.parametrize("n_orders", [6, 8, 13])
def test_flagship_padded_sharded_stream(people_csv, stock_csv, n_orders):
    orders_rows = [{"cust_id": str(i % 120), "prod_id": str(i % 8), "qty": str(i)}
                   for i in range(n_orders)]
    TF.run_paths.clear()

    def run(pkg, side):
        Table = JTable if side == "ref" else TTable
        Threeway = JThreeway if side == "ref" else TF.ThreewayJoin
        cust = pkg.take(pkg.from_file(people_csv).select_columns("id", "name")).unique_index_on("id")
        prod = pkg.take(pkg.from_file(stock_csv).select_columns("prod_id", "product")
                        ).unique_index_on("prod_id")
        rows = [pkg.Row(r) for r in orders_rows]
        host = _dicts(pkg.take_rows(rows).join(cust, "cust_id").join(prod).to_rows())
        cust.on_device("cpu")
        prod.on_device("cpu")
        t = Table.from_rows(rows, "cpu").with_sharding(_mesh(side))
        tw = Threeway.build(t, cust.device_table, prod.device_table)
        return host, _dicts(tw.run().to_rows())

    got = _both(run)
    assert got["port"] == got["ref"] and got["port"][0] == got["port"][1]
    padded = n_orders % 8 != 0
    assert TF.run_paths["padded"] == int(padded)
    assert TF.run_paths["compaction"] >= int(padded)


def test_typed_sharding_pads_never_alias_prefix_zero(tmp_path):
    path = tmp_path / "o.csv"
    path.write_text("order_id,cust_id,prod_id\no1,c1,p1\no2,c0,p0\no3,c2,p1\n")

    def run(pkg, side):
        Table = JTable if side == "ref" else TTable
        Threeway = JThreeway if side == "ref" else TF.ThreewayJoin
        Sort = JS if side == "ref" else TS
        Jn = JJ if side == "ref" else TJ
        orders = pkg.from_file(str(path)).on_device("cpu").plan.table
        assert orders.columns["cust_id"].kind == "int"
        sharded = orders.with_sharding(_mesh(side))
        cust = Table.from_pylists({"id": ["c0", "c1", "c2"], "name": ["n0", "n1", "n2"]}, "cpu")
        prod = Table.from_pylists({"prod_id": ["p0", "p1"], "product": ["a", "b"]}, "cpu")
        tw = Threeway.build(sharded, Jn.DeviceIndex.build(Sort.sort_table(cust, ["id"]), ["id"]),
                            Jn.DeviceIndex.build(Sort.sort_table(prod, ["prod_id"]), ["prod_id"]))
        out = tw.run()
        return (out.nrows, sorted(r["order_id"] for r in out.to_rows()),
                sharded.columns["cust_id"]._demote().dictionary.tolist(),
                _dicts(sharded.to_rows()) == _dicts(orders.to_rows()))

    got = _both(run)
    assert got["port"] == got["ref"] == (3, ["o1", "o2", "o3"], [b"c0", b"c1", b"c2"], True)


@pytest.mark.parametrize("wide", [False, True])
def test_sharded_index_build_routes_dsort(people_csv, monkeypatch, wide):
    monkeypatch.setattr(JS, "DSORT_MIN_ROWS", 1)
    monkeypatch.setattr(TS, "DSORT_MIN_ROWS", 1)
    rng = np.random.default_rng(31)
    n = 33_000  # 16 + 16 packed bits: the two-lane sort
    perm = rng.permutation(n)
    data = {"a": np.char.add("a", np.char.zfill(perm.astype(str), 6)).tolist(),
            "b": np.char.add("b", np.char.zfill(((perm * 7) % n).astype(str), 6)).tolist()}
    out = {}
    for side, pkg in PKGS.items():
        tel = j_tel if side == "ref" else t_tel
        Table = JTable if side == "ref" else TTable
        src_of = j_source if side == "ref" else t_source
        with tel.collect():
            if wide:
                t = Table.from_pylists(data, "cpu").with_sharding(_mesh(side))
                idx = src_of(t).index_on("a", "b")
                got = [_dicts(pkg.take(idx).to_rows()[:50]), len(idx),
                       _dicts(idx.find(data["a"][5]).to_rows())]
            else:
                dev = pkg.from_file(people_csv).on_device("cpu", shards=8)
                idx = dev.index_on("surname", "name")
                got = [_dicts(pkg.take(idx).to_rows()), len(dev.unique_index_on("id"))]
            stages = [r.stage for r in tel.records]
        out[side] = (got, stages.count("dsort"))
    assert out["port"] == out["ref"]
    assert out["port"][1] >= 1
    if wide:
        from csvplus_tpu_torch.ops.sort import _packed_sort_lanes

        t = TTable.from_pylists(data, "cpu").with_sharding(_mesh("port"))
        assert len(_packed_sort_lanes([t.columns["a"], t.columns["b"]])) == 2


@pytest.mark.parametrize("shards", [8, 7])
def test_dsort_index_stays_sharded(people_csv, orders_csv, monkeypatch, shards):
    """An index built through the dsort route keeps the permutation's
    block layout on the mesh (no column lands whole on one device), and
    every read of it equals the reference's: iteration, a find with a
    stage after it, sub_index, a join from a sharded stream, and both
    dedup policies."""
    monkeypatch.setattr(JS, "DSORT_MIN_ROWS", 1)
    monkeypatch.setattr(TS, "DSORT_MIN_ROWS", 1)

    def run(pkg, side):
        dev = pkg.from_file(people_csv).on_device("cpu", shards=shards)
        idx = dev.index_on("surname", "name")
        cust = dev.unique_index_on("id")
        if side == "port":
            q = -(-120 // shards)
            want = [max(0, min(q, 120 - i * q)) for i in range(shards)]
            for ix in (idx, cust):
                for c in ix._impl.dev.table.columns.values():
                    assert isinstance(c.storage, TM.ShardedRows)
                    assert c.storage.mesh.size == shards and c.storage.lens == want
        orders = pkg.from_file(orders_csv)
        out = [_dicts(pkg.take(idx).to_rows()),
               _dicts(idx.find("Jones").filter(pkg.Like({"name": "Amelia"})).to_rows()),
               _dicts(idx.find("Jones").to_rows()),
               _dicts(pkg.take(idx.sub_index("Jones")).to_rows()),
               _dicts(orders.on_device("cpu", shards=shards).join(cust, "cust_id").to_rows())]
        if side == "port":
            # the reference's probe refuses an unsharded stream against a
            # sharded index; here each shard sends the rows it is asked for
            assert _dicts(orders.on_device("cpu").join(cust, "cust_id").to_rows()) == out[4]
        for policy in ("first", "last"):
            d = dev.index_on("name")
            d.resolve_duplicates(policy)
            out.append(_dicts(pkg.take(d).to_rows()))
        return out

    got = _both(run)
    assert got["port"] == got["ref"]
    assert len(got["port"][4]) > 0 and len(got["port"][5]) == 10


def test_config5_sharded_join(people_csv, orders_csv):
    def run(pkg, side):
        cust = pkg.take(pkg.from_file(people_csv).select_columns("id", "name")).unique_index_on("id")
        host = _dicts(pkg.take(pkg.from_file(orders_csv)).join(cust, "cust_id").to_rows())
        cust.on_device("cpu")
        if side == "ref":
            dev = JW.sharded_join(pkg.from_file(orders_csv), cust, shards=8)
        else:
            dev = TW.sharded_join(pkg.from_file(orders_csv), cust, shards=8,
                                  mesh=TM.make_mesh(8, devices=CPU8))
        return host, _dicts(dev.to_rows())

    got = _both(run)
    assert got["port"] == got["ref"] and got["port"][0] == got["port"][1]
    # mesh= places the shards itself (one device for all of them)
    cust = T.take(T.from_file(people_csv).select_columns("id", "name")).unique_index_on("id")
    cust.on_device("cpu")
    dev = TW.sharded_join(T.from_file(orders_csv), cust, shards=8,
                          mesh=TM.make_mesh(4, devices=["cpu"] * 4))
    assert _dicts(dev.to_rows()) == got["port"][0]


# -- the host-answer expansions ------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_host_answer_expansions_equal_reference(seed):
    rng = np.random.default_rng(seed)
    m = 200
    lowers = [rng.integers(0, 50, m).astype(np.int32) for _ in range(3)]
    counts = [rng.integers(0, 4, m).astype(np.int32) for _ in range(3)]
    for got, want in zip(TJ.expand_matches(lowers[0], counts[0]),
                         JJ.expand_matches(lowers[0], counts[0])):
        assert np.array_equal(got, want)
    g = TJ._multiway_expand_host(lowers, counts)
    w = JJ._multiway_expand_host(lowers, counts)
    assert np.array_equal(g[0], w[0]) and g[2:] == w[2:]
    assert all(np.array_equal(a, b) for a, b in zip(g[1], w[1]))


def test_a_host_answering_probe_expands_on_the_host(monkeypatch):
    """A probe that answers in numpy (the reference's host tier) takes the
    host expansion in the binary and the multiway join, with the
    reference's rows and path."""
    rows = [{"k": f"k{i % 7}", "s": str(i)} for i in range(40)]
    out = {}
    for side, pkg in PKGS.items():
        Jn = JJ if side == "ref" else TJ
        tel = j_tel if side == "ref" else t_tel
        Table = JTable if side == "ref" else TTable
        orig = Jn.DeviceIndex.probe

        def host_probe(self, *a, _orig=orig, **k):
            lo, ct = _orig(self, *a, **k)
            return np.asarray(lo), np.asarray(ct)

        monkeypatch.setattr(Jn.DeviceIndex, "probe", host_probe)
        idx = _dim(side, "k", "k", "v", 7).device_table
        idx2 = _dim(side, "k", "k", "w", 5).device_table
        t = Table.from_rows([pkg.Row(r) for r in rows], "cpu")
        with tel.collect():
            one = Jn.join_tables(t, idx, ["k"])
            two = Jn.multiway_join(t, [(idx, ("k",)), (idx2, ("k",))])
            paths = [r.extra.get("path") for r in tel.records if r.stage == "join:expand"]
        out[side] = (_dicts(one.to_rows()), _dicts(two.to_rows()), paths)
        monkeypatch.setattr(Jn.DeviceIndex, "probe", orig)
    assert out["port"] == out["ref"]
    assert out["port"][2] == ["host-expand", "multiway-host-expand"]


# -- the two thresholds are read from the environment at import ----------------------

THRESHOLD_PATH = r"""
import json, sys
import csvplus_tpu_torch as T
from csvplus_tpu_torch.utils.observe import telemetry

with open("o.csv", "w") as f:
    f.write("order_id,cust_id\n" + "".join(f"o{i},c{i % 13}\n" for i in range(300)))
with open("c.csv", "w") as f:
    f.write("cust_id,name\n" + "".join(f"c{i},n{i}\n" for i in range(13)))
cust = T.from_file("c.csv").on_device("cpu").unique_index_on("cust_id")
with telemetry.collect():
    src = T.from_file("o.csv").on_device("cpu", shards=4)
    src.join(cust, "cust_id").to_rows()
    src.index_on("cust_id")
    stages = [r.stage for r in telemetry.records]
print(json.dumps({"partitioned": "join:all_to_all" in stages, "dsort": "dsort" in stages}))
"""


@pytest.mark.parametrize("env", [{}, {"CSVPLUS_PARTITION_MIN_KEYS": "1"},
                                 {"CSVPLUS_DSORT_MIN_ROWS": "1"}])
def test_threshold_knobs_change_the_tier_in_a_fresh_process(tmp_path, env):
    import json
    import os
    import subprocess
    import sys

    root = __import__("pathlib").Path(__file__).resolve().parents[1]
    full = {k: v for k, v in os.environ.items()
            if k not in ("CSVPLUS_PARTITION_MIN_KEYS", "CSVPLUS_DSORT_MIN_ROWS")}
    full.update(env, PYTHONPATH=str(root))
    res = subprocess.run([sys.executable, "-c", THRESHOLD_PATH], cwd=tmp_path, env=full,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"partitioned": "CSVPLUS_PARTITION_MIN_KEYS" in env,
                   "dsort": "CSVPLUS_DSORT_MIN_ROWS" in env}
