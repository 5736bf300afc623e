"""The port's sharded streamed ingest and sharded random pipelines, held
against the JAX package's on the CPU: ``from_file(...).on_device("cpu",
shards=8)`` in the port (8 shards on the CPU device), ``on_device("cpu",
shards=8)`` in the reference (its 8 virtual CPU devices), on small files
streamed in tiny chunks so shard boundaries land mid-file.

Covered: chunks land on their shards (``ingest:shard-assemble`` with
``n_shards`` / ``max_shard_rows``, ``_pre_sharded``, the ingest stage
rows), mixed column kinds with a mid-stream demotion, a pipeline, a
table whose trailing shards are all padding, the lane-threshold fallback
to the whole-file tiers, seeded random pipelines over sharded tables and
sharded streamed ingests against the host (including empty tables), the
worker count (K) leaving no trace in the result, and
``MutableIndex.append_csv(shards=8)``."""

import os
import random

import numpy as np
import pytest

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu.columnar.ingest import source_from_table as j_source
from csvplus_tpu.columnar.table import DeviceTable as JTable
from csvplus_tpu.parallel.mesh import make_mesh as j_make_mesh
from csvplus_tpu.utils.checksum import checksum_device_table as j_checksum
from csvplus_tpu.utils.observe import telemetry as j_tel
from csvplus_tpu_torch.columnar.ingest import source_from_table as t_source
from csvplus_tpu_torch.columnar.table import DeviceTable as TTable
from csvplus_tpu_torch.parallel import mesh as TM
from csvplus_tpu_torch.utils.checksum import checksum_device_table as t_checksum
from csvplus_tpu_torch.utils.observe import telemetry as t_tel

PKGS = {"ref": J, "port": T}


@pytest.fixture()
def stream_small(monkeypatch):
    monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")
    monkeypatch.setenv("CSVPLUS_STREAM_CHUNK_BYTES", "2048")


def _dicts(rows):
    return [dict(r) for r in rows]


def _write(tmp_path, text, name="s.csv"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


# stage rows whose extras are host timings or the port's own accounting
_TIMED = {"ingest:encode", "ingest:place"}


def _ingest_records(tel):
    return [(r.stage, r.rows_in, r.rows_out,
             {} if r.stage in _TIMED else {k: v for k, v in r.extra.items()})
            for r in tel.records]


@pytest.mark.parametrize("shards", [8, 5])
def test_chunks_land_on_shards(tmp_path, stream_small, shards):
    path = _write(tmp_path, "order_id,cust_id,qty\n"
                  + "".join(f"o{i},c{i % 11},{i % 50}\n" for i in range(1800)))
    out = {}
    for side, pkg in PKGS.items():
        tel = j_tel if side == "ref" else t_tel
        with tel.collect():
            t = pkg.from_file(path).on_device("cpu", shards=shards).plan.table
            recs = _ingest_records(tel)
        chk = j_checksum if side == "ref" else t_checksum
        out[side] = (recs, getattr(t, "_pre_sharded", False), _dicts(t.to_rows()),
                     chk(t, positional=True), {n: c.kind for n, c in t.columns.items()})
    assert out["port"] == out["ref"]
    recs, pre, rows, _, _ = out["port"]
    assemble = next(r for r in recs if r[0] == "ingest:shard-assemble")
    assert pre and assemble[3] == {"n_shards": shards, "max_shard_rows": -(-1800 // shards)}
    assert rows == _dicts(T.take(T.from_file(path)).to_rows())
    t = T.from_file(path).on_device("cpu", shards=shards).plan.table
    assert t.ingest_tier == "streamed" and t.shard_row_counts() == {
        i: -(-1800 // shards) for i in range(shards)}


def test_sharded_ingest_mixed_kinds_and_demotion(tmp_path, stream_small):
    body = "".join(f"v{i},name{i % 5},{i % 30}\n" for i in range(800))
    body += "NOT_NUM,name0,0\n"
    body += "".join(f"v{i},name{i % 5},{i % 30}\n" for i in range(436))
    path = _write(tmp_path, "a,b,c\n" + body)

    def run(pkg, side):
        t = pkg.from_file(path).on_device("cpu", shards=8).plan.table
        return {n: c.kind for n, c in t.columns.items()}, _dicts(t.to_rows())

    got = {side: run(pkg, side) for side, pkg in PKGS.items()}
    assert got["port"] == got["ref"]
    kinds, rows = got["port"]
    assert kinds["a"] == "str" and rows == _dicts(T.take(T.from_file(path)).to_rows())
    if os.environ.get("CSVPLUS_TYPED_LANES", "1") != "0":
        assert kinds["b"] == "int"


def test_sharded_ingest_pipeline(tmp_path, stream_small):
    rng = np.random.default_rng(3)
    opath = _write(tmp_path, "order_id,cust_id,qty\n" + "".join(
        f"o{i},c{int(rng.integers(0, 30))},{int(rng.integers(1, 99))}\n" for i in range(1200)),
        "orders.csv")
    cpath = _write(tmp_path, "id,name\n" + "".join(f"c{i},n{i % 7}\n" for i in range(30)),
                   "cust.csv")

    def run(pkg, side):
        want = _dicts(pkg.take(pkg.from_file(opath)).filter(pkg.Like({"qty": "42"}))
                      .join(pkg.take(pkg.from_file(cpath)).unique_index_on("id"), "cust_id")
                      .to_rows())
        cust = pkg.from_file(cpath).on_device("cpu").unique_index_on("id")
        got = _dicts(pkg.from_file(opath).on_device("cpu", shards=8)
                     .filter(pkg.Like({"qty": "42"})).join(cust, "cust_id").to_rows())
        return want, got

    got = {side: run(pkg, side) for side, pkg in PKGS.items()}
    assert got["port"] == got["ref"] and got["port"][0] == got["port"][1]


@pytest.mark.parametrize("n", [9, 1, 0])
def test_tiny_table_trailing_shards_all_padding(tmp_path, stream_small, n):
    path = _write(tmp_path, "a,b\n" + "".join(f"x{i},{i}\n" for i in range(n)))

    def run(pkg, side):
        t = pkg.from_file(path).on_device("cpu", shards=8).plan.table
        return (getattr(t, "_pre_sharded", False), _dicts(t.to_rows()),
                _dicts(pkg.from_file(path).on_device("cpu", shards=8)
                       .filter(pkg.Not(pkg.Like({"a": "x3"}))).to_rows()))

    got = {side: run(pkg, side) for side, pkg in PKGS.items()}
    assert got["port"] == got["ref"]
    assert got["port"][0]  # the chunks, or the header-only one, landed on their shards
    assert got["port"][1] == _dicts(T.take(T.from_file(path)).to_rows())


def test_lane_threshold_falls_back_under_a_mesh(tmp_path, stream_small, monkeypatch):
    monkeypatch.setenv("CSVPLUS_DICT_DEVICE_MIN_DISTINCT", "50")
    monkeypatch.setenv("CSVPLUS_TYPED_LANES", "0")  # dictionary columns only
    path = _write(tmp_path, "k\n" + "".join(f"u{i}x\n" for i in range(400)))

    def run(pkg, side):
        tel = j_tel if side == "ref" else t_tel
        with tel.collect():
            t = pkg.from_file(path).on_device("cpu", shards=8).plan.table
            stages = [r.stage for r in tel.records]
        return getattr(t, "_pre_sharded", False), [r["k"] for r in t.to_rows()], stages

    got = {side: run(pkg, side) for side, pkg in PKGS.items()}
    pre, keys, stages = got["port"]
    assert not pre and keys == [f"u{i}x" for i in range(400)]
    assert got["ref"][:2] == (pre, keys)
    # the streamed tier gave up; a whole-file tier made the table
    assert "ingest:shard-assemble" not in stages and "ingest:native-encoded" in stages
    assert T.from_file(path).on_device("cpu", shards=8).plan.table.mesh.size == 8


# -- seeded random pipelines (the reference's hypothesis strategies, as cases) ----------

_INT_VALS = ["0", "1", "7", "42", "100", "4095"]
_WIDE_VALS = ["x", "alpha", "omega-long-value", "Zoë-λ", "xxxxxxxxxxxx"]
_ROW_VALS = {"a": ["x", "y", "Zoë", "7", ""], "b": ["y", " sp", "", "q"], "c": ["zz", "k"]}


def _preds(pkg):
    return [pkg.Like({"a": "x"}), pkg.Like({"b": "y", "a": "x"}), pkg.Not(pkg.Like({"c": "zz"})),
            pkg.All(pkg.Like({"a": "x"}), pkg.Not(pkg.Like({"b": ""}))),
            pkg.Any(pkg.Like({"a": "Zoë"}), pkg.Like({"b": " sp"})), pkg.Like({"nope": "x"}),
            pkg.Like({"a": "7"}), pkg.Any(pkg.Like({"b": "omega-long-value"}),
                                          pkg.Like({"a": "4095"}))]


def _pipeline(rng: random.Random, n_stages: int):
    kinds = ["filter", "select", "dropc", "top", "drop", "tw", "dw", "join", "except",
             "validate", "map"]
    out = []
    for _ in range(n_stages):
        kind = rng.choice(kinds)
        if kind in ("filter", "tw", "dw", "validate"):
            out.append((kind, rng.randrange(8 if kind == "filter" else 3)))
        elif kind == "select":
            out.append((kind, rng.choice([("a",), ("a", "b")])))
        elif kind == "dropc":
            out.append((kind, rng.choice([("c",), ("a", "c")])))
        elif kind in ("top", "drop"):
            out.append((kind, rng.randint(0, 30)))
        elif kind == "map":
            out.append((kind, rng.randrange(3)))
        else:
            out.append((kind, ("a",)))
    return out


def _apply(pkg, src, pipeline, side_idx):
    small = [pkg.Like({"a": "x"}), pkg.Not(pkg.Like({"b": "y"})), pkg.Like({"nope": "q"})]
    maps = [pkg.SetValue("a", "K"), pkg.Rename({"b": "bb"}), pkg.Rename({"a": "b"})]
    for kind, arg in pipeline:
        if kind == "filter":
            src = src.filter(_preds(pkg)[arg])
        elif kind == "select":
            src = src.select_columns(*arg)
        elif kind == "dropc":
            src = src.drop_columns(*arg)
        elif kind == "top":
            src = src.top(arg)
        elif kind == "drop":
            src = src.drop(arg)
        elif kind == "tw":
            src = src.take_while(small[arg])
        elif kind == "dw":
            src = src.drop_while(small[arg])
        elif kind == "join":
            src = src.join(side_idx, *arg)
        elif kind == "except":
            src = src.except_(side_idx, *arg)
        elif kind == "validate":
            src = src.validate([pkg.Like({"a": "x"}), pkg.Not(pkg.Like({"c": "zz"})),
                                pkg.Like({"b": "y"})][arg], "invalid row")
        else:
            src = src.map(maps[arg])
    return src


def _either(src):
    try:
        return "rows", _dicts(src.to_rows())
    except Exception as e:
        return "error", type(e).__name__


def _side_index(pkg):
    rows = [pkg.Row({"a": v, "s": f"side{i}"}) for i, v in enumerate(["x", "7", "Zoë", "alpha"])]
    idx = pkg.take_rows(rows).index_on("a")
    idx.on_device("cpu")
    return idx


@pytest.mark.parametrize("case", range(8))
def test_random_pipeline_sharded_matches_host(case):
    rng = random.Random(1000 + case)
    rows = [{k: rng.choice(v) for k, v in _ROW_VALS.items() if rng.random() > 0.15}
            for _ in range(rng.randint(0, 40))]
    pipeline = _pipeline(rng, rng.randint(0, 4))

    def run(pkg, side):
        Table = JTable if side == "ref" else TTable
        src_of = j_source if side == "ref" else t_source
        mesh = j_make_mesh(8) if side == "ref" else TM.make_mesh(8, devices=["cpu"] * 8)
        prs = [pkg.Row(r) for r in rows]
        idx = _side_index(pkg)
        host = _either(_apply(pkg, pkg.take_rows(prs), pipeline, idx))
        dev = _either(_apply(pkg, src_of(Table.from_rows(prs, "cpu").with_sharding(mesh)),
                             pipeline, idx))
        return host, dev

    got = {side: run(pkg, side) for side, pkg in PKGS.items()}
    assert got["port"] == got["ref"]
    host, dev = got["port"]
    assert dev == host if host[0] == "rows" else dev[0] == "error"


@pytest.mark.parametrize("case", range(8))
def test_random_pipeline_sharded_ingest_matches_host(tmp_path, monkeypatch, case):
    monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")
    monkeypatch.setenv("CSVPLUS_STREAM_CHUNK_BYTES", "96")
    rng = random.Random(2000 + case)
    spec = [(rng.choice(_INT_VALS), rng.choice(_WIDE_VALS)) for _ in range(rng.randint(0, 24))]
    pipeline = _pipeline(rng, rng.randint(0, 3))
    path = _write(tmp_path, "a,b\n" + "".join(f"{x},{y}\n" for x, y in spec))

    def run(pkg, side):
        idx = _side_index(pkg)
        host = _either(_apply(pkg, pkg.take(pkg.from_file(path)), pipeline, idx))
        dev = _either(_apply(pkg, pkg.from_file(path).on_device("cpu", shards=8), pipeline, idx))
        return host, dev

    got = {side: run(pkg, side) for side, pkg in PKGS.items()}
    assert got["port"] == got["ref"]
    host, dev = got["port"]
    assert dev == host if host[0] == "rows" else dev[0] == "error"


@pytest.mark.parametrize("workers", ["1", "2", "5"])
def test_worker_count_leaves_no_trace_in_a_sharded_ingest(tmp_path, monkeypatch, workers):
    monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")
    monkeypatch.setenv("CSVPLUS_STREAM_CHUNK_BYTES", "1500")
    rng = np.random.default_rng(7)
    # a multiple of 8 rows: the reference's checksum refuses a padded table
    path = _write(tmp_path, "id,g,v\n" + "".join(
        f"r{i},g{int(rng.integers(0, 40))},{int(rng.integers(-50, 50))}\n" for i in range(1504)))
    monkeypatch.setenv("CSVPLUS_INGEST_WORKERS", "1")
    base = T.from_file(path).on_device("cpu", shards=8).plan.table
    want = t_checksum(base, positional=True)
    monkeypatch.setenv("CSVPLUS_INGEST_WORKERS", workers)
    t = T.from_file(path).on_device("cpu", shards=8).plan.table
    assert t.ingest_seconds["workers"] == int(workers)
    assert t_checksum(t, positional=True) == want
    assert {n: c.kind for n, c in t.columns.items()} == {n: c.kind for n, c in base.columns.items()}
    ref = J.from_file(path).on_device("cpu", shards=8).plan.table
    assert j_checksum(ref, positional=True) == want


def test_append_csv_sharded(tmp_path):
    from csvplus_tpu.storage import MutableIndex as JMutable
    from csvplus_tpu.storage import index_checksums as j_sums
    from csvplus_tpu_torch.storage import MutableIndex as TMutable
    from csvplus_tpu_torch.storage import index_checksums as t_sums

    base = _write(tmp_path, "k,v\n" + "".join(f"k{i % 50},{i}\n" for i in range(300)), "base.csv")
    extra = _write(tmp_path, "k,v\n" + "".join(f"k{i % 70},x{i}\n" for i in range(203)),
                   "extra.csv")
    got = {}
    for side, pkg in PKGS.items():
        Mutable = JMutable if side == "ref" else TMutable
        mi = Mutable.create(pkg.from_file(base).on_device("cpu"), ["k"], ingest_device="cpu",
                            directory=str(tmp_path / f"mi_{side}"))
        n = mi.append_csv(extra, device="cpu", shards=8)
        got[side] = (n, (j_sums if side == "ref" else t_sums)(mi.to_index()),
                     _dicts(mi.find_rows(["k3"])))
        mi.close()
    assert got["port"] == got["ref"] and got["port"][0] == 203
