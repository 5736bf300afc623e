"""The port's mutable indexes (``csvplus_tpu_torch/storage/``) and
``LookupServer``'s write surface, held against the JAX package's on the
CPU: the same op sequence through both packages gives the same
positional checksums after EVERY compaction step (each side also equal
to its own ``rebuild_reference``), the same probe answers, the same
errors; the cases of ``tests/test_storage.py``; recovery after a crash in
each window of the reference's crash matrix (this file runs itself as the
child process); directories, WAL segments, manifests, bases (index file
versions 1, 2 and 3) and prune sidecars written by either package open in
the other; and ``append`` / ``delete`` acks read back as the reference
server reads them."""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child(workdir, acked_path):
    """The crash child: build a durable index in *workdir* (the port's),
    play :data:`OPS` and record each acked op; an armed fault
    (``CSVPLUS_FAULTS``) kills an op mid-flight."""
    sys.path.insert(0, ROOT)
    from csvplus_tpu_torch.storage import MutableIndex

    acked = []
    crashed = None
    try:
        mi = MutableIndex(_fresh_base(TP), directory=workdir, ingest_device="cpu")
        for op in OPS:
            if op["op"] == "compact":
                mi.compact_once()  # not a logical op: never acked
            elif op["op"] == "rows":
                mi.append_rows(op["rows"])
                acked.append(op)
            else:
                mi.delete(tuple(op["key"]))
                acked.append(op)
    except Exception as exc:  # the armed crash window fires here
        crashed = f"{type(exc).__name__}: {exc}"
    if os.environ.get("CSVPLUS_WAL_CHILD_TEAR") == "1":
        # dying mid write(2): a frame header promising 64 bytes with
        # garbage behind it on the active segment
        segs = sorted(n for n in os.listdir(workdir) if n.startswith("wal-"))
        with open(os.path.join(workdir, segs[-1]), "ab") as f:
            f.write(b"\x40\x00\x00\x00\xde\xad\xbe\xefTORN")
            f.flush()
            os.fsync(f.fileno())
    with open(acked_path, "w") as f:
        json.dump({"ops": acked, "crashed": crashed}, f)
    os._exit(3 if crashed else 0)  # a crashed child looks crashed


OPS = [
    {"op": "rows", "rows": [{"k": f"a{j:02d}", "v": f"x{j}", "w": "aw"} for j in range(12)]},
    {"op": "del", "key": ["k003"]},
    {"op": "rows", "rows": [{"k": "k003", "v": "reborn", "w": "rw"},
                            {"k": "a05", "v": "dup", "w": "dw"}]},
    {"op": "del", "key": ["a07"]},
    {"op": "compact"},
    {"op": "rows", "rows": [{"k": f"b{j:02d}", "v": f"y{j}", "w": "bw"} for j in range(8)]},
    {"op": "del", "key": ["b02"]},
    {"op": "rows", "rows": [{"k": "b02", "v": "back", "w": "zw"}]},
]


class _Pkg:
    """One package's storage surface."""

    def __init__(self, name):
        import importlib

        root = importlib.import_module(name)
        self.name = name
        self.root = root
        self.storage = importlib.import_module(f"{name}.storage")
        self.lsm = importlib.import_module(f"{name}.storage.lsm")
        self.Row = importlib.import_module(f"{name}.row").Row
        self.take_rows = importlib.import_module(f"{name}.source").take_rows
        self.create_index = importlib.import_module(f"{name}.index").create_index
        self.faults = importlib.import_module(f"{name}.resilience.faults")


TP = _Pkg("csvplus_tpu_torch")


def _fresh_base(pkg):
    rows = [{"k": f"k{i % 37:03d}", "v": f"v{i}", "w": f"w{i % 5}"} for i in range(400)]
    return pkg.create_index(pkg.take_rows([pkg.Row(r) for r in rows]), ["k"])


if __name__ == "__main__":
    _child(sys.argv[1], sys.argv[2])


import numpy as np  # noqa: E402

JP = _Pkg("csvplus_tpu")
PKGS = (TP, JP)


@pytest.fixture(autouse=True)
def _disarmed():
    for p in PKGS:
        p.faults.deactivate()
    yield
    for p in PKGS:
        p.faults.deactivate()


def _rows(pkg, n, off=0, keyspace=13):
    return [pkg.Row({"k": f"k{(i + off) % keyspace:03d}", "v": f"v{i + off}"}) for i in range(n)]


def _mk(pkg, n=120, mode="append", keyspace=13, **kw):
    return pkg.storage.MutableIndex.create(
        pkg.take_rows(_rows(pkg, n, keyspace=keyspace)), ["k"], mode=mode,
        ingest_device="cpu", **kw)


def _sums(pkg, mi):
    """(checksums of the live tier set, of the package's own rebuild):
    they must be equal, and are returned once."""
    got = pkg.storage.index_checksums(mi.to_index())
    assert got == pkg.storage.index_checksums(pkg.storage.rebuild_reference(mi))
    return got


def _blocks(groups):
    return [[dict(r) for r in b] for b in groups]


def _both(script):
    """Run *script(pkg)* in both packages; it yields observations, which
    must be equal step by step.  Returns the port's."""
    runs = {p.name: list(script(p)) for p in PKGS}
    got, want = runs[TP.name], runs[JP.name]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"step {i}: {g!r} != {w!r}"
    return got


# -- parity at every compaction step ------------------------------------------


@pytest.mark.parametrize("mode", ["append", "upsert"])
def test_parity_every_compaction_step(mode):
    def script(pkg):
        mi = _mk(pkg, mode=mode)
        for step in range(4):
            mi.append_rows(_rows(pkg, 17, off=100 + 40 * step))
            mi.append_rows(_rows(pkg, 9, off=60 + 40 * step))
            yield _sums(pkg, mi)
            stats = mi.compact_once()
            yield (stats["kind"], stats["deltas"], stats["rows_in"], stats["rows_out"])
            assert mi.delta_count == 0
            yield pkg.storage.index_checksums(mi.tiers().base)
        yield mi.compact_once()

    _both(script)


@pytest.mark.parametrize("mode", ["append", "upsert"])
def test_tombstone_parity_every_compaction_step(mode):
    def script(pkg):
        mi = _mk(pkg, mode=mode)
        for step in range(3):
            mi.append_rows(_rows(pkg, 8, off=100 + 30 * step))
            mi.delete((f"k{(2 + step) % 13:03d}",))
            mi.append_rows(_rows(pkg, 8, off=40 + 30 * step))
            mi.delete((f"k{(5 + step) % 13:03d}",))
            mi.append_rows([pkg.Row({"k": f"k{(2 + step) % 13:03d}", "v": f"re{step}"})])
            yield _sums(pkg, mi)
            stats = mi.compact_once() if step % 2 else mi.compact_step(ratio=2)
            yield (stats["kind"], stats["deltas"], stats["rows_in"], stats["rows_out"])
            yield _sums(pkg, mi)
            yield [(d.seq, d.nrows, d.tombs) for d in mi.tiers().deltas]
        mi.compact_once()
        assert all(not d.tombs for d in mi.tiers().deltas)
        yield _sums(pkg, mi)

    _both(script)


@pytest.mark.parametrize("mode", ["append", "upsert"])
def test_multi_tier_probes_match_reference(mode):
    probes = [("a1",), ("a1", "b0"), ("a9", "b9"), (), ("zz",), ("a1", "zz")]

    def script(pkg):
        rows = [pkg.Row({"a": f"a{i % 3}", "b": f"b{i % 4}", "v": f"x{i}"}) for i in range(36)]
        mi = pkg.storage.MutableIndex.create(pkg.take_rows(rows), ["a", "b"], mode=mode,
                                             ingest_device="cpu")
        mi.append_rows([{"a": "a1", "b": "b9", "v": "d1"}, {"a": "a1", "b": "b0", "v": "d2"}])
        mi.append_rows([{"a": "a1", "b": "b0", "v": "d3"}, {"a": "a9", "b": "b9", "v": "d4"}])
        live = _blocks(mi.find_rows_many(probes))
        assert live == _blocks(mi.to_index()._impl.find_rows_many(probes))
        yield live

    _both(script)


def test_upsert_newest_wins_and_append_multiset():
    def script(pkg):
        mi = _mk(pkg, n=26, mode="upsert", keyspace=5)
        yield len(mi.find_rows("k003"))
        mi.append_rows([{"k": "k003", "v": "NEW"}])
        yield [dict(r) for r in mi.find_rows("k003")]
        mi.compact_once()
        yield [dict(r) for r in mi.find_rows("k003")], _sums(pkg, mi)
        ma = _mk(pkg, n=26, mode="append", keyspace=5)
        ma.append_rows([{"k": "k003", "v": "NEW"}])
        yield len(ma.find_rows("k003"))

    got = _both(script)
    assert got[1] == [{"k": "k003", "v": "NEW"}] and got[3] == got[0] + 1


def test_append_csv_rides_streamed_ingest(tmp_path, monkeypatch):
    monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")
    monkeypatch.setenv("CSVPLUS_STREAM_CHUNK_BYTES", "96")
    p = tmp_path / "delta.csv"
    p.write_text("k,v\n" + "".join(f"k{i % 7:03d},csv{i}\n" for i in range(50)))

    def script(pkg):
        mi = _mk(pkg)
        yield mi.append_csv(str(p), device="cpu"), mi.delta_count
        yield _sums(pkg, mi)
        mi.compact_once()
        yield _sums(pkg, mi), _blocks([mi.find_rows("k001")])

    _both(script)


def _csv_delta(tmp_path):
    p = tmp_path / "delta.csv"
    p.write_text("k,v\n" + "".join(f"k{i % 7:03d},csv{i}\n" for i in range(30)))
    return str(p)


def test_append_csv_defaults_to_the_index_device(tmp_path):
    """A bare ``append_csv`` builds its delta on the index's own device
    (its base's), as ``append_rows`` does, with no ``ingest_device`` given."""
    p = tmp_path / "base.csv"
    p.write_text("k,v\n" + "".join(f"k{i % 13:03d},v{i}\n" for i in range(40)))
    base = TP.root.from_file(str(p)).on_device("cpu").index_on("k")
    mi = TP.storage.MutableIndex(base)
    assert mi.device == base._impl.dev.table.device
    assert mi.append_csv(_csv_delta(tmp_path)) == 30
    mi.append_rows([{"k": "k001", "v": "row"}])
    tiers = [d.index._impl.dev.table.device for d in mi._tiers.deltas]
    assert tiers == [mi.device, mi.device]


def test_append_csv_defaults_to_cuda(tmp_path):
    """A host-only index with no ``ingest_device`` appends a CSV on
    ``"cuda"``, the port's default: without a card that raises, and
    nothing is appended."""
    mi = TP.storage.MutableIndex(_fresh_base(TP))
    assert mi.device is None
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mi.append_csv(_csv_delta(tmp_path))
    assert mi.delta_count == 0
    assert mi.append_csv(_csv_delta(tmp_path), device="cpu") == 30


def test_empty_appends_and_validation():
    def script(pkg):
        mi = _mk(pkg, n=10)
        yield mi.append_rows([]), mi.delta_count
        for fn in (lambda: mi.find_rows(("a", "b")),
                   lambda: mi.delete(("a", "b")),
                   lambda: pkg.storage.MutableIndex.create(
                       pkg.take_rows(_rows(pkg, 5)), ["k"], mode="merge"),
                   lambda: pkg.storage.MutableIndex("not an index"),
                   lambda: mi.compact_step(ratio=1)):
            try:
                fn()
                yield "ok"
            except Exception as e:
                yield type(e).__name__, str(e)

    _both(script)


def test_merge_tiers_host_path_equals_device_path():
    def script(pkg):
        def host_index(rows):
            rows = sorted((pkg.Row(r) for r in rows), key=lambda r: (r["k"],))
            return pkg.root.index.Index(pkg.root.index.IndexImpl(rows, ["k"]))

        a, b = _rows(pkg, 20), _rows(pkg, 8, off=50)
        for mode in ("append", "upsert"):
            host = pkg.storage.merge_tiers([host_index(a), host_index(b)], ["k"], mode)
            assert host._impl.dev is None
            mi = pkg.storage.MutableIndex.create(
                pkg.take_rows([pkg.Row(r) for r in a]).on_device("cpu"), ["k"], mode=mode,
                ingest_device="cpu")
            mi.append_rows([pkg.Row(r) for r in b])
            dev = mi.to_index()
            assert dev._impl.dev is not None
            yield pkg.storage.index_checksums(host)
            assert pkg.storage.index_checksums(host) == pkg.storage.index_checksums(dev)

    _both(script)


def test_upsert_merge_drops_dead_rows_and_dictionary_groups():
    def script(pkg):
        t = pkg.root.columnar.table.DeviceTable.from_pylists(
            {"k": [f"k{i % 8:03d}" for i in range(40)], "v": [f"v{i}" for i in range(40)]},
            "cpu")
        mi = pkg.storage.MutableIndex(pkg.root.take(t).index_on("k").sync(), mode="upsert")
        mi.append_rows([pkg.Row({"k": f"k{i % 8:03d}", "v": f"n{i}"}) for i in range(40)])
        stats = mi.compact_once()
        dev = mi.tiers().base._impl.dev
        assert dev is not None
        yield stats["rows_in"], stats["rows_out"], dev.table.columns["v"].dictionary.tolist()
        yield _sums(pkg, mi)

    got = _both(script)
    assert got[0][:2] == (80, 40) and len(got[0][2]) == 40


def test_leveled_compaction_policy_and_parity():
    def script(pkg):
        mi = _mk(pkg, n=400, keyspace=29)
        for step in range(9):
            mi.append_rows(_rows(pkg, 4, off=500 + 10 * step, keyspace=29))
            stats = mi.compact_step(ratio=3)
            yield None if stats is None else (stats["kind"], stats["deltas"], stats["rows_out"])
            yield _sums(pkg, mi)
        while mi.delta_count:
            stats = mi.compact_step(ratio=2) or mi.compact_once()
            yield stats["kind"], _sums(pkg, mi)

    got = _both(script)
    assert any(isinstance(g, tuple) and g[0] == "partial" for g in got)


def test_delete_visibility():
    def script(pkg):
        for mode in ("append", "upsert"):
            mi = _mk(pkg, mode=mode)
            yield _blocks(mi.find_rows_many([("k003",)]))
            mi.delete(("k003",))
            yield _blocks(mi.find_rows_many([("k003",)]))
            mi.append_rows([pkg.Row({"k": "k003", "v": "reborn"})])
            yield _blocks(mi.find_rows_many([("k003",)])), _sums(pkg, mi)

    _both(script)


def test_snapshot_and_stages():
    def script(pkg):
        tel = pkg.root.utils.observe.telemetry
        mi = _mk(pkg, n=50)
        mi.append_rows(_rows(pkg, 5, off=300))
        with tel.collect():
            mi.compact_once()
            yield [r.stage for r in tel.records if r.stage.startswith("storage:")]
        snap = mi.snapshot()
        yield {k: snap[k] for k in ("mode", "epoch", "base_rows", "deltas", "compactions")}

    got = _both(script)
    assert got[0] == ["storage:merge", "storage:compact"]


def test_tier_swap_listeners_fire_as_the_reference():
    """``subscribe``: one event per append or delete, in tier order, none
    for a compaction; ``unsubscribe`` stops them."""
    def script(pkg):
        mi = _mk(pkg, n=30)
        events = []
        listener = events.append  # one bound method: unsubscribe matches by identity
        pinned = mi.subscribe(listener)
        mi.append_rows(_rows(pkg, 3, off=100))
        mi.delete(("k001",))
        mi.compact_once()
        mi.append_rows(_rows(pkg, 2, off=200))
        mi.unsubscribe(listener)
        mi.delete(("k002",))
        yield pinned.epoch, [(kind, seq, len(x._impl) if kind == "rows" else x)
                             for kind, seq, x in events]

    got = _both(script)
    assert [e[0] for e in got[0][1]] == ["rows", "tombs", "rows"]


# -- threads, the compactor, recompiles -----------------------------------------


def test_concurrent_readers_during_compaction_bitwise_equal():
    mi = _mk(TP, n=400, keyspace=31)
    for j in range(3):
        mi.append_rows(_rows(TP, 25, off=500 + 30 * j, keyspace=31))
    probes = [(f"k{i:03d}",) for i in range(0, 31, 2)] + [("zz",), ()]
    serial = _blocks(mi.to_index()._impl.find_rows_many(probes))
    errs = []
    start = threading.Barrier(5)

    def reader():
        try:
            start.wait(timeout=30)
            for _ in range(8):
                assert _blocks(mi.find_rows_many(probes)) == serial
        except BaseException as e:
            errs.append(e)

    ts = [threading.Thread(target=reader) for _ in range(4)]
    for t in ts:
        t.start()
    start.wait(timeout=30)
    assert mi.compact_once() is not None
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs, errs[0]
    assert _blocks(mi.find_rows_many(probes)) == serial


def _wait_until(pred, timeout=10.0):
    end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > end:
            raise TimeoutError("condition not reached")
        time.sleep(0.005)


def test_compactor_thread_appends_parity_and_metrics():
    from csvplus_tpu_torch.serve import ServingMetrics

    mi = _mk(TP, n=100)
    m = ServingMetrics()
    c = TP.storage.Compactor(mi, min_deltas=1, interval_s=0.002, metrics=m, index_name="mut")
    with c:
        for j in range(12):
            mi.append_rows(_rows(TP, 7, off=1000 + 10 * j))
        _wait_until(lambda: mi.delta_count == 0)
    assert len(mi) == 100 + 84
    ref = _mk(JP, n=100)
    for j in range(12):
        ref.append_rows(_rows(JP, 7, off=1000 + 10 * j))
    assert _sums(TP, mi) == _sums(JP, ref)
    cell = m.snapshot()["by_index"]["mut"]
    assert cell["compactions"] >= 1 and cell["last_compact_ms"] is not None


def test_compactor_loop_records_failure_and_retries():
    mi = _mk(TP, n=30)
    mi.append_rows(_rows(TP, 5, off=300))
    c = TP.storage.Compactor(mi, min_deltas=1, interval_s=0.002)
    with TP.faults.active(TP.faults.FaultPlan(
            [{"site": "storage:compact", "at": [0], "error": "fatal"}])):
        with c:
            _wait_until(lambda: mi.delta_count == 0)
    snap = c.snapshot()
    assert snap["failures"] >= 1 and "InjectedFatalError" in snap["last_error"]
    assert snap["compactions"] >= 1
    _sums(TP, mi)


@pytest.mark.parametrize("hit", [0, 1], ids=["at-entry", "pre-swap"])
def test_compact_crash_leaves_tier_set_intact_and_retryable(hit):
    def script(pkg):
        mi = _mk(pkg, n=60)
        mi.append_rows(_rows(pkg, 9, off=300))
        mi.append_rows(_rows(pkg, 9, off=400))
        epoch0, deltas0 = mi.epoch, mi.delta_count
        before = _blocks(mi.find_rows_many([("k001",), ("zz",)]))
        with pkg.faults.active(pkg.faults.FaultPlan(
                [{"site": "storage:compact", "at": [hit], "error": "fatal"}])):
            with pytest.raises(pkg.faults.InjectedFatalError):
                mi.compact_once()
        assert (mi.epoch, mi.delta_count) == (epoch0, deltas0)
        assert _blocks(mi.find_rows_many([("k001",), ("zz",)])) == before
        yield _sums(pkg, mi)
        stats = mi.compact_once()
        yield stats["deltas"], mi.delta_count, _sums(pkg, mi)

    _both(script)


def test_compactions_and_warm_lookups_build_no_kernel():
    """Compactions upload with torch and build nothing: the recompile
    counters stay where they were across appends, compactions and warm
    lookups (the reference's zero-recompile contract)."""
    from csvplus_tpu_torch.obs.recompile import RecompileWatch

    mi = _mk(TP, n=400, keyspace=41)
    probes = [(f"k{i:03d}",) for i in range(41)] + [("zz",)]
    mi.find_rows_many(probes)
    with RecompileWatch() as w:
        for j in range(3):
            mi.append_rows(_rows(TP, 15, off=600 + 20 * j, keyspace=41))
            mi.compact_step(ratio=2)
        mi.compact_once()
        for _ in range(3):
            mi.find_rows_many(probes)
    assert w.observable()
    w.assert_zero("appends, compactions and warm lookups")


# -- durability ---------------------------------------------------------------


def test_durable_roundtrip_and_recovery_parity(tmp_path):
    def script(pkg):
        d = str(tmp_path / pkg.name)
        mi = pkg.storage.MutableIndex.create(
            pkg.take_rows(_rows(pkg, 60)), ["k"], ingest_device="cpu", directory=d,
            wal_sync="always")
        mi.append_rows(_rows(pkg, 9, off=100))
        mi.delete(("k001",))
        mi.append_rows(_rows(pkg, 5, off=200))
        snap = mi.snapshot()
        yield snap["wal"]["records"], snap["checkpoint"], _sums(pkg, mi)
        re1 = pkg.storage.MutableIndex.open(d, ingest_device="cpu")
        yield re1.recovered_records, _sums(pkg, re1)
        with pytest.raises(Exception, match="use MutableIndex.open"):
            pkg.storage.MutableIndex.create(pkg.take_rows(_rows(pkg, 4)), ["k"],
                                            ingest_device="cpu", directory=d)
        mi.compact_once()
        re2 = pkg.storage.MutableIndex.open(d, ingest_device="cpu")
        yield re2.recovered_records, _sums(pkg, re2), sorted(os.listdir(d))
        mi.append_rows(_rows(pkg, 4, off=300))
        mi.delete(("k002",))
        re3 = pkg.storage.MutableIndex.open(d, ingest_device="cpu")
        yield re3.recovered_records, _sums(pkg, re3)
        mi.close()

    _both(script)


def test_wal_sync_modes_and_stats(tmp_path):
    def script(pkg):
        yield pkg.storage.wal_sync_mode("batch")
        with pytest.raises(ValueError):
            pkg.storage.wal_sync_mode("sometimes")
        d = str(tmp_path / pkg.name)
        mi = pkg.storage.MutableIndex.create(pkg.take_rows(_rows(pkg, 30)), ["k"],
                                             ingest_device="cpu", directory=d, wal_sync="batch")
        mi.append_rows(_rows(pkg, 5, off=100))
        mi.append_rows(_rows(pkg, 5, off=200))
        delta = mi.wal_sync()
        yield delta["records"], delta["bytes"], delta["fsyncs"] >= 1
        yield mi.wal_sync()["records"]
        yield _mk(pkg, n=20).wal_sync()
        yield _sums(pkg, pkg.storage.MutableIndex.open(d, ingest_device="cpu"))

    _both(script)


def _durable_history(pkg, d, base_src):
    """A durable index in *d* with a checkpoint behind it and a WAL tail
    in front: every kind of file the directory holds."""
    mi = pkg.storage.MutableIndex.create(base_src, ["k"], ingest_device="cpu", directory=d)
    mi.append_rows([{"k": "k001", "v": "a"}, {"k": "zz", "v": "b"}])
    mi.delete(("k004",))
    mi.compact_once()
    mi.append_rows([{"k": "k004", "v": "back"}, {"k": "k002", "v": "c"}])
    mi.delete(("k005",))
    mi.close()
    return _sums(pkg, mi)


BASES = {
    "v1-host-base": lambda pkg, tmp: pkg.take_rows(_rows(pkg, 80)),
    "v2-columnar-base": lambda pkg, tmp: pkg.take_rows(_rows(pkg, 80)).on_device("cpu"),
    "v3-lane-base": None,  # a streamed file whose key column is a lane column
}


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("base", sorted(BASES))
def test_directory_written_by_either_package_opens_in_the_other(tmp_path, monkeypatch, base,
                                                                  writer):
    """The manifest, the WAL segments, the checkpointed bases and the
    prune sidecars one package writes recover in the other to the same
    checksums, and to the writer's own live state."""
    w, r = (TP, JP) if writer == "port" else (JP, TP)
    d = str(tmp_path / "idx")
    if base == "v3-lane-base":
        monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")
        monkeypatch.setenv("CSVPLUS_STREAM_CHUNK_BYTES", "256")
        monkeypatch.setenv("CSVPLUS_DICT_DEVICE_MIN_DISTINCT", "8")
        p = tmp_path / "base.csv"
        p.write_text("k,v\n" + "".join(f"k{i % 40:03d},v{i}\n" for i in range(120)))
        src = w.root.from_file(str(p)).on_device("cpu")
        assert src.plan.table.columns["k"].dev_dictionary is not None
    else:
        src = BASES[base](w, tmp_path)
    live = _durable_history(w, d, src)
    names = sorted(os.listdir(d))
    assert "MANIFEST.json" in names and any(n.startswith("prune-") for n in names)
    assert any(n.startswith("wal-") for n in names)
    with open(os.path.join(d, "MANIFEST.json")) as f:
        man = json.load(f)
    reopened = r.storage.MutableIndex.open(d, ingest_device="cpu")
    assert reopened.recovered_records == 2
    assert _sums(r, reopened) == live
    assert man["applied_lsn"] == 2


@pytest.mark.parametrize("base", sorted(BASES))
def test_first_base_files_load_in_the_other_package(tmp_path, monkeypatch, base):
    """The base a fresh durable directory writes (index file versions 1,
    2 and 3) and its prune sidecar load in the other package."""
    for w, r in ((TP, JP), (JP, TP)):
        d = str(tmp_path / f"{w.name}-idx")
        if base == "v3-lane-base":
            monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")
            monkeypatch.setenv("CSVPLUS_STREAM_CHUNK_BYTES", "256")
            monkeypatch.setenv("CSVPLUS_DICT_DEVICE_MIN_DISTINCT", "8")
            p = tmp_path / "base.csv"
            p.write_text("k,v\n" + "".join(f"k{i % 40:03d},v{i}\n" for i in range(120)))
            src = w.root.from_file(str(p)).on_device("cpu")
        else:
            src = BASES[base](w, tmp_path)
        mi = w.storage.MutableIndex.create(src, ["k"], ingest_device="cpu", directory=d)
        path = os.path.join(d, "base-00000001.idx")
        with open(path, "rb") as f:
            head = f.read(2)
        if base == "v1-host-base":
            assert head != b"PK"
        else:
            import numpy as _np

            with _np.load(path) as z:
                meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
            assert meta["version"] == (3 if base == "v3-lane-base" else 2)
        kw = {"device": "cpu"} if r is TP else {}
        loaded = r.root.load_index(path, **kw)
        assert r.storage.index_checksums(loaded) == w.storage.index_checksums(mi.tiers().base)
        side = os.path.join(d, "prune-00000001.flt")
        got = r.storage.load_pruner(side, expect_nrows=len(loaded._impl))
        want = mi.tiers().base_pruner
        assert (got.nrows, got.fence_lo, got.fence_hi, got.m, got.k, got.seed) == (
            want.nrows, want.fence_lo, want.fence_hi, want.m, want.k, want.seed)
        assert np.array_equal(got.bits, want.bits)
        mi.close()


# -- the crash matrix: this file runs itself as the child ---------------------------

CRASH_WINDOWS = {
    "wal_append": ({"site": "storage:wal-write", "at": [2], "error": "fatal"}, 2, 2),
    "wal_delete": ({"site": "storage:wal-write", "at": [3], "error": "fatal"}, 3, 3),
    "segment_seal": ({"site": "storage:wal-write", "at": [4], "error": "fatal"}, 4, 4),
    "manifest_pre_rename": ({"site": "storage:manifest-swap", "at": [0], "error": "fatal"}, 4, 4),
    "manifest_post_rename": ({"site": "storage:manifest-swap", "at": [1], "error": "fatal"},
                             4, 0),
    "sidecar_post_write": ({"site": "storage:prune-sidecar", "at": [1], "error": "fatal"}, 4, 4),
    "torn_tail": (None, 7, 3),
}


def _replay(pkg, acked):
    """A fresh memory-only index fed exactly the acked logical stream."""
    mi = pkg.storage.MutableIndex(_fresh_base(pkg), ingest_device="cpu")
    for op in acked:
        if op["op"] == "rows":
            mi.append_rows(op["rows"])
        else:
            mi.delete(tuple(op["key"]))
    return mi


@pytest.mark.parametrize("window", sorted(CRASH_WINDOWS))
def test_recovery_after_a_crash_mid_write(tmp_path, window):
    """The port's child dies in the window (an injected fatal, then
    ``os._exit``; or a torn final frame); both packages recover the
    directory to the checksums of the acked stream, with the
    reference's counts of acked ops and replayed records."""
    fault, n_acked, n_replay = CRASH_WINDOWS[window]
    work, acked_path = str(tmp_path / "idx"), str(tmp_path / "acked.json")
    env = dict(os.environ, CSVPLUS_WAL_SYNC="always", PYTHONPATH=ROOT)
    env.pop("CSVPLUS_FAULTS", None)
    if fault is not None:
        env["CSVPLUS_FAULTS"] = json.dumps([fault])
    if window == "torn_tail":
        env["CSVPLUS_WAL_CHILD_TEAR"] = "1"
    res = subprocess.run([sys.executable, os.path.abspath(__file__), work, acked_path],
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == (0 if fault is None else 3), res.stderr
    with open(acked_path) as f:
        acked = json.load(f)["ops"]
    assert len(acked) == n_acked
    want = _sums(JP, _replay(JP, acked))
    assert _sums(TP, _replay(TP, acked)) == want
    port = TP.storage.MutableIndex.open(work, ingest_device="cpu")
    assert port.recovered_records == n_replay
    assert _sums(TP, port) == want
    port.close()
    ref = JP.storage.MutableIndex.open(work)
    assert _sums(JP, ref) == want
    ref.close()


# -- LookupServer's write surface -------------------------------------------------


def test_server_append_delete_acks_read_back_as_the_reference(tmp_path):
    """Appends and deletes through the server: the same acks, the same
    rows read back in the same cycle and after, the same per-index
    counters, on durable indexes."""
    def script(pkg):
        srv_mod = __import__(f"{pkg.name}.serve", fromlist=["LookupServer"])
        mi = _mk(pkg, n=60, directory=str(tmp_path / pkg.name), wal_sync="batch")
        srv = srv_mod.LookupServer(indexes={"m": mi}).start()
        try:
            futs = [srv.submit_append([{"k": "k001", "v": "new1"}, {"k": "zz", "v": "z"}],
                                      index="m"),
                    srv.submit_delete("k002", index="m"),
                    srv.submit("k002", index="m"),
                    srv.submit_append([{"k": "k002", "v": "again"}], index="m"),
                    srv.submit("k001", index="m")]
            vals = [f.result(30) for f in futs]
            yield [[dict(r) for r in v] if isinstance(v, list) else v for v in vals]
            yield [dict(r) for r in srv.submit("k002", index="m").result(30)]
            with pytest.raises(TypeError):
                srv_mod.LookupServer(_mk(pkg, n=5).to_index()).submit_append([{"k": "a"}])
            with pytest.raises(ValueError):
                srv.submit_delete(("a", "b"), index="m")
            with pytest.raises(ValueError):
                srv.submit_append([], index="m")
        finally:
            srv.stop() if pkg is JP else srv.stop(30)
        cell = srv.snapshot()["by_index"]["m"]
        yield {k: cell[k] for k in ("append_reqs", "delete_reqs", "rows_appended",
                                    "deltas_live", "wal_records")}
        yield _sums(pkg, mi)
        mi.close()
        yield _sums(pkg, pkg.storage.MutableIndex.open(str(tmp_path / pkg.name),
                                                       ingest_device="cpu"))

    got = _both(script)
    assert got[0][0] == 2 and got[0][1] == 1


def test_server_write_to_an_immutable_index_is_refused():
    from csvplus_tpu_torch.serve import LookupServer

    idx = _mk(TP, n=5).to_index()
    srv = LookupServer(idx)
    with pytest.raises(TypeError):
        srv.submit_append([{"k": "a"}])
    with pytest.raises(TypeError):
        srv.submit_delete("a")
