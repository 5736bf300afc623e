"""The rest of the port's ``Index`` API held against the JAX package on
the CPU, on the same bytes made from a seed with numpy:

* ``resolve_duplicates`` with a callback on a device-lazy index (fault
  F1): rows, ``len``, ``find`` / ``find_many``, the callback's calls
  (count, order and arguments) and the index's placement (``dev`` set,
  ``is_lazy``) equal the reference's for member-returning,
  group-dropping, new-row and member-mutating callbacks; a raising
  callback leaves both indexes as they were;
* ``write_to`` / ``load_index``: the JSON-lines format (version 1) of a
  host index, the columnar npz (version 2) and, with a lane-dictionary
  column, version 3 (whose reload builds no host dictionary); a file
  written by either package loads in the other with equal rows and
  checksums; the three error messages; a failed write leaves no file;
* ``for row in src`` and ``for row in idx``, and an abandoned iterator
  stops its producer;
* the package's exported names."""

import json
import threading
import zipfile

import numpy as np
import pytest
import torch

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu.utils.checksum import checksum_device_table as j_checksum
from csvplus_tpu_torch.utils.checksum import checksum_device_table as t_checksum

PKGS = {"ref": J, "port": T}


def _csv(tmp_path, n=2000, keys=300, seed=1, name="dups.csv"):
    """``k`` zero-padded over *keys* values (so ~n/keys rows a key), ``v``
    the row number, ``w`` a small-cardinality payload."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, keys, n)
    w = rng.integers(0, 5, n)
    p = tmp_path / name
    p.write_text("k,v,w\n" + "".join(f"k{a:05d},{i},w{b}\n"
                                     for i, (a, b) in enumerate(zip(k.tolist(), w.tolist()))))
    return str(p)


def _index(pkg, path, *cols):
    return pkg.from_file(path).on_device("cpu").index_on(*(cols or ("k",)))


def _state(idx):
    """Everything a caller can observe, placement included."""
    impl = idx._impl
    placed = (impl.dev is not None, impl.is_lazy)
    found = [dict(r) for r in idx.find("k00007").to_rows()]
    many = [[dict(r) for r in s.to_rows()] for s in idx.find_many(["k00003", "k00299", "nope"])]
    return placed, len(idx), found, many, [dict(r) for r in idx]


CALLBACKS = {
    # keep the latest version of each key: always a member
    "member": lambda pkg: lambda g: max(g, key=lambda r: int(r["v"])),
    # drop odd-led groups, keep the first row of the others
    "drop": lambda pkg: lambda g: None if int(g[0]["v"]) % 2 else g[0],
    # an empty row drops too; shorter than the key list
    "empty-row": lambda pkg: lambda g: pkg.Row() if len(g) > 7 else g[-1],
    # a brand-new row for groups of exactly 6
    "new-row": lambda pkg: lambda g: pkg.Row({"k": g[0]["k"], "v": "new"}) if len(g) == 6
    else g[0],
    # mutates a member and returns it: that is a new row
    "mutated-member": lambda pkg: lambda g: (g[0].__setitem__("w", "zz"), g[0])[1],
    # mutates one member, returns another (unchanged) one: a member
    "mutate-other": lambda pkg: lambda g: (g[0].__setitem__("w", "zz"), g[-1])[1],
}
ON_DEVICE = {"member", "drop", "empty-row", "mutate-other"}


@pytest.mark.parametrize("kind", sorted(CALLBACKS))
def test_callback_dedup_matches_reference_rows_and_placement(tmp_path, kind):
    path = _csv(tmp_path)
    out = {}
    for side, pkg in PKGS.items():
        idx = _index(pkg, path)
        assert idx._impl.is_lazy and idx._impl.dev is not None
        calls = []
        cb = CALLBACKS[kind](pkg)

        def f(g, cb=cb, calls=calls):
            calls.append([dict(r) for r in g])
            return cb(g)

        idx.resolve_duplicates(f)
        out[side] = (_state(idx), calls)
    (ref_state, ref_calls), (state, calls) = out["ref"], out["port"]
    # the callback ran once per duplicate group, in index order, on the
    # same rows
    assert calls == ref_calls and len(calls) > 50
    assert [g[0]["k"] for g in calls] == sorted(g[0]["k"] for g in calls)
    assert state == ref_state
    assert state[0] == ((True, True) if kind in ON_DEVICE else (False, False))


@pytest.mark.parametrize("kind", ["member", "drop", "new-row"])
def test_callback_dedup_equals_the_host_dedup(tmp_path, kind):
    """The device dedup (only the groups decoded, vectorized group ids)
    gives the host dedup's rows and calls on a materialized index."""
    path = _csv(tmp_path)
    got = []
    for materialize in (False, True):
        idx = _index(T, path)
        if materialize:
            idx.materialize()
        calls = []
        cb = CALLBACKS[kind](T)
        idx.resolve_duplicates(lambda g, cb=cb: (calls.append([dict(r) for r in g]), cb(g))[1])
        got.append(([dict(r) for r in idx], calls, len(idx)))
    assert got[0] == got[1]


TWO_KEY_CALLBACKS = {
    "member": CALLBACKS["member"],
    # a new row that keeps both key cells
    "new-row": lambda pkg: lambda g: pkg.Row({**g[0], "v": "new"}) if len(g) == 3 else g[0],
}


@pytest.mark.parametrize("kind", sorted(TWO_KEY_CALLBACKS))
def test_callback_dedup_on_two_key_columns_matches_reference(tmp_path, kind):
    path = _csv(tmp_path, keys=60)
    out = {}
    for side, pkg in PKGS.items():
        idx = _index(pkg, path, "w", "k")
        calls = []
        cb = TWO_KEY_CALLBACKS[kind](pkg)
        idx.resolve_duplicates(lambda g, cb=cb: (calls.append([dict(r) for r in g]), cb(g))[1])
        placed = (idx._impl.dev is not None, idx._impl.is_lazy)
        found = [dict(r) for r in idx.find("w3").to_rows()]
        out[side] = (placed, calls, found, [dict(r) for r in idx])
    assert out["port"] == out["ref"]
    assert out["port"][0] == ((True, True) if kind == "member" else (False, False))


def test_callback_dedup_without_duplicates_keeps_the_index(tmp_path):
    path = _csv(tmp_path, n=200, keys=10_000)
    for pkg in (J, T):
        idx = pkg.from_file(path).on_device("cpu").unique_index_on("v")
        dev = idx._impl.dev
        idx.resolve_duplicates(lambda g: pytest.fail("no group to resolve"))
        assert idx._impl.dev is dev and idx._impl.is_lazy


def test_raising_callback_leaves_both_indexes_unchanged(tmp_path):
    path = _csv(tmp_path)
    out = {}
    for side, pkg in PKGS.items():
        idx = _index(pkg, path)
        before = (len(idx), idx._impl.dev)
        seen = []

        def boom(g, seen=seen):
            seen.append(1)
            if len(seen) == 5:
                raise KeyError("stop")
            return g[0]

        with pytest.raises(KeyError):
            idx.resolve_duplicates(boom)
        assert (len(idx), idx._impl.dev) == before and idx._impl.is_lazy
        out[side] = (_state(idx), len(seen))
    assert out["port"] == out["ref"]


def test_dedup_then_join_stays_on_the_device(tmp_path):
    """After a member-returning dedup the index still joins on the device
    (a Lookup-free plan over it lowers), equal to the reference."""
    path = _csv(tmp_path)
    out = []
    for pkg in (J, T):
        idx = _index(pkg, path)
        idx.resolve_duplicates(CALLBACKS["member"](pkg))
        probe = pkg.take_rows([pkg.Row({"k": f"k{i:05d}", "x": str(i)}) for i in range(0, 300, 7)])
        out.append(probe.on_device("cpu").join(idx, "k").to_rows())
        assert idx.device_table is idx._impl.dev is not None
    assert out[0] == out[1] and len(out[1]) == 43


# -- persistence -------------------------------------------------------------


def _lane_env(monkeypatch):
    monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")
    monkeypatch.setenv("CSVPLUS_STREAM_CHUNK_BYTES", "8192")
    monkeypatch.setenv("CSVPLUS_DICT_DEVICE_MIN_DISTINCT", "100")


def _written(tmp_path, pkg, path, kind):
    idx = _index(pkg, path)
    if kind == "v1":
        idx.resolve_duplicates(CALLBACKS["new-row"](pkg))  # now a host index
        assert not idx._impl.is_lazy
    else:
        idx.resolve_duplicates("last")
    fn = str(tmp_path / f"{pkg.__name__}-{kind}.idx")
    # written first: a decode caches the lane column's host dictionary
    idx.write_to(fn)
    chk = None if kind == "v1" else (j_checksum if pkg is J else t_checksum)(idx._impl.dev.table)
    want = [dict(r) for r in take_rows_of(idx)]
    return fn, want, chk


def take_rows_of(idx):
    """The index's rows without materializing it (a find of everything)."""
    return idx.find().to_rows()


def _version(fn):
    with open(fn, "rb") as f:
        head = f.read(2)
    if head == b"PK":
        with zipfile.ZipFile(fn) as z:
            meta = json.loads(np.load(z.open("__meta__.npy")).tobytes())
        return meta["version"]
    with open(fn) as f:
        return json.loads(f.readline())["version"]


@pytest.mark.parametrize("kind", ["v1", "v2", "v3"])
def test_write_and_load_round_trip_across_packages(tmp_path, monkeypatch, kind):
    if kind == "v3":
        _lane_env(monkeypatch)
    path = _csv(tmp_path)
    written = {side: _written(tmp_path, pkg, path, kind) for side, pkg in PKGS.items()}
    for side in PKGS:
        assert _version(written[side][0]) == int(kind[1])
    assert written["port"][1] == written["ref"][1]
    for reader_side, pkg in PKGS.items():
        for writer_side, (fn, want, chk) in written.items():
            idx = pkg.load_index(fn, device="cpu")
            impl = idx._impl
            if kind == "v1":
                assert not impl.is_lazy and impl.dev is None
            else:
                assert impl.is_lazy and impl.dev is not None
                table = impl.dev.table
                lane = table.columns["k"]
                # v3: sorted lanes straight back, no host dictionary
                assert (lane._dictionary is None) == (kind == "v3")
                got_chk = (j_checksum if pkg is J else t_checksum)(table)
                assert got_chk == written["ref"][2] == written["port"][2]
            assert [dict(r) for r in take_rows_of(idx)] == want, (reader_side, writer_side)
            assert [dict(r) for r in idx.find("k00042").to_rows()] == [
                r for r in want if r["k"] == "k00042"]


def test_a_small_decode_leaves_the_ports_lane_file_at_v3(tmp_path, monkeypatch):
    """A ``find`` that decodes a few rows of a lane column makes the
    reference build the column's host dictionary, so its ``write_to``
    writes version 2; the port decodes the rows' lanes gathered on the
    device, builds no host dictionary and writes version 3 (a difference
    by design).  Each package loads both files to the same rows."""
    _lane_env(monkeypatch)
    path = _csv(tmp_path)
    fns, found = {}, {}
    for side, pkg in PKGS.items():
        idx = _index(pkg, path)
        idx.resolve_duplicates("last")
        found[side] = [dict(r) for r in idx.find("k00007").to_rows()]
        fns[side] = str(tmp_path / f"{side}.idx")
        idx.write_to(fns[side])
    assert found["port"] == found["ref"] != []
    assert (_version(fns["ref"]), _version(fns["port"])) == (2, 3)
    rows = [[dict(r) for r in take_rows_of(pkg.load_index(fn, device="cpu"))]
            for pkg in PKGS.values() for fn in fns.values()]
    assert all(r == rows[0] for r in rows) and len(rows[0]) == 300

def test_load_index_defaults_to_cuda(tmp_path):
    path = _csv(tmp_path, n=100)
    fn = str(tmp_path / "x.idx")
    _index(T, path).write_to(fn)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        T.load_index(fn)
    assert T.LoadIndex(fn, device="cpu")._impl.dev.table.device.type == "cpu"


def _bad_files(tmp_path):
    p = tmp_path
    (p / "garbage").write_text("hello\n")
    (p / "othermagic").write_text(json.dumps({"magic": "x", "version": 1}) + "\n")
    (p / "version").write_text(json.dumps({"magic": "csvplus-tpu-index", "version": 9}) + "\n")
    (p / "truncated").write_text(json.dumps({"magic": "csvplus-tpu-index", "version": 1,
                                             "columns": ["k"], "count": 3}) + "\n"
                                 + json.dumps({"k": "a"}) + "\n")
    np.savez(p / "npzmeta.npz", __meta__=np.frombuffer(json.dumps(
        {"magic": "csvplus-tpu-index", "version": 7}).encode(), dtype=np.uint8))
    np.savez(p / "npznometa.npz", x=np.zeros(3))
    return ["garbage", "othermagic", "version", "truncated", "npzmeta.npz", "npznometa.npz"]


def test_load_errors_match_reference(tmp_path):
    for name in _bad_files(tmp_path):
        fn = str(tmp_path / name)
        errs = []
        for pkg in (J, T):
            with pytest.raises(ValueError) as ei:
                pkg.load_index(fn, device="cpu")
            errs.append(str(ei.value))
        assert errs[0] == errs[1], name
    msgs = {n: None for n in ("garbage", "version", "truncated")}
    for name in msgs:
        with pytest.raises(ValueError) as ei:
            T.load_index(str(tmp_path / name), device="cpu")
        msgs[name] = str(ei.value)
    assert msgs["garbage"].endswith("not a csvplus-tpu index file")
    assert msgs["version"].endswith("unsupported index version 9")
    assert msgs["truncated"].endswith("truncated index file (1 rows, expected 3)")


@pytest.mark.parametrize("columnar", [False, True])
def test_failed_write_removes_the_file(tmp_path, monkeypatch, columnar):
    path = _csv(tmp_path, n=300)
    idx = _index(T, path)
    if not columnar:
        idx.materialize()
        idx._impl.dev = None
        idx._impl.rows[3]["bad"] = object()  # not JSON-serializable
    else:
        def boom(*a, **k):
            raise OSError("disk full")
        monkeypatch.setattr(np, "savez", boom)
    fn = tmp_path / "out.idx"
    with pytest.raises((TypeError, OSError)):
        idx.write_to(str(fn))
    assert not fn.exists()


# -- iteration ----------------------------------------------------------------


def test_iterating_sources_and_indexes_matches_reference(tmp_path):
    path = _csv(tmp_path, n=500)
    got = {}
    for side, pkg in PKGS.items():
        src = pkg.take(pkg.from_file(path))
        dev = pkg.from_file(path).on_device("cpu")
        idx = _index(pkg, path)
        got[side] = ([dict(r) for r in src], [dict(r) for r in dev.filter(pkg.Like({"w": "w2"}))],
                     [dict(r) for r in idx], [type(r).__name__ for r in idx][:1])
    assert got["port"] == got["ref"]
    assert len(got["port"][0]) == 500 and got["port"][3] == ["Row"]


def test_iteration_clones_rows(tmp_path):
    idx = _index(T, _csv(tmp_path, n=50))
    first = next(iter(idx))
    first["k"] = "changed"
    assert next(iter(idx))["k"] != "changed"


def test_abandoned_iterator_stops_its_producer():
    produced = []
    src = T.take_rows([T.Row({"i": str(i)}) for i in range(50_000)]).transform(
        lambda r: (produced.append(1), r)[1])
    before = {t.ident for t in threading.enumerate()}
    it = iter(src)
    assert [next(it)["i"] for _ in range(3)] == ["0", "1", "2"]
    it.close()
    n = len(produced)
    assert n < 5000  # the bounded queue, not the whole source
    leftover = [t for t in threading.enumerate()
                if t.ident not in before and t.name == "csvplus-relay"]
    assert leftover == []
    assert len(produced) == n  # nothing more after the close


def test_iterator_relays_errors():
    def bad(r):
        if r["i"] == "7":
            raise ValueError("row seven")
        return r

    src = T.take_rows([T.Row({"i": str(i)}) for i in range(20)]).transform(bad)
    with pytest.raises(T.DataSourceError, match="row 7: row seven"):
        list(src)


# -- the package surface --------------------------------------------------------


def test_exported_names_match_reference():
    # storage/ is not ported yet; every other reference export is here
    assert set(J.__all__) - set(T.__all__) == {"storage"}
    assert set(T.__all__) - set(J.__all__) == set()
    assert T.__version__ == J.__version__
    assert T.LoadIndex is T.load_index and T.Index.WriteTo is T.Index.write_to
    for name in T.__all__:
        assert getattr(T, name) is not None
    assert T.telemetry is __import__("csvplus_tpu_torch.utils.observe",
                                     fromlist=["telemetry"]).telemetry
