"""A join's probe translation on the device, held against the host table.

``StringColumn.renumbered_to_col`` translates a probe column's codes into
a build column's code space on the device: both dictionaries in their
search form (two lanes folded into one int64 key for fields of up to 8
bytes, the k-lane search past that), one search of the probe's entries
in the build's, one gather of the codes.  A host dictionary's search
form is packed and uploaded once and shared by every copy of its column.
The answer must be the codes ``renumbered_to``'s host ``np.searchsorted``
table gives, bit for bit, for host and lane dictionaries on either side,
sharded or not; and a join through it must equal the reference's."""

import sys
import threading

import numpy as np
import pytest
import torch

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu.utils.checksum import checksum_device_table as j_checksum
from csvplus_tpu_torch.columnar.table import PAD_CODE, DeviceTable, StringColumn
from csvplus_tpu_torch.ops import lanes as TL
from csvplus_tpu_torch.parallel.mesh import ShardedRows, make_mesh
from csvplus_tpu_torch.utils.checksum import checksum_device_table as t_checksum
from csvplus_tpu_torch.utils.observe import telemetry as t_tel

ALPHABET = np.frombuffer(b"ab\x00c~\xff", dtype=np.uint8)


def _dict(rng, n: int, width: int) -> np.ndarray:
    """Up to *n* sorted distinct 'S' values of 0..*width* bytes over a
    small alphabet with NUL and 0xFF in it, so prefixes, embedded NULs
    and the sign flip all come up."""
    if n == 0:
        return np.empty(0, dtype="S1")
    lens = rng.integers(0, width + 1, n)
    lens[0] = width  # the dtype is as wide as the case says
    vals = {ALPHABET[rng.integers(0, ALPHABET.size, k)].tobytes() for k in lens}
    return np.unique(np.array(sorted(vals), dtype=f"S{width}"))


def _overlap(rng, probe: np.ndarray, build: np.ndarray, how: str):
    """(probe, build) made disjoint, the probe a subset of the build, a
    superset of it, or half shared."""
    if how == "disjoint":
        return probe, np.setdiff1d(build, probe)
    if how == "subset":
        return probe, np.union1d(build, probe)
    if how == "superset":
        return np.union1d(probe, build), build
    return probe, np.union1d(build, probe[::2])


def _narrow(d: np.ndarray) -> np.ndarray:
    """*d*'s entries a lane dictionary can hold (at most ``MAX_LANE_BYTES``)."""
    cap = TL.MAX_LANE_BYTES
    return d[np.char.str_len(d) <= cap].astype(f"S{min(d.dtype.itemsize, cap)}")


def _lane_col(d: np.ndarray, codes: torch.Tensor) -> StringColumn:
    lanes = TL.pack_host(d, TL.lanes_for_width(d.dtype.itemsize if d.size else 1))
    return StringColumn(None, codes, dev_dictionary=tuple(torch.from_numpy(x) for x in lanes))


def _codes(rng, n_dict: int, rows: int = 300) -> torch.Tensor:
    """Codes into a dictionary of *n_dict* slots with absent (-1) cells."""
    return torch.from_numpy(rng.integers(-1, max(n_dict, 1), rows).astype(np.int32)) \
        if n_dict else torch.full((rows,), -1, dtype=torch.int32)


def _host_table(probe: np.ndarray, build: np.ndarray, codes: torch.Tensor) -> np.ndarray:
    """``renumbered_to``'s host translation of *codes* (the reference)."""
    return StringColumn(probe, codes).renumbered_to(build).numpy()


def _storage_np(x) -> np.ndarray:
    if isinstance(x, ShardedRows):
        return np.concatenate([s.numpy() for s in x.shards])
    return x.numpy()


#: (probe width, build width): 1-8 bytes search a folded int64 key, 9-32
#: the k-lane search, past 32 two host dictionaries search at any width
#: and a lane side leaves the host side's wide entries out (the slot map)
WIDTHS = [(1, 1), (3, 6), (6, 8), (8, 2), (12, 5), (7, 20), (32, 32), (40, 40), (36, 9), (9, 44)]
SIDES = ["host-host", "lane-host", "host-lane", "lane-lane"]


def _cases():
    cap = TL.MAX_LANE_BYTES
    for wq, wb in WIDTHS:
        for sides in SIDES:
            if sides == "lane-lane" and max(wq, wb) > cap:
                continue
            # a lane side stays within the lane cap
            q = min(wq, cap) if sides.startswith("lane") else wq
            b = min(wb, cap) if sides.endswith("lane") else wb
            yield pytest.param(q, b, sides, "half", id=f"{q}-{b}-{sides}")
    for how in ["disjoint", "subset", "superset"]:
        for wq, wb in [(6, 6), (16, 10)]:
            yield pytest.param(wq, wb, "host-host", how, id=f"{wq}-{wb}-{how}")
    for empty in ["empty-probe", "empty-build"]:
        for sides in SIDES:
            yield pytest.param(4, 4, sides, empty, id=f"{empty}-{sides}")
    yield pytest.param(8, 8, "host-host", "nuls", id="trailing-nuls")
    yield pytest.param(6, 6, "host-host", "mesh", id="mesh8-host-host")
    yield pytest.param(20, 6, "lane-host", "mesh", id="mesh8-lane-host")


@pytest.mark.parametrize("wq,wb,sides,how", list(_cases()))
def test_device_translation_equals_the_host_table(wq, wb, sides, how):
    rng = np.random.default_rng([wq, wb, len(sides), len(how)])
    probe, build = _dict(rng, 120, wq), _dict(rng, 150, wb)
    if how == "empty-probe":
        probe = probe[:0]
    elif how == "empty-build":
        build = build[:0]
    elif how == "nuls":
        # values equal up to trailing NULs are one value: the probe's wider
        # dtype pads them with NULs the build's does not hold, and values
        # with an embedded NUL differ from those without
        base = [b"", b"a", b"ab", b"a\x00b", b"ab\x00\x00c", b"\x00", b"\x00\x00a"]
        probe = np.unique(np.array(base + [b"ab\x00c\x00\x00"], dtype="S8"))
        build = np.unique(np.array(base[1:4] + [b"ab\x00c"], dtype="S5"))
    elif how != "mesh":
        probe, build = _overlap(rng, probe, build, how)
    probe = _narrow(probe) if sides.startswith("lane") else probe
    build = _narrow(build) if sides.endswith("lane") else build
    codes = _codes(rng, probe.size)
    want = _host_table(probe, build, codes)
    q = _lane_col(probe, codes) if sides.startswith("lane") else StringColumn(probe, codes)
    b_codes = torch.zeros(4, dtype=torch.int32)
    b = _lane_col(build, b_codes) if sides.endswith("lane") else StringColumn(build, b_codes)
    if how == "mesh":
        mesh = make_mesh(8, devices=["cpu"] * 8)
        q = DeviceTable({"k": q}, codes.shape[0], torch.device("cpu")).with_sharding(mesh).columns["k"]
        assert isinstance(q.storage, ShardedRows)
    tally = {}
    got = q.renumbered_to_col(b, tally)
    assert isinstance(got, ShardedRows) == (how == "mesh")
    got = _storage_np(got)
    assert got.dtype == np.int32
    assert np.array_equal(got[: want.size], want)
    assert (got[want.size:] == PAD_CODE).all()  # the mesh's tail pads pass through
    searched = int(np.sum(np.char.str_len(probe) <= TL.MAX_LANE_BYTES)) \
        if sides != "host-host" else probe.size
    assert tally["host_entries"] == 0 and tally["device_entries"] == searched


@pytest.mark.parametrize("n_lanes", [2, 4, 8])
def test_translate_lanes_searches_lane_dictionaries_like_the_host(n_lanes):
    """``translate_lanes`` (lane dictionaries, ``find_codes``) takes the
    folded int64 search at two lanes and the k-lane search past them."""
    rng = np.random.default_rng(n_lanes)
    build = _dict(rng, 200, 4 * n_lanes)
    query = np.union1d(_dict(rng, 90, 4 * n_lanes), build[::5])
    bl = tuple(torch.from_numpy(x) for x in TL.pack_host(build, n_lanes))
    ql = tuple(torch.from_numpy(x) for x in TL.pack_host(query, n_lanes))
    assert len(TL.fold_lanes(bl)) == (1 if n_lanes == 2 else n_lanes)
    pos = np.clip(np.searchsorted(build, query), 0, build.size - 1)
    want = np.where(build[pos] == query, pos, -1)
    got = TL.translate_lanes(bl, ql)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def _encoded(seed: int, n: int = 5000):
    """An orders table (host-dictionary ``cust_id``/``prod_id``) and a
    customers index on ``cust_id``, through the port."""
    rng = np.random.default_rng(seed)
    cust = T.take_rows([T.Row({"cust_id": f"c{i}", "name": f"n{i}"}) for i in range(0, 400, 3)]) \
        .on_device("cpu").unique_index_on("cust_id")
    orders = T.take_rows([T.Row({"oid": str(i), "cust_id": f"c{int(rng.integers(400))}",
                                 "prod_id": f"p{int(rng.integers(9))}"}) for i in range(n)]) \
        .on_device("cpu")
    return orders, cust


def _counting_packs(monkeypatch) -> list:
    calls = []
    real = TL.pack_host

    def counted(d, lanes):
        calls.append(int(d.shape[0]))
        return real(d, lanes)

    monkeypatch.setattr(TL, "pack_host", counted)
    return calls


def test_twenty_filtered_copies_pack_each_dictionary_once(monkeypatch):
    orders, cust = _encoded(1)
    packs = _counting_packs(monkeypatch)
    probe_col = orders.plan.table.columns["cust_id"]
    build_col = cust.device_table.table.columns["cust_id"]
    seen = []
    with t_tel.collect():
        for i in range(20):
            src = orders.filter(T.Not(T.Like({"prod_id": f"p{i % 9}"}))).join(cust, "cust_id")
            seen.append(len(src.to_rows()))
        recs = [r for r in t_tel.records if r.stage == "join:translate"]
    assert len(recs) == 20 and all(seen)
    # one pack of the orders' dictionary, one of the customers'
    assert sorted(packs) == sorted([probe_col.dict_size, build_col.dict_size])
    assert [r.extra["host_entries"] for r in recs] == [0] * 20
    assert [r.extra["device_entries"] for r in recs] == [probe_col.dict_size] * 20
    first, *rest = [r.extra["h2d_bytes"] for r in recs]
    assert first == 8 * (probe_col.dict_size + build_col.dict_size) and rest == [0] * 19


def test_every_copy_of_a_column_finds_its_resident_lanes(monkeypatch):
    orders, cust = _encoded(2)
    col = orders.plan.table.columns["cust_id"]
    build = cust.device_table.table.columns["cust_id"]
    col.renumbered_to_col(build)  # packs both
    packs = _counting_packs(monkeypatch)
    sel = torch.arange(0, col.storage.shape[0], 7)
    mesh = make_mesh(8, devices=["cpu"] * 8)
    sharded = DeviceTable({"k": col}, int(col.storage.shape[0]), torch.device("cpu")) \
        .with_sharding(mesh).columns["k"]
    copies = [col.gather(sel), col.with_codes(col.storage[:100]), sharded, sharded.shard(3),
              sharded.gather(ShardedRows(mesh, [torch.arange(0, 5)] * 8))]
    for c in copies:
        assert c._host_lanes is col._host_lanes
        tally = {}
        got = _storage_np(c.renumbered_to_col(build, tally))
        want = _storage_np(c.storage)
        want = np.where(want >= 0, _host_table(col.dictionary, build.dictionary,
                                               torch.from_numpy(want.clip(0))).astype(np.int32),
                        want)
        assert np.array_equal(got, want)
        assert tally == {"host_entries": 0, "device_entries": col.dict_size, "h2d_bytes": 0}
    assert packs == []


class _NoSync:
    """Makes every host read of a tensor raise while armed."""

    NAMES = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__", "nonzero")

    def __init__(self, monkeypatch):
        self.armed = False
        for name in self.NAMES:
            real = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._guard(name, real))

    def _guard(self, name, real):
        def guarded(t, *a, **k):
            if self.armed:
                raise AssertionError(f"host sync: Tensor.{name}")
            return real(t, *a, **k)
        return guarded


def test_the_translation_adds_no_host_sync(monkeypatch):
    orders, cust = _encoded(3)
    col = orders.plan.table.columns["cust_id"].gather(torch.arange(0, 5000, 2))
    build = cust.device_table.table.columns["cust_id"]
    col.renumbered_to_col(build)  # the first call packs from host memory
    guard = _NoSync(monkeypatch)
    with t_tel.collect():
        before = t_tel.host_sync_elements
        guard.armed = True
        try:
            with t_tel.stage("join:translate", 2500) as stage:
                got = col.renumbered_to_col(build, stage)
        finally:
            guard.armed = False
        assert t_tel.host_sync_elements == before
    want = _host_table(col.dictionary, build.dictionary, col.storage)
    assert np.array_equal(got.numpy(), want)


def test_concurrent_probes_pack_each_dictionary_once(monkeypatch):
    """Sixteen threads translate fresh copies of one column against one
    build column at once: the shared state packs each dictionary once and
    every thread gets the host table's answer."""
    orders, cust = _encoded(4)
    col = orders.plan.table.columns["cust_id"]
    build = cust.device_table.table.columns["cust_id"]
    want = _host_table(col.dictionary, build.dictionary, col.storage)
    packs = _counting_packs(monkeypatch)
    out, start = [None] * 16, threading.Barrier(16, timeout=30)

    def probe(i):
        start.wait()
        out[i] = col.gather(torch.arange(col.storage.shape[0])).renumbered_to_col(build).numpy()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=probe, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sorted(packs) == sorted([col.dict_size, build.dict_size])
    assert all(np.array_equal(o, want) for o in out)


@pytest.mark.parametrize("sharded", [False, True], ids=["one-device", "mesh8"])
def test_a_join_on_host_dictionaries_equals_the_reference(corpus, monkeypatch, sharded):
    """The 3-table join with every key a host dictionary (typed lanes
    off): the port's rows and positional checksums equal the
    reference's, and the port translated on the device."""
    monkeypatch.setenv("CSVPLUS_TYPED_LANES", "0")

    def run(pkg):
        cust = pkg.from_file(corpus["people_csv"]).on_device("cpu").unique_index_on("id")
        prod = pkg.from_file(corpus["stock_csv"]).on_device("cpu").unique_index_on("prod_id")
        src = pkg.from_file(corpus["orders_csv"])
        src = src.on_device("cpu", shards=8) if sharded else src.on_device("cpu")
        assert src.plan.table.columns["cust_id"].kind == "str"
        src = src.filter(pkg.Not(pkg.Like({"qty": "7"}))).join(cust, "cust_id").join(prod)
        table = src.to_device_table()
        cols = sorted(table.columns)
        chk = t_checksum if pkg is T else j_checksum
        return [r for r in src.to_rows()], chk(table, cols, positional=True)

    with t_tel.collect():
        got = run(T)
        recs = [r for r in t_tel.records if r.stage == "join:translate"]
    want = run(J)
    assert [dict(r) for r in got[0]] == [dict(r) for r in want[0]] and len(got[0]) > 0
    assert got[1] == want[1]
    assert recs and all(r.extra["host_entries"] == 0 and r.extra["device_entries"] > 0
                        for r in recs)
