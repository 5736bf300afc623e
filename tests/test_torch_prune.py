"""The port's LSM read pruning (``csvplus_tpu_torch/storage/prune.py``)
held against the JAX package's on the CPU: the same fences, Bloom bits,
hashes and pass matrices from the same tiers (host-backed and
device-lazy), the same sidecar bytes loaded by either package, the same
probe answers with pruning on and off, the same counters, and the
read-amp-aware compactor's convergence; the cases of
``tests/test_prune.py``."""

import os
import threading
import time

import numpy as np
import pytest

import csvplus_tpu as J
import csvplus_tpu.storage.prune as JPR
import csvplus_tpu_torch as T
import csvplus_tpu_torch.storage.prune as TPR
from csvplus_tpu_torch.obs.recompile import RecompileWatch
from csvplus_tpu_torch.resilience import faults as t_faults
from csvplus_tpu_torch.storage import Compactor, MutableIndex, index_checksums, rebuild_reference
from csvplus_tpu_torch.storage.lsm import tier_rows

SIDES = {"port": (T, TPR), "ref": (J, JPR)}


@pytest.fixture(autouse=True)
def _disarmed():
    t_faults.deactivate()
    yield
    t_faults.deactivate()


def _idx(pkg, rows, cols, device=False):
    src = pkg.take_rows([pkg.Row(r) for r in rows])
    if device:
        src = src.on_device("cpu")
    return pkg.create_index(src, cols)


def _keys_of(impl, cols):
    return [tuple(r[c] for c in cols) for r in tier_rows(impl)]


def _pruner_view(p):
    return (p.nrows, p.fence_lo, p.fence_hi, p.m, p.k, p.seed, p.bits_per_key,
            None if p.bits is None else p.bits.tobytes())


SHAPES = {
    "one-column": (["k"], [{"k": f"k{i:04d}", "v": str(i)} for i in range(500)]),
    "two-columns": (["a", "b"], [{"a": f"a{i % 17:02d}", "b": f"b{i % 29:02d}", "v": str(i)}
                                 for i in range(400)]),
    "single-row": (["k"], [{"k": "only", "v": "1"}]),
    "code-boundaries": (["k"], [{"k": k, "v": "x"} for k in ["a", "aa", "ab", "b", "ba"]]),
    "utf8": (["k"], [{"k": f"Zoë{i % 9}", "v": str(i)} for i in range(40)]),
    "empty": (["k"], []),
}


@pytest.mark.parametrize("device", [False, True], ids=["host", "device-lazy"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_pruner_equals_reference_and_has_no_false_negatives(shape, device):
    """Fences, filter bits and parameters equal the reference's for the
    same tier; every present key (and its prefixes) passes."""
    cols, rows = SHAPES[shape]
    if device and not rows:
        return  # an empty source builds a host index in both packages
    t_idx, j_idx = _idx(T, rows, cols, device), _idx(J, rows, cols, device)
    if device:
        assert t_idx._impl.dev is not None and t_idx._impl._rows is None
    tp, jp = TPR.build_pruner(t_idx._impl, cols), JPR.build_pruner(j_idx._impl, cols)
    assert _pruner_view(tp) == _pruner_view(jp)
    assert tp.nrows == len(rows)
    for key in _keys_of(t_idx._impl, cols):
        assert tp.can_contain(key, len(cols))
        h1, h2 = TPR.probe_hashes(key, tp.seed)
        assert (h1, h2) == JPR.probe_hashes(key, jp.seed)
        assert not tp.filter_excludes(h1, h2)
        for w in range(1, len(cols)):
            assert not tp.fence_excludes(key[:w])
    if device:  # the lazy tier stayed on its device branch
        assert t_idx._impl._rows is None


def test_scalar_and_vectorized_hashes_identical():
    cols = ["a", "b"]
    rows = [{"a": f"a{i % 13:02d}", "b": f"b{(i * 7) % 31:02d}", "v": str(i)} for i in range(300)]
    for device in (False, True):
        impl = _idx(T, rows, cols, device)._impl
        hv = TPR._row_hashes(impl, cols, seed=0x5EED)
        jv = JPR._row_hashes(_idx(J, rows, cols, device)._impl, cols, seed=0x5EED)
        assert np.array_equal(hv, jv)
        for i, key in enumerate(_keys_of(impl, cols)):
            h = int(hv[i])
            assert TPR.probe_hashes(key, 0x5EED) == (h & 0xFFFFFFFF, (h >> 32) | 1)


def test_filter_false_positive_rate_bounded():
    rows = [{"k": f"present{i:05d}", "v": str(i)} for i in range(2000)]
    p = TPR.build_pruner(_idx(T, rows, ["k"])._impl, ["k"])
    fp = sum(not p.filter_excludes(*TPR.probe_hashes((f"absent{i:05d}",), p.seed))
             for i in range(4000))
    assert fp / 4000 < 0.05


def test_fence_exactness():
    rows = [{"k": f"m{i:03d}", "v": str(i)} for i in range(50)]
    p = TPR.build_pruner(_idx(T, rows, ["k"])._impl, ["k"])
    assert p.fence_lo == ("m000",) and p.fence_hi == ("m049",)
    got = [p.fence_excludes(x) for x in [("a",), ("z",), ("m025",), ("m",), ("l",), ()]]
    assert got == [True, True, False, True, True, False]
    rows2 = [{"a": f"a{i % 5:02d}", "b": f"b{i:03d}", "v": str(i)} for i in range(30)]
    p2 = TPR.build_pruner(_idx(T, rows2, ["a", "b"])._impl, ["a", "b"])
    assert [p2.fence_excludes(x) for x in [("a02",), ("a99",), ("a",)]] == [False, True, True]


def test_pass_matrix_and_shortlist_equal_reference_and_scalar():
    def tiers(pkg, mod):
        idxs = [_idx(pkg, [{"k": f"a{i:02d}", "v": str(i)} for i in range(40)], ["k"]),
                _idx(pkg, [{"k": f"m{i:02d}", "v": str(i)} for i in range(25)], ["k"], True),
                _idx(pkg, [], ["k"]),
                _idx(pkg, [{"k": "solo", "v": "1"}], ["k"])]
        return [mod.build_pruner(t._impl, ["k"]) for t in idxs]

    probes = ([(f"a{i:02d}",) for i in range(0, 50, 7)] + [(f"m{i:02d}",) for i in range(0, 30, 5)]
              + [("solo",), ("zz",), ("",), (), ("a",), ("m",)])
    tp, jp = tiers(T, TPR), tiers(J, JPR)
    td, jd = TPR.PruneDirectory(tp, width=1), JPR.PruneDirectory(jp, width=1)
    mat = td.pass_matrix(probes)
    assert np.array_equal(mat, jd.pass_matrix(probes))
    assert np.array_equal(td.pass_matrix(probes[:5]), jd.pass_matrix(probes[:5]))
    for i, probe in enumerate(probes):
        assert td.shortlist(probe) == jd.shortlist(probe)
        for t, pr in enumerate(tp):
            assert mat[i, t] == pr.can_contain(probe, 1)


# -- probe invisibility ------------------------------------------------------------


def _mk_layered(pkg, mode="append", directory=None):
    rows = [pkg.Row({"k": f"k{i % 37:03d}", "v": f"v{i}"}) for i in range(300)]
    mi = pkg.storage.MutableIndex.create(pkg.take_rows(rows), ["k"], mode=mode,
                                         ingest_device="cpu", directory=directory)
    for b in range(24):
        mi.append_rows([{"k": f"k{(b * 5 + j) % 61:03d}", "v": f"b{b}-{j}"} for j in range(6)])
    mi.delete(("k003",))
    mi.delete(("k040",))
    mi.append_rows([{"k": "k003", "v": "reborn"}])
    return mi


_PROBES = [(f"k{i:03d}",) for i in range(0, 64, 3)] + [("k003",), ("k040",), ("nope",), ("k",),
                                                        ()]


def _blocks(mi, probes=_PROBES):
    return [[dict(r) for r in b] for b in mi.find_rows_many(probes)]


@pytest.mark.parametrize("mode", ["append", "upsert"])
def test_pruned_reads_equal_unpruned_and_reference(mode, monkeypatch):
    """Pruning on and off, the port and the reference: the same answers,
    probe counters and compaction steps, through tombstones and every
    leveled step."""
    on = {side: _mk_layered(pkg, mode) for side, (pkg, _) in SIDES.items()}
    monkeypatch.setenv("CSVPLUS_LSM_PRUNE", "0")
    off = _mk_layered(T, mode)
    monkeypatch.delenv("CSVPLUS_LSM_PRUNE")
    assert on["port"].tiers().prune_directory() is not None
    assert off.tiers().prune_directory() is None
    want = _blocks(on["ref"])
    assert _blocks(on["port"]) == want == _blocks(off)
    mbs = {side: mi.bounds_many([("k003",), ("nope",)]) for side, mi in on.items()}
    assert (mbs["port"].tiers_probed, mbs["port"].tiers_pruned) == (
        mbs["ref"].tiers_probed, mbs["ref"].tiers_pruned)
    for _ in range(10):
        steps = {side: mi.compact_step() for side, mi in on.items()}
        s_off = off.compact_step()
        assert (steps["port"] is None) == (steps["ref"] is None) == (s_off is None)
        want = _blocks(on["ref"])
        assert _blocks(on["port"]) == want == _blocks(off)
        assert index_checksums(on["port"].to_index()) == index_checksums(
            rebuild_reference(on["port"]))
        if steps["port"] is None:
            break
    for mi in (*on.values(), off):
        mi.compact_once()
    assert _blocks(on["port"]) == _blocks(on["ref"]) == _blocks(off)


def test_deleted_key_stays_deleted_and_counters_land():
    from csvplus_tpu_torch.serve import ServingMetrics

    mi = _mk_layered(T)
    assert mi.find_rows(("k040",)) == []
    st = mi.snapshot()["prune"]
    assert st["enabled"] and st["tiers_pruned"] > 0
    assert {"k": "k003", "v": "reborn"} in [dict(r) for r in mi.find_rows(("k003",))]
    n_row_tiers = len(mi.tiers().indexes())
    mb = mi.bounds_many([("k003",), ("nope",)])
    assert mb.tiers_probed + mb.tiers_pruned == 2 * n_row_tiers
    m = ServingMetrics()
    m.on_index_batch("idx", lookups=2, tiers_probed=mb.tiers_probed,
                     tiers_pruned=mb.tiers_pruned)
    cell = m.snapshot()["by_index"]["idx"]
    assert (cell["tiers_probed"], cell["tiers_pruned"]) == (mb.tiers_probed, mb.tiers_pruned)


def test_prune_stage_and_no_kernel_built():
    from csvplus_tpu_torch.utils.observe import telemetry

    mi = _mk_layered(T)
    mi.find_rows_many(_PROBES)
    with RecompileWatch() as w, telemetry.collect():
        mi.find_rows_many(_PROBES)
        stages = {r.stage for r in telemetry.records}
    w.assert_zero("warm pruned lookups")
    assert "storage:prune" in stages


# -- sidecars ----------------------------------------------------------------------


def test_sidecar_roundtrip_across_packages(tmp_path):
    cols = ["a", "b"]
    rows = [{"a": f"a{i % 11:02d}", "b": f"b{i % 7:02d}", "v": str(i)} for i in range(200)]
    for (wpkg, wmod), (_, rmod) in ((SIDES["port"], SIDES["ref"]), (SIDES["ref"], SIDES["port"])):
        p = wmod.build_pruner(_idx(wpkg, rows, cols)._impl, cols)
        path = str(tmp_path / f"{wpkg.__name__}.flt")
        wmod.write_pruner(path, p)
        assert _pruner_view(rmod.load_pruner(path, expect_nrows=p.nrows)) == _pruner_view(p)
    with open(str(tmp_path / "csvplus_tpu_torch.flt"), "rb") as a, \
            open(str(tmp_path / "csvplus_tpu.flt"), "rb") as b:
        za, zb = np.load(a), np.load(b)
        assert za["meta"].tobytes() == zb["meta"].tobytes()
        assert za["bits"].tobytes() == zb["bits"].tobytes()


def test_sidecar_corruption_raises_and_recovery_degrades(tmp_path):
    rows = [{"k": f"k{i:03d}", "v": str(i)} for i in range(80)]
    p = TPR.build_pruner(_idx(T, rows, ["k"])._impl, ["k"])
    path = str(tmp_path / "prune-00000001.flt")
    TPR.write_pruner(path, p)
    with pytest.raises(ValueError):
        TPR.load_pruner(path, expect_nrows=p.nrows + 1)
    with open(path, "wb") as f:
        f.write(b"garbage, not an npz")
    with pytest.raises(Exception):
        TPR.load_pruner(path, expect_nrows=p.nrows)
    d = str(tmp_path / "idx")
    mi = _mk_layered(T, directory=d)
    mi.compact_once()
    side = [n for n in os.listdir(d) if n.startswith("prune-")]
    assert len(side) == 1
    mi.close()
    with open(os.path.join(d, side[0]), "wb") as f:
        f.write(b"torn to bits")
    mi2 = MutableIndex.open(d, ingest_device="cpu")
    assert mi2.snapshot()["prune"]["enabled"]
    assert index_checksums(mi2.to_index()) == index_checksums(rebuild_reference(mi2))
    mi2.close()


def test_checkpoint_sweeps_stale_sidecars(tmp_path):
    names = {}
    for side, (pkg, _) in SIDES.items():
        d = str(tmp_path / side)
        mi = _mk_layered(pkg, directory=d)
        mi.compact_once()
        mi.append_rows([{"k": "k900", "v": "tail"}])
        mi.compact_once()
        mi.close()
        names[side] = sorted(os.listdir(d))
    assert names["port"] == names["ref"]
    assert len([n for n in names["port"] if n.startswith("prune-")]) == 1
    mi2 = MutableIndex.open(str(tmp_path / "ref"), ingest_device="cpu")
    assert mi2.snapshot()["prune"]["enabled"]
    assert [dict(r) for r in mi2.find_rows(("k900",))] == [{"k": "k900", "v": "tail"}]
    mi2.close()


# -- the read-amp-aware compactor ------------------------------------------------


def test_readamp_compactor_converges_under_load():
    rows = [T.Row({"k": f"k{i % 7:03d}", "v": f"v{i}"}) for i in range(64)]
    mi = MutableIndex.create(T.take_rows(rows), ["k"], ingest_device="cpu")
    for b in range(24):
        mi.append_rows([{"k": "k000", "v": f"hot{b}"}, {"k": f"x{b:03d}", "v": "c"}])
    probes = [("k000",)] * 8
    mi.find_rows_many(probes)
    assert mi.readamp.take_window() > 20
    c = Compactor(mi, min_deltas=1, interval_s=0.005, policy="readamp", readamp_target=4.0)
    deadline = time.monotonic() + 30.0
    converged = False
    with c:
        while time.monotonic() < deadline:
            mi.append_rows([{"k": "k000", "v": "more"}])
            assert mi.find_rows_many(probes)[0]
            snap = c.snapshot()
            if (snap["last_readamp"] is not None and snap["last_readamp"] <= 4.0
                    and snap["compactions"] >= 1):
                converged = True
                break
            time.sleep(0.01)
    assert converged, c.snapshot()
    assert index_checksums(mi.to_index()) == index_checksums(rebuild_reference(mi))


def test_readamp_policy_idle_without_evidence_and_validation():
    mi = MutableIndex.create(T.take_rows([T.Row({"k": "a", "v": "1"})]), ["k"],
                             ingest_device="cpu")
    for b in range(6):
        mi.append_rows([{"k": f"b{b}", "v": "x"}])
    assert Compactor(mi, policy="readamp", readamp_target=2.0).run_once() is None
    assert mi.delta_count == 6
    with pytest.raises(ValueError):
        Compactor(mi, policy="nope")
    with pytest.raises(ValueError):
        Compactor(mi, policy="readamp", readamp_target=0.5)


def test_concurrent_readers_during_readamp_compaction():
    rows = [T.Row({"k": f"k{i % 5:03d}", "v": f"v{i}"}) for i in range(40)]
    mi = MutableIndex.create(T.take_rows(rows), ["k"], ingest_device="cpu")
    for b in range(16):
        mi.append_rows([{"k": "k001", "v": f"h{b}"}])
    errors = []

    def reader():
        try:
            for _ in range(60):
                assert len(mi.find_rows(("k001",))) >= 8
        except Exception as err:
            errors.append(err)

    threads = [threading.Thread(target=reader) for _ in range(4)]
    with Compactor(mi, min_deltas=1, interval_s=0.001, policy="readamp", readamp_target=2.0):
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    assert not errors
    assert index_checksums(mi.to_index()) == index_checksums(rebuild_reference(mi))
