"""The port's policy dedup (``resolve_duplicates("first" | "last")`` on a
device-lazy index) held against the JAX package on the CPU, on the same
bytes: the kept rows and their order, ``len``, the rebuilt index's
``find`` results, and its placement.  The port keeps the run flags on
the device and compacts them there (``ops/sort.run_flags``,
``flag_positions``); the reference picks the kept positions with numpy on
the host.  A table with no duplicate key leaves the index as it was, in
both packages.  The cases reach the edges of the run-boundary compare:
no duplicates, one key throughout, duplicate runs first and last in the
index, tables of no row and of one, a key of a string and a typed column,
and a lane-dictionary key as streamed ingest leaves it."""

import numpy as np
import pytest

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu_torch.utils.observe import telemetry as t_tel

PKGS = {"ref": J, "port": T}


def _write(tmp_path, header, rows):
    p = tmp_path / "dups.csv"
    p.write_text(",".join(header) + "\n" + "".join(",".join(r) + "\n" for r in rows))
    return str(p)


def _shuffled(rows, seed):
    order = np.random.default_rng(seed).permutation(len(rows))
    return [rows[i] for i in order.tolist()]


def _no_dups(tmp_path, monkeypatch):
    rows = _shuffled([[f"k{i:03d}", str(i)] for i in range(50)], 1)
    return _write(tmp_path, ["k", "v"], rows), ("k",), ["k007", "k049", "nope"]


def _one_key(tmp_path, monkeypatch):
    rows = [["same", str(i)] for i in range(40)]
    return _write(tmp_path, ["k", "v"], rows), ("k",), ["same", "other"]


def _runs_at_edges(tmp_path, monkeypatch):
    # "a" sorts first and "z" last: their runs open and close the index
    keys = ["a"] * 3 + [f"m{i:02d}" for i in range(20)] + ["m05"] * 2 + ["z"] * 4
    rows = _shuffled([[k, str(i)] for i, k in enumerate(keys)], 2)
    return _write(tmp_path, ["k", "v"], rows), ("k",), ["a", "m05", "z", "m19"]


def _empty(tmp_path, monkeypatch):
    # an index of no row stays on the device only as an empty sub-index
    return _write(tmp_path, ["k", "v"], [["k0", "0"], ["k1", "1"]]), ("k", "v"), ["0"], ("zz",)


def _single(tmp_path, monkeypatch):
    return _write(tmp_path, ["k", "v"], [["k0", "0"]]), ("k",), ["k0", "k1"]


def _string_and_typed(tmp_path, monkeypatch):
    # ``t`` is prefix + canonical int32: a typed value-lane column
    rng = np.random.default_rng(3)
    k = rng.integers(0, 4, 300).tolist()
    t = rng.integers(0, 25, 300).tolist()
    rows = [[f"s{a}", f"n{b}", str(i)] for i, (a, b) in enumerate(zip(k, t))]
    probes = [("s1",), ("s2", "n7"), ("s3", "n24"), ("s0", "n99")]
    return _write(tmp_path, ["k", "t", "v"], rows), ("k", "t"), probes


def _lane_dictionary(tmp_path, monkeypatch):
    # streamed in several chunks, ``k``'s dictionary kept on the device
    monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")
    monkeypatch.setenv("CSVPLUS_STREAM_CHUNK_BYTES", "8192")
    monkeypatch.setenv("CSVPLUS_DICT_DEVICE_MIN_DISTINCT", "100")
    rng = np.random.default_rng(4)
    k = rng.integers(0, 2500, 3000).tolist()
    rows = [[f"o{a:08d}", f"c{i % 97}", str(i)] for i, a in enumerate(k)]
    probes = [f"o{k[0]:08d}", f"o{k[-1]:08d}", "o99999999"]
    return _write(tmp_path, ["k", "c", "v"], rows), ("k",), probes


CASES = {
    "no-dups": _no_dups,
    "one-key": _one_key,
    "runs-at-edges": _runs_at_edges,
    "empty": _empty,
    "single": _single,
    "string-and-typed": _string_and_typed,
    "lane-dictionary": _lane_dictionary,
}


def _found(idx, probes):
    return [[dict(r) for r in idx.find(*((p,) if isinstance(p, str) else p)).to_rows()]
            for p in probes]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("policy", ["first", "last"])
def test_policy_dedup_matches_reference(tmp_path, monkeypatch, policy, case):
    path, key, probes, *sub = CASES[case](tmp_path, monkeypatch)
    out = {}
    for side, pkg in PKGS.items():
        idx = pkg.from_file(path).on_device("cpu").index_on(*key)
        if sub:
            idx = idx.sub_index(*sub[0])
        impl = idx._impl
        assert impl.is_lazy and impl.dev is not None
        before = (impl.dev, idx.device_table, len(idx))
        if side == "port":
            if case == "lane-dictionary":
                col = impl.dev.table.columns["k"]
                assert col.dev_dictionary is not None and col._dictionary is None
            with t_tel.collect():
                idx.resolve_duplicates(policy)
                syncs = t_tel.host_sync_elements
            # the kept rows' count is the one scalar read back
            assert syncs == 1
        else:
            idx.resolve_duplicates(policy)
        unchanged = impl.dev is before[0] and idx.device_table is before[1]
        placed = (impl.dev is not None, impl.is_lazy)
        out[side] = (unchanged, placed, len(idx), [dict(r) for r in idx], _found(idx, probes))
    assert out["port"] == out["ref"]
    unchanged, placed, n, rows, _ = out["port"]
    assert placed == (True, True)
    # no duplicate key: the index is left as it was
    assert unchanged == (n == before[2])
    keys = [tuple(r[c] for c in key[len(sub[0]) if sub else 0:]) for r in rows]
    assert len(set(keys)) == len(keys) == n
