"""The port's streamed ingest tier (``csvplus_tpu_torch/native/scanner.py
stream_encoded_chunks`` and ``columnar/ingest.py _stream_to_table``) held
bitwise against the JAX package's on the CPU, on the same bytes: every
chunk the generator yields, and the table the tier builds, at chunk sizes
of 8, 23, 64 and 1 MiB bytes and K = 1, 2 and 8 workers; the same errors
with the same absolute row numbers; a StreamFallback for each of the
reference's reasons; the size threshold; the narrowed uploads; and the
filter -> join -> join slice over a streamed multi-chunk orders file."""

import io

import numpy as np
import pytest
import torch

import csvplus_tpu as J
import csvplus_tpu.native.scanner as JS
import csvplus_tpu_torch as T
import csvplus_tpu_torch.columnar.ingest as TI
import csvplus_tpu_torch.native.scanner as TS
from csvplus_tpu.utils.checksum import checksum_device_table as j_checksum
from csvplus_tpu_torch.utils.checksum import checksum_device_table as t_checksum

CHUNKS = [8, 23, 64, 1 << 20]
WORKERS = [1, 2, 8]


def _rows(n, fmt):
    return "".join(fmt(i) for i in range(n))


def _demote_mid(n=60):
    rows = [f"o{i},{i}\n" for i in range(n)]
    rows[n * 2 // 3] = f"o{n * 2 // 3},notanint\n"
    return "id,qty\n" + "".join(rows)


# name -> (text, reader configuration)
CASES = {
    "typed-and-strings": ("id,name,qty\n" + _rows(40, lambda i: f"r{i},n{i % 7},{i % 13}\n"), None),
    "distinct-chunk-dicts": ("k\n" + _rows(20, lambda i: f"z{i}\n") + _rows(20, lambda i: f"a{i}\n"),
                             None),
    "quoted": ("id,txt,qty\n" + _rows(24, lambda i: (
        f'r{i},"v,{i}\nline2-{i}",{i % 7}\n' if i % 3 == 0
        else f'r{i},"say ""hi"" {i}",{i % 7}\n' if i % 3 == 1
        else f"r{i},plain{i},{i % 7}\n")), None),
    "quoted-crlf": ("id,txt,qty\r\n" + _rows(24, lambda i: (
        f'r{i},"v,{i}\r\nnl{i}",{i}\r\n' if i % 4 == 0
        else f'r{i},"say ""hi"" {i}",{i}\r\n' if i % 4 == 1
        else f"r{i},plain{i},{i}\r\n")), None),
    "quoted-field-over-chunk": ('a,b\n"' + "x," * 40 + '",1\nplain,2\n', None),
    "demotion-mid-file": (_demote_mid(), None),
    "prefix-drift": ("id,v\n" + _rows(30, lambda i: f"{'o' if i < 20 else 'p'}{i},{i}\n"), None),
    # a chunk of blank lines only: zero records after the header demotes
    # every typed column (the reference's quirk, kept)
    "zero-record-chunk": ("a,b\n" + _rows(12, lambda i: f"o{i},{i}\n") + "\n" * 40
                          + _rows(12, lambda i: f"o{i},{i}\n"), None),
    "comments": ("a,b\n#skip\n1,2\n#also\n3,4\n" + "#c\n" * 12 + _rows(10, lambda i: f"{i},{i}\n"),
                 "comment"),
    "comment-only-first-chunk": ("#c1\n#c2\n#c3\na,b\n1,2\n3,4\n", "comment"),
    "header-only": ("a,b,c\n", None),
    "assume-header": ("1,2,3\n4,5,6\n" * 5, "assume"),
    "padded-missing-columns": ("1,2,3\n4\n5,6\n" * 4, "assume-any"),
    "utf8": ("a,b\n" + _rows(12, lambda i: f"Zoë{i},λ{i % 3}\n"), None),
}
ERROR_CASES = {
    "field-count": "a,b\n" + _rows(30, lambda i: f"{i},x\n") + "oops\n" + "1,2\n" * 10,
    "first-error-wins": "a,b\n" + "".join(
        "bad\n" if i in (15, 40) else f"{i},x\n" for i in range(50)),
    "bare-quote": "a,b\n" + _rows(20, lambda i: f"{i},x\n") + 'x"y,2\n',
    "no-header": "",
}


def _reader(pkg, path, config):
    r = pkg.from_file(path)
    if config == "comment":
        return r.comment_char("#")
    if config == "assume":
        return r.assume_header({"x": 0, "z": 2})
    if config == "assume-any":
        return r.assume_header({"x": 0, "z": 2}).num_fields_any()
    return r


def _write(tmp_path, text, name="s.csv"):
    p = tmp_path / name
    p.write_bytes(text.encode("utf-8"))
    return str(p)


def _snapshot(mod, reader, path, chunk, workers):
    """Every yielded chunk, bitwise: names, row count, and per column its
    kind with the typed prefix and values or the dictionary entries and
    codes.  The dictionary's 'S' width is not compared: a chunk that a
    worker typed speculatively and the reassembler re-encoded comes out
    'S12' wide where a direct encode is as wide as its longest entry, and
    which of the two happens depends on thread timing, in the reference
    as in the port; the entries' bytes are the same."""
    out = []
    for names, encoded, n in mod.stream_encoded_chunks(
        reader, path, chunk_bytes=chunk, workers=workers
    ):
        cols = {}
        for c in names:
            enc = encoded[c]
            if len(enc) == 3 and enc[0] == "int":
                cols[c] = ("int", enc[1], str(enc[2].dtype), enc[2].tolist())
            else:
                d, codes = enc
                cols[c] = ("dict", d.tolist(), str(codes.dtype), codes.tolist())
        out.append((list(names), n, cols))
    return out


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # compared across packages: type, text, row
        return ("error", type(e).__name__, str(e), getattr(e, "line", None))


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", sorted(CASES) + sorted(ERROR_CASES))
def test_stream_chunks_match_reference(tmp_path, case, chunk, workers):
    text, config = CASES.get(case, (ERROR_CASES.get(case), None))
    path = _write(tmp_path, text)
    got = _outcome(lambda: _snapshot(TS, _reader(T, path, config), path, chunk, workers))
    want = _outcome(lambda: _snapshot(JS, _reader(J, path, config), path, chunk, workers))
    assert got == want
    if case in ERROR_CASES and case != "no-header":
        assert got[0] == "error" and got[3] is not None
    # K is unobservable: every worker count yields what K = 1 yields
    assert got == _outcome(lambda: _snapshot(TS, _reader(T, path, config), path, chunk, 1))


def test_stream_workers_stress_match_serial(tmp_path):
    """More workers than cores and a tiny thread switch interval: the
    reassembler's swap of the workers' typed snapshot (a demotion
    mid-file) still yields exactly what K = 1 yields."""
    import sys

    path = _write(tmp_path, _demote_mid(300))
    want = _snapshot(TS, T.from_file(path), path, 23, 1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            assert _snapshot(TS, T.from_file(path), path, 23, 16) == want
    finally:
        sys.setswitchinterval(old)


def test_stream_chunks_show_the_demotions():
    """The cases above do reach what they are named for."""
    import tempfile
    from pathlib import Path

    d = Path(tempfile.mkdtemp())
    for case in ("demotion-mid-file", "prefix-drift", "zero-record-chunk"):
        path = _write(d, CASES[case][0], case + ".csv")
        snap = _snapshot(TS, T.from_file(path), path, 23, 2)
        kinds = [chunk[2][name][0] for chunk in snap for name in chunk[2]]
        assert "int" in kinds and "dict" in kinds, case


def _same_column(tc, jc):
    assert tc.kind == jc.kind
    if jc.kind == "int":
        assert tc.prefix == jc.prefix
        assert np.array_equal(tc.values.numpy(), np.asarray(jc.values))
        return
    assert (tc.dev_dictionary is None) == (jc.dev_dictionary is None)
    assert tc._dev_dict_sorted == jc._dev_dict_sorted
    if jc.dev_dictionary is not None and jc._dictionary is None:
        assert tc._dictionary is None
        assert len(tc.dev_dictionary) == len(jc.dev_dictionary)
        for t_lane, j_lane in zip(tc.dev_dictionary, jc.dev_dictionary):
            assert np.array_equal(t_lane.numpy(), np.asarray(j_lane))
    else:
        # entries and their order; the 'S' width may differ (see _snapshot)
        assert tc.dictionary.tolist() == jc.dictionary.tolist()
    assert tc.codes.dtype == torch.int32
    assert np.array_equal(tc.codes.numpy(), np.asarray(jc.codes))


@pytest.fixture
def stream_env(monkeypatch):
    monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")

    def setup(chunk, workers, lanes=None):
        monkeypatch.setenv("CSVPLUS_STREAM_CHUNK_BYTES", str(chunk))
        monkeypatch.setenv("CSVPLUS_INGEST_WORKERS", str(workers))
        if lanes is not None:
            monkeypatch.setenv("CSVPLUS_DICT_DEVICE_MIN_DISTINCT", str(lanes))

    return setup


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", ["typed-and-strings", "quoted-crlf", "demotion-mid-file",
                                  "zero-record-chunk", "padded-missing-columns", "header-only",
                                  "field-count"])
def test_streamed_table_matches_reference(tmp_path, stream_env, case, chunk, workers):
    """``from_file(...).on_device("cpu")`` through the streamed tier: the
    same columns, bit for bit, as the reference's tier builds, or the
    same error."""
    stream_env(chunk, workers)
    text, config = CASES.get(case, (ERROR_CASES.get(case), None))
    path = _write(tmp_path, text)
    got = _outcome(lambda: _reader(T, path, config).on_device("cpu"))
    want = _outcome(lambda: _reader(J, path, config).on_device("cpu"))
    if want[0] == "error":
        assert got == want
        return
    tt, jt = got[1].plan.table, want[1].plan.table
    assert tt.ingest_tier == "streamed" and tt.nrows == jt.nrows
    assert tt.ingest_seconds["workers"] == workers
    assert tt.row_base == jt.row_base
    assert list(tt.columns) == list(jt.columns)
    for name in jt.columns:
        _same_column(tt.columns[name], jt.columns[name])
    assert got[1].to_rows() == want[1].to_rows()


FALLBACKS = {
    "lazy-quotes": ('a,b\n"q,uoted",2\n', lambda pkg, p: pkg.from_file(p).lazy_quotes()),
    "nul": ("a,b\nx\x00y,1\n", lambda pkg, p: pkg.from_file(p)),
    "long-field": ("a\n" + "x" * 400 + "\n", lambda pkg, p: pkg.from_file(p)),
    "trim": ("a,b\n 1, 2\n", lambda pkg, p: pkg.from_file(p).trim_leading_space()),
    "two-byte-delimiter": ("aéb\n1é2\n", lambda pkg, p: pkg.from_file(p).delimiter("é")),
    "two-byte-comment": ("a,b\n1,2\n", lambda pkg, p: pkg.from_file(p).comment_char("é")),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_stream_fallback_reasons_match_reference(tmp_path, stream_env, case):
    """Each of the reference's reasons raises StreamFallback in both
    generators, and ingest then takes the same whole-file tier with the
    same rows."""
    stream_env(8, 2)
    text, mk = FALLBACKS[case]
    path = _write(tmp_path, text)
    with pytest.raises(TS.StreamFallback):
        _snapshot(TS, mk(T, path), path, 8, 2)
    with pytest.raises(JS.StreamFallback):
        _snapshot(JS, mk(J, path), path, 8, 2)
    src = mk(T, path).on_device("cpu")
    assert src.plan.table.ingest_tier != "streamed"
    assert src.to_rows() == mk(J, path).on_device("cpu").to_rows()


def test_stream_fallback_empty_file(tmp_path, stream_env):
    """An empty file (no record) falls back in both consumers; the
    whole-file tier then reports the same error."""
    stream_env(8, 2)
    path = _write(tmp_path, "")
    with pytest.raises(TS.StreamFallback):
        TI._stream_to_table(T.from_file(path), path, "cpu")
    got = _outcome(lambda: T.from_file(path).on_device("cpu"))
    want = _outcome(lambda: J.from_file(path).on_device("cpu"))
    assert got[0] == "error" and got == want


def test_stream_fallback_lane_width_exceeded(tmp_path, stream_env):
    """A lane column that meets a value wider than 32 bytes in a later
    chunk cannot be finished by this tier: StreamFallback, then the
    whole-file tiers give the reference's rows."""
    stream_env(64, 2, lanes=1)
    text = "k,v\n" + _rows(30, lambda i: f"key{i},{i}\n") + "w" * 40 + ",1\n"
    path = _write(tmp_path, text)
    with pytest.raises(TS.StreamFallback, match="lane width"):
        TI._stream_to_table(T.from_file(path), path, "cpu")
    src = T.from_file(path).on_device("cpu")
    assert src.plan.table.ingest_tier == "native-encoded"
    assert src.to_rows() == J.from_file(path).on_device("cpu").to_rows()


def test_stream_failures_raise_instead_of_falling_back(tmp_path, stream_env, monkeypatch):
    """A failure that is not one of the reference's reasons (here a
    worker's exception) raises; it never becomes a whole-file ingest."""
    stream_env(16, 2)
    path = _write(tmp_path, "a,b\n" + _rows(40, lambda i: f"{i},x{i}\n"))

    def broken(ctx, data):
        raise OSError("worker failed")

    monkeypatch.setattr(TS, "_scan_encode_chunk", broken)
    with pytest.raises(OSError, match="worker failed"):
        T.from_file(path).on_device("cpu")


@pytest.mark.parametrize("size_delta,streamed", [(0, True), (1, False)])
def test_stream_threshold_respected(tmp_path, monkeypatch, size_delta, streamed):
    path = _write(tmp_path, "a,b\n" + _rows(50, lambda i: f"{i},x\n"))
    size = len(open(path, "rb").read())
    monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", str(size + size_delta))
    tier = T.from_file(path).on_device("cpu").plan.table.ingest_tier
    assert tier == ("streamed" if streamed else "native-encoded")


def test_stream_threshold_default_and_off(tmp_path, monkeypatch):
    """256 MiB by default, as the reference; 0 turns the tier off."""
    assert TI._STREAM_MIN_BYTES == 256 << 20
    from csvplus_tpu.columnar.ingest import _STREAM_MIN_BYTES

    assert TI._STREAM_MIN_BYTES == _STREAM_MIN_BYTES
    path = _write(tmp_path, "a,b\n1,2\n")
    monkeypatch.delenv("CSVPLUS_STREAM_MIN_BYTES", raising=False)
    assert not TI._stream_ingest_wanted(path)
    monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "0")
    assert not TI._stream_ingest_wanted(path)
    monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "5")
    assert TI._stream_ingest_wanted(path)


@pytest.mark.parametrize("value,want", [("3", 3), ("lots", None), ("0", None), ("99", 32)])
def test_ingest_workers_knob_matches_reference(monkeypatch, value, want):
    monkeypatch.setenv("CSVPLUS_INGEST_WORKERS", value)
    assert TS._ingest_workers() == JS._ingest_workers()
    if want is not None:
        assert TS._ingest_workers() == want


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int32"])
def test_narrowed_codes_widen_on_the_device(dtype):
    """Codes narrowed for the upload come back as the same int32 slots
    through both concatenations (remap and offset)."""
    size = {"uint8": 200, "uint16": 60_000, "int32": 70_000}[dtype]
    rng = np.random.default_rng(size)
    chunks = [rng.integers(0, size, n).astype(np.int32) for n in (50, 0, 77)]
    narrowed = [TI._narrow_codes(c, size) for c in chunks]
    assert {str(c.dtype) for c in narrowed} == {dtype}
    up = [torch.from_numpy(c) for c in narrowed]
    maps = [rng.permutation(size).astype(np.int32) for _ in chunks]
    got = TI._remap_concat([torch.from_numpy(m) for m in maps], up)
    want = np.concatenate([m[c] for m, c in zip(maps, chunks)])
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    offsets = [0, size, 2 * size]
    got = TI._offset_concat(up, offsets)
    want = np.concatenate([c + o for c, o in zip(chunks, offsets)])
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("lo,hi,dtype", [(-128, 127, "int8"), (-32768, 32767, "int16"),
                                         (-40000, 5, "int32"), (0, 2**31 - 1, "int32")])
def test_narrowed_values_widen_on_the_device(lo, hi, dtype):
    vals = np.array([lo, hi, 0, lo // 2], dtype=np.int32)
    narrowed = TI._narrow_values(vals)
    assert str(narrowed.dtype) == dtype
    got = TI._values_concat([torch.from_numpy(narrowed), torch.from_numpy(narrowed[:0])])
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), vals)


def test_uploader_wraps_host_arrays_on_the_cpu():
    up = TI._uploader(torch.device("cpu"))
    for dtype in (np.uint8, np.uint16, np.int8, np.int16, np.int32):
        arr = np.arange(5, dtype=dtype)
        t = up(arr[::-1])  # a strided view is made contiguous
        assert t.dtype == torch.from_numpy(arr).dtype and t.tolist() == arr[::-1].tolist()


@pytest.fixture
def slice_files(tmp_path):
    rng = np.random.default_rng(7)
    n = 3000
    cust = rng.integers(0, 40, n)
    prod = rng.integers(0, 9, n)
    (tmp_path / "o.csv").write_text("order_id,cust_id,prod_id,qty\n" + "".join(
        f"o{i},c{c},p{p},{i % 5 + 1}\n" for i, (c, p) in enumerate(zip(cust, prod))))
    (tmp_path / "c.csv").write_text("id,name\n" + "".join(f"c{i},n{i % 7}\n" for i in range(40)))
    (tmp_path / "p.csv").write_text("prod_id,product,price\n" + "".join(
        f"p{i},x{i},{i}.5\n" for i in range(9)))
    return tmp_path


def test_streamed_slice_matches_reference(slice_files, stream_env, tmp_path):
    """filter -> join -> join over a streamed multi-chunk orders file at
    K = 2: the same CSV bytes and positional checksums as the
    reference's, with the four orders columns typed."""
    stream_env(4096, 2)

    def pipeline(pkg):
        orders = pkg.from_file(str(slice_files / "o.csv")).on_device("cpu")
        cust = pkg.from_file(str(slice_files / "c.csv")).on_device("cpu").unique_index_on("id")
        prod = pkg.from_file(str(slice_files / "p.csv")).on_device("cpu").unique_index_on("prod_id")
        pred = pkg.Any(pkg.Like({"prod_id": "p3"}), pkg.Like({"qty": "2"}))
        return orders, orders.filter(pred).join(cust, "cust_id").join(prod)

    t_orders, t_src = pipeline(T)
    j_orders, j_src = pipeline(J)
    table = t_orders.plan.table
    assert table.ingest_tier == "streamed" and table.ingest_seconds["chunks"] > 10
    assert {c.kind for c in table.columns.values()} == {"int"}
    cols = ["order_id", "cust_id", "prod_id", "qty", "id", "name", "product", "price"]
    t_buf, j_buf = io.StringIO(), io.StringIO()
    t_src.to_csv(t_buf, *cols)
    j_src.to_csv(j_buf, *cols)
    assert t_buf.getvalue() == j_buf.getvalue() and t_buf.getvalue().count("\n") > 500
    assert t_checksum(t_src.to_device_table(), cols, positional=True) == j_checksum(
        j_src.to_device_table(), cols, positional=True)
