"""The port's device-parse tier (``csvplus_tpu_torch/ops/parse.py``,
``native/scanner.py read_device_parsed_columns``, the ``device-parsed``
tier and the streamed tier's device chunk encoder in
``columnar/ingest.py``) held bitwise against the JAX package's on the CPU,
on the same bytes, with ``CSVPLUS_DEVICE_PARSE=1`` set for both packages
(the reference then takes the tier on JAX's CPU backend): every case of
``tests/test_device_parse.py``, the column encode against the
reference's ``_encode_column_kernel`` at 2, 4 and 8 lanes, the plain pack
against the reference's lane packing, the streamed tier with the encoder,
the tier policy, and the ``ingest:device-parsed`` stage sequence."""

import numpy as np
import pytest
import torch

import csvplus_tpu as J
import csvplus_tpu.native.scanner as JS
import csvplus_tpu_torch as T
import csvplus_tpu_torch.columnar.ingest as TI
import csvplus_tpu_torch.native.scanner as TS
from csvplus_tpu.ops.lanes import pack_host
from csvplus_tpu.ops.parse import _encode_column_kernel
from csvplus_tpu.utils.checksum import checksum_device_table as j_checksum
from csvplus_tpu.utils.observe import telemetry as j_tel
from csvplus_tpu_torch.ops import parse as TP
from csvplus_tpu_torch.utils.checksum import checksum_device_table as t_checksum
from csvplus_tpu_torch.utils.observe import telemetry as t_tel

import jax.numpy as jnp
from hypo_compat import given, settings, st


@pytest.fixture(autouse=True)
def _device_parse_on(monkeypatch):
    monkeypatch.setenv("CSVPLUS_DEVICE_PARSE", "1")


def _write(tmp_path, text, name="t.csv"):
    p = tmp_path / name
    p.write_bytes(text.encode("utf-8") if isinstance(text, str) else text)
    return str(p)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # compared across packages: type, text, row
        return ("error", type(e).__name__, str(e), getattr(e, "line", None))


def _parsed(sc, reader, path, **kw):
    """The tier's output as plain data: per column the dictionary's bytes,
    dtype (itemsize included) and the codes."""
    enc = sc.read_device_parsed_columns(reader, path, **kw)
    if enc is None:
        return None
    names, data = enc
    return names, {n: (data[n][0].tolist(), str(data[n][0].dtype),
                       np.asarray(data[n][1]).tolist()) for n in names}


def _both(tmp_path, text, mk=lambda pkg, p: pkg.from_file(p)):
    path = _write(tmp_path, text)
    got = _outcome(lambda: _parsed(TS, mk(T, path), path, device="cpu"))
    want = _outcome(lambda: _parsed(JS, mk(J, path), path))
    return got, want


WIDTHS = ["short", "a-16-byte-value!", "a-rather-long-value-over-8-bytes", "mid"]
TEXTS = {
    "simple": "a,b\n1,2\n3,44\nx,\n",
    "no-trailing-newline": "a,b\n1,2\n3,44",
    "lane-widths": "k\n" + "\n".join(WIDTHS) + "\n",
    "over-32-bytes": "k,v\n" + "short,1\n" + "x" * 33 + ",2\nmid,3\n",
    "many-values": "k\n" + "\n".join(
        f"v{int(x)}" for x in np.random.default_rng(6).integers(0, 500, 20_000)) + "\n",
    "utf8": "a,b\nZoë,λ\nÅ,b\nZoë,c\n",
    "empty-fields": "a,b,c\n,,\n1,,\n,,2\n",
    "quotes": 'a,b\n"q",2\n',
    "cr": "a,b\r\n1,2\r\n",
    "blank-line": "a,b\n\n1,2\n",
    "empty": "",
    "leading-newline": "\na,b\n1,2\n",
    "nul": "a,b\nx\x00y,1\n",
    "ragged": "a,b\n1,2\n1,2,3\n",
    "header-only": "a,b\n",
}


@pytest.mark.parametrize("case", sorted(TEXTS))
def test_device_parsed_columns_match_reference(tmp_path, case):
    """Names, dictionaries (bytes and itemsize), codes, or the decline, or
    the error type and row number."""
    got, want = _both(tmp_path, TEXTS[case])
    assert got == want
    if case in ("quotes", "cr", "blank-line", "empty", "leading-newline", "nul"):
        assert got == ("ok", None)
    if case == "ragged":
        assert got[0] == "error" and got[3] == 3


READERS = {
    "select": lambda pkg, p: pkg.from_file(p).select_columns("cust_id", "qty"),
    "assume-header": lambda pkg, p: pkg.from_file(p).assume_header({"x": 0, "z": 2}),
    "num-fields-any": lambda pkg, p: pkg.from_file(p).assume_header({"x": 0, "z": 2})
    .num_fields_any(),
    "trim": lambda pkg, p: pkg.from_file(p).trim_leading_space(),
    "comment": lambda pkg, p: pkg.from_file(p).comment_char("#"),
    "two-byte-delimiter": lambda pkg, p: pkg.from_file(p).delimiter("é"),
}


@pytest.mark.parametrize("config", sorted(READERS))
def test_reader_configurations_match_reference(tmp_path, config):
    text = {"select": "id,cust_id,qty\n1,c1,3\n2,c2,4\n",
            "assume-header": "1,2,3\n4,5,6\n",
            "num-fields-any": "1,2,3\n4\n5,6\n",
            "two-byte-delimiter": "aéb\n1é2\n"}.get(config, "a,b\n1,2\n")
    got, want = _both(tmp_path, text, READERS[config])
    assert got == want
    if config in ("trim", "comment", "two-byte-delimiter"):
        assert got == ("ok", None)


def test_corpus_files_match_reference(people_csv, orders_csv, stock_csv):
    for path in (people_csv, orders_csv, stock_csv):
        got = _parsed(TS, T.from_file(path), path, device="cpu")
        assert got is not None
        assert got == _parsed(JS, J.from_file(path), path)


def test_no_host_encode_for_fields_up_to_32_bytes(tmp_path, monkeypatch, orders_csv):
    """Fields up to 32 bytes (the corpus's 25-byte ts column too) encode
    on the device; the host encode is never consulted."""
    def boom(*a, **k):
        raise AssertionError("host encode used for a field of <= 32 bytes")

    monkeypatch.setattr(TS, "encode_fields_vectorized", boom)
    for path in (_write(tmp_path, TEXTS["lane-widths"]), orders_csv):
        assert TS.read_device_parsed_columns(T.from_file(path), path, "cpu") is not None


def _table_view(src):
    t = src.plan.table
    return {n: (c.kind, c.dictionary.tolist(), str(c.dictionary.dtype), c.codes.tolist())
            for n, c in t.columns.items()}


@pytest.mark.parametrize("case", ["simple", "lane-widths", "over-32-bytes", "utf8",
                                  "empty-fields", "ragged", "quotes", "many-values"])
def test_on_device_matches_reference(tmp_path, case):
    """``from_file(...).on_device("cpu")``: the port takes the
    ``device-parsed`` tier where the reference does (its stage says so),
    with the same column kinds (all dictionaries), dictionaries, codes,
    rows and positional checksums, or the same error."""
    path = _write(tmp_path, TEXTS[case])
    stages = {}
    srcs = {}
    for side, pkg, tel in (("port", T, t_tel), ("ref", J, j_tel)):
        with tel.collect():
            srcs[side] = _outcome(lambda: pkg.from_file(path).on_device("cpu"))
            stages[side] = [r.stage for r in tel.records]
    got, want = srcs["port"], srcs["ref"]
    assert stages["port"] == stages["ref"]
    if want[0] == "error":
        assert got == want
        return
    tiered = "ingest:device-parsed" in stages["ref"]
    assert got[1].plan.table.ingest_tier == ("device-parsed" if tiered else "native-encoded")
    assert tiered == (case != "quotes")
    tt, jt = got[1].plan.table, want[1].plan.table
    assert _table_view(got[1]) == {
        n: (c.kind, c.dictionary.tolist(), str(c.dictionary.dtype), np.asarray(c.codes).tolist())
        for n, c in jt.columns.items()}
    assert got[1].to_rows() == want[1].to_rows()
    assert t_checksum(tt, positional=True) == j_checksum(jt, positional=True)


def test_ondevice_pipeline_through_device_parse(people_csv):
    """Rows, a filter and an index through the tier equal the reference's."""
    t, j = T.from_file(people_csv).on_device("cpu"), J.from_file(people_csv).on_device("cpu")
    assert t.plan.table.ingest_tier == "device-parsed"
    assert {c.kind for c in t.plan.table.columns.values()} == {"str"}
    assert t.to_rows() == j.to_rows()
    tp, jp = T.Like({"name": "Amelia", "surname": "Jones"}), J.Like(
        {"name": "Amelia", "surname": "Jones"})
    assert t.filter(tp).to_rows() == j.filter(jp).to_rows()
    assert T.take(t.index_on("surname", "name")).to_rows() == J.Take(
        j.index_on("surname", "name")).to_rows()


def test_device_parsed_stage_sequence_matches_reference(orders_csv):
    """One ``ingest:device-parsed`` record with the rows out, in both."""
    seqs = {}
    for side, pkg, tel in (("port", T, t_tel), ("ref", J, j_tel)):
        with tel.collect():
            pkg.from_file(orders_csv).on_device("cpu")
            seqs[side] = [(r.stage, r.rows_in, r.rows_out) for r in tel.records]
    assert seqs["port"] == seqs["ref"]
    assert [s for s, _, _ in seqs["port"]] == ["ingest:device-parsed"]


# -- the column encode, and the pack against the reference's lanes ------------


def _fields(rng, m, max_len, n_distinct):
    """A byte buffer of m comma-separated fields drawn from n_distinct
    values of 0..max_len bytes (duplicates on purpose), with no trailing
    separator: the last field ends at the buffer's last byte."""
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789-_", dtype=np.uint8)
    lens = rng.integers(0, max_len + 1, n_distinct)
    lens[0] = max_len
    values = [bytes(alphabet[rng.integers(0, alphabet.size, int(n))]) for n in lens]
    pick = rng.integers(0, n_distinct, m)
    pick[-1] = 0  # the widest value ends the buffer
    chosen = [values[i] for i in pick]
    data = b",".join(chosen)
    starts = np.zeros(m, dtype=np.int64)
    starts[1:] = np.cumsum([len(v) + 1 for v in chosen[:-1]])
    lens_a = np.asarray([len(v) for v in chosen], dtype=np.int32)
    assert starts[-1] + lens_a[-1] == len(data)
    return data, starts, lens_a, chosen


@pytest.mark.parametrize("lanes,max_len", [(2, 0), (2, 5), (2, 8), (4, 16), (4, 13),
                                            (8, 32), (8, 17)])
def test_encode_column_matches_reference_kernel(lanes, max_len):
    """Codes, the unique count and each unique's first row, bitwise, at
    the lane count the column's widest field gives."""
    rng = np.random.default_rng(lanes * 100 + max_len)
    m = 3001
    data, starts, lens, _ = _fields(rng, m, max_len, 40)
    assert TP.lanes_for_width(max_len) == lanes
    j_codes, j_n, j_first = _encode_column_kernel(
        jnp.asarray(np.frombuffer(data, np.uint8)), jnp.asarray(starts, jnp.int32),
        jnp.asarray(lens), lanes=lanes)
    words = TP.pack_field_lanes(torch.frombuffer(bytearray(data), dtype=torch.uint8),
                                torch.from_numpy(starts.astype(np.int32)),
                                torch.from_numpy(lens), lanes)
    codes, n_uniq, first = TP.encode_lanes(words)
    assert codes.dtype == torch.int32 and first.dtype == torch.int32
    assert codes.tolist() == np.asarray(j_codes).tolist()
    assert int(n_uniq) == int(j_n)
    assert first.tolist() == np.asarray(j_first).tolist()


@pytest.mark.parametrize("lanes", [2, 4, 8])
def test_pack_plain_equals_the_reference_lanes(lanes):
    """The plain pack gives the reference's words: NUL-padded big-endian
    sign-flipped int32 lanes (``csvplus_tpu/ops/lanes.py pack_host`` packs
    the same layout), lengths 0 to 4*lanes, a field ending at the
    buffer's last byte."""
    rng = np.random.default_rng(lanes)
    data, starts, lens, chosen = _fields(rng, 777, 4 * lanes, 60)
    got = TP.pack_field_lanes_plain(torch.frombuffer(bytearray(data), dtype=torch.uint8),
                                    torch.from_numpy(starts.astype(np.int32)),
                                    torch.from_numpy(lens), lanes)
    want = pack_host(np.asarray(chosen, dtype=f"S{4 * lanes}"), lanes)
    assert got.shape == (lanes, 777)
    for w in range(lanes):
        assert got[w].tolist() == want[w].tolist()


def test_pack_reads_nothing_past_the_buffer():
    """A field whose length runs past the buffer packs as NUL there."""
    data = torch.tensor(list(b"abcdef"), dtype=torch.uint8)
    got = TP.pack_field_lanes_plain(data, torch.tensor([4], dtype=torch.int32),
                                    torch.tensor([6], dtype=torch.int32), 2)
    want = pack_host(np.asarray([b"ef"], dtype="S8"), 2)
    assert [got[0].item(), got[1].item()] == [int(want[0][0]), int(want[1][0])]


def test_pack_wrapper_checks():
    data = torch.zeros(4, dtype=torch.uint8)
    ok = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        TP.pack_field_lanes(data, ok, ok, 3)
    with pytest.raises(ValueError):
        TP.pack_field_lanes(data, ok.to(torch.int64), ok, 2)
    with pytest.raises(ValueError):
        TP.pack_field_lanes(data.to(torch.int32), ok, ok, 2)
    assert TP.pack_field_lanes(data, ok, ok, 2).shape == (2, 1)


def test_encode_column_device_matches_reference():
    """``encode_column_device``: the dictionary (bytes, dtype, itemsize)
    and codes of the reference's, and None over 32 bytes, in both."""
    from csvplus_tpu.ops.parse import encode_column_device as j_encode

    rng = np.random.default_rng(9)
    for max_len in (1, 7, 12, 31, 32, 33):
        data, starts, lens, _ = _fields(rng, 500, max_len, 25)
        got = TP.encode_column_device(torch.frombuffer(bytearray(data), dtype=torch.uint8),
                                      starts, lens)
        want = j_encode(jnp.asarray(np.frombuffer(data, np.uint8)), data, starts, lens)
        if want is None:
            assert got is None and max_len > 32
            continue
        assert got[0].dtype == want[0].dtype and got[0].tolist() == want[0].tolist()
        assert got[1].tolist() == np.asarray(want[1]).tolist()
    empty = TP.encode_column_device(torch.zeros(0, dtype=torch.uint8),
                                    np.zeros(0, np.int64), np.zeros(0, np.int32))
    assert str(empty[0].dtype) == "|S1" and empty[1].shape == (0,)


_simple_field = st.text(alphabet=st.characters(codec="utf-8", exclude_characters='\x00"\r\n,'),
                        max_size=10)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.lists(_simple_field, min_size=2, max_size=4), min_size=1, max_size=10),
       st.booleans())
def test_device_parse_hypothesis(tmp_path_factory, rows, trailing_nl):
    """Arbitrary simple rectangular CSVs: the same output as the reference
    (or the same decline, or the same error)."""
    width = max(len(r) for r in rows)
    rows = [r + [""] * (width - len(r)) for r in rows]
    text = "\n".join(",".join(r) for r in [[f"c{i}" for i in range(width)]] + rows)
    if trailing_nl:
        text += "\n"
    got, want = _both(tmp_path_factory.mktemp("dp"), text)
    assert got == want


# -- the streamed tier with the device chunk encoder ----------------------------


def _same_column(tc, jc):
    assert tc.kind == jc.kind
    if jc.kind == "int":
        assert tc.prefix == jc.prefix
        assert tc.values.tolist() == np.asarray(jc.values).tolist()
        return
    assert (tc.dev_dictionary is None) == (jc.dev_dictionary is None)
    assert tc._dev_dict_sorted == jc._dev_dict_sorted
    if jc.dev_dictionary is not None and jc._dictionary is None:
        assert tc._dictionary is None
        for t_lane, j_lane in zip(tc.dev_dictionary, jc.dev_dictionary):
            assert t_lane.tolist() == np.asarray(j_lane).tolist()
    else:
        assert tc.dictionary.tolist() == jc.dictionary.tolist()
    assert tc.codes.dtype == torch.int32
    assert tc.codes.tolist() == np.asarray(jc.codes).tolist()


WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta"]


def _demote_mid(n=60):
    rows = [f"o{i},{WORDS[i % 5]},{i}\n" for i in range(n)]
    rows[n * 2 // 3] = f"o{n * 2 // 3},w1,notanint\n"
    return "id,word,qty\n" + "".join(rows)


STREAM_CASES = {
    "strings-and-typed": ("id,name,qty\n" + "".join(
        f"r{i},{WORDS[i % 7]},{i % 13}\n" for i in range(60)), None),
    "distinct-chunk-dicts": ("k\n" + "".join(f"z{i}z\n" for i in range(30))
                             + "".join(f"a{i}a\n" for i in range(30)), None),
    "demotion-mid-file": (_demote_mid(), None),
    "wide-column": ("k,v\n" + "".join(f"{'x' * (30 + i % 6)}{i},{WORDS[i % 3]}\n"
                                      for i in range(40)),
                    None),
    "lane-column": ("k,v\n" + "".join(f"key-{(i * 7919) % 97:04d},{i % 3}\n"
                                      for i in range(80)), 20),
}


@pytest.mark.parametrize("chunk", [23, 64, 1 << 20])
@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streamed_tier_with_encoder_matches_reference(tmp_path, monkeypatch, case, chunk):
    """The streamed tier with the device chunk encoder: the same columns,
    bit for bit, as the reference's (host dictionaries, a lane column, a
    mid-file typed demotion, a column over 32 bytes that the encoder
    declines); K forced to 1 though 4 workers are asked for."""
    text, lanes = STREAM_CASES[case]
    monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")
    monkeypatch.setenv("CSVPLUS_STREAM_CHUNK_BYTES", str(chunk))
    monkeypatch.setenv("CSVPLUS_INGEST_WORKERS", "4")
    if lanes is not None:
        monkeypatch.setenv("CSVPLUS_DICT_DEVICE_MIN_DISTINCT", str(lanes))
    path = _write(tmp_path, text)
    encoded = []
    real = TP.encode_column_device

    def counting(*a):
        out = real(*a)
        encoded.append(out is not None)
        return out

    monkeypatch.setattr(TP, "encode_column_device", counting)
    stages = {}
    with t_tel.collect():
        t = T.from_file(path).on_device("cpu")
        stages["port"] = {r.stage: r for r in t_tel.records}
    with j_tel.collect():
        j = J.from_file(path).on_device("cpu")
        stages["ref"] = {r.stage: r for r in j_tel.records}
    tt, jt = t.plan.table, j.plan.table
    assert tt.ingest_tier == "streamed" and tt.nrows == jt.nrows
    assert tt.ingest_seconds["workers"] == 1
    for side in ("port", "ref"):
        assert stages[side]["ingest:scan"].extra["workers"] == 1
        assert stages[side]["ingest:encode"].extra["workers"] == 1
    assert list(tt.columns) == list(jt.columns)
    for name in jt.columns:
        _same_column(tt.columns[name], jt.columns[name])
    assert t.to_rows() == j.to_rows()
    assert t_checksum(tt, positional=True) == j_checksum(jt, positional=True)
    assert any(encoded)  # the encoder ran on the device path
    if case == "wide-column":
        assert not all(encoded)  # ... and declined the column over 32 bytes
    if case == "lane-column":
        assert tt.columns["k"].dev_dictionary is not None
    if case == "demotion-mid-file":
        assert tt.columns["qty"].kind == "str"


def test_typed_only_stream_launches_no_encode_but_one_worker(tmp_path, monkeypatch):
    """Every column typed: the encoder never runs, K is still 1."""
    monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")
    monkeypatch.setenv("CSVPLUS_STREAM_CHUNK_BYTES", "64")
    monkeypatch.setenv("CSVPLUS_INGEST_WORKERS", "4")
    path = _write(tmp_path, "a,b\n" + "".join(f"o{i},{i}\n" for i in range(50)))
    calls = []
    monkeypatch.setattr(TP, "encode_column_device", lambda *a: calls.append(1))
    t = T.from_file(path).on_device("cpu").plan.table
    assert t.ingest_tier == "streamed" and t.ingest_seconds["workers"] == 1
    assert {c.kind for c in t.columns.values()} == {"int"} and not calls


# -- the policy --------------------------------------------------------------------


def test_policy_flag_device_and_rtt(monkeypatch):
    monkeypatch.setenv("CSVPLUS_DEVICE_PARSE", "0")
    assert not TI._device_parse_enabled("cuda")
    monkeypatch.setenv("CSVPLUS_DEVICE_PARSE", "1")
    assert TI._device_parse_enabled("cpu")
    monkeypatch.delenv("CSVPLUS_DEVICE_PARSE")
    assert not TI._device_parse_enabled("cpu")  # the CPU: off, no probe
    monkeypatch.setattr(TI, "link_rtt_ms", lambda device="cuda": 5.0)
    assert TI._device_parse_enabled("cuda")
    monkeypatch.setattr(TI, "link_rtt_ms", lambda device="cuda": 25.0)
    assert not TI._device_parse_enabled("cuda")
    monkeypatch.setenv("CSVPLUS_DEVICE_PARSE_MAX_RTT_MS", "30")
    assert TI._device_parse_enabled("cuda")
    monkeypatch.setenv("CSVPLUS_DEVICE_PARSE_MAX_RTT_MS", "junk")  # the default, 20 ms
    assert not TI._device_parse_enabled("cuda")


def test_default_off_on_the_cpu_keeps_native_encoded(tmp_path, monkeypatch):
    monkeypatch.delenv("CSVPLUS_DEVICE_PARSE")
    path = _write(tmp_path, TEXTS["simple"])
    assert T.from_file(path).on_device("cpu").plan.table.ingest_tier == "native-encoded"


def test_link_rtt_is_measured_and_cached(monkeypatch):
    TI._link_rtt_cache.clear()
    rtt = TI.link_rtt_ms("cpu")
    assert rtt >= 0.0 and TI.link_rtt_ms("cpu") == rtt
    TI._link_rtt_cache.clear()


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path = _write(tmp_path, TEXTS["simple"])
    with pytest.raises(RuntimeError):
        TS.read_device_parsed_columns(T.from_file(path), path, "cuda")
    with pytest.raises(RuntimeError):
        TP.parse_simple_csv_device(b"a\n1\n", ",", "cuda")
