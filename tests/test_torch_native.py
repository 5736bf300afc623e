"""The port's native CSV scanner (``csvplus_tpu_torch/native``) held
bitwise against the JAX package's (``csvplus_tpu/native``) on the same
bytes: the scan (single pass and threaded), the vectorized dictionary
encode, the typed int32 parse, the C++ itoa, both whole-file ingest tiers
and their errors, the tier that ingest picks, and the rule that a scanner
which cannot be built or loaded raises instead of falling back."""

import random

import numpy as np
import pytest

import csvplus_tpu as J
import csvplus_tpu.native.scanner as JS
import csvplus_tpu_torch as T
import csvplus_tpu_torch.native.scanner as TS

# quotes, CR/LF, blank lines, ragged rows, scratch fields, UTF-8, a NUL
# byte and a 300-byte field
SCAN_CASES = {
    "plain": "a,b,c\n1,2,3\n",
    "no-final-newline": "a,b\n1,2",
    "crlf": "x\r\ny\r\n",
    "quoted-comma": '"quoted,comma",2\n',
    "doubled-quotes": '"say ""hi""",2\n',
    "multiline-quoted": '"multi\nline",2\n"multi\r\nline",3\n',
    "empty-fields": "1,,3\n1,2,\n",
    "blank-lines": "\n\n1,2\n\n3,4\n",
    "empty": "",
    "lone-cr": "lone\rcr,2\ntrail\r",
    "ragged": "a,b,c\n1,2\n3,4,5,6\n",
    "comments": "#c\na,b\n#x,y\n1,2\n",
    "utf8": "a,b\nZoë,Zürich\nλ,😀\n",
    "nul": "a,b\nx\x00y,1\n",
    "long-field": "a,b\n" + "x" * 300 + ",1\n",
}
DIALECTS = {
    "default": {},
    "comment": {"comment": "#"},
    "lazy": {"lazy_quotes": True},
    "semicolon": {"delimiter": ";"},
}
ERROR_CASES = {
    "bare-quote": 'a,b\nx"y,2\n',
    "extraneous-quote": 'a,b\n1,2\n"x"y,2\n',
    "never-closed": 'a,b\n"never closed\n',
}


def _same_scan(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3] == want[3]


def _err(fn):
    with pytest.raises(Exception) as ei:
        fn()
    e = ei.value
    return type(e).__name__, str(e), getattr(e, "line", None)


def _same_scan_or_error(data: bytes, kw: dict) -> None:
    """Identical scans of *data*, or the identical error."""
    try:
        want = JS.scan_bytes(data, **kw)
    except J.DataSourceError:
        assert _err(lambda: TS.scan_bytes(data, **kw)) == _err(
            lambda: JS.scan_bytes(data, **kw))
        return
    _same_scan(TS.scan_bytes(data, **kw), want)


@pytest.mark.parametrize("dialect", sorted(DIALECTS))
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_bytes_matches_reference(case, dialect):
    _same_scan_or_error(SCAN_CASES[case].encode("utf-8"), DIALECTS[dialect])


@pytest.mark.parametrize("lazy", [False, True], ids=["strict", "lazy"])
@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_scan_errors_match_reference(case, lazy):
    data = ERROR_CASES[case].encode()
    if lazy:  # lazy quotes accept what strict mode rejects, identically
        _same_scan(TS.scan_bytes(data, lazy_quotes=True), JS.scan_bytes(data, lazy_quotes=True))
        return
    got = _err(lambda: TS.scan_bytes(data))
    assert got[0] == "DataSourceError" and got[2] is not None
    assert got == _err(lambda: JS.scan_bytes(data))


def _quote_free_data(n: int = 4000) -> bytes:
    rng = np.random.default_rng(5)
    return "".join(
        f"{i},v{int(x)},w{int(y)}\n"
        for i, (x, y) in enumerate(zip(rng.integers(0, 50, n), rng.integers(0, 9, n)))
    ).encode()


@pytest.mark.parametrize("threads", [2, 7])
def test_scan_bytes_parallel_matches_reference(monkeypatch, threads):
    data = _quote_free_data()
    monkeypatch.setattr(JS, "_PARALLEL_MIN_BYTES", 1024)
    monkeypatch.setattr(TS, "_PARALLEL_MIN_BYTES", 1024)
    got = TS.scan_bytes_parallel(data, n_threads=threads)
    _same_scan(got, JS.scan_bytes_parallel(data, n_threads=threads))
    _same_scan(got, TS.scan_bytes(data))  # and the chunked scan == one pass
    quoted = b'a,b\n"q,x",2\n' * 200  # quotes force the single pass
    _same_scan(TS.scan_bytes_parallel(quoted, n_threads=threads),
               JS.scan_bytes_parallel(quoted, n_threads=threads))


def _fields(values):
    """(combined bytes as u8, starts, lens) of a list of byte strings."""
    blob = b"".join(values)
    lens = np.array([len(v) for v in values], dtype=np.int32)
    starts = np.zeros(len(values), dtype=np.int64)
    if len(values) > 1:
        starts[1:] = np.cumsum(lens[:-1])
    return np.frombuffer(blob + b"\x00", dtype=np.uint8), starts, lens


@pytest.mark.parametrize("distinct", [30, 3000], ids=["hash", "sort"])
@pytest.mark.parametrize("width", [(1, 8), (9, 16), (17, 40)], ids=["le8", "9-16", "gt16"])
def test_encode_fields_vectorized_matches_reference(width, distinct):
    rng = np.random.default_rng(width[0] * 7 + distinct)
    alphabet = np.frombuffer(b"abcXYZ019-_ ", dtype=np.uint8)
    pool = [
        bytes(rng.choice(alphabet, size=int(rng.integers(width[0], width[1] + 1))))
        for _ in range(distinct)
    ]
    values = [pool[i] for i in rng.integers(0, distinct, 4000)]
    combined, starts, lens = _fields(values)
    got = TS.encode_fields_vectorized(combined, starts, lens)
    want = JS.encode_fields_vectorized(combined, starts, lens)
    assert got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])
    assert got[1].dtype == want[1].dtype and np.array_equal(got[1], want[1])
    assert got[0][got[1]].tolist() == values  # decodes back to the input


def test_encode_fields_vectorized_declines_long_fields():
    combined, starts, lens = _fields([b"x" * 300, b"y"])
    assert TS.encode_fields_vectorized(combined, starts, lens) is None
    assert JS.encode_fields_vectorized(combined, starts, lens) is None


PACK_CASES = {
    "ints": ([b"0", b"-7", b"42", b"2147483647", b"-2147483647"], None),
    "ids": ([b"o1", b"o0", b"o123456789"], None),
    "leading-zeros-join-prefix": ([b"o007", b"o001", b"o009"], None),
    "established-prefix": ([b"c5", b"c6"], b"c"),
    "minus-zero": ([b"1", b"-0"], None),
    "overflow": ([b"2147483648"], None),
    "int32-min": ([b"-2147483648"], None),
    "prefix-drift": ([b"o1", b"p2"], None),
    "wrong-established-prefix": ([b"c5"], b"o"),
    "non-canonical": ([b"o1", b"o01"], None),
    "sign-after-prefix": ([b"o1", b"o-1"], None),
    "no-digits": ([b"abc"], None),
    "too-long-prefix": ([b"x" * 30 + b"1"], None),
    "empty-column": ([], None),
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_int32_native_matches_reference(case):
    values, prefix = PACK_CASES[case]
    combined, starts, lens = _fields(values)
    got = TS.pack_int32_native(combined, starts, lens, prefix)
    want = JS.pack_int32_native(combined, starts, lens, prefix)
    if want is None:
        assert got is None
        return
    assert got[0] == want[0]
    assert got[1].dtype == np.int32 and np.array_equal(got[1], want[1])


def test_pack_int32_native_threaded_ranges(monkeypatch):
    values = [b"o%d" % i for i in range(5000)]
    combined, starts, lens = _fields(values)
    monkeypatch.setattr(TS, "_PACK_THREADS_MIN_N", 16)
    got = TS.pack_int32_native(combined, starts, lens, None)
    assert got[0] == b"o" and np.array_equal(got[1], np.arange(5000, dtype=np.int32))
    bad = values[:4000] + [b"o01"] + values[4001:]  # one bad cell in a later range
    assert TS.pack_int32_native(*_fields(bad), None) is None


def test_format_i32_native_matches_reference():
    rng = np.random.default_rng(11)
    values = np.concatenate([
        np.array([0, -1, 1, 9, 10, -10, 2**31 - 1, -(2**31) + 1, -(2**31)], np.int32),
        rng.integers(-(2**31), 2**31, 3000).astype(np.int32),
    ])
    got_mat, got_lens = TS.format_i32_native(values)
    want_mat, want_lens = JS.format_i32_native(values)
    assert np.array_equal(got_mat, want_mat) and np.array_equal(got_lens, want_lens)
    text = [bytes(r[:l]).decode() for r, l in zip(got_mat, got_lens)]
    assert text == [str(int(v)) for v in values]


def _write(tmp_path, text, name="t.csv"):
    p = tmp_path / name
    p.write_bytes(text.encode("utf-8"))
    return str(p)


def _same_encoded(got, want):
    if want is None:
        assert got is None
        return
    assert got[0] == want[0]
    assert list(got[1]) == list(want[1])
    for name in want[0]:
        g, w = got[1][name], want[1][name]
        assert len(g) == len(w)
        if len(w) == 3:
            assert g[0] == w[0] == "int" and g[1] == w[1]
            assert g[2].dtype == np.int32 and np.array_equal(g[2], w[2])
        else:
            assert g[0].dtype == w[0].dtype and np.array_equal(g[0], w[0])
            assert g[1].dtype == w[1].dtype and np.array_equal(g[1], w[1])


ENCODED_FILES = {
    "typed-and-strings": "id,name,qty,price\n" + "".join(
        f"o{i},n{i % 13}x,{i % 7 - 3},{i % 11}.5\n" for i in range(300)),
    "quoted-scratch": 'a,b\n"esc ""q""",2\n"multi\nline",3\nplain,4\n',
    "crlf-and-blank-lines": "a,b\r\n1,x\r\n\r\n2,y\r\n",
    "comments": "a,b\n#skip\n1,2\n",
    "utf8": "a,b\nZoë,Zürich\n",
    "nul": "a,b\nx\x00y,1\n",
    "long-field": "a,b\n" + "x" * 300 + ",1\n",
    "extremes": "v,w\n2147483647,-2147483647\n-5,0\n",
    "minus-zero-stays-string": "v\n-0\n1\n",
}


@pytest.mark.parametrize("typed", ["1", "0"])
@pytest.mark.parametrize("case", sorted(ENCODED_FILES))
def test_read_encoded_columns_native_matches_reference(tmp_path, monkeypatch, case, typed):
    monkeypatch.setenv("CSVPLUS_TYPED_LANES", typed)
    path = _write(tmp_path, ENCODED_FILES[case])
    comment = "#" if case == "comments" else None

    def reader(pkg):
        r = pkg.from_file(path)
        return r.comment_char(comment) if comment else r

    got = TS.read_encoded_columns_native(reader(T), path)
    _same_encoded(got, JS.read_encoded_columns_native(reader(J), path))
    if case == "typed-and-strings":
        kinds = {n: len(v) == 3 for n, v in got[1].items()}
        assert kinds == {"id": typed == "1", "name": False, "qty": typed == "1",
                         "price": False}


def test_read_encoded_columns_native_threaded_columns(tmp_path, monkeypatch):
    """The column pool and the threaded pack, at a small size."""
    path = _write(tmp_path, "a,b,c\n" + "".join(
        f"o{i},x{i % 37}y,{(i * 7919) % 1000}\n" for i in range(3000)))
    for mod in (TS, JS):
        monkeypatch.setattr(mod, "_PACK_THREADS_MIN_N", 64)
    got = TS.read_encoded_columns_native(T.from_file(path), path)
    _same_encoded(got, JS.read_encoded_columns_native(J.from_file(path), path))
    assert len(got[1]["a"]) == 3 and len(got[1]["b"]) == 2


READER_POLICIES = {
    "auto-header": lambda r: r,
    "select-columns": lambda r: r.select_columns("c", "a"),
    "assume-header-any": lambda r: r.assume_header({"x": 0, "z": 2}).num_fields_any(),
    "expect-header": lambda r: r.expect_header({"a": 0, "b": 1}).num_fields_any(),
}


@pytest.mark.parametrize("policy", sorted(READER_POLICIES))
def test_header_policies_match_reference(tmp_path, policy):
    path = _write(tmp_path, "a,b,c\n1,2,3\n4\n5,6,7\n")
    mk = READER_POLICIES[policy]
    for tier in ("read_encoded_columns_native", "read_columns_native"):
        t_fn, j_fn = getattr(TS, tier), getattr(JS, tier)
        try:
            want = j_fn(mk(J.from_file(path)), path)
        except Exception:
            assert _err(lambda: t_fn(mk(T.from_file(path)), path)) == _err(
                lambda: j_fn(mk(J.from_file(path)), path))
            continue
        got = t_fn(mk(T.from_file(path)), path)
        if tier == "read_columns_native":
            assert got == want
        else:
            _same_encoded(got, want)


@pytest.mark.parametrize("text", [
    "a,b\n1,2\n1,2,3\n",  # wrong number of fields
    "",  # no header record
    'a,b\n"x"y,2\n',  # a parse error on row 2
    'a,b\r\n1,2\r\n"never closed\n',  # an unclosed quote on row 3
])
def test_ingest_errors_match_reference(tmp_path, text):
    path = _write(tmp_path, text)
    for tier in ("read_encoded_columns_native", "read_columns_native"):
        got = _err(lambda: getattr(TS, tier)(T.from_file(path), path))
        assert got == _err(lambda: getattr(JS, tier)(J.from_file(path), path))
    got = _err(lambda: T.from_file(path).on_device("cpu").to_rows())
    assert got == _err(lambda: J.from_file(path).on_device("cpu").to_rows())


def _reference_tier(monkeypatch, reader, path):
    """The tier the JAX package's ingest takes for *reader*, seen by
    spying on its two native tier functions."""
    seen = []

    def spy(name):
        real = getattr(JS, name)

        def call(*a, **kw):
            out = real(*a, **kw)
            seen.append((name, out is not None))
            return out

        monkeypatch.setattr(JS, name, call)

    spy("read_encoded_columns_native")
    spy("read_columns_native")
    reader.on_device("cpu")
    if ("read_encoded_columns_native", True) in seen:
        return "native-encoded"
    if ("read_columns_native", True) in seen:
        return "native-strings"
    return "python"


TIER_READERS = {
    "default": (lambda pkg, p: pkg.from_file(p), "native-encoded"),
    "comment": (lambda pkg, p: pkg.from_file(p).comment_char("#"), "native-encoded"),
    "lazy-quotes": (lambda pkg, p: pkg.from_file(p).lazy_quotes(), "native-encoded"),
    "trim-leading-space": (lambda pkg, p: pkg.from_file(p).trim_leading_space(), "python"),
    "two-byte-delimiter": (lambda pkg, p: pkg.from_file(p).delimiter("é"), "python"),
    "two-byte-comment": (lambda pkg, p: pkg.from_file(p).comment_char("é"), "python"),
    "nul-byte": (lambda pkg, p: pkg.from_file(p), "native-strings"),
    "long-field": (lambda pkg, p: pkg.from_file(p), "native-strings"),
}


@pytest.mark.parametrize("case", sorted(TIER_READERS))
def test_tier_matches_reference(tmp_path, monkeypatch, case):
    mk, want_tier = TIER_READERS[case]
    text = "a,b\nx1,2\nx2,3\n"
    if case == "nul-byte":
        text = "a,b\nx\x00y,1\n"
    elif case == "long-field":
        text = "a,b\n" + "x" * 300 + ",1\n"
    path = _write(tmp_path, text)
    assert _reference_tier(monkeypatch, mk(J, path), path) == want_tier
    src = mk(T, path).on_device("cpu")
    assert src.plan.table.ingest_tier == want_tier
    want_rows = mk(J, path).on_device("cpu").to_rows()
    assert src.to_rows() == want_rows


def test_conftest_corpus_takes_the_native_encoded_tier(corpus, monkeypatch):
    for key in ("orders_csv", "people_csv", "stock_csv"):
        path = corpus[key]
        assert _reference_tier(monkeypatch, J.from_file(path), path) == "native-encoded"
        assert T.from_file(path).on_device("cpu").plan.table.ingest_tier == "native-encoded"


@pytest.fixture
def fresh_scanner(monkeypatch, tmp_path):
    """The port's scanner module with no library loaded, building into a
    scratch directory."""
    monkeypatch.setattr(TS, "_lib", None)
    monkeypatch.setattr(TS, "BUILD_DIR", tmp_path / "build")
    return TS


def test_scanner_build_failure_raises(fresh_scanner, tmp_path, monkeypatch, people_csv):
    broken = tmp_path / "scanner.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(TS, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="native scanner build failed"):
        T.from_file(people_csv).on_device("cpu")
    with pytest.raises(RuntimeError, match="native scanner build failed"):
        TS.scan_bytes(b"a,b\n")


def test_scanner_load_failure_raises(fresh_scanner, tmp_path, monkeypatch, people_csv):
    junk = tmp_path / "libjunk.so"
    junk.write_bytes(b"not a shared object")
    monkeypatch.setattr(TS, "build", lambda: junk)
    with pytest.raises(RuntimeError, match="cannot be loaded"):
        T.from_file(people_csv).on_device("cpu")


def test_scanner_without_gxx_raises(fresh_scanner, monkeypatch, people_csv):
    monkeypatch.setattr(TS.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        T.from_file(people_csv).on_device("cpu")


def test_scanner_builds_under_a_source_hash(fresh_scanner):
    path = TS.build()
    assert path.parent == TS.BUILD_DIR and path.name.startswith("libcsvplus_scanner_")
    assert TS.build() == path  # a second call reuses the build
    assert TS._load() is TS._load()


def test_seeded_scan_fuzz_matches_reference():
    """Random quote/CRLF/comment/delimiter placements: identical offsets,
    or the identical error."""
    tokens = ['"', '""', ",", ";", "\n", "\r\n", "\r", "#", " ", "a", "Zoë", "42", 'q"q']
    for seed in range(150):
        rng = random.Random(seed)
        data = "".join(rng.choice(tokens) for _ in range(rng.randrange(0, 40))).encode()
        for kw in DIALECTS.values():
            _same_scan_or_error(data, kw)
