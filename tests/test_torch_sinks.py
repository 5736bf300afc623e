"""The port's vectorized sinks (``csvplus_tpu_torch/columnar/csvenc.py``,
``sinks.py``'s device fast paths, ``to_json``/``to_json_file``) held byte
for byte against the JAX package's on the CPU: ``to_csv``,
``to_csv_file``, ``to_json`` and ``to_json_file`` over dictionary, typed
and lane columns fed to both packages from the same numpy arrays; cells
that need CSV quoting (quote, CR, LF, delimiter, leading space, ``\\.``,
a typed prefix that needs quoting); Go's JSON escapes; the same errors
and no file left behind for absent cells and missing columns; an empty
result; and the C++ scatter against the numpy build of the CSV body."""

import io
import os

import numpy as np
import pytest

import jax.numpy as jnp

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu.columnar.ingest import source_from_table as j_source
from csvplus_tpu.columnar.table import DeviceTable as JTable
from csvplus_tpu.columnar.table import StringColumn as JString
from csvplus_tpu.columnar.typed import IntColumn as JInt
from csvplus_tpu_torch.columnar import csvenc
from csvplus_tpu_torch.columnar.ingest import source_from_table as t_source
from csvplus_tpu_torch.columnar.table import from_reference_arrays
from csvplus_tpu_torch.ops.lanes import lanes_for_width, pack_host

SPECIAL = ['say "hi"', "x,y", " lead", "\tlead", "cr\rx", "lf\nx", "\\.", "\\.x", "plain", "",
           "a&b<c>d", "bs\x08ff\x0c", "ctl\x01\x1f", "ls ps ", "unicode→é",
           'q"uo\\te', "tab\there"]


def _dict(values):
    return np.unique(np.array([v.encode("utf-8") for v in values], dtype="S"))


def _tables(columns, n):
    """The same encoded table in both packages.  *columns* maps a name to
    ("str", values), ("int", prefix, values) or ("lanes", values,
    sorted): lanes are packed from the values' dictionary (shuffled and
    duplicated when unsorted, as the streamed tier leaves it)."""
    rng = np.random.default_rng(n)
    t_cols, j_cols = {}, {}
    for name, spec in columns.items():
        if spec[0] == "int":
            _, prefix, vals = spec
            vals = np.asarray(vals, dtype=np.int32)
            t_cols[name] = ("int", prefix, vals)
            j_cols[name] = JInt(prefix, jnp.asarray(vals))
            continue
        d = _dict(spec[1])
        codes = rng.integers(0, d.size, n).astype(np.int32)
        if spec[0] == "str":
            t_cols[name] = (d, codes)
            j_cols[name] = JString(d, jnp.asarray(codes))
            continue
        sorted_ = spec[2]
        entries = d if sorted_ else np.concatenate([d[::-1], d[: d.size // 2]])
        slots = codes if sorted_ else (d.size - 1 - codes)  # the same cells
        lanes = pack_host(entries, lanes_for_width(entries.dtype.itemsize))
        t_cols[name] = ("lanes", lanes, slots, sorted_)
        j_cols[name] = JString(None, jnp.asarray(slots), dev_dictionary=tuple(
            jnp.asarray(x) for x in lanes), dev_dict_sorted=sorted_)
    return from_reference_arrays(t_cols, "cpu"), JTable(j_cols, n, None)


TABLES = {
    "dictionary": ({"a": ("str", SPECIAL), "b": ("str", ["x", "y", "z"])}, 60),
    "typed": ({"id": ("int", b"o", [0, 7, -3, 2**31 - 1, -(2**31 - 1)] * 6),
               "q": ("int", b"", list(range(-15, 15)))}, 30),
    "typed-affix-needs-quotes": ({"p": ("int", b"a,b", [1, 2, 3]), "s": ("int", b" x", [4, 5, 6]),
                                  "q": ("int", b'q"', [7, 8, 9])}, 3),
    "lanes-sorted": ({"k": ("lanes", [f"key-{i:04d}" for i in range(50)], True),
                      "v": ("str", SPECIAL)}, 80),
    "lanes-unsorted": ({"k": ("lanes", [f"key-{i:04d}" for i in range(50)] + SPECIAL, False),
                        "n": ("int", b"n", list(range(80)))}, 80),
    "mixed": ({"k": ("lanes", SPECIAL, False), "a": ("str", SPECIAL),
               "i": ("int", b"", list(range(40)))}, 40),
}


def _sinks(src, columns):
    csv_buf, json_buf = io.StringIO(), io.StringIO()
    src.to_csv(csv_buf, *columns)
    src.to_json(json_buf)
    return csv_buf.getvalue(), json_buf.getvalue()


@pytest.mark.parametrize("case", sorted(TABLES))
def test_sink_bytes_match_reference(case):
    spec, n = TABLES[case]
    tt, jt = _tables(spec, n)
    cols = list(spec)[::-1]
    got = _sinks(t_source(tt), cols)
    want = _sinks(j_source(jt), cols)
    assert got == want
    assert got[0].count("\n") > n and got[1].startswith("[{")
    # both CSV builds of the port give the same bytes
    assert csvenc.encode_csv_body(tt, cols, native=True) == csvenc.encode_csv_body(
        tt, cols, native=False) == got[0].split("\n", 1)[1]


@pytest.mark.parametrize("case", sorted(TABLES))
def test_sink_files_match_reference(case, tmp_path):
    spec, n = TABLES[case]
    tt, jt = _tables(spec, n)
    cols = list(spec)
    for pkg_src, tag in ((t_source(tt), "t"), (j_source(jt), "j")):
        pkg_src.to_csv_file(str(tmp_path / f"{tag}.csv"), *cols)
        pkg_src.to_json_file(str(tmp_path / f"{tag}.json"))
    for ext in ("csv", "json"):
        assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()


def test_lane_sink_needs_no_sort_of_a_sorted_lane_column():
    """A sorted lane column's sink unpacks the lanes on the host once; an
    unsorted one is sorted on the device first (its codes are remapped
    before they are read)."""
    from csvplus_tpu_torch.columnar import table as TB

    TB.lane_sorts.clear()
    tt, _ = _tables(TABLES["lanes-sorted"][0], 80)
    csvenc.encode_csv_body(tt, ["k"])
    assert TB.lane_sorts == []
    tt, _ = _tables(TABLES["lanes-unsorted"][0], 80)
    csvenc.encode_csv_body(tt, ["k"])
    assert len(TB.lane_sorts) == 1


def test_go_json_escapes_match_reference():
    rows = [{"k": v, "a&b\x08": "v"} for v in SPECIAL]
    got, want = io.StringIO(), io.StringIO()
    T.take_rows([T.Row(r) for r in rows]).to_json(got)
    J.TakeRows([J.Row(r) for r in rows]).to_json(want)
    assert got.getvalue() == want.getvalue()
    text = got.getvalue()
    assert "\\u0008" in text and "\\u000c" in text and "\\u2028" in text and "\\u2029" in text
    assert "a&b<c>d" in text  # &<> are not escaped
    # the device path's vectorized JSON body, the same bytes
    tt = T.take_rows([T.Row(r) for r in rows]).on_device("cpu")
    buf = io.StringIO()
    tt.to_json(buf)
    assert buf.getvalue() == text


@pytest.fixture
def hetero(tmp_path):
    rows = [{"a": "1", "b": "x"}, {"a": "2"}, {"a": "3", "b": "z"}]

    def sources():
        return (T.take_rows([T.Row(r) for r in rows]).on_device("cpu"),
                J.TakeRows([J.Row(r) for r in rows]).on_device("cpu"))

    return sources


def _error(fn):
    with pytest.raises(Exception) as ei:
        fn()
    return type(ei.value).__name__, str(ei.value), getattr(ei.value, "line", None)


@pytest.mark.parametrize("columns", [("a", "b"), ("a", "missing")], ids=["absent", "missing"])
def test_sink_errors_match_reference_and_leave_no_file(hetero, tmp_path, columns):
    """Absent cells or a missing column: the streaming fallback raises the
    reference's error with its row number, and no file is left."""
    t_src, j_src = hetero()
    t_path, j_path = tmp_path / "t.csv", tmp_path / "j.csv"
    got = _error(lambda: t_src.to_csv_file(str(t_path), *columns))
    want = _error(lambda: j_src.to_csv_file(str(j_path), *columns))
    assert got == want and got[0] == "DataSourceError"
    assert not os.path.exists(t_path) and not os.path.exists(j_path)


def test_json_of_rows_with_absent_cells_matches_reference(hetero, tmp_path):
    """Rows of different schemas: JSON streams them (no error)."""
    t_src, j_src = hetero()
    t_src.to_json_file(str(tmp_path / "t.json"))
    j_src.to_json_file(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert csvenc.encode_json_body(t_src.to_device_table()) is None


def test_empty_result_matches_reference(people_csv, tmp_path):
    def run(pkg, tag):
        src = pkg.from_file(people_csv).on_device("cpu").filter(pkg.Like({"name": "nobody"}))
        src.to_csv_file(str(tmp_path / f"{tag}.csv"), "name", "surname")
        src.to_json_file(str(tmp_path / f"{tag}.json"))

    run(T, "t")
    run(J, "j")
    for ext in ("csv", "json"):
        assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
    assert (tmp_path / "t.json").read_bytes() == b"[]"
    assert (tmp_path / "t.csv").read_bytes() == b"name,surname\n"


def test_device_sink_runs_the_plan_once(people_csv, monkeypatch):
    """The CSV fast path executes the device plan once and never decodes
    rows (no per-row writer)."""
    from csvplus_tpu_torch.columnar import exec as E
    from csvplus_tpu_torch.columnar.table import DeviceTable

    calls = []
    real = E.execute_plan
    monkeypatch.setattr(E, "execute_plan", lambda root: calls.append(1) or real(root))
    monkeypatch.setattr(DeviceTable, "to_rows", lambda *a, **k: pytest.fail("rows decoded"))
    src = T.from_file(people_csv).on_device("cpu").filter(T.Not(T.Like({"name": "Amelia"})))
    buf = io.StringIO()
    src.to_csv(buf, "name", "surname", "born")
    assert len(calls) == 1 and buf.getvalue().count("\n") > 100
    want = io.StringIO()
    J.from_file(people_csv).on_device("cpu").filter(J.Not(J.Like({"name": "Amelia"}))).to_csv(
        want, "name", "surname", "born")
    assert buf.getvalue() == want.getvalue()


def test_to_json_aliases():
    src = T.take_rows([T.Row({"b": "2", "a": "1"})])
    buf = io.StringIO()
    src.ToJSON(buf)
    assert buf.getvalue() == '[{"a":"1","b":"2"}\n]'
    assert T.DataSource.ToJSONFile is T.DataSource.to_json_file
