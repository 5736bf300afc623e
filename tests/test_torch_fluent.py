"""The fluent stages this slice adds to the port's ``DataSource`` —
``except_``, ``drop``, ``take_while``, ``drop_while`` and ``explain`` —
held against the JAX package on the CPU, on the conftest corpus (120
people, 8 products, 10 000 orders).

Each chain runs on the host path and on the device (``"cpu"``) in both
packages: the rows, the positional checksums, the plan each builds (or
where it fell to the host, and why) and errors with their row numbers
must be equal, and the device result must equal the host result."""

import re

import pytest

import csvplus_tpu as J
import csvplus_tpu_torch as T
from csvplus_tpu.utils.checksum import checksum_device_table as j_checksum
from csvplus_tpu_torch.utils.checksum import checksum_device_table as t_checksum


def _src(pkg, path, device):
    src = pkg.from_file(path)
    return src.on_device("cpu") if device else pkg.take(src)


def _index(pkg, corpus, device, unique_ids=(3, 5, 7, 11, 13)):
    """A unique index of a few product ids (device or host)."""
    src = _src(pkg, corpus["stock_csv"], device).filter(
        pkg.Any(*[pkg.Like({"prod_id": str(i)}) for i in range(8) if i in unique_ids]))
    return src.unique_index_on("prod_id")


CHAINS = {
    "except": lambda pkg, src, idx: src.except_(idx, "prod_id"),
    "except-then-filter": lambda pkg, src, idx: src.except_(idx, "prod_id").filter(
        pkg.Like({"qty": "3"})),
    "filter-then-except-default-columns": lambda pkg, src, idx: src.select_columns(
        "order_id", "prod_id").except_(idx),
    "drop": lambda pkg, src, idx: src.drop(9_990),
    "drop-all": lambda pkg, src, idx: src.drop(20_000),
    "drop-zero-then-top": lambda pkg, src, idx: src.drop(0).top(4),
    "take-while": lambda pkg, src, idx: src.take_while(pkg.Not(pkg.Like({"qty": "9"}))),
    "take-while-none": lambda pkg, src, idx: src.take_while(pkg.Like({"qty": "nope"})),
    "drop-while": lambda pkg, src, idx: src.drop_while(pkg.Not(pkg.Like({"qty": "9"}))).top(50),
    "drop-while-all": lambda pkg, src, idx: src.drop_while(pkg.Not(pkg.Like({"qty": "nope"}))),
    "windows-then-join": lambda pkg, src, idx: src.drop(5).take_while(
        pkg.Not(pkg.Like({"prod_id": "3", "qty": "1"}))).join(idx, "prod_id"),
    "opaque-take-while": lambda pkg, src, idx: src.take_while(lambda row: row["qty"] != "9"),
    "except-missing-column": lambda pkg, src, idx: src.except_(idx, "nope"),
}


def _outcome(src):
    try:
        return ("rows", [dict(r) for r in src.to_rows()])
    except Exception as e:
        return ("error", type(e).__name__, str(e))


@pytest.mark.parametrize("device", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_fluent_stage_matches_reference(corpus, name, device):
    got = {}
    for pkg in (J, T):
        src = _src(pkg, corpus["orders_csv"], device)
        chain = CHAINS[name](pkg, src, _index(pkg, corpus, device))
        got[pkg] = (_outcome(chain), chain.plan is not None, chain.plan_note)
    assert got[T] == got[J]
    if not device:
        assert not got[T][1]
    if name.startswith("opaque") and device:
        assert got[T][2] == "take_while(<lambda>) is not symbolic"
    if got[T][0][0] == "rows":
        host = CHAINS[name](T, _src(T, corpus["orders_csv"], False),
                            _index(T, corpus, False))
        assert _outcome(host) == got[T][0]


@pytest.mark.parametrize("name", ["except", "except-then-filter", "drop", "take-while",
                                  "drop-while", "windows-then-join"])
def test_fluent_stage_lowers_and_checksums_match_reference(corpus, name):
    tables = {}
    for pkg in (J, T):
        chain = CHAINS[name](pkg, _src(pkg, corpus["orders_csv"], True),
                             _index(pkg, corpus, True))
        assert chain.plan is not None
        tables[pkg] = chain.to_device_table()
    assert tables[T].nrows == tables[J].nrows > 0
    assert list(tables[T].columns) == list(tables[J].columns)
    assert t_checksum(tables[T], positional=True) == j_checksum(tables[J], positional=True)


def _explained(chain) -> str:
    """``explain()`` with the index objects' default reprs (package name
    and address) reduced to ``<Index>``."""
    return re.sub(r"<csvplus_tpu(_torch)?\.index\.Index object at 0x[0-9a-f]+>", "<Index>",
                  chain.explain())


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_explain_matches_reference(corpus, name):
    out = {}
    for pkg in (J, T):
        chain = CHAINS[name](pkg, _src(pkg, corpus["orders_csv"], True), _index(pkg, corpus, True))
        out[pkg] = _explained(chain)
    assert out[T] == out[J]
    # a chain broken by a host-only index says where and why
    host_idx = {pkg: _index(pkg, corpus, False) for pkg in (J, T)}
    notes = {pkg: _explained(_src(pkg, corpus["orders_csv"], True)
                             .except_(host_idx[pkg], "prod_id").top(3)) for pkg in (J, T)}
    assert notes[T] == notes[J] and "except_() against an index with no device copy" in notes[T]


def test_validate_before_other_stages_runs_on_host_with_the_reference_error(corpus):
    """A Validate followed by another stage cannot lower (host push
    semantics); the chain runs on the host and fails at the same row."""
    got = {pkg: _outcome(_src(pkg, corpus["orders_csv"], True)
                         .validate(pkg.Not(pkg.Like({"qty": "9"})), "qty 9").drop(2))
           for pkg in (J, T)}
    assert got[T] == got[J] and got[T][0] == "error" and "qty 9" in got[T][2]
