"""The port's analysis payload, ``explain`` text and CLI
(``csvplus_tpu_torch/analysis/report.py`` and ``__main__.py``) held
against the JAX package's on the CPU.

With both packages' build-side sketch registries reset, the port's
``json_payload(device="cpu")`` has the reference's ``plans`` and
``plan_cert`` halves (the reference's ``sharded-join`` on its 8 virtual
CPU devices, the port's on an 8-shard CPU mesh), and ``explain_text``
gives the reference's text for every example chain.  The CLI's exit
codes are the reference's: 0 clean, 1 with findings, 2 for an unknown
plan name, 3 when the payload drifts from a snapshot; the committed
``tests/data/analyze_snapshot_torch.json`` matches, and ``--device cuda``
raises where no card is present."""

import json
from pathlib import Path

import pytest
import torch

from csvplus_tpu.analysis import __main__ as JM
from csvplus_tpu.analysis import report as JR
from csvplus_tpu.obs.joinskew import joinskew as j_skew
from csvplus_tpu_torch.analysis import __main__ as TM
from csvplus_tpu_torch.analysis import report as TR
from csvplus_tpu_torch.obs.joinskew import joinskew as t_skew

ROOT = Path(__file__).resolve().parent.parent
SNAPSHOT = ROOT / "tests" / "data" / "analyze_snapshot_torch.json"
#: One small file, so the payload's lint half stays cheap where only the
#: plan halves are compared.
ONE_FILE = str(ROOT / "csvplus_tpu_torch" / "errors.py")

BAD = "def f(items):\n    for x in items:\n        try:\n            x.close()\n" \
      "        except Exception:\n            pass\n"


@pytest.fixture(autouse=True)
def _empty_sketches():
    """``certify`` reads the process-wide build-side sketches (in both
    packages): reset them, and restore what was there after."""
    saved = []
    for sk in (t_skew, j_skew):
        with sk._lock:
            saved.append((dict(sk._build_sketches),
                          {k: dict(v) for k, v in sk._counters.items()}))
        sk.reset()
    yield
    for sk, (sketches, counters) in zip((t_skew, j_skew), saved):
        sk.reset()
        with sk._lock:
            sk._build_sketches.update(sketches)
            sk._counters.update(counters)


def _reset():
    t_skew.reset()
    j_skew.reset()


def test_payload_plans_and_plan_cert_equal_the_references():
    import jax

    assert len(jax.devices()) >= 8  # the reference builds its sharded chain
    got = TR.json_payload([ONE_FILE], device="cpu")
    _reset()
    want = JR.json_payload([ONE_FILE])
    assert got["schema"] == want["schema"] == TR.SCHEMA_VERSION == 3
    assert sorted(got["plans"]) == sorted(want["plans"])
    assert "skipped" not in got["plans"]["sharded-join"]
    assert got["plans"] == want["plans"]
    assert got["plan_cert"] == want["plan_cert"]
    assert got["lint"] == []


def test_explain_text_equals_the_references_for_every_chain():
    got_plans, want_plans = TR.example_plans("cpu"), JR.example_plans()
    assert sorted(got_plans) == sorted(want_plans)
    for name in sorted(want_plans):
        assert TR.explain_text(name, got_plans[name]) == JR.explain_text(name, want_plans[name])
    assert TR.example_plan_reports("cpu")["sharded-join"].ok


def test_the_sharded_chain_is_placed_sharded():
    d = TR.plan_analysis_json(TR.example_plans("cpu")["sharded-join"])
    assert d["ok"] and d["row_placement"] == "sharded(shards)"
    assert d["provenance"][0]["stage"] == "Scan[0]"
    assert "broadcast-tier" in d["cost"][2]["note"]


def test_committed_snapshot_matches(capsys):
    assert TM.main(["--snapshot", str(SNAPSHOT), "--device", "cpu"]) == 0
    assert "payload matches" in capsys.readouterr().err


def test_exit_codes_match_the_references(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD)
    # 1: a finding, bare and through `lint --json`
    assert TM.main([str(bad)]) == JM.main([str(bad)]) == 1
    assert TM.main(["lint", "--json", str(bad)]) == JM.main(["lint", "--json", str(bad)]) == 1
    out = capsys.readouterr().out
    assert out.count('"FAULT001"') == 2
    # 0: clean
    assert TM.main(["lint", ONE_FILE]) == 0
    # 2: an unknown plan name
    assert TM.main(["explain", "nope", "--device", "cpu"]) == JM.main(["explain", "nope"]) == 2
    assert "unknown plan(s): nope" in capsys.readouterr().err
    # 3: the payload drifted from the snapshot
    drifted = json.loads(SNAPSHOT.read_text())
    drifted["plans"]["quickstart-join"]["ok"] = False
    path = tmp_path / "drifted.json"
    path.write_text(json.dumps(drifted))
    assert TM.main([ONE_FILE, "--snapshot", str(path), "--device", "cpu"]) == 3
    _reset()
    assert JM.main([ONE_FILE, "--snapshot", str(path)]) == 3
    assert "drifted" in capsys.readouterr().err


def test_explain_list_json_and_env_modes(tmp_path, capsys):
    assert TM.main(["explain", "--list", "--device", "cpu"]) == 0
    names = capsys.readouterr().out.split()
    assert names == sorted(TR.example_plans("cpu"))
    assert TM.main(["explain", "quickstart-join", "--json", "--device", "cpu"]) == 0
    body = json.loads(capsys.readouterr().out)
    assert body["quickstart-join"] == TR.plan_analysis_json(
        TR.example_plans("cpu")["quickstart-join"])
    target = tmp_path / "ENV.md"
    assert TM.main(["env", "--write", str(target)]) == 0
    assert target.read_text() == (ROOT / "docs" / "ENV_TORCH.md").read_text()
    capsys.readouterr()
    assert TM.main(["env"]) == 0
    assert capsys.readouterr().out == target.read_text()


def test_plan_cert_cli_equals_the_references(monkeypatch, capsys):
    monkeypatch.setenv("CSVPLUS_PLANCERT_N", "2")
    assert TM.main(["plan-cert", "--json", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    _reset()
    assert JM.main(["plan-cert", "--json"]) == 0
    assert got == json.loads(capsys.readouterr().out)
    assert got["ok"] and got["plans_total"] == 28


def test_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TR.example_plans()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TM.main(["explain", "quickstart-join"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TM.main(["plan-cert", "--json"])
