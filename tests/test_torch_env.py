"""The port's environment registry held against the JAX package's, and the
seven knobs the port used to hard-code read as the reference reads them.

``ENV_REGISTRY`` has the reference's 38 entries, equal by value and in
order; ``render_env_md()``'s table rows equal the reference's as a set,
and the committed ``docs/ENV_TORCH.md`` equals the port's render.  Each
knob is set in a fresh process of each package (it is read at import,
at construction or at call time, as in the reference) and what it drives
is compared: the probe tier and the join's stage rows for
``CSVPLUS_DIRECT_PROBE_MAX_BITS`` on a 2^20 key universe; ``max_batch``
and ``_tick_s`` for ``CSVPLUS_SERVE_MAX_BATCH`` / ``CSVPLUS_SERVE_TICK_US``;
the typed refusal ``ServerOverloaded(depth, bound)`` for
``CSVPLUS_SERVE_QUEUE``; the number of chunks the parallel scan cuts for
``CSVPLUS_SCAN_THREADS``; the library's name for ``CSVPLUS_NATIVE_SO`` and
a build that fails on a bad flag for ``CSVPLUS_NATIVE_CFLAGS`` (which
also enters the port's build digest)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import csvplus_tpu.utils.env as JE
import csvplus_tpu_torch.utils.env as TE

ROOT = Path(__file__).resolve().parent.parent

#: The knobs F3 found hard-coded in the port.
F3_KNOBS = (
    "CSVPLUS_DIRECT_PROBE_MAX_BITS",
    "CSVPLUS_SERVE_MAX_BATCH",
    "CSVPLUS_SERVE_TICK_US",
    "CSVPLUS_SERVE_QUEUE",
    "CSVPLUS_SCAN_THREADS",
    "CSVPLUS_NATIVE_SO",
    "CSVPLUS_NATIVE_CFLAGS",
)


def _rows(md: str) -> set:
    return {line for line in md.splitlines() if line.startswith("| `")}


def test_registry_equals_the_references_entry_by_entry():
    assert list(TE.ENV_REGISTRY) == list(JE.ENV_REGISTRY)
    assert len(TE.ENV_REGISTRY) == 38
    for name, want in JE.ENV_REGISTRY.items():
        got = TE.ENV_REGISTRY[name]
        assert (got.name, got.kind, got.default, got.description) == (
            want.name, want.kind, want.default, want.description), name
    assert set(F3_KNOBS) <= set(TE.ENV_REGISTRY)


def test_rendered_table_rows_equal_the_references():
    got, want = _rows(TE.render_env_md()), _rows(JE.render_env_md())
    assert got == want and len(got) == 38


def test_committed_env_doc_is_the_ports_render():
    doc = (ROOT / "docs" / "ENV_TORCH.md").read_text(encoding="utf-8")
    assert doc == TE.render_env_md()
    assert "python -m csvplus_tpu_torch.analysis env --write docs/ENV_TORCH.md" in doc


def test_accessors_refuse_an_unregistered_name():
    for fn, args in ((TE.env_int, (0,)), (TE.env_str, ()), (TE.env_float, (0.0,)),
                     (TE.env_flag, ())):
        with pytest.raises(KeyError, match="ENV001-R"):
            fn("CSVPLUS_ZZ_NOT_REGISTERED", *args)


#: Run in a fresh process of package sys.argv[1] with the behavioural
#: knobs set; prints what each drives.
BEHAVIOUR = r"""
import importlib, json, sys
pkg = sys.argv[1]
M = importlib.import_module(pkg)
J = importlib.import_module(pkg + ".ops.join")
S = importlib.import_module(pkg + ".native.scanner")
tel = importlib.import_module(pkg + ".utils.observe").telemetry
coalesce = importlib.import_module(pkg + ".serve.coalesce")
admit = importlib.import_module(pkg + ".serve.admit")
out = {"direct_max_bits": J.DeviceIndex.DIRECT_MAX_BITS}

# a two-column key over 1,000 x 1,000 values: a 2^20 packed-key universe
rows = [M.Row({"k1": f"a{i % 1000}", "k2": f"b{(i * 7) % 1000}", "v": str(i)})
        for i in range(2000)]
idx = M.take_rows(rows).on_device("cpu").index_on("k1", "k2")
probe = M.take_rows([M.Row({"k1": f"a{i % 1000}", "k2": f"b{(i * 7) % 1000}"})
                     for i in range(0, 4000, 3)]).on_device("cpu")
with tel.collect():
    joined = probe.join(idx, "k1", "k2").to_rows()
    out["stages"] = [(r.stage, r.rows_in, r.rows_out) for r in tel.records]
    out["tiers"] = [r.extra.get("tier") for r in tel.records if r.stage == "join:probe"]
out["joined"] = len(joined)
out["direct_bits"] = idx._impl.dev.direct_bits

srv = coalesce.LookupServer(idx)
out["max_batch"], out["tick_s"] = srv.max_batch, srv._tick_s
out["max_pending"] = srv.admission.max_pending
try:
    admit.AdmissionController().admit(3)
    out["overloaded"] = None
except admit.ServerOverloaded as e:
    out["overloaded"] = [type(e).__name__, str(e)]

calls = []
real = S.scan_bytes
def counting(*a, **kw):
    calls.append(kw.get("offset", 0))
    return real(*a, **kw)
S.scan_bytes = counting
data = b"".join(b"%d,x%d\n" % (i, i) for i in range(1_000_000))
starts, lens, counts, _ = S.scan_bytes_parallel(data, n_threads=8)
out["scan_chunks"] = len(calls)
out["scan_fields"] = int(len(starts))
print(json.dumps(out))
"""

#: Run with the build knobs set; prints the library's name and how a
#: build with the bad flag fails.
BUILD = r"""
import importlib, json, os, sys
pkg = sys.argv[1]
S = importlib.import_module(pkg + ".native.scanner")
if pkg == "csvplus_tpu":
    name = os.path.basename(S._SO)
    build = S._build
else:
    name = S.artifact()[0].name
    build = S.build
try:
    build()
    failed = None
except Exception as e:
    failed = "native scanner build failed" in str(e)
print(json.dumps({"name": name, "failed": failed}))
"""


def _run_all(jobs):
    """Run ``{key: (script, package, env)}`` together; ``{key: parsed output}``."""
    procs = {}
    for key, (script, pkg, env) in jobs.items():
        full = {k: v for k, v in os.environ.items() if k not in F3_KNOBS}
        full.update(env, PYTHONPATH=str(ROOT))
        procs[key] = subprocess.Popen([sys.executable, "-c", script, pkg], cwd=env["_cwd"],
                                      env=full, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for key, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=240)
            assert proc.returncode == 0, (key, stderr[-3000:])
            out[key] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def test_each_f3_knob_drives_the_same_behaviour_in_both_packages(tmp_path):
    behaviour = {
        "CSVPLUS_DIRECT_PROBE_MAX_BITS": "16",
        "CSVPLUS_SERVE_MAX_BATCH": "17",
        "CSVPLUS_SERVE_TICK_US": "250",
        "CSVPLUS_SERVE_QUEUE": "3",
        "CSVPLUS_SCAN_THREADS": "3",
        "_cwd": str(tmp_path),
    }
    so = tmp_path / "libknob_scanner.so"
    build = {
        "CSVPLUS_NATIVE_SO": str(so),
        "CSVPLUS_NATIVE_CFLAGS": "--csvplus-no-such-flag",
        "_cwd": str(tmp_path),
    }
    got = _run_all({
        (kind, pkg): (script, pkg, env)
        for kind, script, env in (("behaviour", BEHAVIOUR, behaviour), ("build", BUILD, build))
        for pkg in ("csvplus_tpu", "csvplus_tpu_torch")
    })
    ref, port = got[("behaviour", "csvplus_tpu")], got[("behaviour", "csvplus_tpu_torch")]
    assert port == ref
    # what the knobs changed, against the defaults (23 bits, 4096, 0 us,
    # 8192, 16 threads)
    assert ref["direct_max_bits"] == 16 and ref["direct_bits"] is None
    assert ref["tiers"] == ["broadcast-i32"] and ref["joined"] > 0
    assert ref["max_batch"] == 17 and ref["tick_s"] == pytest.approx(250e-6)
    assert ref["max_pending"] == 3
    assert ref["overloaded"][0] == "ServerOverloaded" and "3" in ref["overloaded"][1]
    assert ref["scan_chunks"] == 3 and ref["scan_fields"] == 2_000_000
    assert got[("build", "csvplus_tpu")] == got[("build", "csvplus_tpu_torch")] == {
        "name": "libknob_scanner.so", "failed": True}
    assert not so.exists()


def test_the_defaults_take_the_direct_tier_and_the_reference_bounds(monkeypatch):
    """Unset, the knobs give the defaults the port used to hard-code."""
    from csvplus_tpu_torch.ops.join import DeviceIndex
    from csvplus_tpu_torch.serve.admit import AdmissionController

    for k in F3_KNOBS:
        monkeypatch.delenv(k, raising=False)
    assert DeviceIndex.DIRECT_MAX_BITS == 23
    assert AdmissionController().max_pending == 8192
    monkeypatch.setenv("CSVPLUS_SERVE_QUEUE", "5")
    assert AdmissionController().max_pending == 5  # read at construction
    assert AdmissionController(7).max_pending == 7  # the argument wins


def test_cflags_enter_the_build_digest_and_the_so_name_keeps_it(monkeypatch, tmp_path):
    import csvplus_tpu_torch.native.scanner as TS

    monkeypatch.delenv("CSVPLUS_NATIVE_CFLAGS", raising=False)
    plain_path, plain, extra = TS.artifact()
    assert extra == [] and plain_path.name == f"libcsvplus_scanner_{plain}.so"
    monkeypatch.setenv("CSVPLUS_NATIVE_CFLAGS", "-O2  -DCSVPLUS_KNOB=1")
    flagged_path, flagged, extra = TS.artifact()
    assert extra == ["-O2", "-DCSVPLUS_KNOB=1"] and flagged != plain
    assert flagged_path != plain_path
    # a library under a CSVPLUS_NATIVE_SO name keeps no digest and is
    # rebuilt at each build (a changed flag never loads a stale build)
    monkeypatch.setattr(TS, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(TS, "_SO_NAME", "custom.so")
    monkeypatch.setenv("CSVPLUS_NATIVE_CFLAGS", "-O1")
    built = TS.build()
    assert built == tmp_path / "custom.so"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["custom.so"]
    built.write_bytes(b"stale")
    assert TS.build() == built and built.read_bytes()[:4] == b"\x7fELF"
