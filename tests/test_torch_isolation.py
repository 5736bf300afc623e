"""The port stands alone: ``csvplus_tpu_torch``, ``chip_smoke.py`` and
``warm_compare.py`` import neither ``jax`` nor any module of ``csvplus_tpu`` (on the
whole-file and on the streamed ingest tier, with lane dictionaries and
the vectorized CSV/JSON sinks, and through the plan cache with every
module the plan-analysis slice added, and through the serving tier with
every module the serving slice added, and through the device-parse tier
and the mutable indexes with their server writes, and through live views,
plan-space certification and the obs tools, and through the multi-device
primitives, the flagship and the graft entry: ``parallel``, ``models`` and
``graft``), its ingest loads its own build of the
native scanner and never the JAX package's, its device entry points
refuse ``"cuda"`` where no card is present instead of running on the CPU
(the streamed tier and the JSON sink's source too), and ``chip_smoke.py``
and ``warm_compare.py`` fail without a card."""

import ast
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "csvplus_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                   ROOT / "warm_compare.py"]

MAIN_PATH = r"""
import io, json, sys, tempfile
from pathlib import Path
import csvplus_tpu_torch as T
from csvplus_tpu_torch.utils.checksum import checksum_device_table

d = Path(tempfile.mkdtemp())
(d / "o.csv").write_text("order_id,cust_id,prod_id,qty\n"
    + "".join(f"o{i},c{i % 7},p{i % 5},{i % 3}\n" for i in range(200)))
(d / "c.csv").write_text("id,name\n" + "".join(f"c{i},n{i}\n" for i in range(7)))
(d / "p.csv").write_text("prod_id,product\n" + "".join(f"p{i},x{i}\n" for i in range(5)))
orders = T.from_file(str(d / "o.csv")).on_device("cpu")
cust = T.from_file(str(d / "c.csv")).on_device("cpu").unique_index_on("id")
prod = T.from_file(str(d / "p.csv")).on_device("cpu").unique_index_on("prod_id")
src = orders.filter(T.Not(T.Like({"prod_id": "p0", "qty": "1"}))).join(cust, "cust_id").join(prod)
rows = src.to_rows()
sums = checksum_device_table(src.to_device_table(), positional=True)
src.to_csv(io.StringIO(), "order_id", "name")
src.to_json(io.StringIO())
lanes = orders.plan.table.columns["order_id"].dev_dictionary is not None
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "csvplus_tpu" or m.startswith("csvplus_tpu."))
libs = sorted({line.split()[-1] for line in open("/proc/self/maps")
               if line.rstrip().endswith(".so") or ".so." in line})
print(json.dumps({"rows": len(rows), "sums": len(sums), "foreign": bad, "libs": libs,
                  "tier": orders.plan.table.ingest_tier, "lanes": lanes}))
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env.update(extra)
    return env


def test_main_path_loads_no_jax_and_no_reference_module(tmp_path):
    res = subprocess.run(
        [sys.executable, "-c", MAIN_PATH], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["rows"] > 0 and out["sums"] == 7
    assert out["foreign"] == []


def test_main_path_loads_the_ports_own_scanner_only(tmp_path):
    """The port's ingest runs its own build of the native scanner and
    never loads the JAX package's ``csvplus_tpu/native/_scanner.so``."""
    res = subprocess.run(
        [sys.executable, "-c", MAIN_PATH], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["tier"] == "native-encoded"
    ours = ROOT / "csvplus_tpu_torch" / "_build"
    assert any(Path(p).parent == ours and Path(p).name.startswith("libcsvplus_scanner_")
               for p in out["libs"]), out["libs"]
    assert not [p for p in out["libs"] if "csvplus_tpu/native" in p or "_scanner.so" in p]


def test_streamed_lane_path_loads_no_jax_and_no_reference_module(tmp_path):
    """The same script on the streamed tier (small chunks, two workers)
    with order_id in a device-lane dictionary."""
    res = subprocess.run(
        [sys.executable, "-c", MAIN_PATH], cwd=tmp_path,
        env=_env(CSVPLUS_STREAM_MIN_BYTES="1", CSVPLUS_STREAM_CHUNK_BYTES="512",
                 CSVPLUS_INGEST_WORKERS="2", CSVPLUS_DICT_DEVICE_MIN_DISTINCT="1",
                 CSVPLUS_TYPED_LANES="0"),
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["tier"] == "streamed" and out["lanes"] is True
    assert out["rows"] > 0 and out["sums"] == 7
    assert out["foreign"] == []


PLANCACHE_PATH = r"""
import json, sys
import csvplus_tpu_torch as T
import csvplus_tpu_torch.analysis, csvplus_tpu_torch.obs.joinskew, csvplus_tpu_torch.obs.sketch
import csvplus_tpu_torch.parallel.pjoin, csvplus_tpu_torch.serve, csvplus_tpu_torch.utils.env
from csvplus_tpu_torch.serve import PlanCache

orders = T.take_rows([T.Row({"k": f"c{i % 7}", "p": f"p{i % 5}", "q": str(i % 3)})
                      for i in range(200)]).on_device("cpu")
cust = T.take_rows([T.Row({"k": f"c{i}", "n": f"n{i}"}) for i in range(7)]).on_device("cpu")
prod = T.take_rows([T.Row({"p": f"p{i}", "x": f"x{i}"}) for i in range(5)]).on_device("cpu")
plan = orders.filter(T.Not(T.Like({"q": "1"}))).join(cust.unique_index_on("k")) \
    .join(prod.unique_index_on("p")).except_(cust.top(2).unique_index_on("k")).plan
cache = PlanCache()
table = cache.execute(plan)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "csvplus_tpu" or m.startswith("csvplus_tpu."))
print(json.dumps({"rows": table.nrows, "stats": cache.stats(), "foreign": bad}))
"""


def test_plancache_path_loads_no_jax_and_no_reference_module(tmp_path):
    """The slice's entry point, with every module it added (analysis,
    serve, obs, parallel, utils.env) imported and a fused plan run."""
    res = subprocess.run(
        [sys.executable, "-c", PLANCACHE_PATH], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["foreign"] == []
    assert out["rows"] > 0 and out["stats"]["optimize_failed"] == 0
    assert out["stats"]["fused"] == 1


SERVING_PATH = r"""
import json, sys
import csvplus_tpu_torch as T
import csvplus_tpu_torch.obs.flight, csvplus_tpu_torch.obs.memory, csvplus_tpu_torch.obs.metrics
import csvplus_tpu_torch.obs.recompile, csvplus_tpu_torch.obs.span, csvplus_tpu_torch.resilience
import csvplus_tpu_torch.utils.observe
from csvplus_tpu_torch.serve import LookupServer

idx = T.take_rows([T.Row({"k": f"c{i}", "v": str(i)}) for i in range(300)]) \
    .on_device("cpu").unique_index_on("k")
rows = T.to_rows_many(idx.find_many(["c7", "nope", ("c9",)]))
with LookupServer(idx) as srv:
    got = [srv.submit(f"c{i}").result(timeout=30) for i in range(20)]
    plan = srv.submit_plan(idx.find("c3").filter(T.Like({"v": "3"})).plan).result(timeout=30)
    snap = srv.snapshot()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "csvplus_tpu" or m.startswith("csvplus_tpu."))
print(json.dumps({"rows": [len(r) for r in rows], "served": sum(len(g) for g in got),
                  "plan_rows": plan.nrows, "completed": snap["completed"], "foreign": bad}))
"""


def test_serving_path_loads_no_jax_and_no_reference_module(tmp_path):
    """The serving slice's entry points (``find_many``, ``LookupServer``
    lookups and a ``Lookup`` plan), with every module it added imported."""
    res = subprocess.run(
        [sys.executable, "-c", SERVING_PATH], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["foreign"] == []
    assert out["rows"] == [1, 0, 1] and out["served"] == 20
    assert out["plan_rows"] == 1 and out["completed"] == 21


DEVICE_PARSE_STORAGE_PATH = r"""
import json, sys, tempfile, os
from pathlib import Path
import csvplus_tpu_torch as T
import csvplus_tpu_torch.ops.parse, csvplus_tpu_torch.ops.cubuild
import csvplus_tpu_torch.storage.compact, csvplus_tpu_torch.storage.lsm
import csvplus_tpu_torch.storage.manifest, csvplus_tpu_torch.storage.prune
import csvplus_tpu_torch.storage.wal
from csvplus_tpu_torch.serve import LookupServer
from csvplus_tpu_torch.storage import MutableIndex, index_checksums, rebuild_reference

d = Path(tempfile.mkdtemp())
(d / "o.csv").write_text("order_id,name\n" + "".join(f"o{i},n{i % 7}x\n" for i in range(300)))
whole = T.from_file(str(d / "o.csv")).on_device("cpu")
os.environ.update(CSVPLUS_STREAM_MIN_BYTES="1", CSVPLUS_STREAM_CHUNK_BYTES="512")
streamed = T.from_file(str(d / "o.csv")).on_device("cpu")
mi = MutableIndex.create(whole, ["order_id"], directory=str(d / "idx"), ingest_device="cpu")
with LookupServer(indexes={"m": mi}) as srv:
    acks = [srv.submit_append([{"order_id": "new", "name": "z"}], index="m").result(timeout=30),
            srv.submit_delete("o3", index="m").result(timeout=30)]
    found = len(srv.submit("new", index="m").result(timeout=30))
mi.compact_once()
mi.close()
back = MutableIndex.open(str(d / "idx"), ingest_device="cpu")
same = index_checksums(back.to_index()) == index_checksums(rebuild_reference(mi))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "csvplus_tpu" or m.startswith("csvplus_tpu."))
print(json.dumps({"tiers": [whole.plan.table.ingest_tier, streamed.plan.table.ingest_tier],
                  "workers": streamed.plan.table.ingest_seconds["workers"], "acks": acks,
                  "found": found, "same": same, "foreign": bad}))
"""


def test_device_parse_and_storage_load_no_jax_and_no_reference_module(tmp_path):
    """The device-parse tier (whole file and streamed, forced on with
    ``CSVPLUS_DEVICE_PARSE=1``), a durable MutableIndex behind the server's
    write calls, a compaction and a recovery, with every module this slice
    added imported."""
    res = subprocess.run(
        [sys.executable, "-c", DEVICE_PARSE_STORAGE_PATH], cwd=tmp_path,
        env=_env(CSVPLUS_DEVICE_PARSE="1", CSVPLUS_INGEST_WORKERS="4"),
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["foreign"] == []
    assert out["tiers"] == ["device-parsed", "streamed"] and out["workers"] == 1
    assert out["acks"] == [1, 1] and out["found"] == 1 and out["same"] is True


VIEWS_PATH = r"""
import json, sys, tempfile
import csvplus_tpu_torch as T
import csvplus_tpu_torch.obs, csvplus_tpu_torch.obs.__main__, csvplus_tpu_torch.obs.diff
import csvplus_tpu_torch.obs.export, csvplus_tpu_torch.analysis.plancert
from csvplus_tpu_torch import plan as P
from csvplus_tpu_torch.analysis.plancert import certify
from csvplus_tpu_torch.obs.export import export_chrome_trace
from csvplus_tpu_torch.obs.span import tracer
from csvplus_tpu_torch.serve import LookupServer
from csvplus_tpu_torch.storage import MutableIndex
from csvplus_tpu_torch.views import MaterializedView

rows = [T.Row({"oid": f"o{i:03d}", "c": f"c{i % 5}"}) for i in range(40)]
mi = MutableIndex.create(T.take_rows(rows), ["oid"], ingest_device="cpu")
dim = T.take_rows([T.Row({"c": f"c{i}", "n": f"n{i}"}) for i in range(5)]).on_device("cpu") \
    .index_on("c")
srv = LookupServer(indexes={"o": mi})
with tracer.trace("views") as tr:
    view = srv.register_view("v", P.Filter(P.Join(P.Scan(None), dim, ("c",)),
                                           T.Like({"c": "c1"})), source="o")
    with srv:
        srv.submit_append([{"oid": "o999", "c": "c1"}], index="o").result(timeout=30)
        srv.submit("o999", index="o").result(timeout=30)
same = view.checksums() == view.recompute_checksums()
export_chrome_trace(tempfile.mkdtemp(), [tr])
ok = certify(n=2, device="cpu").ok
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "csvplus_tpu" or m.startswith("csvplus_tpu."))
print(json.dumps({"rows": len(view.rows()), "read": len(view.read("o999")), "same": same,
                  "certified": ok, "foreign": bad}))
"""


def test_views_plancert_and_obs_tools_load_no_jax_and_no_reference_module(tmp_path):
    """This slice's entry points: a live view registered on a server and
    refreshed by a served write, a traced run exported, ``certify``, with
    the views, plan-certification and obs tool modules imported."""
    res = subprocess.run(
        [sys.executable, "-c", VIEWS_PATH], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["foreign"] == []
    assert out == {"rows": 9, "read": 1, "same": True, "certified": True, "foreign": []}


MULTIDEVICE_PATH = r"""
import json, sys
import numpy as np
import csvplus_tpu_torch as T
import csvplus_tpu_torch.models, csvplus_tpu_torch.models.workloads
from csvplus_tpu_torch import graft
from csvplus_tpu_torch.models.flagship import ThreewayJoin
from csvplus_tpu_torch.parallel import make_mesh
from csvplus_tpu_torch.parallel.dsort import distributed_sort
from csvplus_tpu_torch.parallel.pjoin import partitioned_probe

mesh = make_mesh(4, devices=["cpu"] * 4)
keys = np.sort(np.arange(0, 2000, 3, dtype=np.int32))
lo, ct = partitioned_probe(mesh, np.arange(-1, 999, dtype=np.int32), keys)
vals, perm = distributed_sort(mesh, np.arange(500, 0, -1, dtype=np.int32))
orders = T.take_rows([T.Row({"c": f"c{i % 7}", "p": f"p{i % 5}"}) for i in range(50)]) \
    .on_device("cpu").to_device_table()
cust = T.take_rows([T.Row({"c": f"c{i}", "n": f"n{i}"}) for i in range(7)]).on_device("cpu") \
    .unique_index_on("c")
prod = T.take_rows([T.Row({"p": f"p{i}", "x": f"x{i}"}) for i in range(5)]).on_device("cpu") \
    .unique_index_on("p")
rows = ThreewayJoin.build(orders, cust.device_table, prod.device_table, "c", "p").run().nrows
dry = graft.dryrun_multichip(4, devices=["cpu"] * 4)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "csvplus_tpu" or m.startswith("csvplus_tpu."))
print(json.dumps({"hits": int((ct > 0).sum()), "sorted": bool((np.diff(vals) >= 0).all()),
                  "rows": rows, "paths": len(dry["paths"]), "foreign": bad}))
"""


def test_multidevice_flagship_and_graft_load_no_jax_and_no_reference_module(tmp_path):
    """This slice's entry points: the partitioned probe and the sample sort
    on a 4-shard CPU mesh, the flagship's ``ThreewayJoin``, and
    ``graft.dryrun_multichip``, with ``parallel``, ``models`` and ``graft``
    imported."""
    res = subprocess.run(
        [sys.executable, "-c", MULTIDEVICE_PATH], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"hits": 333, "sorted": True, "rows": 50, "paths": 7, "foreign": []}


SHARDED_PATH = r"""
import json, os, sys
import csvplus_tpu_torch as T
import csvplus_tpu_torch.ops.sort as S

with open("o.csv", "w") as f:
    f.write("order_id,cust_id,qty\n" + "".join(f"o{i},c{i % 11},{i % 5}\n" for i in range(203)))
with open("c.csv", "w") as f:
    f.write("cust_id,name\n" + "".join(f"c{i},n{i}\n" for i in range(11)))
cust = T.from_file("c.csv").on_device("cpu").unique_index_on("cust_id")
src = T.from_file("o.csv").on_device("cpu", shards=8)
rows = src.filter(T.Not(T.Like({"qty": "0"}))).join(cust, "cust_id").to_rows()
S.DSORT_MIN_ROWS = 1
idx = src.unique_index_on("order_id")
os.environ.update(CSVPLUS_STREAM_MIN_BYTES="1", CSVPLUS_STREAM_CHUNK_BYTES="512")
streamed = T.from_file("o.csv").on_device("cpu", shards=3)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
             or m == "csvplus_tpu" or m.startswith("csvplus_tpu."))
print(json.dumps({"rows": len(rows), "index": len(idx),
                  "found": len(idx.find("o7").to_rows()),
                  "streamed": streamed.plan.table.ingest_tier, "foreign": bad}))
"""


def test_sharded_tables_load_no_jax_and_no_reference_module(tmp_path):
    """Sharded tables: ``on_device("cpu", shards=8)``, a filter and a join,
    an index build through the sample sort and a sharded streamed ingest,
    with neither ``jax`` nor ``csvplus_tpu`` loaded."""
    res = subprocess.run(
        [sys.executable, "-c", SHARDED_PATH], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"rows": 162, "index": 203, "found": 1, "streamed": "streamed", "foreign": []}


def test_pack_kernel_wrapper_never_falls_back_off_the_cpu():
    """The pack wrapper runs its plain version only for a CPU tensor: a
    tensor on any other device goes to the kernel or raises."""
    from csvplus_tpu_torch.ops import parse as P

    meta = torch.empty(4, dtype=torch.uint8, device="meta")
    idx = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        P.pack_field_lanes(meta, idx, idx, 2)
    assert P.SOURCE.name == "parse.cu" and P.SOURCE.exists()


def test_device_parse_on_cuda_raises_without_a_card(people_csv, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import csvplus_tpu_torch as T

    monkeypatch.setenv("CSVPLUS_DEVICE_PARSE", "1")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        T.from_file(people_csv).on_device("cuda")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "csvplus_tpu"), f"{path.name} imports {name}"


def test_on_device_cuda_raises_without_a_card(people_csv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import csvplus_tpu_torch as T

    with pytest.raises(RuntimeError, match="no CUDA card"):
        T.from_file(people_csv).on_device()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        T.take(T.from_file(people_csv)).on_device("cuda")


def test_streamed_tier_and_json_source_refuse_cuda_without_a_card(people_csv, monkeypatch):
    """The streamed tier raises on "cuda" without a card (it does not fall
    back to the CPU or to a whole-file tier), and so does the source a
    JSON sink would read."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import csvplus_tpu_torch as T

    monkeypatch.setenv("CSVPLUS_STREAM_MIN_BYTES", "1")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        T.from_file(people_csv).on_device()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        T.from_file(people_csv).on_device("cuda").to_json(io.StringIO())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        T.take_rows([T.Row({"a": "1"})]).on_device().to_json_file("never-written.json")
    assert not os.path.exists("never-written.json")


@pytest.mark.parametrize("alone", [False, True], ids=["in-repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, str(script)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_warm_compare_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run(
        [sys.executable, str(ROOT / "warm_compare.py"), str(ROOT)], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 1 and "no CUDA card" in res.stderr
    assert '"warm_a"' not in res.stdout
