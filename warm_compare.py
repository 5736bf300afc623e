"""Time the port's warm pipeline (a) of ``chip_smoke.py`` with the
``csvplus_tpu_torch`` and ``chip_smoke.py`` of one or more source trees,
each tree in a process of its own, in the order given (for example
parent, change, change, parent), with telemetry off (the default).

Pipeline (a) is ``orders.filter(Not(Like{prod_id: p0, qty: 1}))
.join(cust, "cust_id").join(prod)`` over ``chip_smoke.generate``'s
orders, run to a device table and synchronized.  Each process builds its
tree's kernels, generates its data from the seed, warms the pipeline
three times and then times *reps* runs; it prints one JSON line with the
median and every run.  Every tree must give the same row count.  The
summary gives each tree's process medians with their median and
quartiles, and, taking the processes two by two in the order run, how
many of those pairs each tree won.

    python3 warm_compare.py TREE [TREE ...] [--rows N] [--reps R] [--seed S]

Needs a CUDA card and exits 1 without one, unless ``--device cpu`` asks
for a small rehearsal on the CPU.  The data goes to
``TREE/.chip_smoke_data/warm`` and is removed at the end."""

import argparse
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path


def child(tree: Path, rows: int, reps: int, seed: int, device: str) -> dict:
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(tree)] + [p for p in sys.path if p not in ("", here)]
    import csvplus_tpu_torch as T
    from csvplus_tpu_torch.ops import mask as M

    if not Path(T.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {T.__file__}, not the package of {tree}")
    spec = importlib.util.spec_from_file_location("chip_smoke", tree / "chip_smoke.py")
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    if device == "cuda":
        M.build()
    workdir = tree / ".chip_smoke_data" / "warm"
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        data = C.generate(workdir, rows, seed)
        orders = T.from_file(str(data["paths"]["orders"])).on_device(device)
        _, cust, prod = C._index_dims(data, device)
        pred = C._pipelines(data)["a"][0]
        src = orders.filter(pred).join(cust, "cust_id").join(prod)
        for _ in range(3):
            table = src.to_device_table()
            C._sync(device)
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            src.to_device_table()
            C._sync(device)
            runs.append((time.perf_counter() - t0) * 1e3)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"tree": str(tree), "rows": rows, "nrows_out": table.nrows,
            "median_ms": statistics.median(runs), "runs_ms": runs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--reps", type=int, default=31)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.trees[0].resolve(), args.rows, args.reps, args.seed,
                               args.device)))
        return 0
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("warm_compare.py: no CUDA card", file=sys.stderr)
            return 1
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        print(f"nvidia-smi: {smi}", flush=True)
    results = []
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, __file__, str(tree), "--child", "--rows", str(args.rows),
             "--reps", str(args.reps), "--seed", str(args.seed), "--device", args.device],
            capture_output=True, text=True,
        )
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise RuntimeError(f"{tree}: exit code {proc.returncode}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{tree}: warm (a) median {res['median_ms']:.4f} ms over {args.reps} runs "
              f"(min {min(res['runs_ms']):.4f}, max {max(res['runs_ms']):.4f}), "
              f"{res['nrows_out']:,} rows", flush=True)
        results.append(res)
    if len({r["nrows_out"] for r in results}) != 1:
        raise AssertionError(f"the trees disagree on the row count: {results}")
    summary = {}
    for tree in dict.fromkeys(r["tree"] for r in results):
        medians = [r["median_ms"] for r in results if r["tree"] == tree]
        q = statistics.quantiles(medians, n=4) if len(medians) > 1 else medians * 3
        summary[tree] = {"medians_ms": medians, "median_ms": statistics.median(medians),
                         "quartiles_ms": [q[0], q[2]], "pairs_won": 0}
    for a, b in zip(results[0::2], results[1::2]):
        if a["tree"] != b["tree"] and a["median_ms"] != b["median_ms"]:
            summary[min(a, b, key=lambda r: r["median_ms"])["tree"]]["pairs_won"] += 1
    for tree, v in summary.items():
        print(f"{tree}: median of {len(v['medians_ms'])} process medians {v['median_ms']:.4f} ms, "
              f"quartiles {v['quartiles_ms'][0]:.4f}-{v['quartiles_ms'][1]:.4f} ms, "
              f"pairs won {v['pairs_won']}", flush=True)
    print(json.dumps({"warm_a": results, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
