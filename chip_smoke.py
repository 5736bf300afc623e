#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``csvplus_tpu_torch``) on one NVIDIA GPU.

Usage: python3 chip_smoke.py [--seed S] [--profile]

Phases; any failure raises, exits non-zero and prints no result line:

1. Device: the card's name, and its name and power limit from nvidia-smi;
   the host's CPU count.
2. Build: ``csrc/mask.cu`` with nvcc for sm_90a and the native CSV
   scanner ``native/scanner.cpp`` with g++, both started together;
   prints the seconds.
3. Mask kernel against its plain PyTorch version on the card, bitwise:
   seeded codes with ~5 % absent cells at n = 10,000,003 (ragged on
   purpose) for k in {1, 2, 8} columns, both modes, IN-lists of 1 and 50
   targets, and at n = 1000; at both sizes also pipeline (b)'s shape
   (k = 2 "any", 50 + 1 targets), a column 4 bytes off 16-byte alignment
   (the kernel's row-at-a-time path), an IN-list too long to stage in
   shared memory (its global-memory path), and typed value lanes
   (arbitrary int32: negative values and targets, +-(2^31 - 1), a target
   absent from the column).  Times the kernel (device time per call, see
   ``_timed``), its bound, the plain version and, for the single-column
   IN-list, ``torch.isin``.
4. Main path, through the public API on "cuda": northstar-shaped CSVs
   written from the seed (orders ``order_id,cust_id,prod_id,qty``
   x 10,000,000, customers ``id,name`` x 100,000, products
   ``prod_id,product,price`` x 1,000); ``from_file(...).on_device("cuda")``
   for all three, which must take the ``native-encoded`` ingest tier with
   the four orders columns as typed int32 lanes; ``unique_index_on`` for
   both build sides, then
   (a) ``filter(Not(Like{prod_id, qty})).join(cust, "cust_id").join(prod)``
   (b) ``filter(Any(Like prod_id p1..p50, Like qty 7))`` with the same joins.
   Each result is held against a numpy oracle built from the generated
   arrays: row count, positional checksums of every column, first rows.
   The mask kernel's launch count must rise, the result must lie on the
   card, and no orders-side column may be demoted to a dictionary in the
   cold and warm runs of either pipeline.
5. A ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Writes its CSVs under ``.chip_smoke_data/`` beside this file and removes
them at the end.  Needs one card; imports nothing of JAX or csvplus_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_ORDERS = 10_000_000  # BASELINE.json config 3
N_CUST = 100_000
N_PROD = 1_000
MASK_ROWS = 10_000_003
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM int32 issue rate: 132 SMs x 64 INT32 lanes per SM (NVIDIA H100
# Tensor Core GPU Architecture whitepaper) at the 1.98 GHz boost clock that
# gives the data sheet's 67 TFLOP/s fp32 (132 x 128 lanes x 2 x 1.98e9).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# More targets than the kernel stages in shared memory (MAX_STAGED in
# csrc/mask.cu): such an IN-list is read from global memory.
LONG_IN_LIST = 12_300
I32_MAX = 2**31 - 1
ORDERS_COLS = ("order_id", "cust_id", "prod_id", "qty")
_FNV_OFFSET = np.uint32(2166136261)
_FNV_PRIME = np.uint32(16777619)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 3: the mask kernel against its plain version ---------------------


def _timed(fn, reps: int = 20, batches: int = 5) -> float:
    """Device milliseconds per call of *fn*: the median over *batches* of
    the mean of *reps* back-to-back calls between two CUDA events.  Each
    batch is queued behind a GPU spin (``torch.cuda._sleep``) long enough
    for the host to enqueue every call, so the events bracket device work
    only, not the host's Python time per call (which exceeds a 10M-row
    mask's device time and would otherwise idle the card between calls)."""
    import torch

    fn()  # warm: lazy loads, allocator
    means = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)  # ~0.1 s of GPU cycles
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        means.append(a.elapsed_time(b) / reps)
    return float(np.median(means))


def _bound_ms(n: int, targets) -> "tuple[float, str]":
    """Least time for the mask on this card: (4k + 1) n bytes over the
    memory rate, or 2 n * sum|T_j| int32 operations (a compare and an OR
    per target) over the int32 issue rate, whichever is larger."""
    t_bytes = (4 * len(targets) + 1) * n / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n * sum(len(t) for t in targets) / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_mask_kernel(seed: int) -> dict:
    import torch

    from csvplus_tpu_torch.ops import mask as M

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def codes(n: int, k: int, hi: int = 1000):
        out = []
        for _ in range(k):
            c = torch.randint(0, hi, (n,), generator=g, device=dev, dtype=torch.int32)
            c[torch.rand(n, generator=g, device=dev) < 0.05] = -1
            out.append(c)
        return out

    def typed(n: int, k: int):
        """k typed value-lane columns: int32 in [-1000, 1000) with ~1 %
        of cells at +(2^31 - 1) and ~1 % at -(2^31 - 1)."""
        out = []
        for _ in range(k):
            c = torch.randint(-1000, 1000, (n,), generator=g, device=dev, dtype=torch.int32)
            r = torch.rand(n, generator=g, device=dev)
            c[r < 0.01] = I32_MAX
            c[r > 0.99] = -I32_MAX
            out.append(c)
        return out

    def unaligned(n: int):
        """One contiguous column 4 bytes past a 16-byte boundary."""
        buf = codes(n + 1, 1)[0]
        return buf[1:]

    worst = 0
    cases = []

    def check(name, cols, targets, mode):
        nonlocal worst
        n = cols[0].shape[0]
        got = M.fused_equality_mask(cols, targets, n, mode)
        want = M.fused_equality_mask_plain(cols, targets, mode)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        worst = max(worst, err)
        if not torch.equal(got, want):
            raise AssertionError(f"mask kernel != plain at n={n} {name} {mode}")
        cases.append((n, name, mode))

    for n in (MASK_ROWS, 1000):
        for k in (1, 2, 8):
            cols = codes(n, k)
            for mode in ("all", "any"):
                for t in (1, 50):
                    targets = [list(range(7 * j, 7 * j + t)) for j in range(k)]
                    check(f"k={k} T={t}", cols, targets, mode)
        # pipeline (b)'s shape: a 50-target IN-list and one target
        check("k=2 T=50+1", codes(n, 2), [list(range(1, 51)), [7]], "any")
        # not 16-byte aligned: the row-at-a-time path, alone and beside
        # an aligned column
        skew = unaligned(n)
        if skew.data_ptr() % 16 == 0:
            raise AssertionError("the unaligned column came out aligned")
        for mode in ("all", "any"):
            check("k=1 unaligned", [skew], [[3, 5]], mode)
            check("k=2 unaligned", [codes(n, 1)[0], skew], [[7], [3]], mode)
        # more targets than fit in shared memory: the global-memory path
        wide = codes(n, 1, hi=2 * LONG_IN_LIST + 1000)
        check("k=1 long IN-list", wide, [list(range(0, 2 * LONG_IN_LIST, 2))], "any")
        # typed value lanes: any int32 is a value, none means "absent"
        lanes = typed(n, 2)
        for mode in ("all", "any"):
            check("typed negative", lanes, [[-7], [-1, -999]], mode)
            check("typed +-(2^31-1)", lanes, [[I32_MAX], [-I32_MAX, I32_MAX]], mode)
            check("typed absent target", lanes, [[123_456_789], [5000, -5000]], mode)
    log(f"mask kernel == plain version, bitwise, in {len(cases)} cases")

    timings = []
    n = MASK_ROWS
    for k, mode, t in [(2, "all", 1), (2, "any", 50), (8, "all", 1), (1, "any", 50)]:
        cols = codes(n, k)
        targets = [list(range(7 * j, 7 * j + t)) for j in range(k)]
        ms = _timed(lambda: M.fused_equality_mask(cols, targets, n, mode))
        plain_ms = _timed(lambda: M.fused_equality_mask_plain(cols, targets, mode))
        bound, by = _bound_ms(n, targets)
        lib_ms = None
        if k == 1:
            tt = torch.tensor(targets[0], dtype=torch.int32, device=dev)
            lib_ms = _timed(lambda: torch.isin(cols[0], tt))
        row = {"n": n, "k": k, "mode": mode, "targets_per_col": t, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "library_ms": lib_ms}
        timings.append(row)
        log("mask timing " + json.dumps(row))
    return {"max_abs_err": worst, "timings": timings}


# -- phase 4: the main path --------------------------------------------------


def _fnv32(values: np.ndarray) -> np.ndarray:
    """32-bit FNV-1a of each entry of an 'S' array (the oracle's own)."""
    n = values.size
    width = values.dtype.itemsize
    mat = np.frombuffer(values.tobytes(), dtype=np.uint8).reshape(n, width)
    lens = np.char.str_len(values)
    h = np.full(n, _FNV_OFFSET, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for i in range(width):
            h = np.where(i < lens, (h ^ mat[:, i]) * _FNV_PRIME, h)
    return h


def _positional_sum(hashes: np.ndarray) -> int:
    w = 2 * np.arange(hashes.size, dtype=np.uint32) + np.uint32(1)
    with np.errstate(over="ignore"):
        return int(np.add.reduce(hashes.astype(np.uint32) * w, dtype=np.uint32))


def _sbytes(prefix: bytes, ints: np.ndarray) -> np.ndarray:
    return np.char.add(prefix, ints.astype("S"))


def generate(root: Path, n_orders: int, seed: int) -> dict:
    """Write the three CSVs and return the arrays they were made from."""
    rng = np.random.default_rng(seed)
    cust = rng.integers(0, N_CUST, n_orders)
    prod = rng.integers(0, N_PROD, n_orders)
    qty = rng.integers(1, 101, n_orders)
    ci = np.arange(N_CUST)
    pi = np.arange(N_PROD)
    price = np.array([f"{(i % 9900) / 100 + 0.99:.2f}".encode() for i in pi])
    cols = {
        "cust": {"id": _sbytes(b"c", ci), "name": _sbytes(b"name", ci % 9973)},
        "prod": {"prod_id": _sbytes(b"p", pi), "product": _sbytes(b"prod", pi),
                 "price": price},
    }
    paths = {"orders": root / "orders.csv", "cust": root / "customers.csv",
             "prod": root / "products.csv"}
    with open(paths["cust"], "wb") as f:
        f.write(b"id,name\n")
        f.write(b"\n".join(np.char.add(np.char.add(cols["cust"]["id"], b","),
                                       cols["cust"]["name"]).tolist()) + b"\n")
    with open(paths["prod"], "wb") as f:
        f.write(b"prod_id,product,price\n")
        p = cols["prod"]
        f.write(b"\n".join(np.char.add(np.char.add(np.char.add(p["prod_id"], b","),
                                                   np.char.add(p["product"], b",")),
                                       p["price"]).tolist()) + b"\n")
    with open(paths["orders"], "wb") as f:
        f.write(b"order_id,cust_id,prod_id,qty\n")
        chunk = 1_000_000
        for lo in range(0, n_orders, chunk):
            hi = min(lo + chunk, n_orders)
            line = np.char.add(
                np.char.add(_sbytes(b"o", np.arange(lo, hi)), _sbytes(b",c", cust[lo:hi])),
                np.char.add(_sbytes(b",p", prod[lo:hi]), _sbytes(b",", qty[lo:hi])),
            )
            f.write(b"\n".join(line.tolist()) + b"\n")
    return {"paths": paths, "cust": cust, "prod": prod, "qty": qty, "cols": cols}


def oracle(data: dict, keep: np.ndarray, columns) -> "tuple[int, dict, list]":
    """(row count, positional checksums, first 3 rows) of the filtered
    3-table join: every order matches one customer and one product, so
    the result is the surviving orders in stream order."""
    rows = np.flatnonzero(keep)
    cust, prod, qty = data["cust"][rows], data["prod"][rows], data["qty"][rows]
    c, p = data["cols"]["cust"], data["cols"]["prod"]
    qty_s = np.arange(101).astype("S")
    values = {
        "order_id": lambda sel: _sbytes(b"o", rows[sel]),
        "cust_id": lambda sel: c["id"][cust[sel]],
        "id": lambda sel: c["id"][cust[sel]],
        "name": lambda sel: c["name"][cust[sel]],
        "prod_id": lambda sel: p["prod_id"][prod[sel]],
        "product": lambda sel: p["product"][prod[sel]],
        "price": lambda sel: p["price"][prod[sel]],
        "qty": lambda sel: qty_s[qty[sel]],
    }
    tables = {
        "order_id": None,
        "cust_id": (_fnv32(c["id"]), cust), "id": (_fnv32(c["id"]), cust),
        "name": (_fnv32(c["name"]), cust),
        "prod_id": (_fnv32(p["prod_id"]), prod), "product": (_fnv32(p["product"]), prod),
        "price": (_fnv32(p["price"]), prod), "qty": (_fnv32(qty_s), qty),
    }
    sums = {}
    for col in columns:
        if tables[col] is None:
            hashes = _fnv32(values[col](slice(None)))
        else:
            htab, idx = tables[col]
            hashes = htab[idx]
        sums[col] = _positional_sum(hashes)
    head = slice(0, 3)
    first = [
        {col: values[col](head)[i].decode() for col in columns}
        for i in range(min(3, rows.size))
    ]
    return int(rows.size), sums, first


def profile_pipelines(srcs) -> None:
    """One warm run of each pipeline under ``torch.profiler``: the device
    time by kernel and the device's busy share of the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, src in srcs.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            src.to_device_table()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only (kernels, copies): the host ops that
        # launched them report the same time again
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.device_time_total for e in events)
        log(f"profile pipeline {name}: window {wall_us:.0f} us, {len(events)} device "
            f"event kinds, device busy {busy_us:.0f} us "
            f"({100 * busy_us / wall_us:.1f} % of the window)")
        top = sorted(events, key=lambda e: -e.device_time_total)
        for e in top[:12] + [e for e in top[12:] if "fused_mask" in e.key]:
            log(f"  {e.device_time_total:10.1f} us  x{e.count:<4d} {e.key[:90]}")


def run_main_path(
    n_orders: int, seed: int, device: str, workdir: Path, profile: bool = False
) -> dict:
    """Drive both pipelines through the public API on *device* and hold
    them against the oracle.  Returns the launches and the phase times;
    *profile* adds a ``torch.profiler`` breakdown of one more warm run."""
    import torch

    import csvplus_tpu_torch as T
    from csvplus_tpu_torch.columnar import typed
    from csvplus_tpu_torch.ops import mask as M
    from csvplus_tpu_torch.utils.checksum import checksum_device_table

    t0 = time.perf_counter()
    data = generate(workdir, n_orders, seed)
    log(f"generated {n_orders:,} orders in {time.perf_counter() - t0:.1f}s")

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    typed.demotions.clear()
    t0 = time.perf_counter()
    orders = T.from_file(str(data["paths"]["orders"])).on_device(device)
    sync()
    t_ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    dims = {k: T.from_file(str(data["paths"][k])).on_device(device) for k in ("cust", "prod")}
    cust = dims["cust"].unique_index_on("id")
    prod = dims["prod"].unique_index_on("prod_id")
    sync()
    t_index = time.perf_counter() - t0
    tiers = {"orders": orders.plan.table.ingest_tier,
             **{k: src.plan.table.ingest_tier for k, src in dims.items()}}
    if set(tiers.values()) != {"native-encoded"}:
        raise AssertionError(f"ingest tiers {tiers}, expected native-encoded for all three")
    kinds = {c: orders.plan.table.columns[c].kind for c in ORDERS_COLS}
    if set(kinds.values()) != {"int"}:
        raise AssertionError(f"orders column kinds {kinds}, expected four typed int32 columns")
    index_demotions = list(typed.demotions)

    pipelines: dict = {
        "a": (
            T.Not(T.Like({"prod_id": "p0", "qty": "1"})),
            ~((data["prod"] == 0) & (data["qty"] == 1)),
        ),
        "b": (
            T.Any(*[T.Like({"prod_id": f"p{i}"}) for i in range(1, 51)], T.Like({"qty": "7"})),
            ((data["prod"] >= 1) & (data["prod"] <= 50)) | (data["qty"] == 7),
        ),
    }
    out = {"ingest_s": t_ingest, "index_s": t_index, "rows": n_orders,
           "ingest_tiers": tiers, "cpu_count": os.cpu_count(), "pipelines": {}}
    log(f"ingest {t_ingest:.2f}s ({n_orders / t_ingest:,.0f} rows/s) on the "
        f"{tiers['orders']} tier, orders columns {kinds}; index build (ingest, "
        f"sort, unique check of both dimensions) {t_index:.2f}s; host CPUs {os.cpu_count()}")

    M.launches = 0  # the main path's run starts here
    typed.demotions.clear()
    results = {}
    srcs = {}
    for name, (pred, _) in pipelines.items():
        src = srcs[name] = orders.filter(pred).join(cust, "cust_id").join(prod)
        times = []
        for _ in range(2):  # cold, then warm
            t0 = time.perf_counter()
            table = src.to_device_table()
            sync()
            times.append(time.perf_counter() - t0)
        results[name] = (table, src.top(3).to_rows(), times)
    launches = M.launches  # ... and ends here
    main_demotions = list(typed.demotions)

    for name, (table, first_rows, times) in results.items():
        cols = sorted(table.columns)
        n_want, want_sums, want_first = oracle(data, pipelines[name][1], cols)
        if table.nrows != n_want:
            raise AssertionError(f"pipeline {name}: {table.nrows} rows, oracle {n_want}")
        for c in table.columns.values():
            if c.storage.device.type != device:
                raise AssertionError(f"pipeline {name}: result column on {c.storage.device}")
        got_sums = checksum_device_table(table, cols, positional=True)
        if got_sums != want_sums:
            raise AssertionError(f"pipeline {name}: checksums {got_sums} != oracle {want_sums}")
        if [dict(r) for r in first_rows] != want_first:
            raise AssertionError(f"pipeline {name}: first rows {first_rows} != {want_first}")
        out["pipelines"][name] = {"rows_out": table.nrows, "join_cold_s": times[0],
                                  "join_warm_s": times[1],
                                  "rows_per_s_warm": n_orders / times[1]}
        log(f"pipeline {name}: {table.nrows:,} rows == oracle (count, positional "
            f"checksums of {len(cols)} columns, first rows); filter+join cold "
            f"{times[0]:.3f}s, warm {times[1]:.3f}s ({n_orders / times[1]:,.0f} rows/s)")
    # the orders side stays typed value lanes end to end: in the ingested
    # table and in both pipelines' results, after the checksums and top(3)
    for where, cols in [("ingested orders", orders.plan.table.columns)] + [
        (f"pipeline {name} result", res[0].columns) for name, res in results.items()
    ]:
        for c in ORDERS_COLS:
            if cols[c].kind != "int" or cols[c]._demoted is not None:
                raise AssertionError(f"{where}: column {c} was demoted")
    out["demotions"] = {
        "index_build": [(p.decode(), n) for p, n in index_demotions],
        "main_path": [(p.decode(), n) for p, n in main_demotions],
    }
    log(f"demotions (prefix, rows): index builds {out['demotions']['index_build']}, "
        f"main path {out['demotions']['main_path']}")
    if main_demotions:
        raise AssertionError(f"the main path demoted typed columns: {main_demotions}")
    out["launches"] = launches
    log(f"main path: mask kernel launches {launches}")
    if launches <= 0:
        raise AssertionError("the main path never launched the mask kernel")
    if profile:
        profile_pipelines(srcs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20160914)
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the warm pipelines")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    from csvplus_tpu_torch.ops import mask as M

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind} | nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from concurrent.futures import ThreadPoolExecutor

    from csvplus_tpu_torch.native import scanner as S

    log(f"host CPUs: {os.cpu_count()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:  # nvcc and g++ together
        builds = [pool.submit(M.build), pool.submit(S.build)]
        for f in builds:
            f.result()
    log(f"built {M.SOURCE.relative_to(here)} for sm_90a (nvcc) and "
        f"{S.SOURCE.relative_to(here)} (g++) in {time.perf_counter() - t0:.2f}s")

    mask = check_mask_kernel(args.seed)

    workdir = here / ".chip_smoke_data"
    workdir.mkdir(exist_ok=True)
    try:
        main_path = run_main_path(N_ORDERS, args.seed, "cuda", workdir, args.profile)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    shape = mask["timings"][0]  # pipeline (a)'s shape: k = 2, "all", one target each
    kernels = [{
        "name": "fused_equality_mask",
        "route": "cuda",
        "source": "csvplus_tpu_torch/csrc/mask.cu",
        "replaces": "csvplus_tpu/ops/pallas_mask.py:41",
        "launches": main_path["launches"],
        "max_abs_err": mask["max_abs_err"],
        "ms": shape["ms"],
        "plain_ms": shape["plain_ms"],
        "bound_ms": shape["bound_ms"],
        "bound_by": shape["bound_by"],
        "library_ms": shape["library_ms"],
        "shape": f"n={shape['n']} k={shape['k']} mode={shape['mode']}",
    }]
    log("main path phases " + json.dumps(main_path))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
