#!/usr/bin/env python3
"""Time two builds of the mask kernel in one process on one card: the
checkout's ``csvplus_tpu_torch/csrc/mask.cu`` through its wrapper, and an
older ``mask.cu`` with the linear-scan C interface (column pointers, k,
an ``[offsets (k + 1) | targets]`` table, its target count, rows, mode,
out, stream) through a copy of that version's wrapper, which builds and
uploads its table on every call.

Usage: python3 chip_mask_compare.py --old PATH/TO/OLD/mask.cu [--seed S]

At each of ``chip_smoke.py``'s phase-3 timed shapes (n = 10,000,003) it
checks that both builds give the same mask bitwise, then times them in
turns, old, new, new, old, cold (cycling through copies of the inputs of
150 MB or more) and warm (the same inputs back to back), as phase 3 times
them; then the host microseconds of one call at n = 512, k = 2, 50 + 1
targets.  Prints each row as JSON with the card's name and power limit,
and ``ptxas -v``'s registers and spills of both builds.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def _old_library(source: Path):
    from csvplus_tpu_torch.ops import cubuild

    path = cubuild.nvcc_build(source, "libcsvplus_mask_old")
    lib = ctypes.CDLL(str(path))
    fn = lib.csvplus_fused_mask
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, cubuild.ptxas_report(path)


def _old_mask(fn, cols, targets, nrows: int, mode: str):
    """The older wrapper's CUDA half as it was: the offsets-and-targets
    table built in Python, pinned and uploaded on every call."""
    import torch

    k = len(cols)
    device = cols[0].device
    out = torch.empty(nrows, dtype=torch.bool, device=device)
    flat = [0]
    for t in targets:
        flat.append(flat[-1] + len(t))
    n_targets = flat[-1]
    for t in targets:
        flat.extend(t)
    table = torch.tensor(flat, dtype=torch.int32).pin_memory()
    table = table.to(device, non_blocking=True)
    ptrs = (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ptrs, k, table.data_ptr(), n_targets, nrows, 1 if mode == "all" else 0,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"old mask kernel launch failed: CUDA error {err}")
    return out


def _host_us(call, reps: int = 2_000) -> float:
    import torch

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path, help="the older mask.cu")
    ap.add_argument("--seed", type=int, default=20160914)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_mask_compare: no CUDA device is available", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import chip_smoke as C
    from csvplus_tpu_torch.ops import cubuild
    from csvplus_tpu_torch.ops import mask as M

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    old_fn, old_report = _old_library(args.old.resolve())
    print("ptxas -v, old: " + C.ptxas_summary(old_report), flush=True)
    print("ptxas -v, new: " + C.ptxas_summary(cubuild.ptxas_report(M.build())), flush=True)

    data = C.MaskInputs(args.seed)
    n = C.MASK_ROWS
    rows = []
    for name, k, mode, targets, cols in data.timed_shapes(n):
        versions = {
            "old": lambda cs: _old_mask(old_fn, cs, targets, n, mode),
            "new": lambda cs: M.fused_equality_mask(cs, targets, n, mode),
        }
        if not torch.equal(versions["old"](cols), versions["new"](cols)):
            raise AssertionError(f"old and new masks differ at {name}")
        sets = C._cold_copies(cols)
        # the old kernel scans long lists linearly: fewer calls there
        few = (3, 3) if max(len(t) for t in targets) > 100 else ()
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            fn = versions[which]
            cold = C._timed_cold(fn, sets, *few)
            warm = C._timed(lambda: fn(cols), *few)
            times[which].append((cold, warm))
        bound, by = C._bound_ms(n, targets)
        row = {"shape": name, "n": n, "k": k, "mode": mode,
               "targets_per_col": [len(t) for t in targets], "bound_ms": bound,
               "bound_by": by, "card": smi}
        for which, pairs in times.items():
            row[f"{which}_cold_ms"] = [c for c, _ in pairs]
            row[f"{which}_warm_ms"] = [w for _, w in pairs]
        row["cold_speedup"] = float(np.mean(row["old_cold_ms"]) / np.mean(row["new_cold_ms"]))
        rows.append(row)
        print("mask compare " + json.dumps(row), flush=True)
        del sets, cols

    cols = [torch.randint(0, 100, (512,), device=data.dev, dtype=torch.int32) for _ in range(2)]
    targets = [list(range(1, 51)), [7]]
    host = {"n": 512, "k": 2, "mode": "any", "targets_per_col": [50, 1], "card": smi}
    for which in ("old", "new", "new", "old"):
        fn = (lambda: _old_mask(old_fn, cols, targets, 512, "any")) if which == "old" else (
            lambda: M.fused_equality_mask(cols, targets, 512, "any"))
        host.setdefault(f"{which}_host_us", []).append(_host_us(fn))
    print("mask compare host " + json.dumps(host), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
