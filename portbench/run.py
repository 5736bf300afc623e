"""The benchmark's command line: one run of one cell.

    python3 -m portbench --workload join3-10m.all --seed 7 --seconds 10 --trace 0

Run from the root of a checkout.  It needs as many CUDA cards as the
cell asks for and never falls back to the CPU; it exits non-zero with no
result when they are missing, and when the process holds ``jax``,
``jaxlib``, ``flax`` or the JAX package (``csvplus_tpu``) once the window
has closed.  Earlier lines on standard error give the card, its power
limit and clocks, the set-up's steps, the window and the check; the
numbers compared, each with its limit, are the last lines there, and the
result is the last line of standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from portbench.harness import load_cell, log, run_cell

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "csvplus_tpu"})


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def card_lines() -> None:
    """The card as ``nvidia-smi`` reads it (name, power limit, clocks)."""
    query = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        log(f"nvidia-smi ({query}): {res.stdout.strip() or res.stderr.strip()}")
    except (OSError, subprocess.TimeoutExpired) as e:
        log(f"nvidia-smi: not read ({e})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(ROOT, args.workload)

    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: the cell needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; host CPUs {os.cpu_count()}")
    card_lines()
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    card_lines()
    bad = forbidden_modules()
    if bad:
        log(f"no result: the process holds {bad}")
        return 3
    for name, c in result["checks"].items():
        limit = " ".join(f"{k.replace('_', ' ')} {v}" for k, v in c.items() if k != "value")
        log(f"check {name}: {c['value']} ({limit})")
    print(json.dumps(result), flush=True)
    return 0
