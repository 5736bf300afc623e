"""The control of each cell's comparison, run at the cell's own size.

    python3 -m portbench.control --workload join3-10m.all --seeds 11 12 13 --units 2

For every seed it makes the cell's set-up, then, for each of *units*
units, reads the numbers compared twice through the one comparison
(:func:`portbench.harness.judge`): once for the program's result (a
sound run, whose numbers set the lower readings) and once for the
unit kind's control (``control``: a guarantee of the configuration
broken, whose numbers set the upper readings).  One line per seed and
unit on standard output, then a JSON summary of both readings' extremes.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

from portbench.harness import Device, judge, load_cell, set_up

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, units: int, device: str = "cuda",
             scale: "dict | None" = None) -> list:
    """[(program's numbers, control's numbers)] for *units* units of
    *cell* under *seed*."""
    dev = Device(device)
    unit = set_up(cell, seed, dev, scale)
    out = []
    for k in range(units):
        drawn = unit.draw(k)
        result = unit.run(drawn)
        dev.sync()
        program = judge(unit, drawn, result)
        result = None
        control = unit.control(drawn)
        dev.sync()
        out.append((program, judge(unit, drawn, control)))
        control = None
    del unit
    gc.collect()
    if dev.cuda:
        dev.torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--units", type=int, default=2)
    args = ap.parse_args(argv)
    cell = load_cell(ROOT, args.workload)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    lows, highs = {}, {}
    for seed in args.seeds:
        for k, (program, control) in enumerate(readings(cell, seed, args.units)):
            print(f"{args.workload} seed {seed} unit {k}: program {program} control {control}",
                  flush=True)
            for name in program:
                lows[name] = max(lows.get(name, 0), program[name])
                highs[name] = min(highs.get(name, control[name]), control[name])
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "units": args.units,
                      "program_max": lows, "control_min": highs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
