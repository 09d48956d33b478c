#!/usr/bin/env python3
"""The two readings a cell's limits are set from, on the card:

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 [--seconds S] [--faults a,b]

For each seed, in one process: the program's run of the cell (its
set-up and a window of ``--seconds``, as ``run.py`` drives it) held
against the reference, which gives the lower reading of every number
the cell compares; and the control, the reference with its wavefront
state rounded to bfloat16 after every bounce, put in the program's
place on the same inputs, which gives the upper reading; and with
``--faults`` each planted fault of the cell's loop on the same seed.
One JSON line per seed on standard output."""

from __future__ import annotations

import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
for _p in (BENCH, os.path.dirname(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def readings(cell, seed: int, seconds: float, env, faults=()) -> dict:
    """The program's numbers, the control's and each planted fault's, on
    one seed."""
    import torch

    from harness.faults import planted

    loop = cell.loop
    run = loop.drive(cell, seed, seconds, False, env)
    ref = loop.reference(cell, run.outputs, seed, env)
    out = {"seed": seed, "attempted": run.attempted, "metrics": run.metrics,
           "program": loop.numbers(run.outputs, ref),
           "program_notes": loop.notes(run.outputs, ref)}
    low = loop.reference(cell, run.outputs, seed, env, state_dtype=torch.bfloat16)
    out["control"] = loop.numbers(low, ref)
    out["control_notes"] = loop.notes(low, ref)
    for name in faults:
        with planted(cell.traffic["loop"], name):
            broken = loop.drive(cell, seed, seconds, False, env)
        out[name] = loop.numbers(broken.outputs,
                                 loop.reference(cell, broken.outputs, seed, env))
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    from harness.cells import load_cell
    from harness.driving import Env

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--faults", default="", help="planted faults to read too, comma separated")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("readings.py needs a CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    env = Env(device=torch.device("cuda", 0), age=lambda: time.perf_counter() - t0)
    for seed in (int(s) for s in args.seeds.split(",")):
        faults = [f for f in args.faults.split(",") if f]
        print(json.dumps(readings(cell, seed, args.seconds, env, faults)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
