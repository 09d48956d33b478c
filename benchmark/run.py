#!/usr/bin/env python3
"""The benchmark of ``ray_tracing_tpu_torch``, the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` (``benchmark/workloads/<cell>.json``)
on the cards of this machine: its set-up (the scene compiled, the
kernels loaded or built, the first passes or steps of its traffic), then
``--seconds`` of its traffic, or with ``--trace 1`` one profiled pass or
step.  It then compares what the timed path produced with the plain
reference (``benchmark/reference``) and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics, read by ``benchmark/metrics/``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also close standard error.

Exits 2, printing no result, when the cell's cards are not there; 3 when
a module of JAX or of the JAX package is loaded after the window.
Builds and caches stay inside the checkout (the port's ``build/``).
"""

from __future__ import annotations

import os
import sys
import time

_T0 = time.perf_counter()


def _age_at_start() -> float:
    """Seconds the process had lived when this module started (Linux's
    /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _age_at_start()
BENCH = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH)
for _p in (BENCH, CHECKOUT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def age() -> float:
    """Seconds since the process started."""
    return _AGE0 + time.perf_counter() - _T0


def parse(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    # caches of compilers that the program may use, at fixed places in the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CHECKOUT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CHECKOUT, "build", "triton")
    from harness import report
    from harness.cells import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s): torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    from harness.driving import Env

    env = Env(device=torch.device("cuda", 0), age=age)
    torch.cuda.set_device(env.device)
    run = cell.loop.drive(cell, args.seed, args.seconds, bool(args.trace), env)
    return report.finish(cell, run, args.seed, bool(args.trace), env)


if __name__ == "__main__":
    sys.exit(main())
