#!/usr/bin/env python
"""Profile one stage of the PyTorch port's bench on the card, the
counterpart of ``tools/perf/profile_pass.py``: run the stage once under
torch.profiler (CPU and CUDA activities) and rank the device kernels by
device ms, with their launch counts and the device's busy share (device
time over the profiled wall time).

Usage: python tools/perf/profile_pass_torch.py [fwd|colors|full] [top_n]

The stages are ``ladder_torch.STAGES`` at the bench's settings (zy
1024^2, depth 20, tiles of 65,536 rays); the command line profiles one
whole pass (the full stage: 488,909 device activities, read in 11.9 s
on the host of an NVIDIA H100 80GB HBM3, 700.00 W), ``main(stage,
top_n, tiles=N, depth=D)`` the first N tiles of it at another depth.  The kernels are read from the
profiler's raw results: building ``prof.events()`` for ~300,000 kernels
costs minutes of host time.

Within the profiled session every hand-written kernel family's launches
seen by the profiler are held against the launch counters of its
wrapper (``LAUNCH_COUNTERS``); where they differ the script says so and
exits 1, so that a ranking never silently lacks a kernel.  Exits 1
without a GPU.  Prints the ranking, then one JSON summary line.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
if _HERE not in sys.path:
    sys.path.insert(0, _HERE)

import ladder_torch  # noqa: E402  (the stages and their setup)

# kernel family -> (module under ray_tracing_tpu_torch.ops, counter, device
# kernels per count): K2's wrapper counts calls of two launches each
LAUNCH_COUNTERS = {
    "K1": ("cuda_intersect", "LAUNCHES", 1),
    "K3": ("cuda_intersect", "TF_LAUNCHES", 1),
    "K4": ("cuda_intersect", "MOTION_LAUNCHES", 1),
    "K2": ("cuda_scatter", "LAUNCHES", 2),
    "K5": ("cuda_triangles", "LAUNCHES", 1),
    "K6": ("cuda_triangles", "CL_LAUNCHES", 1),
}
# phase_a_kernel's first three template arguments (kSphTf, kRectTf,
# kSphMotion), demangled or mangled
_PHASE_A = re.compile(r"phase_a_kernel(?:<\s*(true|false)\s*,\s*(true|false)\s*,\s*(true|false)"
                      r"|ILb([01])ELb([01])ELb([01])E)")


def family(name: str):
    """The hand-written kernel family of a device kernel's name (K1-K6),
    or None for any other kernel."""
    m = _PHASE_A.search(name)
    if m:
        sph_tf, rect_tf, motion = (a in ("true", "1") for a in
                                   (m.group(1) or m.group(4), m.group(2) or m.group(5),
                                    m.group(3) or m.group(6)))
        return "K4" if motion else "K3" if sph_tf or rect_tf else "K1"
    for part, fam in (("scatter_add_place_kernel", "K2"), ("scatter_add_sum_kernel", "K2"),
                      ("triangle_sweep_kernel", "K5"), ("cluster_sweep_kernel", "K6")):
        if part in name:
            return fam
    return None


def aggregate(events) -> dict:
    """{kernel name: (launches, device ms)} of (name, device ms) events."""
    kernels = {}
    for name, ms in events:
        n, total = kernels.get(name, (0, 0.0))
        kernels[name] = (n + 1, total + ms)
    return kernels


def counted_launches() -> dict:
    """{family: device kernels its wrapper's counter says it launched}."""
    import importlib

    return {fam: getattr(importlib.import_module(f"ray_tracing_tpu_torch.ops.{mod}"), attr) * per
            for fam, (mod, attr, per) in LAUNCH_COUNTERS.items()}


def reset_counters() -> None:
    import importlib

    for mod, attr, _ in LAUNCH_COUNTERS.values():
        setattr(importlib.import_module(f"ray_tracing_tpu_torch.ops.{mod}"), attr, 0)


def family_totals(kernels: dict) -> dict:
    """{family: (launches, device ms)} of aggregate's kernels, for every
    family of LAUNCH_COUNTERS."""
    totals = dict.fromkeys(LAUNCH_COUNTERS, (0, 0.0))
    for name, (n, ms) in kernels.items():
        fam = family(name)
        if fam is not None:
            totals[fam] = (totals[fam][0] + n, totals[fam][1] + ms)
    return totals


def launch_check(kernels: dict, counts: dict) -> list:
    """The families whose launches in ``kernels`` (aggregate's) differ
    from ``counts`` (counted_launches'), each as a message; [] when every
    family agrees."""
    seen = {fam: n for fam, (n, _) in family_totals(kernels).items()}
    return [f"{fam}: the profiler saw {seen.get(fam, 0)} launches, its wrapper counted "
            f"{counts.get(fam, 0)}" for fam in sorted(set(seen) | set(counts))
            if seen.get(fam, 0) != counts.get(fam, 0)]


def device_events(prof):
    """(name, device ms) of every device activity of a finished
    torch.profiler session, from its raw results."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns() / 1e6) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def main(stage: str = "full", top_n: int = 40, *, tiles: int | None = None,
         depth: int | None = None) -> dict:
    """Profile one pass of ``stage`` at key 1 (after a warm-up at key 0)
    over its first ``tiles`` tiles (None: the whole image) at ``depth``
    (None: the scene's own); prints the ranking and a JSON summary and
    returns the summary.  Raises SystemExit(1) when a kernel family's
    profiled launches differ from its wrapper's counter."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tracing_tpu_torch.ops import rng

    if stage not in ladder_torch.STAGES:
        raise SystemExit(f"unknown stage {stage!r}; the stages are {list(ladder_torch.STAGES)}")
    setup = ladder_torch.Setup(depth=depth, tiles=tiles)
    fn = ladder_torch.STAGES[stage]
    fn(setup, rng.key(0))  # warm-up: builds and loads the kernels
    setup.sync()
    reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(setup, rng.key(1))
        setup.sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = counted_launches()
    t0 = time.perf_counter()
    kernels = aggregate(device_events(prof))
    read_s = time.perf_counter() - t0
    busy = sum(ms for _, ms in kernels.values())
    launches = sum(n for n, _ in kernels.values())
    print(f"stage={stage} {setup.width}x{setup.height} depth {setup.depth}, "
          f"{setup.rays_per_pass} rays in tiles of {setup.tile}: profiled wall {wall_ms:.1f} ms, "
          f"device busy {busy:.1f} ms ({busy / wall_ms:.4f} of wall), {launches} device "
          f"activities, read in {read_s:.1f} s")
    for name, (n, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top_n]:
        fam = family(name)
        print(f"{ms:10.3f} ms  x{n:7d}  {'[' + fam + '] ' if fam else ''}{name[:110]}")
    mismatches = launch_check(kernels, counts)
    totals = family_totals(kernels)
    summary = {"stage": stage, "width": setup.width, "height": setup.height,
               "depth": setup.depth, "rays": setup.rays_per_pass, "tile": setup.tile,
               "wall_ms": wall_ms, "device_ms": busy, "busy_share": busy / wall_ms,
               "device_activities": launches, "counted": counts,
               "families": {fam: n for fam, (n, _) in totals.items()},
               "family_ms": {fam: ms for fam, (_, ms) in totals.items()},
               "mismatches": mismatches}
    print(json.dumps(summary), flush=True)
    if mismatches:
        raise SystemExit("the profile lacks kernel launches its wrappers counted: "
                         + "; ".join(mismatches))
    return summary


if __name__ == "__main__":
    import torch

    if not torch.cuda.is_available():
        print("profile_pass_torch.py needs an NVIDIA GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(1)
    main(sys.argv[1] if len(sys.argv) > 1 else "full",
         int(sys.argv[2]) if len(sys.argv) > 2 else 40)
