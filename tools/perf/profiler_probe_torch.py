#!/usr/bin/env python
"""Does torch.profiler see every launch of the port's ctypes kernels?

Runs, on the card, one child process per variant: ``static`` (K1,
csrc/intersect.cu, built with the flags of ops/_build.py, which link the
CUDA runtime statically by nvcc's default, so the library carries a
runtime of its own beside torch's), ``shared`` (the same flags plus
``-cudart shared``: the library uses the process's one runtime, torch's)
``static-linger`` (the static build, each session held open LINGER_S
after its last synchronize, so that activity buffers flushed late still
land in it) and ``static-busy`` (the static build, BUSY_OPS unprofiled
PyTorch kernels and BUSY_OPS / 100 K1 launches between two sessions, as
a render between two of chip_smoke.py's sessions).  Each child launches K1 through its wrapper on 65,536 zy rays and records,
session by session, how many K1 launches the profiler's raw results
hold against the launches made:

  1. a long session: LONG_OPS small PyTorch kernels with a K1 launch
     after every 100 (the size of a profiled tile of the fwd+bwd pass);
  2. ROUNDS rounds of two short sessions: 10 K1 launches, each beside a
     PyTorch op (chip_smoke.py:profile_pair's pattern), then 10 alone.

Prints one JSON line per child: the runtime libraries mapped into it,
the long session's counts and the K1 launches each short session saw
(of 10), in order, with the first session that missed one.

Usage: python tools/perf/profiler_probe_torch.py [static|shared|static-linger|static-busy ...]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LONG_OPS = 100_000
ROUNDS = 150
SHORT_CALLS = 10
LINGER_S = 0.2
BUSY_OPS = 2000
VARIANTS = ("static", "shared", "static-linger", "static-busy")


def _session(fn, k1_name: str, linger: float):
    """(K1 seen, other device kernels seen) in one profiled call of fn."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(linger)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    k1 = sum(1 for n in names if k1_name in n)
    return k1, len(names) - k1


def child(variant: str) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from ray_tracing_tpu_torch import load_scene_json
    from ray_tracing_tpu_torch.ops import _build
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci

    if variant == "shared":
        from torch.utils.cpp_extension import CUDA_HOME

        _build.NVCC_FLAGS = _build.NVCC_FLAGS + (
            "-cudart", "shared", "-Xlinker", f"-rpath={os.path.join(CUDA_HOME, 'lib64')}")
    lib = _build.build(ci.SOURCE)
    scene = load_scene_json(os.path.join(ROOT, "data", "zy_scene.json")).scene.to("cuda")
    r = np.random.RandomState(0)
    ro = torch.from_numpy(r.uniform(50.0, 500.0, (65536, 3)).astype(np.float32)).cuda()
    rd = torch.from_numpy(r.normal(size=(65536, 3)).astype(np.float32)).cuda()
    rd = (rd / rd.norm(dim=1, keepdim=True)).contiguous()
    x = torch.zeros(1 << 16, device="cuda")

    def k1():
        ci.phase_a_cuda(scene.phase_a, ro, rd, 1e-3, float("inf"))

    k1()  # load and warm up
    torch.cuda.synchronize()
    with open("/proc/self/maps") as fh:
        runtimes = sorted({line.split()[-1] for line in fh if "libcudart" in line})

    def long():
        for i in range(LONG_OPS):
            x.add_(1.0)
            if i % 100 == 99:
                k1()

    linger = LINGER_S if variant == "static-linger" else 0.0
    seen, other = _session(long, "phase_a_kernel", linger)
    long_counts = {"k1_seen": seen, "k1_made": LONG_OPS // 100, "torch_seen": other,
                   "torch_made": LONG_OPS}
    short = []
    for _ in range(ROUNDS):
        if variant == "static-busy":
            for i in range(BUSY_OPS):
                x.add_(1.0)
                if i % 100 == 99:
                    k1()
        for fn in (lambda: [(k1(), x.add_(1.0)) for _ in range(SHORT_CALLS)],
                   lambda: [k1() for _ in range(SHORT_CALLS)]):
            short.append(_session(fn, "phase_a_kernel", linger)[0])
    missed = [i for i, seen in enumerate(short) if seen < SHORT_CALLS]
    return {"variant": variant, "library": os.path.relpath(lib, ROOT), "runtimes": runtimes,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0), "long": long_counts,
            "short_seen": short, "first_short_miss": missed[0] if missed else None,
            "k1_missed": long_counts["k1_made"] - long_counts["k1_seen"]
            + sum(SHORT_CALLS - seen for seen in short)}


def main(variants) -> int:
    rc = 0
    for variant in variants:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", variant],
                             capture_output=True, text=True, timeout=900, cwd=ROOT)
        lines = [x for x in run.stdout.splitlines() if x.startswith("{")]
        if run.returncode or not lines:
            print(f"{variant}: exit {run.returncode}\n{run.stderr[-3000:]}", file=sys.stderr)
            rc = 1
            continue
        print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])), flush=True)
        sys.exit(0)
    import torch

    if not torch.cuda.is_available():
        print("profiler_probe_torch.py needs an NVIDIA GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(1)
    sys.exit(main(sys.argv[1:] or VARIANTS))
