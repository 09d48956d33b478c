"""The end of a run: the comparison with the reference, the per-layer
metrics of a traced run, the check that no module of JAX or of the JAX
package was loaded, and the lines a reader needs, the result's JSON last
on standard output."""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from harness import verdict
from harness.cells import metric_readers

# top-level module names the benchmark's process may never hold: JAX, the
# JAX package, and the repository's own scripts beside the port
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tracing_tpu", "bench_torch", "chip_smoke", "tools")


def forbidden_modules() -> list:
    """The loaded modules whose whole top-level name is forbidden."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_line(env) -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    index = env.device.index or 0
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return f"card {index}: {out}"


class Context:
    """What a per-layer metric's reader reads: the loop, the cell, the
    profiled region's :class:`harness.profile.Trace` and the side
    readings of the run (segments, counted launches)."""

    def __init__(self, cell, run):
        self.cell = cell
        self.loop = cell.traffic["loop"]  # the loop's name
        self.trace = run.trace
        self.readings = run.readings


def per_layer(cell, run) -> dict:
    ctx = Context(cell, run)
    out = {}
    for name, mod in metric_readers().items():
        value = mod.read(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": mod.UNIT}
    return out


def finish(cell, run, seed: int, traced: bool, env) -> int:
    err = []
    metrics = per_layer(cell, run) if traced else {
        k: {"value": v, "unit": "s" if k == "setup_s" else "ms"} for k, v in run.metrics.items()}
    kind = torch.cuda.get_device_name(env.device) if env.device.type == "cuda" else "cpu"
    device = {"platform": "gpu" if env.device.type == "cuda" else "cpu", "kind": kind,
              "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": False, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device}
    err.append(card_line(env))
    err += run.notes
    if traced:
        tr = run.trace
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        err.append(f"profiled {tr.window_s!r} s: device busy {tr.busy_s!r} s, "
                   f"{tr.kernel_launches()} kernels, {len(tr.names)} device activities, "
                   f"read in {tr.read_s:.2f} s; readings {run.readings}")
        err.append(f"launches counted by the wrappers {tr.counted}; seen by the profiler "
                   + str({fam: tr.family_seen(fam) for fam in tr.counted}))
        err += [f"launch check: {line}" for line in tr.launch_check()]
        run.trace = tr = None
    err.append(f"memory_peak_bytes {run.memory_peak_bytes} (torch.cuda.max_memory_allocated)")

    values, lines = verdict.compare(cell, run.outputs, seed, env)
    result["correct"] = verdict.judge(cell, values) and run.failed == 0
    err += lines
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr, flush=True)
        return 3
    err.append("readings not compared: " + json.dumps(
        {k: v for k, v in values.items() if k not in cell.limits}))
    checks = {k: {"value": values.get(k), "limit": lim} for k, lim in cell.limits.items()}
    result["checks"] = checks
    err += [f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    print("\n".join(err), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
