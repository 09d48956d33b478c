"""Per-pass timing and throughput records and profiler traces, the
counterpart of ``ray_tracing_tpu/utils/profiling.py``.

``RenderStats`` keeps each pass's seconds and traced ray segments (the
honest rays/s numerator); its ``summary()`` has the JAX package's keys.
``torch_trace`` wraps a ``torch.profiler`` profile (CPU activity, and
CUDA on a CUDA device) and writes a Chrome trace.

``span(name)`` marks a region of the program in the event stream of a
recording ``torch.profiler`` (on the same clock as its device
activities), and ``sync(site)`` marks one host read that blocks on the
device: ``rtt.sync.<site>``.  Spans are on exactly when a profiler
records; otherwise a span costs one is-enabled check.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

# A span enters a RecordFunction of FUNCTION scope: the profiler records it
# as a host event with the span's name.  torch.profiler.record_function
# would enter one of USER_SCOPE, which the profiler also mirrors onto the
# device timeline as a ``gpu_user_annotation`` covering the kernels the
# region launched: readers of the device activities would count it as one.
_RecordFunction = torch._C._profiler._RecordFunctionFast
_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()  # shared: entering it allocates nothing


def span(name: str):
    """A context that records the region as ``name`` while a
    ``torch.profiler`` records, and the shared null context otherwise."""
    if not _profiler_enabled():
        return _OFF
    return _RecordFunction(name)


def sync(site: str):
    """:func:`span` ``rtt.sync.<site>``, around the one host read at a site
    that waits on the device."""
    if not _profiler_enabled():
        return _OFF
    return _RecordFunction("rtt.sync." + site)


@dataclass
class PassRecord:
    iteration: int
    seconds: float
    segments: float  # traced ray segments (sum over bounces of live rays)

    @property
    def rays_per_s(self) -> float:
        return self.segments / self.seconds if self.seconds > 0 else 0.0


@dataclass
class RenderStats:
    """Accumulates per-pass timing and throughput; prints reference-style
    ``Iter N +Ts`` lines when ``verbose``.  The caller ends a pass once
    its result is on the host, so a pass's seconds hold its device work."""

    verbose: bool = False
    passes: List[PassRecord] = field(default_factory=list)
    _t0: Optional[float] = None

    def start_pass(self) -> None:
        self._t0 = time.perf_counter()

    def end_pass(self, segments: float = 0.0) -> PassRecord:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        rec = PassRecord(iteration=len(self.passes) + 1, seconds=dt, segments=float(segments))
        self.passes.append(rec)
        if self.verbose:
            print(f"Iter {rec.iteration} +{dt:.3f}s", flush=True)
        return rec

    @property
    def total_seconds(self) -> float:
        return sum(p.seconds for p in self.passes)

    @property
    def total_segments(self) -> float:
        return sum(p.segments for p in self.passes)

    @property
    def rays_per_s(self) -> float:
        t = self.total_seconds
        return self.total_segments / t if t > 0 else 0.0

    def summary(self) -> dict:
        return {
            "passes": len(self.passes),
            "total_seconds": self.total_seconds,
            "total_segments": self.total_segments,
            "rays_per_s": self.rays_per_s,
            "seconds_per_pass": self.total_seconds / len(self.passes) if self.passes else 0.0,
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump({
                "summary": self.summary(),
                "passes": [{"iteration": p.iteration, "seconds": p.seconds,
                            "segments": p.segments} for p in self.passes],
            }, fh, indent=1)


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str], device="cpu"):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    when ``device`` is a CUDA device) and write its Chrome trace to
    ``log_dir/trace_<time>_<pid>.json``; a no-op when ``log_dir`` is
    None or empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        name = f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
        prof.export_chrome_trace(os.path.join(log_dir, name))
