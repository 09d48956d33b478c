"""One step or pass under torch.profiler (CPU and CUDA activities), read
from the profiler's raw results, as tools/perf/profile_pass_torch.py
reads them: the device activities by name, the union of device activity
(busy seconds), the idle gaps between them and what the host was doing
in each, and the hand-written kernels' launches against the launch
counters of the port's wrappers.  The trace stays in memory."""

from __future__ import annotations

import importlib
import re
import time

import numpy as np

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
_NOT_KERNELS = ("Memcpy", "Memset")


def family(name: str):
    """The hand-written kernel family of a device activity's name (K1-K6),
    or None."""
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


def counted_launches() -> dict:
    """{family: device kernels its wrapper's counter says it launched}."""
    return {fam: getattr(importlib.import_module(f"ray_tracing_tpu_torch.ops.{mod}"), attr) * per
            for fam, (mod, attr, per) in LAUNCH_COUNTERS.items()}


def reset_counters() -> None:
    for mod, attr, _ in LAUNCH_COUNTERS.values():
        setattr(importlib.import_module(f"ray_tracing_tpu_torch.ops.{mod}"), attr, 0)


class Trace:
    """The reading of one profiled region.

    ``names``/``start``/``dur`` are the device activities (ns), ``kernels``
    {name: (launches, device s)}, ``busy_s`` the union of the device
    activities, ``window_s`` the region's wall by the host clock,
    ``counted`` the wrappers' launch counts over the region."""

    def __init__(self, prof, window_s: float, counted: dict):
        from torch.autograd import DeviceType

        t0 = time.perf_counter()
        names, start, dur, cpu = [], [], [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                names.append(e.name())
                start.append(e.start_ns())
                dur.append(e.duration_ns())
            else:
                cpu.append((e.start_ns(), e.end_ns(), e.name()))
        self.names = names
        self.start = np.asarray(start, np.int64)
        self.dur = np.asarray(dur, np.int64)
        self.cpu = cpu
        self.window_s = window_s
        self.counted = counted
        self.kernels = {}
        for name, d in zip(names, dur):
            n, total = self.kernels.get(name, (0, 0.0))
            self.kernels[name] = (n + 1, total + d * 1e-9)
        self.busy_s, self._gaps = self._union()
        self.read_s = time.perf_counter() - t0

    def _union(self):
        """(seconds covered by device activity, (gap start ns, gap length
        ns) between merged activities)."""
        if not len(self.start):
            return 0.0, (np.zeros(0, np.int64), np.zeros(0, np.int64))
        order = np.argsort(self.start, kind="stable")
        s, e = self.start[order], self.start[order] + self.dur[order]
        run_end = np.maximum.accumulate(e)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > run_end[:-1]
        firsts = np.flatnonzero(new)
        lasts = np.append(firsts[1:] - 1, len(s) - 1)
        busy = int((run_end[lasts] - s[firsts]).sum())
        gap_start = run_end[lasts[:-1]]
        return busy * 1e-9, (gap_start, s[firsts[1:]] - gap_start)

    def kernel_launches(self) -> int:
        """Device kernels (copies and fills left out)."""
        return sum(n for name, (n, _) in self.kernels.items()
                   if not name.startswith(_NOT_KERNELS))

    def family_seen(self, fam: str) -> int:
        return sum(n for name, (n, _) in self.kernels.items() if family(name) == fam)

    def device_s(self, match) -> tuple:
        """(launches seen, device s) of the activities whose name
        ``match(name)`` accepts."""
        n = s = 0
        for name, (k, t) in self.kernels.items():
            if match(name):
                n, s = n + k, s + t
        return n, s

    def family_s(self, fam: str):
        """Device seconds of a kernel family in the region.  Where the
        profiler saw fewer launches than the wrapper counted, the mean of
        the launches it saw times the launches counted; None where it saw
        none but some were counted."""
        seen, s = self.device_s(lambda name: family(name) == fam)
        counted = self.counted.get(fam, 0)
        if seen >= counted:
            return s
        return None if not seen else s / seen * counted

    def launch_check(self) -> list:
        """One line per kernel family whose profiled launches differ from
        its wrapper's count."""
        return [f"{fam}: the profiler saw {self.family_seen(fam)} launches, its wrapper "
                f"counted {self.counted.get(fam, 0)}"
                for fam in LAUNCH_COUNTERS
                if self.family_seen(fam) != self.counted.get(fam, 0)]

    def top_ops(self, k: int = 10) -> list:
        """[[name, device s], ...] of the ``k`` activities that took most."""
        ranked = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:k]
        return [[name, s] for name, (_, s) in ranked]

    def idle_gaps(self, k: int = 10) -> list:
        """[[host op, idle s], ...]: the device's idle gaps summed by the
        innermost host operation running at each gap's midpoint (``host``
        where none was), the ``k`` largest."""
        gap_start, gap_len = self._gaps
        if not len(gap_len):
            return []
        cpu = sorted(self.cpu)
        c_start = np.asarray([c[0] for c in cpu], np.int64)
        c_end = np.asarray([c[1] for c in cpu], np.int64)
        mids = gap_start + gap_len // 2
        idx = np.searchsorted(c_start, mids, side="right") - 1
        totals = {}
        for m, i, length in zip(mids, idx, gap_len):
            name = "host"
            for j in range(i, max(i - 256, -1), -1):
                if c_end[j] >= m:
                    name = cpu[j][2]
                    break
            totals[name] = totals.get(name, 0.0) + length * 1e-9
        return [[n, s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:k]]


def profile(fn, sync):
    """Run ``fn()`` once under the profiler, ``sync()`` inside the region;
    returns (fn's value, :class:`Trace`)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    reset_counters()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window_s = time.perf_counter() - t0
    return out, Trace(prof, window_s, counted_launches())
