"""What every loop (``loops/<name>.py``) shares: where a run goes, what
it hands on, and the timed window with its look at the host.

A loop warms up inside its set-up (the first passes or steps, which
build and load every kernel and are part of the traffic), times its
window, profiles one more pass or step instead when traced, then keeps
on the host what the comparison needs and frees the program's state.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch


@dataclasses.dataclass
class Env:
    """Where a run goes, and its clock since the process started."""

    device: torch.device
    age: object  # () -> seconds since the process started

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Run:
    """What a loop hands on: the end-to-end metrics, the counts, the trace
    and its side readings, and the program's outputs for the comparison."""

    metrics: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    outputs: dict
    trace: object = None
    readings: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)


def peak(env: Env) -> int:
    return int(torch.cuda.max_memory_allocated(env.device)) if env.device.type == "cuda" else 0


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _steal_s() -> float:
    """Seconds the hypervisor ran something else on this machine's CPUs
    (all CPUs summed, /proc/stat); 0 where it cannot be read."""
    try:
        import os

        with open("/proc/stat") as fh:
            fields = fh.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


class _GcClock:
    """Collections of Python's cyclic collector and their seconds, while
    active."""

    def __init__(self):
        self.n, self.s, self._t = 0, 0.0, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.n += 1
            self.s += time.perf_counter() - self._t

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def window(seconds: float, body, what: str, notes: list) -> tuple:
    """``body(j)`` for j = 0, 1, ... until ``seconds`` have passed since the
    first began; returns (calls, wall seconds), all of each call inside.
    Appends to ``notes`` each call's ms and what the host did meanwhile:
    the main thread's CPU seconds over the wall, the machine's steal and
    the cyclic collector's time."""
    walls, cpus = [], []
    steal0 = _steal_s()
    with _GcClock() as gcc:
        t0 = time.perf_counter()
        c0 = time.thread_time()
        j, last, last_c = 0, t0, c0
        while True:
            body(j)
            j += 1
            now, now_c = time.perf_counter(), time.thread_time()
            walls.append(now - last)
            cpus.append(now_c - last_c)
            last, last_c = now, now_c
            if now - t0 >= seconds:
                break
    wall = last - t0
    notes.append(f"each {what}'s ms: {[round(w * 1e3, 1) for w in walls]}")
    notes.append(f"each {what}'s main-thread CPU share: {[round(c / w, 3) for c, w in zip(cpus, walls)]}")
    notes.append(f"host over the window: main thread CPU {sum(cpus):.3f} s of {wall:.3f} s; "
                 f"steal {_steal_s() - steal0:.3f} s (all CPUs); cyclic gc {gcc.n} "
                 f"collections, {gcc.s:.3f} s")
    return j, wall
