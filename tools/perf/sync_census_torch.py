#!/usr/bin/env python
"""The host syncs and the spans of one profiled pass or step of the
port's benchmark cells, on the card.

    python tools/perf/sync_census_torch.py [--seed N] [--out PATH] [cell ...]

Each cell (default ``bunny_grid_c6.render`` and ``zy_scene.train``) is
driven by its benchmark loop (``benchmark/loops/``) with ``--trace 1``:
the set-up, then one pass or step under torch.profiler.  That pass or
step also runs under ``torch.cuda.set_sync_debug_mode("warn")``: every
synchronizing CUDA call warns, and each warning is put down to the
innermost frame of ``ray_tracing_tpu_torch`` on its stack and held
against the ``rtt.sync.<site>`` spans (utils/profiling.py:sync) of the
same region: the one span open at the warning's time, on the profiler's
clock.  Prints, per cell: the warnings by frame and by span, the spans
holding no warning or several, the cell's per-layer metrics
(``benchmark/metrics/``), the device's idle time by innermost span
(``harness/spans.py:idle_by_span``), the profiled window and the spans'
counts; then one JSON line of all of it, also written to ``--out``.
With ``--overhead N``, N more profiled passes or steps follow the
census one (no census), spans off and on in turns (off: the program's
is-enabled check patched to answer False), each read for its window,
idle share, kernels and idle time by span: what the spans cost while a
profiler records.  The census pass's own window holds the warnings'
cost, and its sync spans their handling.

Before the cells, one probe: a span (utils/profiling.py:span) and a
``torch.profiler.record_function`` region around the same kernels, and
what the profiler's events hold of each, host and device.  Exits 1
without a GPU.  Nothing is compared with a reference.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import traceback
import warnings

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_BENCH = os.path.join(_ROOT, "benchmark")
for _p in (_BENCH, _ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

_PACKAGE = os.sep + "ray_tracing_tpu_torch" + os.sep
_SYNC_WARNING = "synchronizing CUDA operation"


class Census:
    """Every synchronizing CUDA call while active: (time ns on the
    profiler's clock, the innermost frame of the port on the stack)."""

    def __init__(self):
        self.calls = []

    def _hook(self, message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING not in str(message):
            return self._show(message, category, filename, lineno, file, line)
        t = time.time_ns()
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack if _PACKAGE in f.filename]
        f = ours[-1] if ours else stack[-2]
        where = f.filename.split(_PACKAGE)[-1] if ours else os.path.basename(f.filename)
        self.calls.append((t, f"{where}:{f.lineno} {f.name}"))

    def __enter__(self):
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.simplefilter("always")
        self._show = warnings.showwarning
        warnings.showwarning = self._hook
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._warnings.__exit__(*exc)


def match(calls, trace) -> dict:
    """The census against the trace's sync spans."""
    from harness.spans import SYNC

    spans = sorted((s, e, n) for s, e, n in trace.cpu if n.startswith(SYNC))
    inside = collections.Counter()
    by_pair = collections.Counter()
    for t, frame in calls:
        hits = [i for i, (s, e, _) in enumerate(spans) if s <= t <= e]
        for i in hits:
            inside[i] += 1
        by_pair[(frame, spans[hits[-1]][2] if hits else "no sync span",
                 len(hits))] += 1
    per_span = collections.Counter(inside[i] for i in range(len(spans)))
    return {
        "sync_calls": len(calls),
        "sync_spans": len(spans),
        "frame_to_span": [[f, n, k, c] for (f, n, k), c in sorted(by_pair.items())],
        "spans_by_calls_inside": {str(k): v for k, v in sorted(per_span.items())},
    }


def probe(device) -> dict:
    """What the profiler's events hold of a span and of a
    record_function region around the same kernels: [name, device,
    user annotation] of each."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ray_tracing_tpu_torch.utils.profiling import span

    x = torch.ones(1 << 20, device=device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span("probe.span"):
            y = x * 2 + 1
        with record_function("probe.record_function"):
            y = y * 2 + 1
        torch.cuda.synchronize(device)
    return {"events": [[e.name(), str(e.device_type()), e.is_user_annotation()]
                       for e in prof.profiler.kineto_results.events()
                       if e.name().startswith("probe.")]}


def _reading(tr, spans_on: bool) -> dict:
    from harness.spans import count, idle_by_span

    return {"spans": spans_on, "window_s": tr.window_s, "busy_s": tr.busy_s,
            "idle_pct": 100.0 * (1.0 - tr.busy_s / tr.window_s),
            "kernels": tr.kernel_launches(), "n_spans": count(tr, "rtt."),
            "idle_by_span": idle_by_span(tr)}


def census_cell(name: str, seed: int, env, overhead: int = 0) -> dict:
    """The census of one traced pass or step of the cell, then
    ``overhead`` more profiled passes or steps, spans off and on in
    turns, each read as the benchmark reads its trace."""
    from unittest import mock

    from harness import report
    from harness.cells import load_cell
    from harness.spans import idle_by_span

    from ray_tracing_tpu_torch.utils import profiling

    cell = load_cell(name)
    loop = cell.loop
    real = loop.profile
    census = Census()
    turns = []

    def profiled(fn, sync):
        def body():
            with census:
                return fn()
        out, tr = real(body, sync)
        for i in range(overhead):
            on = i % 2 == 1
            # spans off: the program's is-enabled check answers False
            with mock.patch.object(profiling, "_profiler_enabled", lambda: on):
                turns.append(_reading(real(fn, sync)[1], on))
        return out, tr

    loop.profile = profiled
    try:
        run = loop.drive(cell, seed, 0.0, True, env)
    finally:
        loop.profile = real
    tr = run.trace
    return {"cell": name, "seed": seed, "window_s": tr.window_s, "busy_s": tr.busy_s,
            "metrics": {k: v["value"] for k, v in report.per_layer(cell, run).items()},
            "idle_by_span": idle_by_span(tr),
            "spans": dict(collections.Counter(n for _, _, n in tr.cpu
                                              if n.startswith("rtt.")).most_common()),
            "census": match(census.calls, tr), "overhead": turns}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="*", default=["bunny_grid_c6.render", "zy_scene.train"])
    ap.add_argument("--seed", type=int, default=3600000001)
    ap.add_argument("--out", default=None)
    ap.add_argument("--overhead", type=int, default=0,
                    help="profiled passes or steps after the census, spans off and on in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sync_census_torch.py needs a CUDA card", file=sys.stderr)
        return 1
    from harness.driving import Env

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    env = Env(device=device, age=lambda: time.perf_counter() - t0)
    result = {"card": torch.cuda.get_device_name(device), "torch": torch.__version__,
              "probe": probe(device), "cells": []}
    print(json.dumps(result["probe"]), flush=True)
    for name in args.cells:
        cell = census_cell(name, args.seed, env, args.overhead)
        result["cells"].append(cell)
        c = cell["census"]
        print(f"{name}: {c['sync_calls']} synchronizing calls, {c['sync_spans']} sync spans; "
              f"window {cell['window_s']:.3f} s, busy {cell['busy_s']:.3f} s", flush=True)
        for frame, span_name, k, n in c["frame_to_span"]:
            print(f"  {n:6d}  {frame}  ->  {span_name} ({k} open)")
        print(f"  sync spans by calls inside: {c['spans_by_calls_inside']}")
        print(f"  metrics: {json.dumps(cell['metrics'])}")
        print(f"  idle by span: {json.dumps(cell['idle_by_span'])}")
        print(f"  spans: {json.dumps(cell['spans'])}", flush=True)
        for t in cell["overhead"]:
            print(f"  spans {'on ' if t['spans'] else 'off'}: window {t['window_s']:.4f} s, "
                  f"idle {t['idle_pct']:.2f} %, {t['kernels']} kernels, {t['n_spans']} spans",
                  flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
