"""The program's own spans in a profiled region: the host events that
``ray_tracing_tpu_torch/utils/profiling.py`` records while a profiler
records (``span``: ``rtt.<layer>``; ``sync``: ``rtt.sync.<site>``, one
host read that waits on the device), read from the host events of a
:class:`harness.profile.Trace` (``cpu``: (start ns, end ns, name)), on
the clock of its device activities.

A program that records no ``rtt.`` span at all (one older than the spans)
gives every reading here None, so its readers report nothing."""

from __future__ import annotations

import numpy as np

PREFIX = "rtt."
SYNC = "rtt.sync."
OUTSIDE = "outside spans"


def _has_spans(trace) -> bool:
    return any(name.startswith(PREFIX) for _, _, name in trace.cpu)


def _intervals(trace, name: str) -> list:
    """[(start ns, end ns)] of the host events named ``name``, or, where
    ``name`` ends in ``.``, of every event whose name starts with it."""
    if name.endswith("."):
        return [(s, e) for s, e, n in trace.cpu if n.startswith(name)]
    return [(s, e) for s, e, n in trace.cpu if n == name]


def wall_s(trace, name: str):
    """Seconds covered by the union of the intervals of span ``name`` (a
    prefix where it ends in ``.``); None where the program recorded no
    span."""
    if not _has_spans(trace):
        return None
    total, end = 0, None
    for s, e in sorted(_intervals(trace, name)):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-9


def count(trace, name: str):
    """How many spans ``name`` (a prefix where it ends in ``.``) the region
    holds; None where the program recorded no span."""
    if not _has_spans(trace):
        return None
    return len(_intervals(trace, name))


def innermost(spans) -> tuple:
    """The timeline of properly nested ``spans`` [(start, end, name)] cut
    where the innermost open span changes: (bounds ns, labels), label i
    holding from bounds[i] to bounds[i + 1], :data:`OUTSIDE` where no
    span is open."""
    bounds, labels, stack = [], [], []

    def close_until(t):
        while stack and (t is None or stack[-1][0] <= t):
            end, _ = stack.pop()
            bounds.append(end)
            labels.append(stack[-1][1] if stack else OUTSIDE)

    for s, e, name in sorted(spans, key=lambda sp: (sp[0], -sp[1])):
        close_until(s)
        stack.append((e, name))
        bounds.append(s)
        labels.append(name)
    close_until(None)
    return np.asarray(bounds, np.int64), labels


def idle_by_span(trace):
    """[[span, idle s], ...], largest first: the device's idle gaps of the
    region (between merged device activities) summed by the innermost
    ``rtt.`` span open at each gap's midpoint, or :data:`OUTSIDE`; None
    where the program recorded no span."""
    if not _has_spans(trace):
        return None
    gap_start, gap_len = trace._gaps
    bounds, labels = innermost([c for c in trace.cpu if c[2].startswith(PREFIX)])
    idx = np.searchsorted(bounds, gap_start + gap_len // 2, side="right") - 1
    totals = {}
    for i, length in zip(idx, gap_len):
        name = labels[i] if i >= 0 else OUTSIDE
        totals[name] = totals.get(name, 0.0) + int(length) * 1e-9
    return [[n, s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])]
