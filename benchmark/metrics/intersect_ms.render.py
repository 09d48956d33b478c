"""Host ms inside ``rtt.intersect`` in the profiled render pass: each
bounce's ``intersect_scene`` (render/integrator.py:_bounce), phase A
(K1, K6) and the phase-B rebuild.

Host time under the profiler, which about doubles a wall: compare it
with the same reading of another run, not with pass_ms.  Nothing to
read from a program without spans.  Moves pass_ms."""

UNIT = "ms"
SPAN = "rtt.intersect"


def read(ctx):
    if ctx.loop != "render" or ctx.trace is None:
        return None
    from harness.spans import wall_s

    s = wall_s(ctx.trace, SPAN)
    return None if s is None else s * 1e3
