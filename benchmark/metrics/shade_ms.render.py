"""Host ms inside ``rtt.shade`` in the profiled render pass: each bounce's
``shade`` (render/integrator.py:_bounce): materials, textures, the
light mixture.

Host time under the profiler, which about doubles a wall: compare it
with the same reading of another run, not with pass_ms.  Nothing to
read from a program without spans.  Moves pass_ms."""

UNIT = "ms"
SPAN = "rtt.shade"


def read(ctx):
    if ctx.loop != "render" or ctx.trace is None:
        return None
    from harness.spans import wall_s

    s = wall_s(ctx.trace, SPAN)
    return None if s is None else s * 1e3
