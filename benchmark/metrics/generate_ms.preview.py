"""Host ms inside ``rtt.generate`` in the profiled preview round: the
document turned into the façade's scene, camera and settings at the
preview's semantics (editor/generate.py:generate).

Host time under the profiler: compare it with the same reading of
another run, not with pass_ms.  Nothing to read from a program without
the span.  Moves pass_ms."""

UNIT = "ms"
SPAN = "rtt.generate"


def read(ctx):
    if ctx.loop != "preview" or ctx.trace is None:
        return None
    from harness.spans import count, wall_s

    return wall_s(ctx.trace, SPAN) * 1e3 if count(ctx.trace, SPAN) else None
