"""Host ms inside ``rtt.compile`` in the profiled preview round: the
façade's scene compiled to the flat tables and the port's renderer
built on them, the tables uploaded to the card
(v4ray/__init__.py:Renderer).

Host time under the profiler: compare it with the same reading of
another run, not with pass_ms.  Nothing to read from a program without
the span.  Moves pass_ms."""

UNIT = "ms"
SPAN = "rtt.compile"


def read(ctx):
    if ctx.loop != "preview" or ctx.trace is None:
        return None
    from harness.spans import count, wall_s

    return wall_s(ctx.trace, SPAN) * 1e3 if count(ctx.trace, SPAN) else None
