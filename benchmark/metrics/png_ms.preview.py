"""Host ms inside ``rtt.png`` in the profiled preview round: the pass's
mean tone-mapped to u8 and encoded as a PNG (editor/web.py:render_png),
then in base64 in its JSON reply (render_reply).

Host time under the profiler: compare it with the same reading of
another run, not with pass_ms.  Nothing to read from a program without
the span.  Moves pass_ms."""

UNIT = "ms"
SPAN = "rtt.png"


def read(ctx):
    if ctx.loop != "preview" or ctx.trace is None:
        return None
    from harness.spans import count, wall_s

    return wall_s(ctx.trace, SPAN) * 1e3 if count(ctx.trace, SPAN) else None
