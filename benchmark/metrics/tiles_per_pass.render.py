"""Tiles the profiled render pass traced: the ``rtt.tile`` spans of
render/renderer.py:render_pass, one per dispatch of the bounce loop's
kernel sequence over a tile of rays (render/integrator.py), so each
per-bounce launch and host sync is paid once per tile.

Nothing to read from a program without the span.  Moves pass_ms."""

UNIT = "tiles"
SPAN = "rtt.tile"


def read(ctx):
    if ctx.loop != "render" or ctx.trace is None:
        return None
    from harness.spans import count

    return count(ctx.trace, SPAN) or None
