"""Host reads that wait on the device in the profiled render pass: the
``rtt.sync.<site>`` spans (render/integrator.py, ops/textures.py,
render/renderer.py, ...), one around each such read.

Nothing to read from a program without spans.  Moves pass_ms."""

UNIT = "syncs"
SPAN = "rtt.sync."


def read(ctx):
    if ctx.loop != "render" or ctx.trace is None:
        return None
    from harness.spans import count

    return count(ctx.trace, SPAN)
