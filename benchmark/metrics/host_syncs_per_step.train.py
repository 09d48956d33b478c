"""Host reads that wait on the device in the profiled train step: the
``rtt.sync.<site>`` spans (render/integrator.py, ops/textures.py,
render/prb_scalar.py, ...), one around each such read.

Nothing to read from a program without spans.  Moves step_ms."""

UNIT = "syncs"
SPAN = "rtt.sync."


def read(ctx):
    if ctx.loop != "train" or ctx.trace is None:
        return None
    from harness.spans import count

    return count(ctx.trace, SPAN)
