"""Tiles the profiled train step traced: the ``rtt.tile`` spans of
parallel/mesh.py:tiled_loss_and_grad, one per dispatch of the taped
bounce loop's kernel sequence and its sweep over a tile of rays
(render/integrator.py), so each per-bounce launch and host sync is paid
once per tile.

Nothing to read from a program without the span.  Moves step_ms."""

UNIT = "tiles"
SPAN = "rtt.tile"


def read(ctx):
    if ctx.loop != "train" or ctx.trace is None:
        return None
    from harness.spans import count

    return count(ctx.trace, SPAN) or None
