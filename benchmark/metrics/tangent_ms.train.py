"""Host ms inside ``rtt.tangent_pass`` in the profiled train step: the
fuzz and IR tangent re-traces (render/prb_scalar.py:
_scalar_tangent_pass).

Host time under the profiler, which about doubles a wall: compare it
with the same reading of another run, not with step_ms.  Nothing to
read from a program without spans.  Moves step_ms."""

UNIT = "ms"
SPAN = "rtt.tangent_pass"


def read(ctx):
    if ctx.loop != "train" or ctx.trace is None:
        return None
    from harness.spans import wall_s

    s = wall_s(ctx.trace, SPAN)
    return None if s is None else s * 1e3
