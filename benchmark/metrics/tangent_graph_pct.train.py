"""Share of the fuzz / IR replay's stages that ran from a captured CUDA
graph in the profiled train step: 100 x the ``rtt.tangent_graph`` spans
(render/stage_graphs.py, one a stage replayed from a graph) over those
and the ``rtt.tangent_capture`` spans (one a capture).

Nothing to read from a program that replays no stage from a graph.
Moves step_ms."""

UNIT = "%"
REPLAY = "rtt.tangent_graph"
CAPTURE = "rtt.tangent_capture"


def read(ctx):
    if ctx.loop != "train" or ctx.trace is None:
        return None
    from harness.spans import count

    replays, captures = count(ctx.trace, REPLAY) or 0, count(ctx.trace, CAPTURE) or 0
    if not replays + captures:
        return None
    return 100.0 * replays / (replays + captures)
