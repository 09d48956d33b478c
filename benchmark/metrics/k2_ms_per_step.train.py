"""Device ms of kernel K2, the tape sweep's scatter (ops/cuda_scatter.py,
csrc/scatter.cu: ``scatter_add_place_kernel`` and
``scatter_add_sum_kernel``), in the profiled train step.  Where the
profiler saw fewer launches than the wrapper counted, the mean of those
it saw times the count.  Moves step_ms."""

UNIT = "ms"
FAMILY = "K2"  # harness/profile.py:family


def read(ctx):
    if ctx.loop != "train" or ctx.trace is None or not ctx.trace.counted.get(FAMILY):
        return None
    s = ctx.trace.family_s(FAMILY)
    return None if s is None else s * 1e3
