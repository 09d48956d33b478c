"""Device ms of kernel K6, the cluster sweep (ops/cuda_triangles.py,
csrc/triangles.cu: ``cluster_sweep_kernel``), in the profiled render
pass.  Where the profiler saw fewer launches than the wrapper counted,
the mean of those it saw times the count.  Nothing to read where K6 did
not run.  Moves pass_ms."""

UNIT = "ms"
FAMILY = "K6"  # harness/profile.py:family: kernel names containing cluster_sweep_kernel


def read(ctx):
    if ctx.loop != "render" or ctx.trace is None or not ctx.trace.counted.get(FAMILY):
        return None
    s = ctx.trace.family_s(FAMILY)
    return None if s is None else s * 1e3
