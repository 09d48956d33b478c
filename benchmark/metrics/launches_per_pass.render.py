"""Device kernels launched in the profiled render pass (copies and fills
left out): the host's dispatch of the bounce loop
(render/renderer.py -> render/integrator.py).  Moves pass_ms."""

UNIT = "launches"


def read(ctx):
    if ctx.loop != "render" or ctx.trace is None:
        return None
    return ctx.trace.kernel_launches()
