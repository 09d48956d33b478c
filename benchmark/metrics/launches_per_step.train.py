"""Device kernels launched in the profiled train step (copies and fills
left out): the host's dispatch of the bounce loop (render/integrator.py,
render/prb_tape.py, render/prb_scalar.py under parallel/mesh.py).
Moves step_ms."""

UNIT = "launches"


def read(ctx):
    if ctx.loop != "train" or ctx.trace is None:
        return None
    return ctx.trace.kernel_launches()
