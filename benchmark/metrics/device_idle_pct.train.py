"""The device's idle share of the profiled train step: 1 - (union of
device activity) / (the step's wall), in %.  Moves step_ms."""

UNIT = "%"


def read(ctx):
    if ctx.loop != "train" or ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
