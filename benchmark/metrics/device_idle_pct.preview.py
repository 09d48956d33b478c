"""The device's idle share of the profiled preview round: 1 - (union of
device activity) / (the round's wall), in %.  Moves pass_ms."""

UNIT = "%"


def read(ctx):
    if ctx.loop != "preview" or ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
