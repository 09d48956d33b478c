"""Kernel K1's share of its roofline in the profiled preview round, in
%: the least time the card could take for the round's phase-A work over
K1's device time.

The bound is the loop's reading (loops/preview.py: harness/roofline.py's
phase_a_bound of the pass's own work): the rays phase A tested are the
segments of the same pass traced again on the session's renderer
(counted untimed), and the packed tables, read once per launch, are the
reference's compile of the preview of the round's scene (the
configuration's scene under the run's edits).  At 485 spheres the bound
is the operations; the run's notes name it.  Device time is the
profiler's for the phase_a_kernel<false, false, false> launches; where
it saw fewer than the wrapper counted, their mean times the count.
Moves pass_ms."""

UNIT = "%"
FAMILY = "K1"  # harness/profile.py:family: phase_a_kernel with no transform or motion


def read(ctx):
    if ctx.loop != "preview" or ctx.trace is None or not ctx.trace.counted.get(FAMILY):
        return None
    device_s = ctx.trace.family_s(FAMILY)
    if not device_s:
        return None
    return 100.0 * ctx.readings["k1_bound_ms"] * 1e-3 / device_s
