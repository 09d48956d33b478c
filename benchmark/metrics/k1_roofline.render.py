"""Kernel K1's share of its roofline in the profiled render pass, in %:
the least time the card could take for the pass's phase-A work over
K1's device time.

The work is the pass's own, not K1's arguments: the rays phase A tested
are the segments traced at the pass's key (counted untimed on the same
code path), and the scene's packed tables are read once per launch
(tile-bounce), by harness/roofline.py (chip_smoke.py's arithmetic).  The
tables come from the reference's compile of the configuration.  Device
time is the profiler's for the phase_a_kernel<false, false, false>
launches; where it saw fewer than the wrapper counted, their mean times
the count.  Moves pass_ms."""

UNIT = "%"
FAMILY = "K1"  # harness/profile.py:family: phase_a_kernel with no transform or motion


def read(ctx):
    if ctx.loop != "render" or ctx.trace is None or not ctx.trace.counted.get(FAMILY):
        return None
    from harness.roofline import phase_a_bound
    from reference.render import compile_scene

    device_s = ctx.trace.family_s(FAMILY)
    if not device_s:
        return None
    scene = compile_scene(ctx.cell.scene, ctx.cell.data_dir, "cpu")[0]
    bound_ms, _ = phase_a_bound(scene.phase_a, ctx.readings["segments"],
                                ctx.readings["k1_launches"])
    return 100.0 * bound_ms * 1e-3 / device_s
