"""The least time an NVIDIA H100 could take for a piece of work, and the
work of phase A, copied from chip_smoke.py's ``bound`` and
``phase_a_bound`` so that every later implementation of a kernel is
judged by the same arithmetic.

Peaks: NVIDIA's data sheet of the H100 SXM at its 700 W limit, float32
outside the tensor cores and HBM3."""

from __future__ import annotations

PEAK_FLOPS = 67e12  # float32, FLOP/s
PEAK_BYTES = 3.35e12  # bytes/s
SPHERE_FLOPS = 20  # oc, half_b, c, disc, sqrt, two roots
RECT_FLOPS = 36  # plane t, then both in-plane coordinates
TF_FLOPS = 45  # an object ray: inv ro + inv_t, inv rd, its norm, the division
MOTION_FLOPS = 6  # c + t_ray v
RAY_BYTES = 36  # a ray in (24 B), its winner out (t, kind, row: 12 B)
T_RAY_BYTES = 4  # a moving table's shutter time in
META_COLS = 2  # [slot, row] as int32 bits after a phase-A table row


def bound(flops: float, nbytes: float):
    """(bound ms, "operations" or "bytes"): the larger of ``flops`` over the
    float32 peak and ``nbytes`` over the memory rate."""
    f_ms, b_ms = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")


def phase_a_work(tables, rays: int, launches: int = 1):
    """(operations, bytes) of ``launches`` phase-A launches that test
    ``rays`` rays in all against the packed tables ``tables`` (rows
    [base | slot | row]): per ray every sphere and rect test, a moving
    sphere's centre and one object ray per distinct transform of each
    transformed table; per ray its 36 bytes (40 with a shutter time); per
    launch the tables once."""
    import torch

    def transforms(rows, tf):
        if not tf or not rows.shape[0]:
            return 0
        slot = rows[:, rows.shape[1] - META_COLS].contiguous().view(torch.int32)
        return int(torch.unique(slot).numel())

    motion = bool(tables.sph_motion)
    per_ray = (tables.sph.shape[0] * (SPHERE_FLOPS + (MOTION_FLOPS if motion else 0))
               + tables.rect.shape[0] * RECT_FLOPS
               + TF_FLOPS * (transforms(tables.sph, tables.sph_tf)
                             + transforms(tables.rect, tables.rect_tf)))
    table_bytes = 4 * (tables.sph.numel() + tables.rect.numel() + tables.slots.numel())
    return rays * per_ray, rays * (RAY_BYTES + (T_RAY_BYTES if motion else 0)) \
        + launches * table_bytes


def phase_a_bound(tables, rays: int, launches: int = 1):
    """bound() of :func:`phase_a_work`."""
    return bound(*phase_a_work(tables, rays, launches))
