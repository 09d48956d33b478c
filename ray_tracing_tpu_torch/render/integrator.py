"""The bounce-loop path integrator, the PyTorch counterpart of
``ray_tracing_tpu/render/integrator.py`` (reference
src/renderer.rs:123-320) in radiance/throughput form::

    radiance  += throughput * (emitted at hits | background at misses)
    throughput *= coef
    ... after max_depth bounces: radiance += throughput * environment

Per-bounce uniforms are keyed by (ray id, global bounce index), never
by a ray's position in the wavefront, so compaction (sorting rays
alive-first and bouncing only the live prefix) gives radiance
bit-identical to the dense loop.
"""

from __future__ import annotations

import torch

from ray_tracing_tpu_torch.models.scene import SceneData
from ray_tracing_tpu_torch.ops.geometry import EPSILON, INF
from ray_tracing_tpu_torch.ops.intersect import intersect_scene
from ray_tracing_tpu_torch.ops.materials import N_SCATTER_U, shade
from ray_tracing_tpu_torch.ops.rng import ray_uniforms


def _bounce(scene: SceneData, key, bounce: int, carry, count_segments: bool = True):
    """One wavefront bounce: intersect, emit/background, scatter.
    carry = (rad, thr, ro, rd, alive, ids, segments)."""
    rad, thr, ro, rd, alive, ids, segments = carry
    if count_segments:
        segments = segments + alive.sum()
    u = ray_uniforms(key, ids, bounce, N_SCATTER_U)
    hit = intersect_scene(scene, ro, rd, EPSILON, INF)
    found = alive & hit.mask
    miss = alive & ~hit.mask

    rad = rad + torch.where(miss[:, None], thr * scene.background[None, :], 0.0)
    em, sc = shade(scene, hit, rd, u)
    rad = rad + torch.where(found[:, None], thr * em, 0.0)
    new_alive = found & sc.scattered
    thr = torch.where(new_alive[:, None], thr * sc.coef, thr)
    ro = torch.where(found[:, None], hit.p, ro)
    rd = torch.where(new_alive[:, None], sc.direction, rd)
    return rad, thr, ro, rd, new_alive, ids, segments


def _initial_carry(ro, rd, ids_base: int):
    n = ro.shape[0]
    dev = ro.device
    return (
        torch.zeros((n, 3), dtype=torch.float32, device=dev),
        torch.ones((n, 3), dtype=torch.float32, device=dev),
        ro,
        rd,
        torch.ones((n,), dtype=torch.bool, device=dev),
        ids_base + torch.arange(n, dtype=torch.int64, device=dev),
        torch.zeros((), dtype=torch.int64, device=dev),
    )


def _finish(scene: SceneData, rad, thr, alive):
    # depth exhausted -> environment (reference renderer.rs:128-130)
    return rad + torch.where(alive[:, None], thr * scene.environment[None, :], 0.0)


def trace(scene: SceneData, ro, rd, key, max_depth: int, *,
          with_stats: bool = False, ids_base: int = 0):
    """Trace a wavefront densely to ``max_depth``; returns (N, 3) linear
    radiance, and with ``with_stats`` also the number of ray segments
    traced (sum over bounces of live rays).  ``ids_base`` offsets the
    per-ray RNG ids, so tiles of one image get globally unique ids."""
    carry = _initial_carry(ro, rd, ids_base)
    for bounce in range(max_depth):
        carry = _bounce(scene, key, bounce, carry, count_segments=with_stats)
    rad, thr, _, _, alive, _, segments = carry
    rad = _finish(scene, rad, thr, alive)
    return (rad, segments) if with_stats else rad


def compact_wavefront(alive, fmats, ivecs):
    """Stable alive-first partition of the wavefront state: returns
    ``(alive_sorted, fmats_sorted, ivecs_sorted)``."""
    order = torch.sort((~alive).to(torch.uint8), stable=True).indices
    return (
        alive[order],
        [f.index_select(0, order) for f in fmats],
        [v.index_select(0, order) for v in ivecs],
    )


def unsort_wavefront(pos, fmats, ivecs):
    """Undo a tracked permutation: ``out[pos[i]] = in[i]``."""
    return (
        [torch.empty_like(f).index_copy_(0, pos, f) for f in fmats],
        [torch.empty_like(v).index_copy_(0, pos, v) for v in ivecs],
    )


def stage_schedule(max_depth: int, stage_bounces: int) -> list:
    """Bounce counts per compaction stage: two ``stage_bounces``-wide
    lead stages, then all remaining bounces as one tail stage (after two
    sorts the wavefront is nearly dead).  The gradient replay must walk
    the same schedule as the forward."""
    sizes = []
    left = max_depth
    while left > 0 and len(sizes) < 2:
        sizes.append(min(stage_bounces, left))
        left -= sizes[-1]
    if left > 0:
        sizes.append(left)
    return sizes


def bounded_bounce_loop(bounces: int, body, carry, alive_of):
    """``body(b, carry)`` for b in range(bounces), stopping once every
    lane is dead (a bounce over an all-dead wavefront is a no-op)."""
    for b in range(bounces):
        if not bool(alive_of(carry).any()):
            break
        carry = body(b, carry)
    return carry


def trace_compacted(scene: SceneData, ro, rd, key, max_depth: int, *,
                    stage_bounces: int = 4, with_stats: bool = False,
                    ids_base: int = 0):
    """Forward trace with staged wavefront compaction.

    Before every stage after the first, the wavefront is sorted
    alive-first (the permutation is tracked by the ray ids) and the
    stage bounces only the live prefix; radiance is unsorted once at the
    end.  Because uniforms are keyed by (ray id, global bounce), the
    result is bit-identical to :func:`trace` with the same key."""
    carry = _initial_carry(ro, rd, ids_base)
    offset = 0
    for stage, bounces in enumerate(stage_schedule(max_depth, stage_bounces)):
        if stage == 0:
            # full-width warm stage (everything is alive anyway)
            for b in range(bounces):
                carry = _bounce(scene, key, b, carry, count_segments=with_stats)
            offset += bounces
            continue
        rad, thr, ro, rd, alive, ids, segments = carry
        alive, (rad, thr, ro, rd), (ids,) = compact_wavefront(alive, [rad, thr, ro, rd], [ids])
        live = int(alive.sum())

        def body(b, c, _offset=offset):
            return _bounce(scene, key, _offset + b, c, count_segments=with_stats)

        out = bounded_bounce_loop(
            bounces, body,
            (rad[:live], thr[:live], ro[:live], rd[:live], alive[:live], ids[:live], segments),
            lambda c: c[4],
        )
        for full, part in zip((rad, thr, ro, rd, alive), out[:5]):
            full[:live] = part
        carry = (rad, thr, ro, rd, alive, ids, out[6])
        offset += bounces

    rad, thr, _, _, alive, ids, segments = carry
    rad = _finish(scene, rad, thr, alive)
    # unsort: sorted position i belongs to ray ids[i] - ids_base
    (rad,), _ = unsort_wavefront(ids - ids_base, [rad], [])
    return (rad, segments) if with_stats else rad
