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

STAGE_BOUNCES = 4  # bounces per lead compaction stage


def _bounce(scene: SceneData, key, bounce: int, carry, count_segments: bool = True,
            tape=None):
    """One wavefront bounce: intersect, emit/background, scatter.
    carry = (rad, thr, ro, rd, alive, ids, segments).  ``tape``, when
    given, also takes the bounce's PRB tape rows: it is called as
    ``tape.write(bounce, hit, aux, found, new_alive, thr, rad, ids)``
    with the shading aux, the throughput entering the bounce and the
    radiance after its emission (render/prb_tape.py)."""
    rad, thr, ro, rd, alive, ids, segments = carry
    if count_segments:
        segments = segments + alive.sum()
    u = ray_uniforms(key, ids, bounce, N_SCATTER_U)
    hit = intersect_scene(scene, ro, rd, EPSILON, INF)
    found = alive & hit.mask
    miss = alive & ~hit.mask

    rad = rad + torch.where(miss[:, None], thr * scene.background[None, :], 0.0)
    if tape is None:
        em, sc = shade(scene, hit, rd, u)
    else:
        em, sc, aux = shade(scene, hit, rd, u, with_aux=True)
    rad = rad + torch.where(found[:, None], thr * em, 0.0)
    new_alive = found & sc.scattered
    if tape is not None:
        tape.write(bounce, hit, aux, found, new_alive, thr, rad, ids)
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


def stage_schedule(max_depth: int, stage_bounces: int = STAGE_BOUNCES) -> list:
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


def run_stage(bounce_fn, bounces: int, carry, live: int):
    """Bounce the live prefix ``[:live]`` of an alive-first wavefront for
    one stage and write it back into the full-width state.

    ``carry`` holds per-ray tensors (leading dim n) with ``alive`` at
    index 4, and 0-d tensors, which pass through whole;
    ``bounce_fn(b, part)`` bounces the prefix at the stage's bounce b.
    Returns the updated carry."""
    part = tuple(x[:live] if x.dim() else x for x in carry)
    out = bounded_bounce_loop(bounces, bounce_fn, part, lambda c: c[4])
    for full, before, after in zip(carry, part, out):
        if full.dim() and after is not before:
            full[:live] = after
    return tuple(full if full.dim() else after for full, after in zip(carry, out))


def trace_stages(scene: SceneData, key, max_depth: int, carry, *, count_segments: bool,
                 tape=None):
    """Bounce ``carry`` through :func:`stage_schedule` with wavefront
    compaction, the one stage walker of every compacted trace.

    The first stage runs full width (everything is alive anyway).  Before
    every later stage the wavefront is sorted alive-first and the stage
    bounces only the live prefix.  Returns ``(carry, pos)``, with
    ``pos`` each sorted ray's input position.  ``tape``, when given, is
    told each stage's layout as ``tape.start_stage(pos, live)`` and
    takes every bounce's rows (see :func:`_bounce`)."""
    n = carry[0].shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=carry[0].device)
    offset = 0
    for stage, bounces in enumerate(stage_schedule(max_depth)):

        def body(b, c, _offset=offset):
            return _bounce(scene, key, _offset + b, c, count_segments, tape)

        if stage == 0:
            if tape is not None:
                tape.start_stage(pos, n)
            for b in range(bounces):
                carry = body(b, carry)
        else:
            rad, thr, ro, rd, alive, ids, segments = carry
            alive, (rad, thr, ro, rd), (ids, pos) = compact_wavefront(
                alive, [rad, thr, ro, rd], [ids, pos]
            )
            live = int(alive.sum())
            if tape is not None:
                tape.start_stage(pos, live)
            carry = run_stage(body, bounces, (rad, thr, ro, rd, alive, ids, segments), live)
        offset += bounces
    return carry, pos


def trace_subset_dot(scene: SceneData, ro, rd, key, max_depth: int, g, alive0, ids0):
    """``vdot(g, radiance)`` of a gathered ray subset, compacted.

    The scalar-tangent pass (render/prb_scalar.py) needs the tangent of
    this one scalar only, so this is the minimal compacted trace
    (:func:`trace_stages`), with uniforms keyed by the absolute ``ids0``
    so the gathered subset replays its paths bit-exactly.  Rays with
    ``alive0`` unset accumulate nothing.  The final dot
    gathers ``g`` by each ray's tracked input position.  Every operation
    takes forward-mode tangents (``torch.autograd.forward_ad``)."""
    rad, thr, ro, rd, _, _, segments = _initial_carry(ro, rd, 0)
    carry = (rad, thr, ro, rd, alive0, ids0.to(torch.int64), segments)
    (rad, thr, _, _, alive, _, _), pos = trace_stages(
        scene, key, max_depth, carry, count_segments=False
    )
    rad = _finish(scene, rad, thr, alive)
    return (g[pos] * rad).sum()


def trace_compacted(scene: SceneData, ro, rd, key, max_depth: int, *,
                    with_stats: bool = False, ids_base: int = 0, tape=None):
    """Forward trace with staged wavefront compaction (:func:`trace_stages`);
    radiance is unsorted once at the end.  Because uniforms are keyed by
    (ray id, global bounce), the result is bit-identical to :func:`trace`
    with the same key.  ``tape`` is render/prb_tape.py's tape writer."""
    carry, pos = trace_stages(scene, key, max_depth, _initial_carry(ro, rd, ids_base),
                              count_segments=with_stats, tape=tape)
    rad, thr, _, _, alive, _, segments = carry
    rad = _finish(scene, rad, thr, alive)
    (rad,), _ = unsort_wavefront(pos, [rad], [])
    return (rad, segments) if with_stats else rad
