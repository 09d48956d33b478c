"""Scene-wide nearest-hit intersection, the PyTorch counterpart of
``ray_tracing_tpu/ops/intersect.py`` for spheres, axis-aligned rects,
triangles and constant media, with instancing transforms (reference
src/renderer.rs:131-183).

Two phases:

* **Phase A** finds each ray's nearest primitive: (t, kind, index).  It
  is selection only.  Spheres and rects go first, through kernel K1 or,
  when a table carries transforms, K3, or with moving spheres K4
  (ops/cuda_intersect.py); then triangles, through the dense sweep K5
  or, for a mesh above ``SWEEP_MAX_TRIS`` triangles, the cluster sweep
  K6 (ops/cuda_triangles.py); then constant media, in plain PyTorch.
  This is the TPU's order; on the CPU the plain versions run in the
  same order.  A later kind wins only with a strictly smaller t.
* **Phase B** gathers the one winning primitive per ray and re-runs
  the same hit math to build the full record (p, normal, uv,
  front_face).

Medium primitives draw their free-flight uniform from ``med_u`` (one
column per medium), so phase B reproduces phase A's stochastic t.
Moving spheres are tested at each ray's shutter time ``t_ray``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ray_tracing_tpu_torch.models.scene import SceneData
from ray_tracing_tpu_torch.ops import cuda_triangles
from ray_tracing_tpu_torch.ops import geometry as geo

INF = geo.INF

# primitive kind tags; the order is the tie-break order (the reference
# breaks ties by global shape index, which grouping by type cannot
# reproduce; ties only occur on coincident surfaces)
KIND_NONE = -1
KIND_SPHERE = 0
KIND_TRIANGLE = 1
KIND_RECT = 2
KIND_MEDIUM = 3  # index = medium id

# Meshes up to this many triangles take the dense sweep (K5); larger ones
# take the two-level cluster sweep (K6).
SWEEP_MAX_TRIS = 32768


@dataclasses.dataclass
class Hit:
    """Batched hit record (reference src/hittable/mod.rs:24-32)."""

    p: torch.Tensor  # (N, 3)
    normal: torch.Tensor  # (N, 3) unit, flipped toward the ray
    t: torch.Tensor  # (N,)
    uv: torch.Tensor  # (N, 2)
    front_face: torch.Tensor  # (N,) bool
    mask: torch.Tensor  # (N,) bool, whether anything was hit
    material: torch.Tensor  # (N,) i32 material id of the winner
    kind: torch.Tensor  # (N,) i32 KIND_* of the winner
    index: torch.Tensor  # (N,) i32 index within the winner's type table


def _gathered_object_ray(scene: SceneData, slots, ro, rd, t_min, t_max):
    """One transform slot per ray: (ro_obj, rd_obj, t_min_obj, t_max_obj,
    fwd, fwd_t)."""
    tf = scene.transforms
    ro_o, rd_o, nrm = geo.transform_ray(tf.inv[slots], tf.inv_t[slots], ro, rd)
    return ro_o, rd_o, t_min * nrm, t_max * nrm, tf.fwd[slots], tf.fwd_t[slots]


def _sphere_phase_b(scene: SceneData, ro, rd, t_min, t_max, idx, t_ray=None):
    """Full record for one gathered sphere per ray; idx: (N,)."""
    sp = scene.spheres
    center = sp.center[idx]
    if sp.has_motion and t_ray is not None:
        center = center + t_ray[:, None] * sp.vel[idx]
    radius = sp.radius[idx]
    if sp.has_transforms:
        ro_o, rd_o, lo, hi, fwd, fwd_t = _gathered_object_ray(
            scene, sp.transform[idx].long(), ro, rd, t_min, t_max)
    else:
        ro_o, rd_o, lo, hi = ro, rd, t_min, t_max
    root1, root2, disc_ok = geo.sphere_roots(ro_o, rd_o, center, radius)
    mask1 = disc_ok & (root1 >= lo) & (root1 <= hi)
    t = torch.where(mask1, root1, root2)
    p = ro_o + rd_o * t[..., None]
    outward = geo.normalize(p - center)
    front_face, normal = geo.face_normal(rd_o, outward)
    uv = geo.sphere_uv(outward)
    if sp.has_transforms:
        p = geo.transform_point(fwd, fwd_t, p)
        normal = geo.normalize(geo.transform_dir(fwd, normal))
    return p, normal, uv, front_face


def _rect_phase_b(scene: SceneData, ro, rd, t_min, t_max, idx):
    rc = scene.rects
    axis = rc.axis[idx]
    a0, a1, b0, b1, k = rc.a0[idx], rc.a1[idx], rc.b0[idx], rc.b1[idx], rc.k[idx]
    if rc.has_transforms:
        ro_o, rd_o, lo, hi, fwd, fwd_t = _gathered_object_ray(
            scene, rc.transform[idx].long(), ro, rd, t_min, t_max)
    else:
        ro_o, rd_o, lo, hi = ro, rd, t_min, t_max
    ua, ub, uk = geo.rect_basis(axis)
    t, _, a, b = geo.rect_t(ro_o, rd_o, ua, ub, uk, a0, a1, b0, b1, k, lo, hi)
    uv = torch.stack([(a - a0) / (a1 - a0), (b - b0) / (b1 - b0)], dim=-1)
    front_face, normal = geo.face_normal(rd_o, geo.rect_normal(axis, rc.positive[idx]))
    p = ro_o + rd_o * t[..., None]
    if rc.has_transforms:
        p = geo.transform_point(fwd, fwd_t, p)
        normal = geo.normalize(geo.transform_dir(fwd, normal))
    return p, normal, uv, front_face


def _triangle_phase_b(scene: SceneData, ro, rd, t_min, t_max, idx):
    """Full record for one gathered triangle per ray: Moeller-Trumbore
    again, interpolated shading normal and uv; the front face is the
    winding, not the view (reference triangle.rs:92)."""
    tr = scene.triangles
    t, _, u, v, det = geo.triangle_t(ro, rd, tr.v0[idx], tr.e12[idx], tr.e13[idx], t_min, t_max)
    w = (1.0 - u - v)[..., None]
    u, v = u[..., None], v[..., None]
    p = ro + rd * t[..., None]
    normal = geo.normalize(tr.n0[idx] * w + tr.n1[idx] * u + tr.n2[idx] * v)
    uv = tr.uv0[idx] * w + tr.uv1[idx] * u + tr.uv2[idx] * v
    return p, normal, uv, det > 0.0


def mesh_strategy(scene: SceneData) -> str:
    """The triangle strategy, as the JAX package chooses it: "none"
    without triangles, "sweep" (the dense sweep, K5) for a table with
    sweep constants of at most ``SWEEP_MAX_TRIS`` triangles, "cluster"
    (the cluster sweep, K6) for a larger table with cluster tables.
    Anything else would need the BVH walk, which is not ported: that
    raises, and no sweep runs in its place."""
    if scene.n_triangles == 0:
        return "none"
    if scene.triangles.has_sweep and scene.n_triangles <= SWEEP_MAX_TRIS:
        return "sweep"
    if scene.triangles.has_clusters:
        return "cluster"
    raise NotImplementedError(
        f"a mesh of {scene.n_triangles} triangles "
        f"({'with' if scene.triangles.has_sweep else 'without'} sweep constants, without "
        "cluster tables) needs the BVH walk, which is not ported yet, see ROADMAP"
    )


def _boundary_nearest(bd, ro, rd, t_lo, t_hi):
    """Nearest hit of rays against one medium's boundary group (reference
    HittableGroup closest-hit fold, group.rs:58-67).  ``t_lo`` is a float
    or a per-ray (N,) tensor.  Returns (t (N,), found (N,))."""
    n = ro.shape[0]
    best_t = torch.full((n,), INF, dtype=torch.float32, device=ro.device)
    found = torch.zeros((n,), dtype=torch.bool, device=ro.device)
    lo = torch.broadcast_to(torch.as_tensor(t_lo, dtype=torch.float32, device=ro.device),
                            (n,))[:, None]

    def fold(t_grid, mask_grid):
        nonlocal best_t, found
        t_best = torch.where(mask_grid, t_grid, INF).amin(dim=1)
        best_t = torch.where(t_best < best_t, t_best, best_t)
        found = found | mask_grid.any(dim=1)

    ro_n, rd_n = ro[:, None, :], rd[:, None, :]
    if bd.n_sph:
        root1, root2, disc_ok = geo.sphere_roots(ro_n, rd_n, bd.sph_center, bd.sph_radius)
        mask1 = disc_ok & (root1 >= lo) & (root1 <= t_hi)
        mask2 = disc_ok & (root2 >= lo) & (root2 <= t_hi)
        fold(torch.where(mask1, root1, root2), mask1 | mask2)
    if bd.n_rect:
        ua, ub, uk = geo.rect_basis(bd.rect_axis)
        t, mask, _, _ = geo.rect_t(ro_n, rd_n, ua, ub, uk, bd.rect_a0, bd.rect_a1,
                                   bd.rect_b0, bd.rect_b1, bd.rect_k, lo, t_hi)
        fold(t, mask)
    if bd.n_tri:
        t, mask, _, _, _ = geo.triangle_t(ro_n, rd_n, bd.tri_v0, bd.tri_e12, bd.tri_e13,
                                          lo, t_hi)
        fold(t, mask)
    return best_t, found


def _medium_phase_a(scene: SceneData, ro, rd, t_min, t_max, med_u):
    """Free-flight candidate t per constant medium, the double hit of
    reference constant_medium.rs:41-75: first boundary hit over
    (-inf, inf), second over (t1 + EPSILON, inf), an exponential flight
    between them.  Returns (t (N, M), mask (N, M)); column m consumes
    ``med_u[:, m]``."""
    md = scene.media
    ts, masks = [], []
    for m, bd in enumerate(md.boundaries):
        slot = md.transform[m]
        if slot:
            tf = scene.transforms
            ro_o, rd_o, nrm = geo.transform_ray(tf.inv[slot], tf.inv_t[slot], ro, rd)
            t_min_o, t_max_o = t_min * nrm, t_max * nrm
        else:
            ro_o, rd_o, nrm = ro, rd, None
            t_min_o, t_max_o = t_min, t_max
        t1, m1 = _boundary_nearest(bd, ro_o, rd_o, -INF, INF)
        t2, m2 = _boundary_nearest(bd, ro_o, rd_o, t1 + geo.EPSILON, INF)
        lo = torch.maximum(t1, torch.as_tensor(t_min_o, dtype=torch.float32))
        hi = torch.minimum(t2, torch.as_tensor(t_max_o, dtype=torch.float32))
        mask = m1 & m2 & (lo < hi)
        lo = torch.clamp_min(lo, 0.0)
        flight = md.niv[m] * torch.log(torch.clamp_min(med_u[:, m], 1e-38))
        mask = mask & (flight <= hi - lo)
        # reference quirk kept (constant_medium.rs:67-75): the flight runs
        # from the clamped window but t is measured from the raw t1
        t = t1 + flight
        ts.append(t if nrm is None else t / nrm)
        masks.append(mask)
    return torch.stack(ts, dim=1), torch.stack(masks, dim=1)


def intersect_scene(scene: SceneData, ro, rd, t_min: float, t_max: float, med_u=None,
                    t_ray=None) -> Hit:
    """Nearest hit of each ray (ro, rd: (N, 3)) against the whole scene;
    ``med_u`` (N, n_medium) uniforms for the constant media's free
    flights (None when the scene has none); ``t_ray`` (N,) shutter times
    for moving spheres (None for a scene without them)."""
    from ray_tracing_tpu_torch.ops.cuda_intersect import phase_a

    if scene.phase_a is None:
        raise ValueError("the scene has no phase-A tables: build it with SceneBuilder or "
                         "scene_from_numpy, or attach them with models.scene.with_phase_a_tables")
    n = ro.shape[0]
    ro_d, rd_d = ro.detach().contiguous(), rd.detach().contiguous()
    if not scene.has_motion:
        t_ray = None
    elif t_ray is not None:
        t_ray = t_ray.detach().contiguous()
    best_t, best_kind, best_idx = phase_a(scene.phase_a, ro_d, rd_d, t_min, t_max, t_ray)

    def consider_per_ray(t, idx, found, kind):
        nonlocal best_t, best_kind, best_idx
        better = found & (t < best_t)
        best_t = torch.where(better, t, best_t)
        best_kind = torch.where(better, kind, best_kind)
        best_idx = torch.where(better, idx, best_idx)

    strategy = mesh_strategy(scene)
    tr = scene.triangles
    if strategy == "sweep":
        consider_per_ray(*cuda_triangles.triangle_sweep(tr, ro_d, rd_d, t_min, t_max),
                         KIND_TRIANGLE)
    elif strategy == "cluster":
        consider_per_ray(*cuda_triangles.cluster_sweep(tr, ro_d, rd_d, t_min, t_max),
                         KIND_TRIANGLE)
    if scene.n_medium:
        t, mask = _medium_phase_a(scene, ro, rd, t_min, t_max, med_u)
        t = torch.where(mask, t, INF)
        idx = torch.argmin(t, dim=1)
        t = torch.gather(t, 1, idx[:, None])[:, 0]
        consider_per_ray(t, idx.to(torch.int32), t < INF, KIND_MEDIUM)

    best_idx = best_idx.long()
    mask = best_kind != KIND_NONE

    p = torch.zeros_like(ro)
    normal = torch.zeros_like(ro)
    normal[:, 1] = 1.0
    uv = torch.zeros((n, 2), dtype=torch.float32, device=ro.device)
    front_face = torch.zeros((n,), dtype=torch.bool, device=ro.device)
    material = torch.zeros((n,), dtype=torch.int32, device=ro.device)

    def merge(kind, rec, mat_ids):
        nonlocal p, normal, uv, front_face, material
        sel = best_kind == kind
        bp, bn, buv, bf = rec
        p = torch.where(sel[:, None], bp, p)
        normal = torch.where(sel[:, None], bn, normal)
        uv = torch.where(sel[:, None], buv, uv)
        front_face = torch.where(sel, bf, front_face)
        material = torch.where(sel, mat_ids, material)

    # phase B on each kind's table; lanes of another kind gather row
    # ``best_idx`` clamped into this table and are discarded by merge
    for kind, count, phase_b, table in (
        (KIND_SPHERE, scene.n_spheres, functools.partial(_sphere_phase_b, t_ray=t_ray),
         scene.spheres),
        (KIND_TRIANGLE, scene.n_triangles, _triangle_phase_b, scene.triangles),
        (KIND_RECT, scene.n_rects, _rect_phase_b, scene.rects),
    ):
        if count:
            idx = best_idx.clamp(max=count - 1)
            merge(kind, phase_b(scene, ro, rd, t_min, t_max, idx), table.material[idx])
    if scene.n_medium:
        # reference constant_medium.rs:77-84: fixed +x normal, front face
        # true, uv zero; p from the world-space ray at phase A's t, which
        # on these lanes is the free flight's (it carries the tangent of
        # the undetached ray); the other lanes' t (INF on a miss) is
        # replaced before the product, so reverse-mode AD sees no 0 * inf
        idx = best_idx.clamp(max=scene.n_medium - 1)
        med_n = torch.zeros_like(ro)
        med_n[:, 0] = 1.0
        med_t = torch.where(best_kind == KIND_MEDIUM, best_t, 0.0)
        merge(KIND_MEDIUM,
              (ro + rd * med_t[:, None], med_n, torch.zeros_like(uv),
               torch.ones_like(front_face)),
              scene.media.material[idx])

    return Hit(
        p=p, normal=normal, t=best_t, uv=uv, front_face=front_face, mask=mask,
        material=material, kind=best_kind, index=best_idx.to(torch.int32),
    )
