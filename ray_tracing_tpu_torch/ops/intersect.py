"""Scene-wide nearest-hit intersection, the PyTorch counterpart of
``ray_tracing_tpu/ops/intersect.py`` for spheres and axis-aligned rects
(reference src/renderer.rs:131-183).

Two phases:

* **Phase A** finds each ray's nearest primitive: (t, kind, index).  It
  is selection only, runs on detached tensors, and is kernel K1
  (ops/cuda_intersect.py) on a CUDA tensor; its plain version there is
  built from the candidate grids below.
* **Phase B** gathers the one winning primitive per ray and re-runs
  the same hit math to build the full record (p, normal, uv,
  front_face).
"""

from __future__ import annotations

import dataclasses

import torch

from ray_tracing_tpu_torch.models.scene import SceneData
from ray_tracing_tpu_torch.ops import geometry as geo

INF = geo.INF

# primitive kind tags; the order is the tie-break order (the reference
# breaks ties by global shape index, which grouping by type cannot
# reproduce; ties only occur on coincident surfaces)
KIND_NONE = -1
KIND_SPHERE = 0
KIND_TRIANGLE = 1
KIND_RECT = 2
KIND_MEDIUM = 3


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


def _sphere_phase_a(sph, ro, rd, t_min, t_max):
    """(N, S) candidate grid of (t, mask) against a packed (S, 4) sphere
    table [cx cy cz r]."""
    return geo.sphere_t(ro[:, None, :], rd[:, None, :], sph[:, 0:3], sph[:, 3], t_min, t_max)


def _rect_phase_a(rect, ro, rd, t_min, t_max):
    """(N, R) candidate grid of (t, mask) against a packed (R, 14) rect
    table [ua ub uk a0 a1 b0 b1 k]."""
    t, mask, _, _ = geo.rect_t(
        ro[:, None, :], rd[:, None, :],
        rect[:, 0:3], rect[:, 3:6], rect[:, 6:9],
        rect[:, 9], rect[:, 10], rect[:, 11], rect[:, 12], rect[:, 13],
        t_min, t_max,
    )
    return t, mask


def _sphere_phase_b(scene: SceneData, ro, rd, t_min, t_max, idx):
    """Full record for one gathered sphere per ray; idx: (N,)."""
    sp = scene.spheres
    center = sp.center[idx]
    radius = sp.radius[idx]
    root1, root2, disc_ok = geo.sphere_roots(ro, rd, center, radius)
    mask1 = disc_ok & (root1 >= t_min) & (root1 <= t_max)
    t = torch.where(mask1, root1, root2)
    p = ro + rd * t[..., None]
    outward = geo.normalize(p - center)
    front_face, normal = geo.face_normal(rd, outward)
    return p, normal, geo.sphere_uv(outward), front_face


def _rect_phase_b(scene: SceneData, ro, rd, t_min, t_max, idx):
    rc = scene.rects
    axis = rc.axis[idx]
    a0, a1, b0, b1, k = rc.a0[idx], rc.a1[idx], rc.b0[idx], rc.b1[idx], rc.k[idx]
    ua, ub, uk = geo.rect_basis(axis)
    t, _, a, b = geo.rect_t(ro, rd, ua, ub, uk, a0, a1, b0, b1, k, t_min, t_max)
    uv = torch.stack([(a - a0) / (a1 - a0), (b - b0) / (b1 - b0)], dim=-1)
    front_face, normal = geo.face_normal(rd, geo.rect_normal(axis, rc.positive[idx]))
    p = ro + rd * t[..., None]
    return p, normal, uv, front_face


def intersect_scene(scene: SceneData, ro, rd, t_min: float, t_max: float) -> Hit:
    """Nearest hit of each ray (ro, rd: (N, 3)) against the whole scene."""
    from ray_tracing_tpu_torch.ops.cuda_intersect import pack_primitive_tables, phase_a

    if scene.n_triangles or scene.n_medium:
        raise NotImplementedError("triangles and media are not ported yet, see ROADMAP")
    n = ro.shape[0]
    sph, rect = pack_primitive_tables(scene)
    best_t, best_kind, best_idx = phase_a(
        sph, rect, ro.detach().contiguous(), rd.detach().contiguous(), t_min, t_max
    )
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
    if scene.n_spheres:
        idx = best_idx.clamp(max=scene.n_spheres - 1)
        merge(KIND_SPHERE, _sphere_phase_b(scene, ro, rd, t_min, t_max, idx),
              scene.spheres.material[idx])
    if scene.n_rects:
        idx = best_idx.clamp(max=scene.n_rects - 1)
        merge(KIND_RECT, _rect_phase_b(scene, ro, rd, t_min, t_max, idx),
              scene.rects.material[idx])

    return Hit(
        p=p, normal=normal, t=best_t, uv=uv, front_face=front_face, mask=mask,
        material=material, kind=best_kind, index=best_idx.to(torch.int32),
    )
