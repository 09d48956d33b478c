"""Scene-wide nearest-hit intersection of the benchmark's plain
reference: spheres, axis-aligned rects and triangles.

Phase A tests every ray against every primitive of the scene's own
tables (the sphere and rect tables, and the triangle table by
Moeller-Trumbore over the chunks of consecutive triangles whose box the
ray meets), with no kernel and no packed table: spheres first, then rects, then triangles, a
later kind winning only with a strictly smaller t, and within a kind the
lowest row on equal t.  Phase B is the port's plain record rebuild as it
stood when the benchmark was written.  Transforms, moving spheres and
constant media are not needed by the benchmark's scenes and are refused.
"""

from __future__ import annotations

import dataclasses

import torch

from .scene import SceneData
from . import geometry as geo

INF = geo.INF

# primitive kind tags; the order is the tie-break order (the reference
# breaks ties by global shape index, which grouping by type cannot
# reproduce; ties only occur on coincident surfaces)
KIND_NONE = -1
KIND_SPHERE = 0
KIND_TRIANGLE = 1
KIND_RECT = 2
KIND_MEDIUM = 3  # index = medium id

CHUNK = 128  # consecutive triangles of the table under one box
PAIR_BATCH = 1 << 15  # (ray, box) pairs tested against their triangles at once


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

def _chunks(tr):
    """The triangle table in chunks of ``CHUNK`` consecutive rows, padded
    with degenerate triangles, and each chunk's box of its vertices grown
    by a slack: ((K, CHUNK, 3) v0, e12, e13, (K, 3) lo, hi)."""
    n = tr.v0.shape[0]
    k = -(-n // CHUNK)
    pad = k * CHUNK - n

    def chunked(x, fill):
        x = torch.cat([x, torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)])
        return x.reshape(k, CHUNK, *x.shape[1:])

    verts = torch.stack([tr.v0, tr.v0 + tr.e12, tr.v0 + tr.e13], dim=1)  # (T, 3, 3)
    lo = chunked(verts.amin(dim=1), INF).amin(dim=1)
    hi = chunked(verts.amax(dim=1), -INF).amax(dim=1)
    slack = 1e-4 * float(torch.clamp_min((hi - lo).abs().amax(), 1.0))
    return (chunked(tr.v0, 0.0), chunked(tr.e12, 0.0), chunked(tr.e13, 0.0), lo - slack,
            hi + slack)


def _triangle_phase_a(tr, ro, rd, t_min: float, t_max: float):
    """Nearest triangle per ray by Moeller-Trumbore against every triangle
    of each chunk whose box the ray meets (a box test only skips chunks
    the ray cannot hit): (t (N,) f32, idx (N,) i32, found (N,) bool), the
    least t, then the lowest index."""
    n = ro.shape[0]
    v0, e12, e13, lo, hi = _chunks(tr)
    inv = 1.0 / torch.where(rd == 0.0, torch.full_like(rd, 1e-30), rd)
    t0 = (lo[None] - ro[:, None]) * inv[:, None]
    t1 = (hi[None] - ro[:, None]) * inv[:, None]
    near = torch.clamp_min(torch.minimum(t0, t1).amax(dim=-1), t_min)
    far = torch.clamp_max(torch.maximum(t0, t1).amin(dim=-1), t_max)
    ray, box = torch.nonzero(near <= far, as_tuple=True)
    del t0, t1, near, far
    pair_t, pair_idx = [], []
    for s in range(0, ray.shape[0], PAIR_BATCH):
        r, b = ray[s:s + PAIR_BATCH], box[s:s + PAIR_BATCH]
        t, mask, _, _, _ = geo.triangle_t(ro[r][:, None], rd[r][:, None], v0[b], e12[b], e13[b],
                                          t_min, t_max)
        t = torch.where(mask, t, INF)
        col = torch.argmin(t, dim=1)
        pair_t.append(torch.gather(t, 1, col[:, None])[:, 0])
        pair_idx.append(b * CHUNK + col)
    best_t = torch.full((n,), INF, dtype=torch.float32, device=ro.device)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=ro.device)
    if not pair_t:
        return best_t, best_idx, best_t < INF
    pair_t, pair_idx = torch.cat(pair_t), torch.cat(pair_idx)
    best_t = best_t.scatter_reduce(0, ray, pair_t, "amin")
    big = torch.iinfo(torch.int64).max
    first = torch.full((n,), big, dtype=torch.int64, device=ro.device).scatter_reduce(
        0, ray, torch.where(pair_t == best_t[ray], pair_idx, big), "amin")
    found = best_t < INF
    best_idx = torch.where(found, first, 0).to(torch.int32)
    return best_t, best_idx, found


def _nearest_of_grid(t, mask):
    """Least t per ray of an (N, P) candidate grid and the lowest column
    holding it: (t (N,), idx (N,) i32, found (N,))."""
    t = torch.where(mask, t, INF)
    t_best = t.amin(dim=1)
    cols = torch.arange(t.shape[1], dtype=torch.int32, device=t.device)
    idx = torch.where(t == t_best[:, None], cols, torch.iinfo(torch.int32).max).amin(dim=1)
    return t_best, idx, t_best < INF


def _phase_a(scene: SceneData, ro, rd, t_min: float, t_max: float):
    """(t, kind, idx) of the nearest primitive per ray over the scene's own
    sphere, rect and triangle tables."""
    n = ro.shape[0]
    best_t = torch.full((n,), INF, dtype=torch.float32, device=ro.device)
    best_kind = torch.full((n,), KIND_NONE, dtype=torch.int32, device=ro.device)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=ro.device)

    def consider(t, idx, found, kind):
        nonlocal best_t, best_kind, best_idx
        better = found & (t < best_t)
        best_t = torch.where(better, t, best_t)
        best_kind = torch.where(better, kind, best_kind)
        best_idx = torch.where(better, idx, best_idx)

    ro_n, rd_n = ro[:, None, :], rd[:, None, :]
    if scene.n_spheres:
        sp = scene.spheres
        consider(*_nearest_of_grid(*geo.sphere_t(ro_n, rd_n, sp.center, sp.radius,
                                                 t_min, t_max)), KIND_SPHERE)
    if scene.n_rects:
        rc = scene.rects
        ua, ub, uk = geo.rect_basis(rc.axis)
        t, mask, _, _ = geo.rect_t(ro_n, rd_n, ua, ub, uk, rc.a0, rc.a1, rc.b0, rc.b1, rc.k,
                                   t_min, t_max)
        consider(*_nearest_of_grid(t, mask), KIND_RECT)
    if scene.n_triangles:
        consider(*_triangle_phase_a(scene.triangles, ro, rd, t_min, t_max), KIND_TRIANGLE)
    return best_t, best_kind, best_idx


def intersect_scene(scene: SceneData, ro, rd, t_min: float, t_max: float, med_u=None,
                    t_ray=None) -> Hit:
    """Nearest hit of each ray (ro, rd: (N, 3)) against the whole scene.
    Phase A selects on detached rays; phase B rebuilds the record of the
    winner on the rays as given, so reverse-mode autograd reaches every
    parameter the record and the shading read."""
    if scene.n_medium or scene.has_motion or scene.spheres.has_transforms \
            or scene.rects.has_transforms:
        raise NotImplementedError("the reference takes spheres, rects and triangles without "
                                  "transforms, motion or media")
    n = ro.shape[0]
    best_t, best_kind, best_idx = _phase_a(scene, ro.detach(), rd.detach(), t_min, t_max)
    best_idx = best_idx.long()

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
        (KIND_SPHERE, scene.n_spheres, _sphere_phase_b, scene.spheres),
        (KIND_TRIANGLE, scene.n_triangles, _triangle_phase_b, scene.triangles),
        (KIND_RECT, scene.n_rects, _rect_phase_b, scene.rects),
    ):
        if count:
            idx = best_idx.clamp(max=count - 1)
            merge(kind, phase_b(scene, ro, rd, t_min, t_max, idx), table.material[idx])

    return Hit(
        p=p, normal=normal, t=best_t, uv=uv, front_face=front_face, mask=best_kind != KIND_NONE,
        material=material, kind=best_kind, index=best_idx.to(torch.int32),
    )
