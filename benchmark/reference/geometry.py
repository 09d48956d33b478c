"""Ray-primitive math for spheres, axis-aligned rects, triangles and
instancing transforms, the PyTorch counterpart of the parts of
``ray_tracing_tpu/ops/geometry.py`` that the port renders.

Every function broadcasts over leading batch shapes: rays shaped
``(N, 1, 3)`` against tables shaped ``(P, 3)`` give an ``(N, P)``
candidate grid; one gathered primitive per ray, ``(N, 3)`` against
``(N, 3)``, gives the full-record phase.  Dot products are written out
as three products and two adds in a fixed order, so every value is a
pure function of its own ray (no reduction whose order depends on the
tensor's layout) and the CUDA kernels (csrc/intersect.cu,
csrc/triangles.cu) round exactly as this code does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPSILON = 1e-3  # reference src/lib.rs:34
INF = math.inf


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm(a):
    return torch.sqrt(dot(a, a))


def safe_sqrt(x):
    """sqrt(maximum(x, 0)), with a finite gradient at x <= 0."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_div(num, den, fallback=0.0):
    """num / den where den != 0, else ``fallback``."""
    ok = den != 0.0
    return torch.where(ok, num / torch.where(ok, den, 1.0), fallback)


def normalize(a):
    s = dot(a, a)
    n = torch.sqrt(torch.where(s > 1e-24, s, 1.0))
    return a / torch.clamp_min(n, 1e-30)[..., None]


def cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def sphere_uv(p):
    """Spherical UV of a unit outward normal (reference sphere.rs:38-45).

    atan2 runs in float64: PyTorch's CPU atan2 rounds differently in its
    vectorised body and its scalar tail, so a float32 atan2 would depend
    on the element's position in the tensor."""
    theta = torch.acos(torch.clamp(-p[..., 1], -1.0, 1.0))
    phi = torch.atan2(-p[..., 2].double(), p[..., 0].double()).float() + math.pi
    u = phi / (2.0 * math.pi)
    v = theta / math.pi
    return torch.stack([u, v], dim=-1)


def sphere_roots(ro, rd, center, radius):
    """Both roots of |ro + t*rd - c|^2 = r^2 with unit rd (reference
    sphere.rs:60-71): half_b = oc.d, c = |oc|^2 - r^2."""
    oc = ro - center
    half_b = dot(oc, rd)
    c = dot(oc, oc) - radius * radius
    disc = half_b * half_b - c
    sqrt_d = safe_sqrt(disc)
    return -half_b - sqrt_d, -half_b + sqrt_d, disc >= 0.0


def sphere_t(ro, rd, center, radius, t_min, t_max):
    """Nearest root in [t_min, t_max] (reference sphere.rs:72-82);
    returns (t, mask)."""
    root1, root2, disc_ok = sphere_roots(ro, rd, center, radius)
    mask1 = disc_ok & (root1 >= t_min) & (root1 <= t_max)
    mask2 = disc_ok & (root2 >= t_min) & (root2 <= t_max)
    return torch.where(mask1, root1, root2), mask1 | mask2


# One-hot basis row per rect variant (0 = XYRect: x0 x1 y0 y1, k on z;
# 1 = YZRect: y0 y1 z0 z1, k on x; 2 = ZXRect: z0 z1 x0 x1, k on y):
# ua on the first in-plane axis, ub on the second, uk on the plane axis.
RECT_UA = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=np.float32)
RECT_UB = np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], dtype=np.float32)
RECT_UK = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], dtype=np.float32)


def rect_basis(axis):
    """(ua, ub, uk) rows of RECT_UA/UB/UK for a tensor of rect variants,
    each (..., 3): row ``axis`` of the s-th table is the unit vector
    on axis (axis + s) % 3, built on the variants' device."""
    return tuple(
        torch.nn.functional.one_hot((axis.long() + s) % 3, 3).to(torch.float32)
        for s in range(3)
    )


def rect_t(ro, rd, ua, ub, uk, a0, a1, b0, b1, k, t_min, t_max):
    """Axis-aligned rect hit (reference aa_rect.rs:114-144), with the
    variant given by its basis rows.  Returns (t, mask, a, b), (a, b)
    the in-plane hit coordinates."""
    o2 = dot(ro, uk)
    d2 = dot(rd, uk)
    d2_ok = d2 != 0.0
    t = torch.where(d2_ok, (k - o2) / torch.where(d2_ok, d2, 1.0), INF)
    t_safe = torch.where(d2_ok, t, 0.0)
    mask = d2_ok & (t >= t_min) & (t <= t_max)
    a = dot(ro, ua) + t_safe * dot(rd, ua)
    b = dot(ro, ub) + t_safe * dot(rd, ub)
    mask = mask & (a >= a0) & (a <= a1) & (b >= b0) & (b <= b1)
    return t, mask, a, b


def rect_normal(axis, positive):
    """Outward normal of a rect variant before face flipping."""
    sign = torch.where(positive, 1.0, -1.0)
    return rect_basis(axis)[2] * sign[..., None]


def aabb_hit(ro, rd_inv, bb_min, bb_max, t_min, t_max):
    """Slab test (reference src/ray.rs:167-189); rd_inv = 1 / rd."""
    t0 = (bb_min - ro) * rd_inv
    t1 = (bb_max - ro) * rd_inv
    lo = torch.as_tensor(t_min, dtype=torch.float32, device=ro.device)
    hi = torch.as_tensor(t_max, dtype=torch.float32, device=ro.device)
    near = torch.maximum(torch.minimum(t0, t1).amax(dim=-1), lo)
    far = torch.minimum(torch.maximum(t0, t1).amin(dim=-1), hi)
    return near <= far


def face_normal(rd, outward_normal):
    """Flip the geometric normal against the ray (reference
    src/hittable/mod.rs:145-155)."""
    front_face = dot(rd, outward_normal) < 0.0
    normal = torch.where(front_face[..., None], outward_normal, -outward_normal)
    return front_face, normal


def triangle_t(ro, rd, v0, e12, e13, t_min, t_max):
    """Moeller-Trumbore with the reference's mask chain (reference
    triangle.rs:56-95).  Returns (t, mask, u, v, det)."""
    p_vec = cross(rd, e13)
    det = dot(e12, p_vec)
    mask = torch.abs(det) > 0.0
    inv_det = torch.where(mask, 1.0 / torch.where(mask, det, 1.0), 0.0)
    t_vec = ro - v0
    u = inv_det * dot(t_vec, p_vec)
    mask = mask & (u >= 0.0) & (u <= 1.0)
    q_vec = cross(t_vec, e12)
    v = inv_det * dot(rd, q_vec)
    mask = mask & (v >= 0.0) & (u + v <= 1.0)
    t = inv_det * dot(e13, q_vec)
    mask = mask & (t >= t_min) & (t <= t_max)
    return t, mask, u, v, det


def _bdot3(a, b):
    """(N, 3) x (T, 3) -> (N, T) dot-product grid as three broadcast
    products and two adds, ((a0 b0 + a1 b1) + a2 b2): no (N, T, 3)
    intermediate and no matrix product (see :func:`matvec3`)."""
    return (a[:, 0:1] * b[None, :, 0] + a[:, 1:2] * b[None, :, 1]) + a[:, 2:3] * b[None, :, 2]


def triangle_sweep_tables(v0, e12, e13):
    """Per-triangle constants of the triple-product sweep (host, numpy).

    With m = ro x rd, Moeller-Trumbore's per-pair products become
    (N, T) dot products against per-triangle constants::

        det   = -(rd . n)            n  = e12 x e13
        u*det =  m . e13 - rd . g1   g1 = e13 x v0
        v*det =  rd . g2 - m . e12   g2 = e12 x v0
        t*det =  ro . n  - d0        d0 = v0 . n

    The constants are computed in float64 against a translated origin
    (the mean of v0), since the two terms of each line cancel at scene
    scale otherwise.  Returns (origin (3,), n, g1, g2 (T, 3), d0 (T,)),
    float32."""
    v0 = np.asarray(v0, np.float64)
    e12 = np.asarray(e12, np.float64)
    e13 = np.asarray(e13, np.float64)
    origin = v0.mean(axis=0) if v0.shape[0] else np.zeros(3)
    v0s = v0 - origin
    n = np.cross(e12, e13)
    g1 = np.cross(e13, v0s)
    g2 = np.cross(e12, v0s)
    d0 = np.sum(v0s * n, axis=-1)
    f = np.float32
    return origin.astype(f), n.astype(f), g1.astype(f), g2.astype(f), d0.astype(f)


def triangle_sweep_t(ro_s, rd, m, e12, e13, n, g1, g2, d0, t_min, t_max):
    """(N, T) candidate grid (t, mask) of the triple-product sweep.

    ``ro_s`` are ray origins already translated by the table's
    ``sw_origin`` (float32 ``ro - sw_origin``), ``m = cross(ro_s, rd)``;
    e12, e13, n, g1, g2: (T, 3); d0: (T,).  The mask chain is the
    reference's (triangle.rs:56-95); u, v and t differ from
    :func:`triangle_t` only by float32 rounding, so phase B re-derives
    the record with :func:`triangle_t`."""
    det = -_bdot3(rd, n)
    mask = torch.abs(det) > 0.0
    inv = torch.where(mask, 1.0 / torch.where(mask, det, 1.0), 0.0)
    u = inv * (_bdot3(m, e13) - _bdot3(rd, g1))
    mask = mask & (u >= 0.0) & (u <= 1.0)
    v = inv * (_bdot3(rd, g2) - _bdot3(m, e12))
    mask = mask & (v >= 0.0) & (u + v <= 1.0)
    t = inv * (_bdot3(ro_s, n) - d0[None, :])
    mask = mask & (t >= t_min) & (t <= t_max)
    return t, mask


def triangle_cluster_sweep_t(ro, rd, origin, cl_lo, cl_hi, cl_e12, cl_e13, cl_n, cl_g1, cl_g2,
                             cl_d0, t_min, t_max):
    """Nearest triangle per ray by the two-level cluster sweep: (t (N,),
    idx (N,) i32, found (N,) bool).

    The clusters (K of C consecutive Morton-sorted triangles, AABBs
    ``cl_lo``/``cl_hi`` translated by ``origin``) go in order.  A
    cluster is swept only when some ray's slab window
    [max(near, t_min), min(far, t_max, best_t)] is non-empty, with
    IEEE 1/rd (a 0 * inf NaN fails the test); one host sync per
    cluster.  Within a cluster the lowest local index wins a tie, and a
    later cluster must be strictly nearer, so (t, idx) equal one argmin
    over the whole table wherever the cull is conservative."""
    n = ro.shape[0]
    c = cl_d0.shape[1]
    ro_s = ro - origin
    m = cross(ro_s, rd)
    inv_rd = 1.0 / rd
    best_t = torch.full((n,), INF, dtype=torch.float32, device=ro.device)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=ro.device)
    for k in range(cl_d0.shape[0]):
        t0 = (cl_lo[k] - ro_s) * inv_rd
        t1 = (cl_hi[k] - ro_s) * inv_rd
        near = torch.clamp_min(torch.minimum(t0, t1).amax(dim=1), t_min)
        far = torch.clamp_max(torch.maximum(t0, t1).amin(dim=1), t_max)
        window = torch.clamp_max(best_t, t_max)
        if not bool((near <= torch.minimum(far, window)).any()):
            continue
        t, mask = triangle_sweep_t(ro_s, rd, m, cl_e12[k], cl_e13[k], cl_n[k], cl_g1[k],
                                   cl_g2[k], cl_d0[k], t_min, t_max)
        t = torch.where(mask, t, INF)
        li = torch.argmin(t, dim=1)
        tb = torch.gather(t, 1, li[:, None])[:, 0]
        better = tb < best_t  # strict: an earlier cluster keeps a tie
        best_t = torch.where(better, tb, best_t)
        best_idx = torch.where(better, (li + k * c).to(torch.int32), best_idx)
    return best_t, best_idx, best_t < INF


def matvec3(m, v):
    """(..., 3, 3) times (..., 3) as explicit float32 products and adds,
    ((m0 x + m1 y) + m2 z) per row.  Never a matrix product: on the card
    a float32 matmul may run in TF32 (about three decimal digits), which
    moves ray origins by whole units at Cornell-box scale."""
    return (m[..., 0] * v[..., 0:1] + m[..., 1] * v[..., 1:2]) + m[..., 2] * v[..., 2:3]


def transform_ray(inv, inv_t, ro, rd):
    """World ray -> object space (reference transform.rs:72-83): returns
    (ro_obj, rd_obj unit, nrm), world t = object t / nrm.  ``inv`` is
    (..., 3, 3) row-major, ``inv_t`` (..., 3)."""
    ro_obj = matvec3(inv, ro) + inv_t
    d = matvec3(inv, rd)
    nrm = norm(d)
    return ro_obj, d / torch.clamp_min(nrm, 1e-30)[..., None], nrm


def transform_point(fwd, fwd_t, p):
    return matvec3(fwd, p) + fwd_t


def transform_dir(fwd, d):
    return matvec3(fwd, d)
