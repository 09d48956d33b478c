"""Light importance sampling, the PyTorch counterpart of
``ray_tracing_tpu/ops/lights.py``: pdf values and direction generation
for the scene's "important" spheres, triangles and rects, as the
reference's uniform mixture over ``Scene::lights`` (reference
sphere.rs:100-144, triangle.rs:103-146, aa_rect.rs:146-185,
group.rs:76-95).  The light list is static, so each light is one
unrolled block.  A transformed light (reference transform.rs:98-125)
takes its pdf in object space, distances and cosines measured there,
and maps its generated direction back through the forward matrix.
"""

from __future__ import annotations

import math

import torch

from .scene import LIGHT_RECT, LIGHT_SPHERE, LIGHT_TRIANGLE, SceneData
from . import geometry as geo
from . import sampling as smp

EPSILON = geo.EPSILON
INF = geo.INF


def _to_object(scene: SceneData, tidx: int, p, d=None):
    """A point and a unit direction in the object space of transform slot
    ``tidx`` (the direction normalized again; reference
    transform.rs:105-112); slot 0 is the identity."""
    if tidx == 0:
        return p, d
    tf = scene.transforms
    inv = tf.inv[tidx]
    p_o = geo.matvec3(inv, p) + tf.inv_t[tidx]
    return p_o, None if d is None else geo.normalize(geo.matvec3(inv, d))


def _to_world(scene: SceneData, tidx: int, d_o):
    """An object-space direction back to world space, unit."""
    if tidx == 0:
        return d_o
    return geo.normalize(geo.matvec3(scene.transforms.fwd[tidx], d_o))


def _sphere_value(scene: SceneData, index: int, tidx: int, p, d):
    sp = scene.spheres
    p_o, d_o = _to_object(scene, tidx, p, d)
    center, radius = sp.center[index], sp.radius[index]
    _, mask = geo.sphere_t(p_o, d_o, center, radius, EPSILON, INF)
    co = center - p_o
    dist_sq = geo.dot(co, co)
    # a point inside the light sphere makes the cone degenerate: the pdf
    # saturates to INF so the MIS weight collapses to 0
    cos_max = geo.safe_sqrt(1.0 - geo.safe_div(radius * radius, dist_sq, INF))
    solid_angle = 2.0 * math.pi * (1.0 - cos_max)
    val = geo.safe_div(torch.ones_like(solid_angle), solid_angle, INF)
    return torch.where(mask, val, 0.0)


def _sphere_generate(scene: SceneData, index: int, tidx: int, p, u1, u2):
    sp = scene.spheres
    p_o, _ = _to_object(scene, tidx, p)
    direction = sp.center[index] - p_o
    local = smp.random_to_sphere(u1, u2, sp.radius[index], geo.dot(direction, direction))
    return _to_world(scene, tidx, geo.normalize(smp.rotate_local(direction, local)))


def _triangle_value(scene: SceneData, index: int, tidx: int, p, d):
    tr = scene.triangles
    p_o, d_o = _to_object(scene, tidx, p, d)
    e12, e13 = tr.e12[index], tr.e13[index]
    t, mask, u, v, _ = geo.triangle_t(p_o, d_o, tr.v0[index], e12, e13, EPSILON, INF)
    w = 1.0 - u - v
    normal = geo.normalize(tr.n0[index] * w[..., None] + tr.n1[index] * u[..., None]
                           + tr.n2[index] * v[..., None])
    area = 0.5 * geo.norm(geo.cross(e12, e13))
    cosine = torch.abs(geo.dot(d_o, normal))
    # a grazing cosine saturates the pdf to INF (MIS weight -> 0)
    t_s = torch.where(mask, t, 0.0)
    val = geo.safe_div(t_s * t_s, cosine * area, INF)
    return torch.where(mask, val, 0.0)


def _triangle_generate(scene: SceneData, index: int, tidx: int, p, u1, u2):
    tr = scene.triangles
    p_o, _ = _to_object(scene, tidx, p)
    # uniform barycentric with EPSILON margins, folded over the diagonal
    # (reference triangle.rs:134-146)
    x = EPSILON + u1 * (1.0 - 2.0 * EPSILON)
    y = EPSILON + u2 * (1.0 - 2.0 * EPSILON)
    over = (x + y) > 1.0
    x = torch.where(over, 1.0 - EPSILON - x, x)
    y = torch.where(over, 1.0 - EPSILON - y, y)
    point = tr.v0[index] + tr.e12[index] * x[..., None] + tr.e13[index] * y[..., None]
    return _to_world(scene, tidx, geo.normalize(point - p_o))


def _rect_value(scene: SceneData, index: int, tidx: int, p, d):
    rc = scene.rects
    p_o, d_o = _to_object(scene, tidx, p, d)
    axis = rc.axis[index]
    a0, a1, b0, b1 = rc.a0[index], rc.a1[index], rc.b0[index], rc.b1[index]
    ua, ub, uk = geo.rect_basis(axis)
    t, mask, _, _ = geo.rect_t(p_o, d_o, ua, ub, uk, a0, a1, b0, b1, rc.k[index], EPSILON, INF)
    area = (a1 - a0) * (b1 - b0)
    _, normal = geo.face_normal(d_o, geo.rect_normal(axis, rc.positive[index]))
    cosine = torch.abs(geo.dot(d_o, normal))
    # a grazing cosine saturates the pdf to INF (MIS weight -> 0)
    t_s = torch.where(mask, t, 0.0)
    val = geo.safe_div(t_s * t_s, cosine * area, INF)
    return torch.where(mask, val, 0.0)


def _rect_generate(scene: SceneData, index: int, tidx: int, p, u1, u2):
    rc = scene.rects
    p_o, _ = _to_object(scene, tidx, p)
    ua, ub, uk = geo.rect_basis(rc.axis[index])
    a = rc.a0[index] + u1 * (rc.a1[index] - rc.a0[index])
    b = rc.b0[index] + u2 * (rc.b1[index] - rc.b0[index])
    k = rc.k[index].expand(a.shape)
    point = ua * a[..., None] + ub * b[..., None] + uk * k[..., None]
    return _to_world(scene, tidx, geo.normalize(point - p_o))


_VALUE = {LIGHT_SPHERE: _sphere_value, LIGHT_TRIANGLE: _triangle_value, LIGHT_RECT: _rect_value}
_GENERATE = {LIGHT_SPHERE: _sphere_generate, LIGHT_TRIANGLE: _triangle_generate,
             LIGHT_RECT: _rect_generate}


def lights_value(scene: SceneData, p, d):
    """Uniform-mixture pdf over all lights: the mean of per-light values
    (reference group.rs:76-89)."""
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    lt = scene.lights
    for kind, index, tidx in zip(lt.kind, lt.index, lt.transform):
        total = total + _VALUE[kind](scene, index, tidx, p, d)
    return total / float(len(scene.lights))


def lights_generate(scene: SceneData, p, u_pick, u1, u2):
    """Pick one light uniformly and sample a direction toward it
    (reference group.rs:91-95)."""
    lt = scene.lights
    dirs = [_GENERATE[kind](scene, index, tidx, p, u1, u2)
            for kind, index, tidx in zip(lt.kind, lt.index, lt.transform)]
    n = len(dirs)
    if n == 1:
        return dirs[0]
    pick = torch.clamp_max((u_pick * n).to(torch.int32), n - 1)
    out = dirs[0]
    for i in range(1, n):
        out = torch.where((pick == i)[..., None], dirs[i], out)
    return out
