"""Light importance sampling, the PyTorch counterpart of
``ray_tracing_tpu/ops/lights.py``: pdf values and direction generation
for the scene's "important" spheres and rects, as the reference's
uniform mixture over ``Scene::lights`` (reference sphere.rs:100-144,
aa_rect.rs:146-185, group.rs:76-95).  The light list is static, so each
light is one unrolled block.  Transformed and triangle lights are not
ported yet.
"""

from __future__ import annotations

import math

import torch

from ray_tracing_tpu_torch.models.scene import LIGHT_RECT, LIGHT_SPHERE, SceneData
from ray_tracing_tpu_torch.ops import geometry as geo
from ray_tracing_tpu_torch.ops import sampling as smp

EPSILON = geo.EPSILON
INF = geo.INF


def _sphere_value(scene: SceneData, index: int, p, d):
    sp = scene.spheres
    center, radius = sp.center[index], sp.radius[index]
    _, mask = geo.sphere_t(p, d, center, radius, EPSILON, INF)
    co = center - p
    dist_sq = geo.dot(co, co)
    # a point inside the light sphere makes the cone degenerate: the pdf
    # saturates to INF so the MIS weight collapses to 0
    cos_max = geo.safe_sqrt(1.0 - geo.safe_div(radius * radius, dist_sq, INF))
    solid_angle = 2.0 * math.pi * (1.0 - cos_max)
    val = geo.safe_div(torch.ones_like(solid_angle), solid_angle, INF)
    return torch.where(mask, val, 0.0)


def _sphere_generate(scene: SceneData, index: int, p, u1, u2):
    sp = scene.spheres
    direction = sp.center[index] - p
    local = smp.random_to_sphere(u1, u2, sp.radius[index], geo.dot(direction, direction))
    return geo.normalize(smp.rotate_local(direction, local))


def _rect_value(scene: SceneData, index: int, p, d):
    rc = scene.rects
    axis = rc.axis[index]
    a0, a1, b0, b1 = rc.a0[index], rc.a1[index], rc.b0[index], rc.b1[index]
    ua, ub, uk = geo.rect_basis(axis)
    t, mask, _, _ = geo.rect_t(p, d, ua, ub, uk, a0, a1, b0, b1, rc.k[index], EPSILON, INF)
    area = (a1 - a0) * (b1 - b0)
    _, normal = geo.face_normal(d, geo.rect_normal(axis, rc.positive[index]))
    cosine = torch.abs(geo.dot(d, normal))
    # a grazing cosine saturates the pdf to INF (MIS weight -> 0)
    t_s = torch.where(mask, t, 0.0)
    val = geo.safe_div(t_s * t_s, cosine * area, INF)
    return torch.where(mask, val, 0.0)


def _rect_generate(scene: SceneData, index: int, p, u1, u2):
    rc = scene.rects
    ua, ub, uk = geo.rect_basis(rc.axis[index])
    a = rc.a0[index] + u1 * (rc.a1[index] - rc.a0[index])
    b = rc.b0[index] + u2 * (rc.b1[index] - rc.b0[index])
    k = rc.k[index].expand(a.shape)
    point = ua * a[..., None] + ub * b[..., None] + uk * k[..., None]
    return geo.normalize(point - p)


_VALUE = {LIGHT_SPHERE: _sphere_value, LIGHT_RECT: _rect_value}
_GENERATE = {LIGHT_SPHERE: _sphere_generate, LIGHT_RECT: _rect_generate}


def _lights(scene: SceneData):
    lt = scene.lights
    for kind, index, tidx in zip(lt.kind, lt.index, lt.transform):
        if kind not in _VALUE:
            raise NotImplementedError("triangle lights are not ported yet, see ROADMAP")
        if tidx:
            raise NotImplementedError("transformed lights are not ported yet, see ROADMAP")
        yield kind, index


def lights_value(scene: SceneData, p, d):
    """Uniform-mixture pdf over all lights: the mean of per-light values
    (reference group.rs:76-89)."""
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    for kind, index in _lights(scene):
        total = total + _VALUE[kind](scene, index, p, d)
    return total / float(len(scene.lights))


def lights_generate(scene: SceneData, p, u_pick, u1, u2):
    """Pick one light uniformly and sample a direction toward it
    (reference group.rs:91-95)."""
    dirs = [_GENERATE[kind](scene, index, p, u1, u2) for kind, index in _lights(scene)]
    n = len(dirs)
    if n == 1:
        return dirs[0]
    pick = torch.clamp_max((u_pick * n).to(torch.int32), n - 1)
    out = dirs[0]
    for i in range(1, n):
        out = torch.where((pick == i)[..., None], dirs[i], out)
    return out
