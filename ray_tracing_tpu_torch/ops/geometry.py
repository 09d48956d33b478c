"""Ray-primitive math for spheres and axis-aligned rects, the PyTorch
counterpart of the parts of ``ray_tracing_tpu/ops/geometry.py`` that the
port renders.

Every function broadcasts over leading batch shapes: rays shaped
``(N, 1, 3)`` against tables shaped ``(P, 3)`` give an ``(N, P)``
candidate grid; one gathered primitive per ray, ``(N, 3)`` against
``(N, 3)``, gives the full-record phase.  Dot products are written out
as three products and two adds in a fixed order, so every value is a
pure function of its own ray (no reduction whose order depends on the
tensor's layout) and the CUDA phase-A kernel (csrc/intersect.cu)
rounds exactly as this code does.
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


def face_normal(rd, outward_normal):
    """Flip the geometric normal against the ray (reference
    src/hittable/mod.rs:145-155)."""
    front_face = dot(rd, outward_normal) < 0.0
    normal = torch.where(front_face[..., None], outward_normal, -outward_normal)
    return front_face, normal
