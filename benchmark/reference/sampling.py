"""Directional samplers and PDFs driven by explicit uniform draws, the
PyTorch counterpart of ``ray_tracing_tpu/ops/sampling.py`` (reference
src/random.rs:6-65, src/pdf/cosine.rs, mixture.rs).

All functions broadcast over leading batch dims; vectors are (..., 3).
"""

from __future__ import annotations

import math

import torch

from .geometry import (
    cross,
    dot,
    normalize,
    safe_div,
    safe_sqrt,
)

TWO_PI = 2.0 * math.pi


def uniform_in_range(u, lo, hi):
    """Map a U[0,1) draw into [lo, hi) (reference random.rs:6-16)."""
    return lo + u * (hi - lo)


def random_in_unit_disk(u1, u2):
    """(reference random.rs:18-25)"""
    r = torch.sqrt(u1)
    theta = TWO_PI * u2
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def random_to_sphere(u1, u2, radius, distance_squared):
    """Cone sample toward a sphere (reference random.rs:27-39); local
    frame with +z toward the sphere center."""
    phi = TWO_PI * u1
    cos_max = safe_sqrt(1.0 - safe_div(radius * radius, distance_squared, math.inf))
    z = 1.0 + u2 * (cos_max - 1.0)
    xy = safe_sqrt(1.0 - z * z)
    return torch.stack([torch.cos(phi) * xy, torch.sin(phi) * xy, z], dim=-1)


def random_on_unit_sphere(u1, u2):
    """(reference random.rs:41-51)"""
    z = uniform_in_range(u1, -1.0, 1.0)
    theta = TWO_PI * u2
    xy = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([torch.cos(theta) * xy, torch.sin(theta) * xy, z], dim=-1)


def _cbrt(x):
    """Cube root of x >= 0.  PyTorch has no cbrt, and its float32 pow
    rounds differently in the CPU's vectorised body and scalar tail, so
    it runs in float64 (position-independent once rounded to float32)."""
    return torch.pow(x.double(), 1.0 / 3.0).float()


def random_in_unit_sphere(u1, u2, u3):
    """(reference random.rs:53-65)"""
    theta = TWO_PI * u1
    cos_phi = uniform_in_range(u2, -1.0, 1.0)
    r = _cbrt(u3)
    sin_phi = torch.sqrt(torch.clamp_min(1.0 - cos_phi * cos_phi, 0.0))
    return torch.stack(
        [r * sin_phi * torch.cos(theta), r * sin_phi * torch.sin(theta), r * cos_phi],
        dim=-1,
    )


def face_towards(direction, up):
    """Rotation whose local +z maps to ``direction`` (nalgebra
    Rotation3::face_towards, reference cosine.rs:25); returns the three
    world-frame columns (xaxis, yaxis, zaxis)."""
    zaxis = normalize(direction)
    xaxis = normalize(cross(up, zaxis))
    yaxis = cross(zaxis, xaxis)
    return xaxis, yaxis, zaxis


def onb_up(direction):
    """(0,1,0) when |dir.x| > 0.9 else (1,0,0) (reference
    cosine.rs:18-24, sphere.rs:133-138)."""
    selector = torch.abs(direction[..., 0]) > 0.9
    zeros = torch.zeros_like(direction[..., 0])
    return torch.stack(
        [torch.where(selector, zeros, 1.0), torch.where(selector, 1.0, zeros), zeros],
        dim=-1,
    )


def rotate_local(direction, local):
    """Map a local-frame vector into world via face_towards(direction)."""
    xaxis, yaxis, zaxis = face_towards(direction, onb_up(direction))
    return xaxis * local[..., 0:1] + yaxis * local[..., 1:2] + zaxis * local[..., 2:3]


def cosine_pdf_value(normal, direction):
    """cos(theta)/pi over the hemisphere around ``normal`` (reference
    cosine.rs:32-37)."""
    cosine = dot(direction, normal)
    return torch.where(cosine > 0.0, cosine / math.pi, 0.0)


def cosine_pdf_generate(normal, u1, u2):
    """Cosine-weighted hemisphere around ``normal`` (reference
    cosine.rs:38-48)."""
    z = torch.sqrt(torch.clamp_min(1.0 - u2, 0.0))
    phi = TWO_PI * u1
    sqrt_r2 = torch.sqrt(u2)
    local = torch.stack([torch.cos(phi) * sqrt_r2, torch.sin(phi) * sqrt_r2, z], dim=-1)
    return rotate_local(normal, local)


def reflect(v, n):
    """(reference material/mod.rs:47-52)"""
    return v - n * (2.0 * dot(v, n))[..., None]


def refract(uv, n, etai_over_etat):
    """Snell refraction of unit vectors (reference material/mod.rs:54-63)."""
    cos_theta = -dot(uv, n)
    r_out_perp = (uv + n * cos_theta[..., None]) * etai_over_etat[..., None]
    k = 1.0 - dot(r_out_perp, r_out_perp)
    return r_out_perp - n * safe_sqrt(k)[..., None]


def schlick_reflectance(cosine, ref_idx):
    """(reference dielectric.rs:23-27).  The fifth power is written as
    x * (x*x)^2, the product XLA's integer power takes; PyTorch's float
    pow would depend on the element's position in a CPU tensor."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    m = 1.0 - cosine
    m2 = m * m
    return r0 + (1.0 - r0) * (m * (m2 * m2))
