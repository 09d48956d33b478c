"""Texture evaluation over flat texture tables, the PyTorch counterpart
of ``ray_tracing_tpu/ops/textures.py`` (reference src/texture/).

Checker recursion is a bounded pointer walk, image sampling a gather
from the flattened atlas, Perlin noise an integer lattice hash with
Hermite interpolation.  Image and noise textures are evaluated on every
ray and selected by its leaf texture's type.
"""

from __future__ import annotations

import torch

from ray_tracing_tpu_torch.models.scene import (
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_NOISE,
    TextureTable,
)
from ray_tracing_tpu_torch.ops.rng import M32, mul32


def _lattice_hash(i, j, k):
    """Integer hash of a lattice point (int32 coordinates taken modulo
    2**32), in int64 words below 2**32."""
    h = (i & M32) * 73856093 ^ (j & M32) * 19349663 ^ (k & M32) * 83492791
    h = h & M32
    h = h ^ (h >> 13)
    h = mul32(h, 0x85EBCA6B)
    return h ^ (h >> 16)


def _grad_dot(h, x, y, z):
    """Improved-noise gradient dot: the hash picks one of 12 edge
    directions and the dot is two adds with sign flips."""
    h4 = h & 15
    u = torch.where(h4 < 8, x, y)
    v = torch.where(h4 < 4, y, torch.where((h4 == 12) | (h4 == 14), x, z))
    return torch.where((h4 & 1) == 0, u, -u) + torch.where((h4 & 2) == 0, v, -v)


def perlin_noise(p):
    """Gradient noise with Hermite smoothing (reference noise.rs:41-140);
    ``p`` is (..., 3), returns (...,) f32 in roughly [-1, 1]."""
    fl = torch.floor(p)
    uvw = p - fl
    ijk = fl.to(torch.int64)
    uu = uvw * uvw * (3.0 - 2.0 * uvw)

    x, y, z = uvw[..., 0], uvw[..., 1], uvw[..., 2]
    accum = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    for corner in range(8):
        di, dj, dk = (corner >> 2) & 1, (corner >> 1) & 1, corner & 1
        h = _lattice_hash(ijk[..., 0] + di, ijk[..., 1] + dj, ijk[..., 2] + dk)
        w = (
            (uu[..., 0] if di else 1.0 - uu[..., 0])
            * (uu[..., 1] if dj else 1.0 - uu[..., 1])
            * (uu[..., 2] if dk else 1.0 - uu[..., 2])
        )
        accum = accum + w * _grad_dot(h, x - di, y - dj, z - dk)
    # scale so the amplitude matches unit-gradient noise (~[-1, 1])
    return accum * 0.7071


def perlin_turb(p, depth, max_depth: int):
    """fBm turbulence |sum w_i noise(2^i p)| (reference noise.rs:91-107);
    ``depth`` is per element, ``max_depth`` the octave bound.  All
    octaves are evaluated in one batch (doubling p is exact) and summed
    in octave order."""
    scales = 2.0 ** torch.arange(max_depth, dtype=torch.float32, device=p.device)
    noise = perlin_noise(p[None] * scales[:, None, None])  # (D, M)
    accum = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    weight = 1.0
    for octave in range(max_depth):
        accum = accum + torch.where(octave < depth, weight * noise[octave], 0.0)
        weight = weight * 0.5
    return torch.abs(accum)


def image_texel_index(tt: TextureTable, img_idx, uv):
    """(row j, col i) of the nearest texel, u clamped and v flipped
    (reference image.rs:26-48)."""
    u = torch.clamp(uv[..., 0], 0.0, 1.0)
    v = 1.0 - torch.clamp(uv[..., 1], 0.0, 1.0)
    dims = tt.image_dims[img_idx]  # (..., 2) = (h, w)
    h = dims[..., 0]
    w = dims[..., 1]
    i = torch.minimum((w.to(torch.float32) * u).to(torch.int32), w - 1)
    j = torch.minimum((h.to(torch.float32) * v).to(torch.int32), h - 1)
    return j, i


def image_value(tt: TextureTable, img_idx, uv):
    """Nearest-texel lookup (reference image.rs:26-72) as one gather
    from the flattened (P, 3) atlas."""
    j, i = image_texel_index(tt, img_idx, uv)
    hmax, wmax = tt.images.shape[1], tt.images.shape[2]
    flat = (img_idx.long() * hmax + j) * wmax + i
    return tt.images.reshape(-1, 3)[flat]


def resolve_leaf(tt: TextureTable, idx, p):
    """Walk checker indirection to the leaf texture id per ray
    (reference checker.rs:31-38: the sign of sin(d x) sin(d y) sin(d z))."""
    for _ in range(max(tt.max_checker_depth, 1)):
        is_checker = tt.ttype[idx] == TEX_CHECKER
        d = tt.density[idx][..., None] * p
        sines = torch.sin(d[..., 0]) * torch.sin(d[..., 1]) * torch.sin(d[..., 2])
        child = torch.where(sines > 0.0, tt.child_even[idx], tt.child_odd[idx])
        idx = torch.where(is_checker, child, idx)
    return idx


def texture_value(tt: TextureTable, idx, uv, p, *, with_leaf: bool = False):
    """Colors of textures ``idx`` (N,) at (uv (N, 2), p (N, 3)): (N, 3),
    or ``(color, resolved leaf)`` with ``with_leaf``, so that a caller
    that also needs the leaf walks the checker chain once.

    The image and noise values are computed on every lane and selected
    by the leaf's type, with no host read: a lane of another type takes
    its solid color, and its image or noise value gets a zero gradient."""
    idx = resolve_leaf(tt, idx.long(), p)
    ttype = tt.ttype[idx]
    out = tt.color[idx]  # TEX_SOLID (reference solid_color.rs:21-28)
    if tt.images.shape[0] > 0:
        out = torch.where((ttype == TEX_IMAGE)[:, None], image_value(tt, tt.image[idx], uv), out)
    if tt.max_noise_depth > 0:
        turb = perlin_turb(tt.scale[idx][:, None] * p + tt.noise_offset[idx],
                           tt.noise_depth[idx], tt.max_noise_depth)
        # white * turb (reference noise.rs:160-171)
        out = torch.where((ttype == TEX_NOISE)[:, None], turb[:, None], out)
    return (out, idx) if with_leaf else out
