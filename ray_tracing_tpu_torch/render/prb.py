"""Path-replay backpropagation (PRB) for the color-linear parameters, the
PyTorch counterpart of ``ray_tracing_tpu/render/prb.py``.

The estimator

    rad = sum_k T_k e_k + T_end env,     T_k = prod_{j<k} A_j w_j

is linear in each occurrence of a color-table entry (A_j the albedo at
a lambertian bounce, e_k the emission at a diffuse light; the MIS
weights w_j do not depend on colors), so with the same paths the exact
per-path derivative is

    d rad / d e_k = T_k                      (emission occurrences)
    d rad / d A_j = S_j / A_j                (albedo occurrences)

with ``S_j = rad_total - prefix_j`` the radiance gathered strictly after
bounce j.  The division is exact for A_j > 0; at A_j = 0 the suffix is
0 and so is the contribution, the one known deviation from true AD.

Gradients cover the solid colors (``textures.color``), the atlas texels
(``textures.images``) and the metal albedo (``materials.albedo``).  The
three accumulators are views of one (P + T + M, 3) table laid out
``[gimg | gcol | gmet]``, updated in place by one ordered scatter-add
per tile: kernel K2 (ops/cuda_scatter.py) on the card, which adds the
contributions to each table row in row order without float atomics, so
every color-linear gradient repeats bit for bit and equals the CPU's.
The fuzz and IR gradients come from a reverse-mode replay of the rays
that reach a metal or a dielectric (render/prb_scalar.py).

:func:`prb_radiance_full` and :func:`prb_radiance` are the
color-linear faces of the autograd surface ``prb_scalar.prb_radiance_all``.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ray_tracing_tpu_torch.models.scene import SceneData

_A_EPS = 1e-6

# rays per tile of the gradient path on the CPU (renderer.tile_rule), and
# of the bench protocol (bench_torch.py, as bench.py traces its tiles)
TILE_SIZE = 65536


def check_fit_init(colors, *, nudge: float | None = None):
    """Guard a PRB fit's starting colors against the zero-albedo pin.

    PRB's albedo derivative is the suffix radiance divided by the albedo,
    so an exactly-zero channel gets an exactly-zero gradient and an
    optimizer started at black never moves.  Warns on any zero channel;
    with ``nudge`` set, also returns the colors clamped to at least that
    value."""
    c = np.asarray(colors.detach().cpu() if isinstance(colors, torch.Tensor) else colors)
    if (c == 0.0).any():
        warnings.warn(
            "PRB fit initialized with exactly-zero color channel(s): "
            "their gradients are pinned to 0 (render/prb.py zero-albedo "
            "deviation); pass nudge= to lift them off zero.",
            UserWarning,
            stacklevel=2,
        )
    if nudge is not None:
        return torch.clamp_min(torch.as_tensor(colors), nudge)
    return colors


class PrbParams(NamedTuple):
    """The color-linear parameter set (one sweep covers all three)."""

    color: torch.Tensor  # (T, 3) = scene.textures.color
    images: torch.Tensor  # (I, Hmax, Wmax, 3) = scene.textures.images
    metal_albedo: torch.Tensor  # (M, 3) = scene.materials.albedo


def _grad_rows(scene: SceneData):
    """(P, T, M): the atlas texels (at least 1, so that the table always
    has an image block), the color rows and the material rows."""
    i, h, w = scene.textures.images.shape[:3]
    return max(i * h * w, 1), scene.textures.color.shape[0], scene.materials.albedo.shape[0]


def _zero_grads(scene: SceneData):
    """One zeroed (P + T + M, 3) table ``[gimg | gcol | gmet]`` on the
    scene's device, and its views (gcol (T, 3), gimg (P, 3) texel-major
    with P = I*Hmax*Wmax, gmet (M, 3))."""
    p, t, m = _grad_rows(scene)
    table = torch.zeros((p + t + m, 3), dtype=torch.float32, device=scene.device)
    return table, (table[p:p + t], table[:p], table[p + t:])


def grads_image_flat(gacc, scene: SceneData):
    """The (I*Hmax*Wmax, 3) texel-major image gradient of an accumulator
    triple (already the table's own layout in the port)."""
    i, h, w = scene.textures.images.shape[:3]
    return gacc[1][: max(i * h * w, 1)]


def prb_radiance_full(params: PrbParams, scene: SceneData, ro, rd, key, max_depth: int, *,
                      ids_base: int = 0, tile_size: int | None = None):
    """Per-ray radiance (N, 3), differentiable by autograd in every
    color-linear parameter (solid colors, atlas texels, metal albedo):
    ``prb_scalar.prb_radiance_all`` with the tangent pass disabled
    (``scalar_rows=((), ())``) and fuzz and IR entering detached."""
    from ray_tracing_tpu_torch.render.prb_scalar import AllParams, prb_radiance_all

    full = AllParams(color=params.color, images=params.images,
                     metal_albedo=params.metal_albedo,
                     fuzz=scene.materials.fuzz.detach(), ir=scene.materials.ir.detach())
    return prb_radiance_all(full, scene, ro, rd, key, max_depth, scalar_rows=((), ()),
                            ids_base=ids_base, tile_size=tile_size)


def prb_radiance(colors, scene: SceneData, ro, rd, key, max_depth: int, *,
                 ids_base: int = 0, tile_size: int | None = None):
    """Colors-only :func:`prb_radiance_full`: the atlas and metal albedo
    enter as the scene holds them."""
    params = PrbParams(colors, scene.textures.images, scene.materials.albedo)
    return prb_radiance_full(params, scene, ro, rd, key, max_depth, ids_base=ids_base,
                             tile_size=tile_size)
