"""Everything a run draws from ``--seed``: the pass and step keys, the
pixels the render comparison samples, the starting parameters of a fit
and its target image.  The same seed gives the same inputs on both
sides of the comparison; each side applies them to the scene it
compiled itself."""

from __future__ import annotations

import numpy as np
import torch

from reference.rng import M32, fold_in


def base_key(seed: int) -> np.ndarray:
    """The two key words of a seed of up to 64 bits: its high and low
    words (any pair of words is a key)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise SystemExit(f"--seed {seed} is not a whole number in [0, 2**64)")
    return np.array([(seed >> 32) & M32, seed & M32], np.uint32)


def pass_key(seed: int, i: int) -> np.ndarray:
    """The key of pass or step ``i``: ``fold_in(key(seed), i)``, the CLI's
    ``rng.fold_in(key, iteration)``."""
    return fold_in(base_key(seed), i)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def sample_pixels(seed: int, n_pixels: int, k: int) -> torch.Tensor:
    """``k`` distinct flat pixel indices, sorted, drawn on the host."""
    perm = torch.randperm(n_pixels, generator=generator(seed, "cpu"))
    return torch.sort(perm[:min(k, n_pixels)]).values


LEAVES = ("color", "images", "metal_albedo", "fuzz", "ir")
UNIT_RANGE = ("images", "metal_albedo", "fuzz")  # leaves held to [0, 1]


@torch.no_grad()
def perturb(params: dict, seed: int, amplitude: float) -> dict:
    """The fit's starting parameters: every element of the five leaves
    (in ``LEAVES`` order) scaled by ``1 + amplitude * (2u - 1)``, u
    uniform from the seed on the leaves' device; texels, metal albedo
    and fuzz then clamped to [0, 1]."""
    g = generator(seed, params["color"].device)
    out = {}
    for name in LEAVES:
        p = params[name]
        u = torch.rand(p.shape, generator=g, device=p.device, dtype=torch.float32)
        q = p * (1.0 + amplitude * (2.0 * u - 1.0))
        out[name] = q.clamp(0.0, 1.0) if name in UNIT_RANGE else q
    return out


@torch.no_grad()
def target_image(seed: int, width: int, height: int, grid: int, lo: float, hi: float,
                 device) -> torch.Tensor:
    """(H, W, 3) float32: a ``grid`` x ``grid`` image of uniform values in
    [lo, hi] drawn from the seed, bilinearly upsampled."""
    g = generator(seed ^ 0x5EED, device)
    small = lo + (hi - lo) * torch.rand((1, 3, grid, grid), generator=g, device=device)
    img = torch.nn.functional.interpolate(small, size=(height, width), mode="bilinear",
                                          align_corners=True)
    return img[0].permute(1, 2, 0).contiguous()
