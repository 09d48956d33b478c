"""``v4ray.texture`` submodule (reference src/py.rs:80-83,
src/texture/*.rs pyclasses) plus JSON-only texture types.

The counterpart of ``v4ray_tpu/texture.py``: ``Image(path)`` reads the
file through the port's ``models/compiler.py:load_image`` (the decoded
``.npy`` beside the file when there is one, else Pillow), so a machine
without Pillow loads the repo's images."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def build_memo(b, tex) -> int:
    """Build ``tex`` into builder ``b`` once per compile: a texture
    object shared by several materials (or checker children) must map to
    ONE table entry — one atlas slot, one differentiable parameter —
    mirroring Scene.compile's material memo."""
    memo = getattr(b, "_v4ray_tex_memo", None)
    if memo is None:
        memo = b._v4ray_tex_memo = {}
    key = id(tex)
    if key not in memo:
        memo[key] = tex._build(b)
    return memo[key]


class SolidColor:
    """reference src/texture/solid_color.rs."""

    def __init__(self, color: Tuple[float, float, float]):
        self.color = tuple(float(x) for x in color)

    def _build(self, b) -> int:
        return b.add_texture_solid(self.color)


class Checker:
    """reference src/texture/checker.rs."""

    def __init__(self, texture1, texture2, density: float):
        self.odd = texture1
        self.even = texture2
        self.density = float(density)

    def _build(self, b) -> int:
        return b.add_texture_checker(
            build_memo(b, self.odd), build_memo(b, self.even), self.density
        )


class Image:
    """reference src/texture/image.rs; accepts a path or an array."""

    def __init__(self, image):
        if isinstance(image, str):
            from ray_tracing_tpu_torch.models.compiler import load_image

            image = load_image(image)
        self.image = np.asarray(image)

    def _build(self, b) -> int:
        return b.add_texture_image(self.image)


class Noise:
    """reference src/texture/noise.rs (Perlin turbulence)."""

    def __init__(self, scale: float, depth: int):
        self.scale = float(scale)
        self.depth = int(depth)

    def _build(self, b) -> int:
        return b.add_texture_noise(self.scale, self.depth)
