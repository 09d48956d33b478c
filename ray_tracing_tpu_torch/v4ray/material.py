"""``v4ray.material`` submodule (reference src/py.rs:77-79,
src/material/*.rs pyclasses) plus JSON-only material types.

A copy of ``v4ray_tpu/material.py`` whose only change is its imports."""

from __future__ import annotations

from ray_tracing_tpu_torch.v4ray.texture import build_memo

from typing import Tuple


class Lambertian:
    """reference src/material/lambertian.rs."""

    def __init__(self, texture):
        self.texture = texture

    def _build(self, b) -> int:
        return b.add_lambertian(build_memo(b, self.texture))


class Metal:
    """reference src/material/metal.rs."""

    def __init__(self, albedo: Tuple[float, float, float], fuzz: float):
        self.albedo = tuple(float(x) for x in albedo)
        self.fuzz = float(fuzz)

    def _build(self, b) -> int:
        return b.add_metal(self.albedo, self.fuzz)


class Dielectric:
    """reference src/material/dielectric.rs."""

    def __init__(self, ir: float):
        self.ir = float(ir)

    def _build(self, b) -> int:
        return b.add_dielectric(self.ir)


class DiffuseLight:
    """reference src/material/diffuse_light.rs."""

    def __init__(self, emit):
        self.emit = emit

    def _build(self, b) -> int:
        return b.add_diffuse_light(build_memo(b, self.emit))


class Isotropic:
    """reference src/material/isotropic.rs."""

    def __init__(self, albedo):
        self.albedo = albedo

    def _build(self, b) -> int:
        return b.add_isotropic(build_memo(b, self.albedo))
