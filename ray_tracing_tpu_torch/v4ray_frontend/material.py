"""Material plugins, as declarative field tables (see plugin.py).

Role parity: reference `v4ray_frontend/material.py` (Lambertian,
Dielectric, Metal — including the preview stand-in idea: glass and
metal render in the cheap live preview as lambertians), extended with
the backend's DiffuseLight and Isotropic.  Project-JSON keys
(``texture``, ``ir``, ``albedo``/``fuzz``, ``emit``/``intensity``) are
fixed by the document format.

A copy of ``v4ray_frontend_tpu/material.py`` whose only change is its
imports; it builds the port's façade objects."""

from __future__ import annotations

import ray_tracing_tpu_torch.v4ray as v4ray
from ray_tracing_tpu_torch.v4ray_frontend.plugin import MaterialType
from ray_tracing_tpu_torch.v4ray_frontend.properties import (
    ColorProperty,
    FloatProperty,
    TextureProperty,
    rgb01,
)

__all__ = [
    "MaterialType", "Lambertian", "Dielectric", "Metal",
    "DiffuseLight", "Isotropic",
]


def _solid(rgb01_tuple):
    return v4ray.texture.SolidColor(rgb01_tuple)


class Lambertian(MaterialType):
    KIND = "lambertian"
    FIELDS = (TextureProperty("texture", slot="texture"),)

    @classmethod
    def apply(cls, data, textures):
        return v4ray.material.Lambertian(textures[data[0]])


class Dielectric(MaterialType):
    KIND = "dielectric"
    FIELDS = (
        FloatProperty("refraction index", default=1.0, slot="ir",
                      check=lambda v: float(v) >= 1),
    )

    @classmethod
    def apply(cls, data, textures):
        return v4ray.material.Dielectric(data[0])

    @classmethod
    def apply_preview(cls, data, textures):
        # glass is invisible at preview depth 1; show a neutral gray body
        return v4ray.material.Lambertian(_solid((0.9, 0.9, 0.9)))


class Metal(MaterialType):
    KIND = "metal"
    FIELDS = (
        ColorProperty("albedo", slot="albedo"),
        FloatProperty("fuzz", slot="fuzz",
                      check=lambda v: 0 <= float(v) <= 1),
    )

    @classmethod
    def apply(cls, data, textures):
        return v4ray.material.Metal(rgb01(data[0]), data[1])

    @classmethod
    def apply_preview(cls, data, textures):
        # mirrors need >1 bounce; preview as a matte body of the same hue
        return v4ray.material.Lambertian(_solid(rgb01(data[0])))


class DiffuseLight(MaterialType):
    """Emissive material (backend material the reference editor lacked)."""

    KIND = "diffuse light"
    FIELDS = (
        ColorProperty("emit color", slot="emit"),
        FloatProperty("intensity", default=1.0, slot="intensity",
                      check=lambda v: float(v) >= 0),
    )

    @classmethod
    def apply(cls, data, textures):
        r, g, b = rgb01(data[0])
        k = float(data[1])
        return v4ray.material.DiffuseLight(_solid((r * k, g * k, b * k)))


class Isotropic(MaterialType):
    """Volume phase function (backend material the reference editor lacked)."""

    KIND = "isotropic"
    FIELDS = (TextureProperty("albedo", slot="albedo"),)

    @classmethod
    def apply(cls, data, textures):
        return v4ray.material.Isotropic(textures[data[0]])

    @classmethod
    def apply_preview(cls, data, textures):
        # a participating medium reads as a surface in the depth-1 preview
        return v4ray.material.Lambertian(textures[data[0]])
