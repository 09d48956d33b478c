"""Texture plugins, as declarative field tables (see plugin.py).

Role parity: reference `v4ray_frontend/texture.py` (SolidColor,
Checker), extended with the backend's Noise texture.  The project-JSON
keys (``color`` hex string, ``texture1``/``texture2`` UUID refs,
``density``, ``scale``/``depth``) are fixed by the document format.

A copy of ``v4ray_frontend_tpu/texture.py`` whose only change is its
imports; it builds the port's façade objects."""

from __future__ import annotations

import os

import ray_tracing_tpu_torch.v4ray as v4ray
from ray_tracing_tpu_torch.v4ray_frontend.plugin import TextureType
from ray_tracing_tpu_torch.v4ray_frontend.properties import (
    ColorProperty,
    FloatProperty,
    StringProperty,
    TextureProperty,
    rgb01,
)

__all__ = ["TextureType", "SolidColor", "Checker", "Image", "Noise"]


class SolidColor(TextureType):
    KIND = "solid color"
    FIELDS = (ColorProperty("color", slot="color"),)

    @classmethod
    def apply(cls, data, textures):
        return v4ray.texture.SolidColor(rgb01(data[0]))


class Checker(TextureType):
    KIND = "checker"
    FIELDS = (
        TextureProperty("texture 1", slot="texture1"),
        TextureProperty("texture 2", slot="texture2"),
        FloatProperty("density", default=1.0, slot="density",
                      check=lambda v: float(v) > 0),
    )

    @classmethod
    def apply(cls, data, textures):
        return v4ray.texture.Checker(textures[data[0]], textures[data[1]],
                                     data[2])


class Image(TextureType):
    """Image-mapped texture by file path (backend + CLI-schema type the
    reference editor never surfaced — reference src/json.rs:147-155
    accepts ``{"type": "image", "file": ...}`` but v4ray_frontend
    registers no Image plugin).  Validation requires the file to exist
    so a bad path reads as an invalid node in the editor instead of a
    render-time crash; the path is stored as typed (absolute or
    relative to the editor's working directory), matching the CLI
    loader's treatment of scene-JSON ``file`` keys."""

    KIND = "image"
    FIELDS = (
        StringProperty("file", slot="file",
                       check=lambda v: bool(str(v).strip())),
    )

    @classmethod
    def rule(cls, data):
        return os.path.isfile(data[0])

    @classmethod
    def apply(cls, data, textures):
        return v4ray.texture.Image(data[0])


class Noise(TextureType):
    """Perlin turbulence (backend texture the reference editor lacked)."""

    KIND = "noise"
    FIELDS = (
        FloatProperty("scale", default=1.0, slot="scale",
                      check=lambda v: float(v) > 0),
        FloatProperty("octaves", default=7.0, min=1.0, max=16.0, decimals=0,
                      slot="depth", codec="int",
                      check=lambda v: int(v) >= 1),
    )

    @classmethod
    def apply(cls, data, textures):
        return v4ray.texture.Noise(float(data[0]), int(data[1]))
