"""Shape plugins, as declarative field tables (see plugin.py).

Role parity: reference `v4ray_frontend/shape.py` (which registered only
Sphere); this registry covers every backend shape — the three
axis-aligned rects, cuboid, and raw triangle included.  Project-JSON
layouts (``center``/``radius``, flat rect keys + ``positive`` flag,
``p0``/``p1``, ``vertices`` rows) are fixed by the document format and
expressed through field slots/codecs.

A copy of ``v4ray_frontend_tpu/shape.py`` whose only change is its
imports; it builds the port's façade objects."""

from __future__ import annotations

import os

import numpy as np

import ray_tracing_tpu_torch.v4ray as v4ray
from ray_tracing_tpu_torch.v4ray_frontend.plugin import ShapeType
from ray_tracing_tpu_torch.v4ray_frontend.properties import FloatProperty, StringProperty

__all__ = [
    "ShapeType", "Sphere", "MovingSphere", "XYRect", "YZRect", "ZXRect",
    "Cuboid", "Triangle", "Mesh", "ConstantMediumSphere",
    "ConstantMediumCuboid",
]


class Sphere(ShapeType):
    KIND = "sphere"
    FIELDS = (
        FloatProperty("center x", slot=("center",)),
        FloatProperty("center y", slot=("center",)),
        FloatProperty("center z", slot=("center",)),
        FloatProperty("radius", slot="radius",
                      check=lambda v: float(v) > 0),
    )

    @classmethod
    def apply(cls, data):
        return [v4ray.shape.Sphere(tuple(data[0:3]), data[3])]


class MovingSphere(ShapeType):
    """True motion blur (superset — see ray_tracing_tpu_torch.v4ray.shape.MovingSphere)."""

    KIND = "moving-sphere"
    FIELDS = (
        FloatProperty("center0 x", slot=("center0",)),
        FloatProperty("center0 y", slot=("center0",)),
        FloatProperty("center0 z", slot=("center0",)),
        FloatProperty("center1 x", slot=("center1",)),
        FloatProperty("center1 y", slot=("center1",)),
        FloatProperty("center1 z", slot=("center1",)),
        FloatProperty("radius", slot="radius",
                      check=lambda v: float(v) > 0),
        FloatProperty("time0", slot="time0"),
        FloatProperty("time1", default=1.0, slot="time1"),
    )

    @classmethod
    def rule(cls, data):
        return float(data[8]) != float(data[7])

    @classmethod
    def apply(cls, data):
        return [v4ray.shape.MovingSphere(
            tuple(data[0:3]), tuple(data[3:6]), data[6],
            time0=data[7], time1=data[8],
        )]


def _rect_plugin(kind_name, backend_cls, axes):
    """One plugin per axis-aligned rect family; `axes` = (u, v, fixed)."""
    a, b, k = axes

    class _Rect(ShapeType):
        KIND = kind_name
        FIELDS = (
            FloatProperty(f"{a}0", slot=f"{a}0"),
            FloatProperty(f"{a}1", default=1.0, slot=f"{a}1"),
            FloatProperty(f"{b}0", slot=f"{b}0"),
            FloatProperty(f"{b}1", default=1.0, slot=f"{b}1"),
            FloatProperty(k, slot=k),
            FloatProperty("positive (>0 = outward +)", default=1.0,
                          slot="positive", codec="sign"),
        )

        @classmethod
        def rule(cls, data):
            return (float(data[0]) < float(data[1])
                    and float(data[2]) < float(data[3]))

        @classmethod
        def apply(cls, data):
            return [backend_cls(data[0], data[1], data[2], data[3], data[4],
                                positive=float(data[5]) > 0)]

    _Rect.__name__ = _Rect.__qualname__ = kind_name.replace("-", "_")
    return _Rect


XYRect = _rect_plugin("xy-rect", v4ray.shape.XYRect, ("x", "y", "z"))
YZRect = _rect_plugin("yz-rect", v4ray.shape.YZRect, ("y", "z", "x"))
ZXRect = _rect_plugin("zx-rect", v4ray.shape.ZXRect, ("z", "x", "y"))


class Cuboid(ShapeType):
    KIND = "cuboid"
    FIELDS = tuple(
        FloatProperty(f"{corner} {axis}", default=d, slot=(corner,))
        for corner, d in (("p0", 0.0), ("p1", 1.0))
        for axis in "xyz"
    )

    @classmethod
    def rule(cls, data):
        return all(float(lo) < float(hi)
                   for lo, hi in zip(data[0:3], data[3:6]))

    @classmethod
    def apply(cls, data):
        return [v4ray.shape.Cuboid(data[0:3], data[3:6])]


class Mesh(ShapeType):
    """OBJ mesh by file path (backend + CLI-schema shape the reference
    editor never surfaced — reference src/json.rs:89-103 accepts
    ``{"type": "mesh", "file": ..., "model": ...}`` but v4ray_frontend
    registers only Sphere).  ``model`` selects a named object inside
    the OBJ; empty = the whole file.  Validation requires the file to
    exist so a bad path reads as an invalid node instead of a
    render-time crash."""

    KIND = "mesh"
    FIELDS = (
        StringProperty("file (.obj)", slot="file",
                       check=lambda v: bool(str(v).strip())),
        StringProperty("model (optional)", slot="model"),
    )

    @classmethod
    def rule(cls, data):
        return os.path.isfile(data[0])

    @classmethod
    def apply(cls, data):
        return [v4ray.shape.Mesh(data[0], data[1] or None)]


class ConstantMediumSphere(ShapeType):
    """Constant-density participating medium with a spherical boundary
    (reference src/hittable/constant_medium.rs; json.rs accepts a
    nested boundary shape).  The declarative field tables are flat, so
    the editor surfaces the two common boundary families as dedicated
    plugins (sphere here, cuboid below); other boundaries (rect,
    triangle, mesh) remain CLI-schema-only.  Pair with an Isotropic
    material for the classic smoke ball."""

    KIND = "constant-medium-sphere"
    FIELDS = (
        FloatProperty("center x", slot=("center",)),
        FloatProperty("center y", slot=("center",)),
        FloatProperty("center z", slot=("center",)),
        FloatProperty("radius", default=1.0, slot="radius",
                      check=lambda v: float(v) > 0),
        FloatProperty("density", default=1.0, slot="density",
                      check=lambda v: float(v) > 0),
    )

    @classmethod
    def apply(cls, data):
        return [v4ray.shape.ConstantMedium(
            v4ray.shape.Sphere(tuple(data[0:3]), data[3]), data[4]
        )]


class ConstantMediumCuboid(ShapeType):
    """Constant-density medium with a cuboid boundary (the reference
    book's smoke boxes).  See ConstantMediumSphere."""

    KIND = "constant-medium-cuboid"
    FIELDS = tuple(
        FloatProperty(f"{corner} {axis}", default=d, slot=(corner,))
        for corner, d in (("p0", 0.0), ("p1", 1.0))
        for axis in "xyz"
    ) + (
        FloatProperty("density", default=1.0, slot="density",
                      check=lambda v: float(v) > 0),
    )

    @classmethod
    def rule(cls, data):
        return all(float(lo) < float(hi)
                   for lo, hi in zip(data[0:3], data[3:6]))

    @classmethod
    def apply(cls, data):
        return [v4ray.shape.ConstantMedium(
            v4ray.shape.Cuboid(data[0:3], data[3:6]), data[6]
        )]


class Triangle(ShapeType):
    KIND = "triangle"
    FIELDS = tuple(
        FloatProperty(f"v{i} {axis}", slot=("vertices", i))
        for i in range(3)
        for axis in "xyz"
    )

    @classmethod
    def rule(cls, data):
        p = np.asarray(data, np.float64).reshape(3, 3)
        return float(np.linalg.norm(np.cross(p[1] - p[0], p[2] - p[0]))) > 0

    @classmethod
    def apply(cls, data):
        return [v4ray.shape.Triangle(np.asarray(data, np.float32).reshape(3, 3))]
