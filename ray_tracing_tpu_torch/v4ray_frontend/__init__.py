"""Scene-editor plugin framework (reference v4ray_frontend/): property
descriptors + stateless plugin type classes + registries.  The editor
discovers available shapes/textures/materials/cameras from these lists
(reference v4ray_frontend/__init__.py:8-11); our registries include the
backend types the reference never surfaced in its editor.

A copy of ``v4ray_frontend_tpu/__init__.py`` whose only change is its
imports."""

from typing import List, Type

from ray_tracing_tpu_torch.v4ray_frontend.camera import CameraType, PerspectiveCamera
from ray_tracing_tpu_torch.v4ray_frontend.material import (
    Dielectric,
    DiffuseLight,
    Isotropic,
    Lambertian,
    MaterialType,
    Metal,
)
from ray_tracing_tpu_torch.v4ray_frontend.shape import (
    ConstantMediumCuboid,
    ConstantMediumSphere,
    Cuboid,
    Mesh,
    MovingSphere,
    ShapeType,
    Sphere,
    Triangle,
    XYRect,
    YZRect,
    ZXRect,
)
from ray_tracing_tpu_torch.v4ray_frontend.texture import (
    Checker,
    Image,
    Noise,
    SolidColor,
    TextureType,
)

shapes: List[Type[ShapeType]] = [
    Sphere, MovingSphere, XYRect, YZRect, ZXRect, Cuboid, Triangle,
    Mesh, ConstantMediumSphere, ConstantMediumCuboid,
]
textures: List[Type[TextureType]] = [SolidColor, Checker, Image, Noise]
materials: List[Type[MaterialType]] = [
    Lambertian, Metal, Dielectric, DiffuseLight, Isotropic
]
cameras: List[Type[CameraType]] = [PerspectiveCamera]
