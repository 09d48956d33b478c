"""Drop-in replacement for the reference's ``v4ray`` extension module
(reference src/py.rs:62-86, type stubs v4ray/*.pyi), backed by the
port's tracer: the counterpart of ``v4ray_tpu/__init__.py``, with
``Scene.compile`` on the port's ``SceneBuilder`` and ``Renderer`` over
the port's renderer on a ``device`` (default ``"cuda"``; without a GPU
it raises, never falling back to the CPU).

Usage matches the reference::

    import ray_tracing_tpu_torch.v4ray as v4ray
    scene = v4ray.Scene(background=(0, 0, 0), environment=(0, 0, 0))
    scene.add(v4ray.shape.Sphere((0, 0, -3), 1.0),
              v4ray.material.Lambertian(v4ray.texture.SolidColor((0.5, 0.5, 0.5))))
    renderer = v4ray.Renderer(
        v4ray.RendererParam(640, 480, 20, True),
        v4ray.PerspectiveCameraParam((0, 0, 1), (0, 0, -1), 60),
        scene,
    )
    image = await renderer.render()   # (h, w, 3) float32 numpy

Differences from the reference: ``render()`` draws from a deterministic
per-renderer key sequence (the reference uses ThreadRng): call ``i``
draws ``rng.fold_in(rng.key(0), i)``, bit-equal to the JAX package's
``jax.random.fold_in(jax.random.key(0), i)``; ``Ray`` / ``HitRecord``
batches are arbitrary-N instead of 8-lane packets.
"""

from __future__ import annotations

import asyncio
from typing import Optional, Tuple

import numpy as np

import torch

from ray_tracing_tpu_torch.models.camera import CameraParam as _CameraParam
from ray_tracing_tpu_torch.models.compiler import SceneBuilder
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.render.renderer import Renderer as _Renderer
from ray_tracing_tpu_torch.render.renderer import RendererParam as _RendererParam

from ray_tracing_tpu_torch.v4ray import material, shape, texture
from ray_tracing_tpu_torch.v4ray.core import AABB, HitRecord, Ray

__all__ = [
    "AABB",
    "HitRecord",
    "PerspectiveCameraParam",
    "Ray",
    "Renderer",
    "RendererParam",
    "Scene",
    "material",
    "shape",
    "texture",
]


class Scene:
    """reference src/scene.rs:93-119 (PyScene)."""

    def __init__(
        self,
        background: Tuple[float, float, float],
        environment: Optional[Tuple[float, float, float]] = None,
    ):
        self.background = tuple(background)
        self.environment = tuple(environment) if environment is not None else (0.0, 0.0, 0.0)
        self.objects = []  # (shape, material, important)

    def add(self, shape_obj, material_obj) -> None:
        self.objects.append((shape_obj, material_obj, False))

    def add_important(self, shape_obj, material_obj) -> None:
        """Register with light importance sampling
        (reference scene.rs:52-61)."""
        self.objects.append((shape_obj, material_obj, True))

    def compile(self, noise_seed: int = 0):
        """Build the flat-table SceneData for the tracer."""
        b = SceneBuilder(
            background=self.background,
            environment=self.environment,
            noise_seed=noise_seed,
        )
        mat_memo = {}
        for shape_obj, material_obj, important in self.objects:
            key = id(material_obj)
            if key not in mat_memo:
                mat_memo[key] = material_obj._build(b)
            shape_obj._build(b, mat_memo[key], important)
        return b.build()


class PerspectiveCameraParam(_CameraParam):
    """reference src/camera.rs:16-62 (pyclass PerspectiveCameraParam)."""

    def __init__(
        self,
        look_from: Tuple[float, float, float],
        look_at: Tuple[float, float, float],
        vfov: float,
        up: Optional[Tuple[float, float, float]] = None,
        aspect_ratio: Optional[float] = None,
        aperture: Optional[float] = None,
        focus_dist: Optional[float] = None,
        time0: Optional[float] = None,
        time1: Optional[float] = None,
    ):
        super().__init__(
            look_from=look_from,
            look_at=look_at,
            vfov=vfov,
            up=up,
            aspect_ratio=aspect_ratio,
            aperture=aperture,
            focus_dist=focus_dist,
            time0=time0,
            time1=time1,
        )


class RendererParam(_RendererParam):
    """reference src/renderer.rs:42-70."""

    def __init__(
        self,
        width: int,
        height: int,
        max_depth: Optional[int] = None,
        antialias: Optional[bool] = None,
    ):
        super().__init__(width=width, height=height, max_depth=max_depth,
                         antialias=antialias)


def resolve_device(device) -> torch.device:
    """``device`` as a torch device with its index (``"cuda"`` becomes
    the current card), raising when it is a GPU and none is present."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: no CUDA device is available "
                               "(torch.cuda.is_available() is False); pass device='cpu' "
                               "to render on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class Renderer:
    """reference src/renderer.rs:430-477 (PyRenderer): async ``render()``
    returning one (h, w, 3) float32 linear-radiance pass, rendered on
    ``device``."""

    def __init__(self, param: RendererParam, camera, scene: Scene, *, device="cuda"):
        if not isinstance(camera, _CameraParam):
            camera = PerspectiveCameraParam(**camera.__dict__)
        self._inner = _Renderer(param, camera, scene.compile(), device=resolve_device(device))
        self._iteration = 0

    def render(self):
        """Awaitable -> numpy (h, w, 3); each call is a fresh 1-spp pass
        (the reference's rayon-job unit), run in the event loop's
        default executor."""
        self._iteration += 1
        key = rng.fold_in(rng.key(0), self._iteration)

        async def run():
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(
                None, lambda: self._inner.render(key).cpu().numpy()
            )

        return run()
