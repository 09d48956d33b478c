"""Thin-lens perspective camera, the PyTorch counterpart of
``ray_tracing_tpu/models/camera.py`` (reference src/camera.rs).

``Camera.build`` precomputes the viewport basis on the host in numpy,
exactly as the JAX package does, and ``get_rays`` generates whole
blocks of rays from viewport coordinates and uniforms.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .scene import SceneData, _Table
from . import geometry as geo
from . import sampling as smp
from .rng import ray_uniforms, split


@dataclasses.dataclass
class CameraParam:
    """Serde-schema-compatible camera description (reference camera.rs:16-32)."""

    look_from: Sequence[float]
    look_at: Sequence[float]
    vfov: float
    up: Optional[Sequence[float]] = None
    aspect_ratio: Optional[float] = None
    aperture: Optional[float] = None
    focus_dist: Optional[float] = None
    time0: Optional[float] = None
    time1: Optional[float] = None

    @classmethod
    def from_json(cls, d: dict) -> "CameraParam":
        return cls(
            look_from=d["look_from"],
            look_at=d["look_at"],
            vfov=d["vfov"],
            up=d.get("up"),
            aspect_ratio=d.get("aspect_ratio"),
            aperture=d.get("aperture"),
            focus_dist=d.get("focus_dist"),
            time0=d.get("time0"),
            time1=d.get("time1"),
        )


@dataclasses.dataclass(frozen=True)
class Camera(_Table):
    origin: torch.Tensor  # (3,)
    lower_left_corner: torch.Tensor  # (3,)
    horizontal: torch.Tensor  # (3,)
    vertical: torch.Tensor  # (3,)
    u: torch.Tensor  # (3,) unit
    v: torch.Tensor  # (3,) unit
    lens_radius: torch.Tensor  # ()
    time0: torch.Tensor  # ()
    time1: torch.Tensor  # ()

    @classmethod
    def build(cls, param: CameraParam, default_aspect_ratio: float) -> "Camera":
        """Host-side precompute (reference camera.rs:86-112)."""
        look_from = np.asarray(param.look_from, np.float32)
        look_at = np.asarray(param.look_at, np.float32)
        theta = float(param.vfov) * np.pi / 180.0
        h = np.tan(theta / 2.0)
        viewport_height = 2.0 * h
        aspect = (
            float(param.aspect_ratio)
            if param.aspect_ratio is not None
            else float(default_aspect_ratio)
        )
        viewport_width = aspect * viewport_height

        w = look_from - look_at
        w = w / np.linalg.norm(w)
        up = np.asarray(param.up if param.up is not None else [0.0, 1.0, 0.0], np.float32)
        u = np.cross(up, w)
        u = u / np.linalg.norm(u)
        v = np.cross(w, u)
        v = v / np.linalg.norm(v)

        focus_dist = (
            float(param.focus_dist)
            if param.focus_dist is not None
            else float(np.linalg.norm(look_from - look_at))
        )
        horizontal = u * (focus_dist * viewport_width)
        vertical = v * (focus_dist * viewport_height)
        lower_left = look_from - horizontal / 2.0 - vertical / 2.0 - w * focus_dist

        aperture = float(param.aperture) if param.aperture is not None else 0.0

        def f32(x):
            return torch.from_numpy(np.array(x, np.float32))

        return cls(
            origin=f32(look_from),
            lower_left_corner=f32(lower_left),
            horizontal=f32(horizontal),
            vertical=f32(vertical),
            u=f32(u),
            v=f32(v),
            lens_radius=f32(aperture / 2.0),
            time0=f32(param.time0 if param.time0 is not None else 0.0),
            time1=f32(param.time1 if param.time1 is not None else 0.0),
        )

    def get_rays(self, st, u_lens1, u_lens2, u_time):
        """Batched get_ray (reference camera.rs:113-129).  st: (N, 2)
        viewport coordinates in [0, 1]^2; returns (origin (N, 3),
        unit direction (N, 3), time (N,))."""
        rd = smp.random_in_unit_disk(u_lens1, u_lens2) * self.lens_radius
        offset = self.u[None, :] * rd[..., 0:1] + self.v[None, :] * rd[..., 1:2]
        source = self.origin[None, :] + offset
        target = (
            self.lower_left_corner[None, :]
            + self.horizontal[None, :] * st[..., 0:1]
            + self.vertical[None, :] * st[..., 1:2]
        )
        direction = geo.normalize(target - source)
        time = self.time0 + u_time * (self.time1 - self.time0)
        return source, direction, time


def camera_rays(camera: Camera, key, width: int, height: int, antialias: bool = True):
    """Primary rays and the trace subkey for one full-image 1-spp pass.

    The five per-ray camera uniforms (pixel jitter x2, lens x2, shutter
    time) come from the id-keyed counter hash under the first subkey of
    ``key``; the second subkey is returned for the integrator.  Returns
    ``(ro, rd, time, k_trace)`` on the camera's device.
    """
    dev = camera.origin.device
    n = width * height
    k_prim, k_trace = split(key)
    u = ray_uniforms(k_prim, torch.arange(n, device=dev), 0, 5)
    cols = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    rows = torch.arange(height - 1, -1, -1, dtype=torch.float32, device=dev)[:, None]
    if antialias:
        s = (cols + u[:, 0].reshape(height, width) - 0.5) / width
        t = (rows + u[:, 1].reshape(height, width) - 0.5) / height
    else:
        s = (cols / width).expand(height, width)
        t = (rows / height).expand(height, width)
    st = torch.stack([s.reshape(-1), t.reshape(-1)], dim=-1)
    ro, rd, time = camera.get_rays(st, u[:, 2], u[:, 3], u[:, 4])
    return ro, rd, time, k_trace


def stamp_shutter(scene: SceneData, camera: Camera) -> SceneData:
    """The scene with the camera's [time0, time1] window as its
    ``shutter`` when it has moving spheres, from which each ray's time is
    drawn per ray id (ops/rng.py:ray_time); a motionless scene as it is.
    The renderer stamps it; ray-level callers (``trace``, the gradient
    pass) read whatever ``shutter`` the scene carries."""
    if scene.has_motion:
        return dataclasses.replace(scene, shutter=torch.stack([camera.time0, camera.time1]))
    return scene
