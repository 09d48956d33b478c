"""Batched Ray / HitRecord / AABB value types exposed to Python, the
counterpart of the reference's numpy bridges (reference src/ray.rs:192-275,
src/hittable/py.rs:63-135, src/bvh/aabb.rs pyclass).

Batches are arbitrary-N struct-of-arrays (the reference exposes one
8-lane packet per object; lane count is a CPU-SIMD artifact the TPU
design drops).

A copy of ``v4ray_tpu/core.py`` whose only change is this docstring (it
imports nothing of either package)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


class Ray:
    """origin/direction (N, 3) f32, time (N,) f32, mask (N,) bool
    (reference src/ray.rs:18-24)."""

    def __init__(self, origin, direction, time=None, mask=None):
        self.origin = np.asarray(origin, np.float32).reshape(-1, 3)
        self.direction = np.asarray(direction, np.float32).reshape(-1, 3)
        n = self.origin.shape[0]
        self.time = (
            np.asarray(time, np.float32).reshape(-1)
            if time is not None
            else np.zeros(n, np.float32)
        )
        self.mask = (
            np.asarray(mask, bool).reshape(-1)
            if mask is not None
            else np.ones(n, bool)
        )

    def __len__(self):
        return self.origin.shape[0]

    def at(self, t):
        t = np.asarray(t, np.float32).reshape(-1, 1)
        return self.origin + self.direction * t


class HitRecord:
    """reference src/hittable/mod.rs:24-32.  Note: the reference's
    PyHitRecord mirrors ``mask`` into ``front_face`` (a bug at
    hittable/py.rs:94); here ``front_face`` is the real face flag."""

    def __init__(self, p, normal, t, uv, front_face, mask):
        self.p = np.asarray(p, np.float32).reshape(-1, 3)
        self.normal = np.asarray(normal, np.float32).reshape(-1, 3)
        self.t = np.asarray(t, np.float32).reshape(-1)
        self.uv = np.asarray(uv, np.float32).reshape(-1, 2)
        self.front_face = np.asarray(front_face, bool).reshape(-1)
        self.mask = np.asarray(mask, bool).reshape(-1)


class AABB:
    """reference src/bvh/aabb.rs:34-66."""

    def __init__(self, min: Tuple[float, float, float], max: Tuple[float, float, float]):
        self._min = tuple(float(x) for x in min)
        self._max = tuple(float(x) for x in max)

    @property
    def min(self):
        return self._min

    @property
    def max(self):
        return self._max

    def join(self, other: "AABB") -> "AABB":
        return AABB(
            tuple(map(min, self._min, other._min)),
            tuple(map(max, self._max, other._max)),
        )

    def grow(self, p) -> "AABB":
        return AABB(
            tuple(map(min, self._min, p)), tuple(map(max, self._max, p))
        )

    def size(self):
        return tuple(b - a for a, b in zip(self._min, self._max))

    def center(self):
        return tuple((a + b) / 2 for a, b in zip(self._min, self._max))

    def surface_area(self) -> float:
        """True surface area 2(wh + wd + hd) — the reference's
        ``surface_area`` returns 2*|size|^2 (a squared-diagonal proxy,
        aabb.rs:63-65); see bvh builder notes."""
        w, h, d = self.size()
        return 2.0 * (w * h + w * d + h * d)
