"""Shape classes of the ``v4ray.shape`` submodule (reference
src/py.rs:70-76, src/hittable/*.rs pyclasses), plus the shapes the
reference only reaches through JSON.

Each shape knows how to register itself into a SceneBuilder
(``_build``) and exposes the reference's ``bounding_box`` / batched
``hit`` methods for direct use from Python.

USER-DEFINED SHAPES: ``Scene.add`` is duck-typed on ``_build(builder,
material, important)`` — any object implementing it participates in
rendering by composing builder primitives (spheres, rects, triangles,
media), exactly like ConstantMedium/Mesh below do.  This is the
TPU-native answer to the reference's ``PyHittable`` duck-typing
(src/hittable/py.rs:142-153): a per-ray Python ``hit()`` callback is
incompatible with a traced wavefront — and the reference's own
conversion is ``todo!()`` for everything but Sphere, so it never
rendered either — whereas table composition actually renders, at full
kernel speed (tests/test_v4ray_api.py::test_user_defined_shape).

The counterpart of ``v4ray_tpu/shape.py``: ``Sphere.hit`` computes with
the port's ``ops/geometry.py`` on a ``device`` (default ``"cuda"``),
numpy in and out, and ``Mesh`` and ``ConstantMedium`` load OBJ files
through the port's ``models/mesh.py``; the rest is a copy."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ray_tracing_tpu_torch.v4ray.core import AABB, HitRecord, Ray

EPSILON = 1e-3


class Sphere:
    """reference src/hittable/sphere.rs:25-180."""

    def __init__(self, center: Tuple[float, float, float], radius: float):
        self.center = tuple(float(x) for x in center)
        self.radius = float(radius)

    def bounding_box(self, time0: float = 0.0, time1: float = 0.0) -> AABB:
        c, r = np.asarray(self.center), self.radius
        return AABB(tuple(c - r), tuple(c + r))

    def hit(self, ray: Ray, t_min, t_max, *, device="cuda") -> HitRecord:
        """The batch's hits on this sphere, computed on ``device``; numpy
        in and out."""
        import torch

        from ray_tracing_tpu_torch.ops import geometry as geo

        def f32(x):
            return torch.as_tensor(np.array(x, np.float32), device=device)

        ro = f32(ray.origin)
        rd = f32(ray.direction)
        center = f32(self.center)
        radius = f32(self.radius)
        t_min = f32(np.broadcast_to(t_min, (len(ray),)))
        t_max = f32(np.broadcast_to(t_max, (len(ray),)))
        t, hit = geo.sphere_t(ro, rd, center, radius, t_min, t_max)
        p = ro + rd * t[:, None]
        outward = geo.normalize(p - center)
        front, normal = geo.face_normal(rd, outward)
        uv = geo.sphere_uv(outward)
        mask = hit.cpu().numpy() & ray.mask
        return HitRecord(
            p=p.cpu().numpy(), normal=normal.cpu().numpy(), t=t.cpu().numpy(),
            uv=uv.cpu().numpy(), front_face=front.cpu().numpy(), mask=mask,
        )

    def _build(self, b, material: int, important: bool) -> None:
        b.add_sphere(self.center, self.radius, material, important=important)


class MovingSphere:
    """Linearly moving sphere (true motion blur — superset: the
    reference's camera jitters ray time, src/camera.rs:113-129, but no
    shape consumes it).  At ``center0`` at shutter time ``time0`` and
    ``center1`` at ``time1``."""

    def __init__(self, center0, center1, radius: float,
                 time0: float = 0.0, time1: float = 1.0):
        self.center0 = tuple(float(x) for x in center0)
        self.center1 = tuple(float(x) for x in center1)
        self.radius = float(radius)
        self.time0 = float(time0)
        self.time1 = float(time1)

    def bounding_box(self, time0: float = 0.0, time1: float = 0.0) -> AABB:
        c0, c1 = np.asarray(self.center0), np.asarray(self.center1)
        r = self.radius
        lo = np.minimum(c0, c1) - r
        hi = np.maximum(c0, c1) + r
        return AABB(tuple(lo), tuple(hi))

    def _build(self, b, material: int, important: bool) -> None:
        if important:
            raise NotImplementedError(
                "a moving sphere cannot be an important light"
            )
        b.add_sphere_moving(
            self.center0, self.center1, self.radius, material,
            time0=self.time0, time1=self.time1,
        )


class Triangle:
    """reference src/hittable/triangle.rs."""

    def __init__(self, vertices, normals=None, uvs=None):
        self.vertices = np.asarray(vertices, np.float32).reshape(3, 3)
        self.normals = (
            np.asarray(normals, np.float32).reshape(3, 3)
            if normals is not None else None
        )
        self.uvs = (
            np.asarray(uvs, np.float32).reshape(3, 2) if uvs is not None else None
        )

    def bounding_box(self, time0: float = 0.0, time1: float = 0.0) -> AABB:
        lo = self.vertices.min(axis=0) - 0.0
        hi = self.vertices.max(axis=0)
        # pad degenerate axes by EPSILON (reference triangle.rs:37-50)
        flat = hi - lo == 0.0
        lo = np.where(flat, lo - EPSILON, lo)
        hi = np.where(flat, hi + EPSILON, hi)
        return AABB(tuple(lo), tuple(hi))

    def _build(self, b, material: int, important: bool) -> None:
        b.add_triangle(self.vertices, material, normals=self.normals,
                       uvs=self.uvs, important=important)


class _Rect:
    axis: int

    def __init__(self, a0, a1, b0, b1, k, positive: bool = True):
        self.a0, self.a1 = float(a0), float(a1)
        self.b0, self.b1 = float(b0), float(b1)
        self.k = float(k)
        self.positive = bool(positive)

    def _build(self, b, material: int, important: bool) -> None:
        b.add_rect(self.axis, self.a0, self.a1, self.b0, self.b1, self.k,
                   material, positive=self.positive, important=important)


class XYRect(_Rect):
    """reference src/hittable/aa_rect.rs (XYRect)."""

    axis = 0


class YZRect(_Rect):
    axis = 1


class ZXRect(_Rect):
    axis = 2


class Cuboid:
    """reference src/hittables/cuboid.rs."""

    def __init__(self, p0, p1):
        self.p0 = tuple(float(x) for x in p0)
        self.p1 = tuple(float(x) for x in p1)

    def _build(self, b, material: int, important: bool) -> None:
        b.add_cuboid(self.p0, self.p1, material, important=important)


class ConstantMedium:
    """reference src/hittable/constant_medium.rs — generic over any
    inner shape (sphere, rect, cuboid, triangle, mesh), matching the
    Rust `ConstantMedium<O>`'s `Hittable`-generic boundary."""

    def __init__(self, boundary, density: float):
        self.boundary = boundary
        self.density = float(density)

    def _build(self, b, material: int, important: bool) -> None:
        s = self.boundary
        kw = {"important": important}
        if isinstance(s, Sphere):
            b.add_medium(self.density, material,
                         spheres=[(s.center, s.radius)], **kw)
        elif isinstance(s, _Rect):
            b.add_medium(self.density, material,
                         rects=[(s.axis, s.a0, s.a1, s.b0, s.b1, s.k)], **kw)
        elif isinstance(s, Cuboid):
            b.add_medium(self.density, material,
                         cuboids=[(s.p0, s.p1)], **kw)
        elif isinstance(s, Triangle):
            b.add_medium(self.density, material,
                         triangles=s.vertices[None], **kw)
        elif isinstance(s, Mesh):
            from ray_tracing_tpu_torch.models.mesh import load_triangles

            pts, _, _ = load_triangles(s.file, s.model)
            b.add_medium(self.density, material, triangles=pts, **kw)
        else:
            raise TypeError(
                f"unsupported constant-medium boundary {type(s).__name__}"
            )


class Mesh:
    """reference src/hittables/obj.rs via an OBJ file path."""

    def __init__(self, file: str, model=None):
        self.file = file
        self.model = model

    def _build(self, b, material: int, important: bool) -> None:
        from ray_tracing_tpu_torch.models.mesh import load_triangles

        pts, nrm, uvs = load_triangles(self.file, self.model)
        b.add_mesh_triangles(pts, nrm, uvs, material, important=important)
