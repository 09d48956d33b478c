"""Scene compiler: reference-schema JSON / programmatic API -> flat
tables, the PyTorch counterpart of ``ray_tracing_tpu/models/compiler.py``
(reference src/json.rs, src/scene.rs).

Host numpy code, copied from the JAX package so that the tables come
out identical, including the per-texture noise offsets drawn from the
builder's ``RandomState`` and the Morton order of the triangle table.
Supported: shapes sphere, moving-sphere, xy-rect, yz-rect, zx-rect,
cuboid, triangle, mesh and constant-medium (over a sphere, rect, cuboid,
triangle or mesh), each but the moving sphere with an optional
``transform`` / ``translate``; textures solid-color, checker, image and
noise; materials lambertian, metal, dielectric, diffuse-light and
isotropic; ``important`` lights.  Sphere and rect transforms go to an
instancing table; triangle transforms are baked into the vertices.  A
Morton-sorted triangle table also gets its cluster tables; the JAX
package's BVH is not built.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ray_tracing_tpu_torch.models.camera import CameraParam
from ray_tracing_tpu_torch.models.mesh import load_triangles
from ray_tracing_tpu_torch.models.scene import (
    LIGHT_RECT,
    LIGHT_SPHERE,
    LIGHT_TRIANGLE,
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_ISOTROPIC,
    MAT_LAMBERTIAN,
    MAT_METAL,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_NOISE,
    TEX_SOLID,
    LightTable,
    MaterialTable,
    MediumTable,
    RectTable,
    SceneData,
    SphereTable,
    TextureTable,
    TriangleTable,
    identity_transform_table,
    make_medium_boundary,
    pack_sweep_kernel_tables,
    pack_triangle_clusters,
    pack_triangle_sweep,
    with_phase_a_tables,
)
from ray_tracing_tpu_torch.render.renderer import RendererParam

RECT_AXIS_BY_NAME = {"xy": 0, "yz": 1, "zx": 2}

Transform = Tuple[np.ndarray, np.ndarray]  # (3x3, translate)


def _cuboid_faces(p0, p1):
    """The six rects of an axis-aligned box, exactly as reference
    cuboid.rs:30-61: (axis, a0, a1, b0, b1, k, positive) rows."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    return [
        (0, float(p0[0]), float(p1[0]), float(p0[1]), float(p1[1]), float(p0[2]), False),
        (0, float(p0[0]), float(p1[0]), float(p0[1]), float(p1[1]), float(p1[2]), True),
        (1, float(p0[1]), float(p1[1]), float(p0[2]), float(p1[2]), float(p0[0]), False),
        (1, float(p0[1]), float(p1[1]), float(p0[2]), float(p1[2]), float(p1[0]), True),
        (2, float(p0[2]), float(p1[2]), float(p0[0]), float(p1[0]), float(p0[1]), False),
        (2, float(p0[2]), float(p1[2]), float(p0[0]), float(p1[0]), float(p1[1]), True),
    ]


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit coordinates of points in [0, 1]^3 into 30-bit
    Morton codes (ray_tracing_tpu/ops/bvh.py:_morton3)."""

    def expand(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    q = np.clip((x * 1024.0), 0, 1023).astype(np.uint32)
    return (expand(q[:, 0]) << np.uint64(2)) | (expand(q[:, 1]) << np.uint64(1)) | expand(q[:, 2])


def morton_order(tri_min: np.ndarray, tri_max: np.ndarray) -> np.ndarray:
    """Stable Morton-sort permutation of triangles by AABB centroid, with
    the centroids in float64 as the JAX package's native builder
    (native/src/v4ray_native.cpp:rt_morton_order), which its compiler
    prefers: a float32 centroid lands in another 1/1024 cell for a few
    triangles of large meshes."""
    centroid = 0.5 * (tri_min.astype(np.float64) + tri_max)
    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    norm = (centroid - lo) / np.maximum(hi - lo, 1e-30)
    return np.argsort(_morton3(norm), kind="stable").astype(np.int32)


def load_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 texels of an image file.  A ``<stem>.npy`` beside
    the image holds the decoded array and is read when present, so a
    machine without Pillow can still load the repo's scenes."""
    cached = os.path.splitext(path)[0] + ".npy"
    if os.path.exists(cached):
        return np.load(cached)
    try:
        from PIL import Image as PILImage
    except ImportError as e:
        raise ImportError(
            f"decoding {path!r} needs Pillow (or a decoded {cached!r})"
        ) from e
    with PILImage.open(path) as im:
        return np.asarray(im.convert("RGB"))


class SceneBuilder:
    """Imperative scene assembly mirroring ``Scene::add`` /
    ``Scene::add_important`` (reference scene.rs:38-61), finalized by
    :meth:`build` into a :class:`SceneData` on the CPU."""

    BVH_THRESHOLD = 16  # Morton-sort the triangle table from this many triangles on

    def __init__(
        self,
        background: Sequence[float] = (0.0, 0.0, 0.0),
        environment: Sequence[float] = (0.0, 0.0, 0.0),
        noise_seed: int = 0,
    ):
        self.background = np.asarray(background, np.float32)
        self.environment = np.asarray(environment, np.float32)
        self.noise_seed = noise_seed
        self._spheres: List[dict] = []
        self._triangles: List[dict] = []
        self._rects: List[dict] = []
        self._transforms: List[Transform] = []
        self._lights: List[Tuple[int, int, int]] = []  # (kind, index, tslot)
        self._media: List[dict] = []
        self._materials: List[dict] = []
        self._textures: List[dict] = []
        self._images: List[np.ndarray] = []
        self._noise_rng = np.random.RandomState((noise_seed * 2654435761) % (2**31))

    # -- textures --
    def add_texture_solid(self, color: Sequence[float]) -> int:
        self._textures.append({"type": TEX_SOLID, "color": np.asarray(color, np.float32)})
        return len(self._textures) - 1

    def add_texture_checker(self, odd: int, even: int, density: float) -> int:
        self._textures.append(
            {"type": TEX_CHECKER, "odd": odd, "even": even, "density": float(density)}
        )
        return len(self._textures) - 1

    def add_texture_image(self, image: np.ndarray) -> int:
        """image: (H, W, 3) uint8 or float in [0, 1]."""
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        self._images.append(img[..., :3])
        self._textures.append({"type": TEX_IMAGE, "image": len(self._images) - 1})
        return len(self._textures) - 1

    def add_texture_noise(self, scale: float, depth: int) -> int:
        offset = self._noise_rng.uniform(0.0, 256.0, 3).astype(np.float32)
        self._textures.append(
            {"type": TEX_NOISE, "scale": float(scale), "depth": int(depth), "offset": offset}
        )
        return len(self._textures) - 1

    # -- materials --
    def _add_material(self, mtype: int, tex: int = 0, albedo=(0, 0, 0), fuzz=0.0, ir=1.0) -> int:
        self._materials.append(
            {
                "mtype": mtype,
                "tex": tex,
                "albedo": np.asarray(albedo, np.float32),
                "fuzz": float(fuzz),
                "ir": float(ir),
            }
        )
        return len(self._materials) - 1

    def add_lambertian(self, texture: int) -> int:
        return self._add_material(MAT_LAMBERTIAN, tex=texture)

    def add_metal(self, albedo: Sequence[float], fuzz: float) -> int:
        return self._add_material(MAT_METAL, albedo=albedo, fuzz=fuzz)

    def add_dielectric(self, ir: float) -> int:
        return self._add_material(MAT_DIELECTRIC, ir=ir)

    def add_diffuse_light(self, emit_texture: int) -> int:
        return self._add_material(MAT_DIFFUSE_LIGHT, tex=emit_texture)

    def add_isotropic(self, albedo_texture: int) -> int:
        return self._add_material(MAT_ISOTROPIC, tex=albedo_texture)

    # -- transforms --
    def _transform_slot(self, transform: Optional[Transform]) -> int:
        if transform is None:
            return 0
        self._transforms.append(
            (np.asarray(transform[0], np.float32), np.asarray(transform[1], np.float32))
        )
        return len(self._transforms)  # slot 0 is the identity

    # -- shapes --
    def add_sphere(
        self, center: Sequence[float], radius: float, material: int, *, important: bool = False,
        transform: Optional[Transform] = None,
    ) -> None:
        slot = self._transform_slot(transform)
        self._spheres.append(
            {"center": np.asarray(center, np.float32), "radius": float(radius),
             "material": material, "transform": slot, "vel": np.zeros(3, np.float32)}
        )
        if important:
            self._lights.append((LIGHT_SPHERE, len(self._spheres) - 1, slot))

    def add_sphere_moving(
        self, center0: Sequence[float], center1: Sequence[float], radius: float, material: int,
        *, time0: float = 0.0, time1: float = 1.0,
    ) -> None:
        """A sphere moving linearly from ``center0`` at shutter time
        ``time0`` to ``center1`` at ``time1``; each ray sees it at its own
        shutter time (ops/rng.py:ray_time).  It takes no transform and is
        never an important light."""
        c0 = np.asarray(center0, np.float32)
        c1 = np.asarray(center1, np.float32)
        if float(time1) == float(time0):
            raise ValueError("moving sphere needs time1 != time0")
        vel = (c1 - c0) / np.float32(time1 - time0)
        self._spheres.append(
            {"center": c0 - vel * np.float32(time0),  # the centre at time 0
             "radius": float(radius), "material": material, "transform": 0, "vel": vel}
        )

    def add_medium(
        self, density: float, material: int, *, spheres: Sequence = (), rects: Sequence = (),
        cuboids: Sequence = (), triangles=None, transform: Optional[Transform] = None,
        important: bool = False,
    ) -> None:
        """Constant medium over a boundary group (reference
        constant_medium.rs, any inner Hittable): spheres [(center,
        radius)], rects [(axis, a0, a1, b0, b1, k)], cuboids [(p0, p1)]
        (six rects each), triangles (F, 3, 3).  ``transform`` wraps the
        whole medium."""
        if important:
            # reference json.rs:692 (ConstantMedium is not Samplable)
            print("importance sampling on unsupported shape!")
        slot = self._transform_slot(transform)
        rect_rows = [tuple(float(x) if i else int(x) for i, x in enumerate(r)) for r in rects]
        for p0, p1 in cuboids:
            rect_rows += [f[:6] for f in _cuboid_faces(p0, p1)]
        tris = (np.asarray(triangles, np.float32).reshape(-1, 3, 3) if triangles is not None
                else np.zeros((0, 3, 3), np.float32))
        self._media.append({
            "niv": -1.0 / float(density),
            "material": material,
            "transform": slot,
            "spheres": [(np.asarray(c, np.float32), float(r)) for c, r in spheres],
            "rects": rect_rows,
            "tris": tris,
        })

    def add_triangle(
        self, vertices, material: int, *, normals=None, uvs=None, important: bool = False,
        transform: Optional[Transform] = None,
    ) -> None:
        v = np.asarray(vertices, np.float32)
        if normals is None:
            # face normal (p2-p1) x (p3-p2) (reference json.rs:581-586)
            n = np.cross(v[1] - v[0], v[2] - v[1])
            n = n / max(np.linalg.norm(n), 1e-30)
            normals = np.stack([n, n, n])
        n = np.asarray(normals, np.float32)
        uv = np.asarray(uvs, np.float32) if uvs is not None else np.zeros((3, 2), np.float32)
        if transform is not None:
            m, t = np.asarray(transform[0], np.float32), np.asarray(transform[1], np.float32)
            if np.linalg.det(m) < 0:
                print("warning: reflection transform on triangle flips its "
                      "winding (front_face semantics differ from reference)")
            v = v @ m.T + t
            n = n @ m.T  # normalized at hit time (ops/intersect.py)
        self._triangles.append({"v": v, "n": n, "uv": uv, "material": material})
        if important:
            self._lights.append((LIGHT_TRIANGLE, len(self._triangles) - 1, 0))

    def add_mesh_triangles(
        self, points: np.ndarray, normals: np.ndarray, uvs: np.ndarray, material: int, *,
        important: bool = False, transform: Optional[Transform] = None,
    ) -> None:
        """points, normals (F, 3, 3) and uvs (F, 3, 2) of a triangle soup."""
        v = np.asarray(points, np.float32)
        n = np.asarray(normals, np.float32)
        uv = np.asarray(uvs, np.float32)
        if transform is not None:
            m, t = np.asarray(transform[0], np.float32), np.asarray(transform[1], np.float32)
            v = v @ m.T + t
            n = n @ m.T
        base = len(self._triangles)
        for f in range(v.shape[0]):
            self._triangles.append({"v": v[f], "n": n[f], "uv": uv[f], "material": material})
        if important:
            for f in range(v.shape[0]):
                self._lights.append((LIGHT_TRIANGLE, base + f, 0))

    def add_rect(
        self,
        axis: Union[int, str],
        a0: float,
        a1: float,
        b0: float,
        b1: float,
        k: float,
        material: int,
        *,
        positive: bool = True,
        important: bool = False,
        transform: Optional[Transform] = None,
    ) -> None:
        if isinstance(axis, str):
            axis = RECT_AXIS_BY_NAME[axis]
        self._add_rect_row(axis, a0, a1, b0, b1, k, positive, material,
                           self._transform_slot(transform), important)

    def _add_rect_row(self, axis, a0, a1, b0, b1, k, positive, material, slot, important):
        self._rects.append(
            {
                "axis": int(axis),
                "a0": float(a0),
                "a1": float(a1),
                "b0": float(b0),
                "b1": float(b1),
                "k": float(k),
                "positive": bool(positive),
                "material": material,
                "transform": slot,
            }
        )
        if important:
            self._lights.append((LIGHT_RECT, len(self._rects) - 1, slot))

    def add_cuboid(
        self, p0: Sequence[float], p1: Sequence[float], material: int, *, important: bool = False,
        transform: Optional[Transform] = None,
    ) -> None:
        """Expand to 6 rects exactly as reference cuboid.rs:30-61; all six
        share one transform slot."""
        slot = self._transform_slot(transform)
        for axis, a0, a1, b0, b1, k, positive in _cuboid_faces(p0, p1):
            self._add_rect_row(axis, a0, a1, b0, b1, k, positive, material, slot, important)

    # -- finalize --
    def _checker_depth(self, idx: int, visiting: Set[int]) -> int:
        tex = self._textures[idx]
        if tex["type"] != TEX_CHECKER:
            return 0
        if idx in visiting:
            raise ValueError("texture cycle")
        visiting.add(idx)
        d = 1 + max(
            self._checker_depth(tex["odd"], visiting),
            self._checker_depth(tex["even"], visiting),
        )
        visiting.remove(idx)
        return d

    def _morton_sort(self) -> None:
        """Sort the triangle list in Morton order of the triangles' AABB
        centroids and remap the triangle lights, as the JAX package does
        before its BVH build (ray_tracing_tpu/models/compiler.py:
        _build_bvh), so triangle indices agree between the packages."""
        v = np.stack([t["v"] for t in self._triangles]).astype(np.float32)
        tmin = v.min(axis=1)
        tmax = v.max(axis=1)
        # pad degenerate (axis-flat) triangles (reference triangle.rs:37-50)
        flat = tmax - tmin == 0.0
        tmin = np.where(flat, tmin - 1e-3, tmin)
        tmax = np.where(flat, tmax + 1e-3, tmax)
        order = morton_order(tmin, tmax)
        inverse = np.empty_like(order)
        inverse[order] = np.arange(order.shape[0], dtype=np.int32)
        self._triangles = [self._triangles[i] for i in order]
        self._lights = [
            (k, int(inverse[i]) if k == LIGHT_TRIANGLE else i, t) for (k, i, t) in self._lights
        ]

    def build(self) -> SceneData:
        f32, i32 = np.float32, np.int32

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x))

        nt = len(self._triangles)
        if nt >= self.BVH_THRESHOLD:
            self._morton_sort()

        ns = len(self._spheres)
        has_motion = any(np.any(s["vel"] != 0) for s in self._spheres)
        has_transforms = any(s["transform"] for s in self._spheres)
        if has_motion and has_transforms:
            raise NotImplementedError(
                "moving spheres cannot share a sphere table with transformed spheres (motion "
                "is world-space; add the transformed shape as a separate static sphere)"
            )
        spheres = SphereTable(
            center=t(
                np.stack([s["center"] for s in self._spheres]) if ns else np.zeros((0, 3), f32)
            ),
            radius=t(np.asarray([s["radius"] for s in self._spheres], f32)),
            material=t(np.asarray([s["material"] for s in self._spheres], i32)),
            transform=t(np.asarray([s["transform"] for s in self._spheres], i32)),
            vel=t(np.stack([s["vel"] for s in self._spheres]) if ns else np.zeros((0, 3), f32)),
            has_transforms=has_transforms,
            has_motion=has_motion,
        )

        media = MediumTable(
            boundaries=tuple(
                make_medium_boundary(m["spheres"], m["rects"], m["tris"]) for m in self._media
            ),
            niv=t(np.asarray([m["niv"] for m in self._media], f32)),
            material=t(np.asarray([m["material"] for m in self._media], i32)),
            transform=tuple(m["transform"] for m in self._media),
        )

        if nt:
            v = np.stack([tr["v"] for tr in self._triangles]).astype(f32)
            n = np.stack([tr["n"] for tr in self._triangles]).astype(f32)
            uv = np.stack([tr["uv"] for tr in self._triangles]).astype(f32)
        else:
            v = np.zeros((0, 3, 3), f32)
            n = np.zeros((0, 3, 3), f32)
            uv = np.zeros((0, 3, 2), f32)
        triangles = TriangleTable(
            v0=t(v[:, 0]),
            e12=t(v[:, 1] - v[:, 0]),
            e13=t(v[:, 2] - v[:, 0]),
            n0=t(n[:, 0]),
            n1=t(n[:, 1]),
            n2=t(n[:, 2]),
            uv0=t(uv[:, 0]),
            uv1=t(uv[:, 1]),
            uv2=t(uv[:, 2]),
            material=t(np.asarray([tr["material"] for tr in self._triangles], i32)),
        )
        if nt:
            triangles = pack_sweep_kernel_tables(pack_triangle_sweep(triangles))
            if nt >= self.BVH_THRESHOLD:
                # Morton order makes consecutive triangles spatial clusters
                triangles = pack_triangle_clusters(triangles)

        nr = len(self._rects)

        def rcol(name, dtype):
            return t(np.asarray([r[name] for r in self._rects], dtype))

        rects = RectTable(
            axis=rcol("axis", i32),
            a0=rcol("a0", f32),
            a1=rcol("a1", f32),
            b0=rcol("b0", f32),
            b1=rcol("b1", f32),
            k=rcol("k", f32),
            positive=rcol("positive", bool),
            material=rcol("material", i32),
            transform=rcol("transform", i32),
            has_transforms=any(r["transform"] for r in self._rects),
        )

        if not self._materials:
            self._add_material(MAT_LAMBERTIAN, tex=0)
        if not self._textures:
            self.add_texture_solid((0.5, 0.5, 0.5))
        materials = MaterialTable(
            mtype=t(np.asarray([m["mtype"] for m in self._materials], i32)),
            tex=t(np.asarray([m["tex"] for m in self._materials], i32)),
            albedo=t(np.stack([m["albedo"] for m in self._materials])),
            fuzz=t(np.asarray([m["fuzz"] for m in self._materials], f32)),
            ir=t(np.asarray([m["ir"] for m in self._materials], f32)),
        )

        ntex = len(self._textures)
        color = np.zeros((ntex, 3), f32)
        density = np.zeros((ntex,), f32)
        child_odd = np.zeros((ntex,), i32)
        child_even = np.zeros((ntex,), i32)
        scale = np.zeros((ntex,), f32)
        noise_depth = np.zeros((ntex,), i32)
        noise_offset = np.zeros((ntex, 3), f32)
        image_idx = np.zeros((ntex,), i32)
        ttypes = np.zeros((ntex,), i32)
        for i, tex in enumerate(self._textures):
            ttypes[i] = tex["type"]
            if tex["type"] == TEX_SOLID:
                color[i] = tex["color"]
            elif tex["type"] == TEX_CHECKER:
                density[i] = tex["density"]
                child_odd[i] = tex["odd"]
                child_even[i] = tex["even"]
            elif tex["type"] == TEX_NOISE:
                scale[i] = tex["scale"]
                noise_depth[i] = tex["depth"]
                noise_offset[i] = tex["offset"]
            elif tex["type"] == TEX_IMAGE:
                image_idx[i] = tex["image"]

        if self._images:
            hmax = max(im.shape[0] for im in self._images)
            wmax = max(im.shape[1] for im in self._images)
            atlas = np.zeros((len(self._images), hmax, wmax, 3), f32)
            dims = np.zeros((len(self._images), 2), i32)
            for i, im in enumerate(self._images):
                atlas[i, : im.shape[0], : im.shape[1]] = im
                dims[i] = (im.shape[0], im.shape[1])
        else:
            atlas = np.zeros((0, 1, 1, 3), f32)
            dims = np.zeros((0, 2), i32)

        max_checker = max((self._checker_depth(i, set()) for i in range(ntex)), default=0)
        textures = TextureTable(
            ttype=t(ttypes),
            color=t(color),
            density=t(density),
            child_odd=t(child_odd),
            child_even=t(child_even),
            scale=t(scale),
            noise_depth=t(noise_depth),
            noise_offset=t(noise_offset),
            image=t(image_idx),
            images=t(atlas),
            image_dims=t(dims),
            max_checker_depth=max(max_checker, 1),
            max_noise_depth=int(noise_depth.max()) if ntex else 0,
        )

        lights = LightTable(
            kind=tuple(l[0] for l in self._lights),
            index=tuple(l[1] for l in self._lights),
            transform=tuple(l[2] for l in self._lights),
        )
        return with_phase_a_tables(SceneData(
            spheres=spheres,
            triangles=triangles,
            rects=rects,
            transforms=identity_transform_table(self._transforms),
            materials=materials,
            textures=textures,
            lights=lights,
            background=t(self.background),
            environment=t(self.environment),
            media=media,
            n_spheres=ns,
            n_triangles=nt,
            n_rects=nr,
            n_lights=len(self._lights),
            n_medium=len(self._media),
        ))


# ---------------------------------------------------------------------- #
# JSON front door (reference src/json.rs:234-250, 702-720)
# ---------------------------------------------------------------------- #


@dataclasses.dataclass
class SceneBundle:
    renderer: RendererParam
    camera: CameraParam
    scene: SceneData


class _JsonVisitor:
    """Named-def resolution with memoization and cycle detection
    (reference json.rs:252-424)."""

    def __init__(self, builder: SceneBuilder, param: dict, base_dir: str):
        self.b = builder
        self.base_dir = base_dir
        self.name_shapes = {s["name"]: s for s in param.get("shapes", []) if "name" in s}
        self.name_materials = {m["name"]: m for m in param.get("materials", []) if "name" in m}
        self.name_textures = {t["name"]: t for t in param.get("textures", []) if "name" in t}
        self.tex_memo: Dict[str, int] = {}
        self.mat_memo: Dict[str, int] = {}
        self.visiting: Set[str] = set()
        self.obj_cache: Dict[tuple, tuple] = {}

    # -- textures --
    def texture(self, spec) -> int:
        if isinstance(spec, str):
            if spec in self.tex_memo:
                return self.tex_memo[spec]
            if ("tex:" + spec) in self.visiting:
                raise ValueError(f"texture cycle through {spec!r}")
            self.visiting.add("tex:" + spec)
            idx = self._texture_def(self.name_textures[spec])
            self.visiting.remove("tex:" + spec)
            self.tex_memo[spec] = idx
            return idx
        return self._texture_def(spec)

    def _texture_def(self, d: dict) -> int:
        ty = d["type"]
        if ty == "solid-color":
            return self.b.add_texture_solid(d["color"])
        if ty == "checker":
            odd = self.texture(d["odd"])
            even = self.texture(d["even"])
            return self.b.add_texture_checker(odd, even, d["density"])
        if ty == "image":
            path = os.path.join(self.base_dir, d["file"])
            if not os.path.exists(path):
                path = d["file"]
            return self.b.add_texture_image(load_image(path))
        if ty == "noise":
            return self.b.add_texture_noise(d["scale"], d["depth"])
        raise ValueError(f"unknown texture type {ty!r}")

    # -- materials --
    def material(self, spec) -> int:
        if isinstance(spec, str):
            if spec in self.mat_memo:
                return self.mat_memo[spec]
            if ("mat:" + spec) in self.visiting:
                raise ValueError(f"material cycle through {spec!r}")
            self.visiting.add("mat:" + spec)
            idx = self._material_def(self.name_materials[spec])
            self.visiting.remove("mat:" + spec)
            self.mat_memo[spec] = idx
            return idx
        return self._material_def(spec)

    def _material_def(self, d: dict) -> int:
        ty = d["type"]
        if ty == "lambertian":
            return self.b.add_lambertian(self.texture(d["texture"]))
        if ty == "isotropic":
            return self.b.add_isotropic(self.texture(d["albedo"]))
        if ty == "dielectric":
            return self.b.add_dielectric(d["ir"])
        if ty == "diffuse-light":
            return self.b.add_diffuse_light(self.texture(d["emit"]))
        if ty == "metal":
            return self.b.add_metal(d["albedo"], d["fuzz"])
        raise ValueError(f"unknown material type {ty!r}")

    # -- shapes --
    def _shape_def(self, spec) -> dict:
        if isinstance(spec, str):
            return self.name_shapes[spec]
        return spec

    def add_object(self, obj: dict) -> None:
        if not obj.get("visible", True):
            return  # reference json.rs:685-699
        material = self.material(obj["material"])
        important = bool(obj.get("important", False))
        self.add_shape(self._shape_def(obj["shape"]), material, important)

    @staticmethod
    def _transform_of(d: dict) -> Optional[Transform]:
        if "transform" not in d and "translate" not in d:
            return None
        m = np.asarray(d.get("transform", np.eye(3)), np.float32)
        t = np.asarray(d.get("translate", np.zeros(3)), np.float32)
        return (m, t)

    def load_obj(self, file: str, model=None):
        path = os.path.join(self.base_dir, file)
        if not os.path.exists(path):
            path = file
        cache_key = (path, model if not isinstance(model, list) else tuple(model))
        if cache_key not in self.obj_cache:
            self.obj_cache[cache_key] = load_triangles(path, model)
        return self.obj_cache[cache_key]

    def add_shape(self, d: dict, material: int, important: bool) -> None:
        ty = d["type"]
        transform = self._transform_of(d)
        kw = dict(important=important, transform=transform)
        if ty == "sphere":
            self.b.add_sphere(d["center"], d["radius"], material, **kw)
        elif ty == "moving-sphere":
            # not in the reference schema (its camera's shutter jitter goes
            # unused): a linearly moving sphere, without transform or
            # importance sampling
            if transform is not None:
                raise NotImplementedError("moving-sphere does not take a transform")
            if important:
                raise NotImplementedError("moving-sphere cannot be an important light")
            self.b.add_sphere_moving(d["center0"], d["center1"], d["radius"], material,
                                     time0=d.get("time0", 0.0), time1=d.get("time1", 1.0))
        elif ty == "xy-rect":
            self.b.add_rect(0, d["x0"], d["x1"], d["y0"], d["y1"], d["z"], material,
                            positive=d.get("positive", True), **kw)
        elif ty == "yz-rect":
            self.b.add_rect(1, d["y0"], d["y1"], d["z0"], d["z1"], d["x"], material,
                            positive=d.get("positive", True), **kw)
        elif ty == "zx-rect":
            self.b.add_rect(2, d["z0"], d["z1"], d["x0"], d["x1"], d["y"], material,
                            positive=d.get("positive", True), **kw)
        elif ty == "triangle":
            self.b.add_triangle(d["vertices"], material, normals=d.get("normals"),
                                uvs=d.get("uvs"), **kw)
        elif ty == "cuboid":
            self.b.add_cuboid(d["p0"], d["p1"], material, **kw)
        elif ty == "mesh":
            pts, nrm, uvs = self.load_obj(d["file"], d.get("model"))
            self.b.add_mesh_triangles(pts, nrm, uvs, material, **kw)
        elif ty == "constant-medium":
            self._add_medium(d, material, kw)
        else:
            raise ValueError(f"unknown shape type {ty!r}")

    def _add_medium(self, d: dict, material: int, kw: dict) -> None:
        inner = self._shape_def(d["shape"])
        if self._transform_of(inner) is not None:
            raise NotImplementedError(
                "transform on a constant-medium's inner shape is not supported; "
                "put the transform on the constant-medium"
            )
        ity = inner["type"]
        if ity == "sphere":
            boundary = dict(spheres=[(inner["center"], inner["radius"])])
        elif ity == "cuboid":
            boundary = dict(cuboids=[(inner["p0"], inner["p1"])])
        elif ity in ("xy-rect", "yz-rect", "zx-rect"):
            names = {
                "xy-rect": ("x0", "x1", "y0", "y1", "z"),
                "yz-rect": ("y0", "y1", "z0", "z1", "x"),
                "zx-rect": ("z0", "z1", "x0", "x1", "y"),
            }[ity]
            boundary = dict(rects=[(RECT_AXIS_BY_NAME[ity[:2]],) + tuple(inner[k] for k in names)])
        elif ity == "triangle":
            boundary = dict(triangles=[inner["vertices"]])
        elif ity == "mesh":
            boundary = dict(triangles=self.load_obj(inner["file"], inner.get("model"))[0])
        else:
            raise ValueError(f"unknown constant-medium inner shape type {ity!r}")
        self.b.add_medium(d["density"], material, **boundary, **kw)


def build_scene(param: dict, base_dir: str = ".", noise_seed: int = 0) -> SceneBundle:
    """Dict (parsed reference-schema JSON) -> compiled SceneBundle
    (reference json.rs:702-720)."""
    builder = SceneBuilder(
        background=param.get("background", (0.0, 0.0, 0.0)),
        environment=param.get("environment", (0.0, 0.0, 0.0)),
        noise_seed=noise_seed,
    )
    visitor = _JsonVisitor(builder, param, base_dir)
    for obj in param.get("objects", []):
        visitor.add_object(obj)
    return SceneBundle(
        renderer=RendererParam.from_json(param["renderer"]),
        camera=CameraParam.from_json(param["camera"]),
        scene=builder.build(),
    )


def load_scene_json(path: str, noise_seed: int = 0) -> SceneBundle:
    with open(path) as fh:
        param = json.load(fh)
    return build_scene(param, base_dir=os.path.dirname(os.path.abspath(path)),
                       noise_seed=noise_seed)
