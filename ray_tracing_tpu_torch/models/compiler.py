"""Scene compiler: reference-schema JSON / programmatic API -> flat
tables, the PyTorch counterpart of ``ray_tracing_tpu/models/compiler.py``
(reference src/json.rs, src/scene.rs).

Host numpy code, copied from the JAX package so that the tables come
out identical, including the per-texture noise offsets drawn from the
builder's ``RandomState``.  Supported: shapes sphere, xy-rect, yz-rect,
zx-rect and cuboid; textures solid-color, checker, image and noise;
materials lambertian, metal, dielectric and diffuse-light; ``important``
lights.  Triangles, meshes, constant media, transforms, moving spheres
and the isotropic material raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ray_tracing_tpu_torch.models.camera import CameraParam
from ray_tracing_tpu_torch.models.scene import (
    LIGHT_RECT,
    LIGHT_SPHERE,
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_LAMBERTIAN,
    MAT_METAL,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_NOISE,
    TEX_SOLID,
    LightTable,
    MaterialTable,
    RectTable,
    SceneData,
    SphereTable,
    TextureTable,
    empty_triangle_table,
    identity_transform_table,
)
from ray_tracing_tpu_torch.render.renderer import RendererParam

RECT_AXIS_BY_NAME = {"xy": 0, "yz": 1, "zx": 2}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet, see ROADMAP")


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
        self._rects: List[dict] = []
        self._lights: List[Tuple[int, int, int]] = []  # (kind, index, tslot)
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

    # -- shapes --
    def add_sphere(
        self, center: Sequence[float], radius: float, material: int, *, important: bool = False
    ) -> None:
        self._spheres.append(
            {"center": np.asarray(center, np.float32), "radius": float(radius), "material": material}
        )
        if important:
            self._lights.append((LIGHT_SPHERE, len(self._spheres) - 1, 0))

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
    ) -> None:
        if isinstance(axis, str):
            axis = RECT_AXIS_BY_NAME[axis]
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
            }
        )
        if important:
            self._lights.append((LIGHT_RECT, len(self._rects) - 1, 0))

    def add_cuboid(
        self, p0: Sequence[float], p1: Sequence[float], material: int, *, important: bool = False
    ) -> None:
        """Expand to 6 rects exactly as reference cuboid.rs:30-61."""
        for axis, a0, a1, b0, b1, k, positive in _cuboid_faces(p0, p1):
            self.add_rect(axis, a0, a1, b0, b1, k, material, positive=positive,
                          important=important)

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

    def build(self) -> SceneData:
        f32, i32 = np.float32, np.int32

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x))

        ns = len(self._spheres)
        spheres = SphereTable(
            center=t(
                np.stack([s["center"] for s in self._spheres]) if ns else np.zeros((0, 3), f32)
            ),
            radius=t(np.asarray([s["radius"] for s in self._spheres], f32)),
            material=t(np.asarray([s["material"] for s in self._spheres], i32)),
            transform=t(np.zeros((ns,), i32)),
            vel=t(np.zeros((ns, 3), f32)),
        )

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
            transform=t(np.zeros((nr,), i32)),
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
        return SceneData(
            spheres=spheres,
            triangles=empty_triangle_table(),
            rects=rects,
            transforms=identity_transform_table(),
            materials=materials,
            textures=textures,
            lights=lights,
            background=t(self.background),
            environment=t(self.environment),
            n_spheres=ns,
            n_triangles=0,
            n_rects=nr,
            n_lights=len(self._lights),
            n_medium=0,
        )


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
            raise _not_ported("the isotropic material")
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

    def add_shape(self, d: dict, material: int, important: bool) -> None:
        ty = d["type"]
        if ty in ("triangle", "mesh", "constant-medium", "moving-sphere"):
            raise _not_ported(f"shape type {ty!r}")
        if "transform" in d or "translate" in d:
            raise _not_ported("a shape transform")
        if ty == "sphere":
            self.b.add_sphere(d["center"], d["radius"], material, important=important)
        elif ty == "xy-rect":
            self.b.add_rect(0, d["x0"], d["x1"], d["y0"], d["y1"], d["z"], material,
                            positive=d.get("positive", True), important=important)
        elif ty == "yz-rect":
            self.b.add_rect(1, d["y0"], d["y1"], d["z0"], d["z1"], d["x"], material,
                            positive=d.get("positive", True), important=important)
        elif ty == "zx-rect":
            self.b.add_rect(2, d["z0"], d["z1"], d["x0"], d["x1"], d["y"], material,
                            positive=d.get("positive", True), important=important)
        elif ty == "cuboid":
            self.b.add_cuboid(d["p0"], d["p1"], material, important=important)
        else:
            raise ValueError(f"unknown shape type {ty!r}")


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
