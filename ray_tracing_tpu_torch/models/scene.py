"""Flat tensor scene representation, the PyTorch counterpart of
``ray_tracing_tpu/models/scene.py``.

The scene compiler (models/compiler.py) expands every JSON object into
primitive records grouped by type (spheres, axis-aligned rects), so
intersection is a dense sweep with no dynamic dispatch.  Every table is
a dataclass of tensors with a ``.to(device)`` method; static layout
facts (counts, the light list) are plain Python values.

The port renders spheres and rects.  Tables the port does not support
yet (triangles, transforms other than the identity slot, motion) are
kept, empty or at their identity values, so the tables compare field by
field with the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# material types (reference src/json.rs:198-207 AnyMaterial, kebab-case)
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4

# texture types (reference src/json.rs:147-155 AnyTexture)
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_NOISE = 3

# light (samplable) primitive kinds
LIGHT_SPHERE = 0
LIGHT_TRIANGLE = 1
LIGHT_RECT = 2


def _to(obj: Any, device) -> Any:
    """Move every tensor field of a (nested) table dataclass to ``device``."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _to(v, device)
    return dataclasses.replace(obj, **changes)


class _Table:
    def to(self, device):
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class SphereTable(_Table):
    center: torch.Tensor  # (S, 3) f32
    radius: torch.Tensor  # (S,) f32
    material: torch.Tensor  # (S,) i32 index into MaterialTable
    transform: torch.Tensor  # (S,) i32, always 0 (identity) in the port
    vel: torch.Tensor  # (S, 3) f32, always 0 (no motion) in the port

    def __len__(self):
        return self.center.shape[0]


@dataclasses.dataclass(frozen=True)
class TriangleTable(_Table):
    """Kept empty: meshes are not ported yet (ROADMAP Queue 1 item 11)."""

    v0: torch.Tensor  # (T, 3)
    e12: torch.Tensor
    e13: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor  # (T, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    material: torch.Tensor  # (T,) i32

    def __len__(self):
        return self.v0.shape[0]


@dataclasses.dataclass(frozen=True)
class RectTable(_Table):
    axis: torch.Tensor  # (R,) i32 variant: 0=xy, 1=yz, 2=zx
    a0: torch.Tensor  # (R,) f32 params in the variant's own order
    a1: torch.Tensor
    b0: torch.Tensor
    b1: torch.Tensor
    k: torch.Tensor
    positive: torch.Tensor  # (R,) bool outward-normal sign
    material: torch.Tensor  # (R,) i32
    transform: torch.Tensor  # (R,) i32, always 0 (identity) in the port

    def __len__(self):
        return self.axis.shape[0]


@dataclasses.dataclass(frozen=True)
class TransformTable(_Table):
    """Instancing transforms; the port holds only slot 0, the identity."""

    fwd: torch.Tensor  # (X, 3, 3)
    fwd_t: torch.Tensor  # (X, 3)
    inv: torch.Tensor  # (X, 3, 3)
    inv_t: torch.Tensor  # (X, 3)


@dataclasses.dataclass(frozen=True)
class MaterialTable(_Table):
    mtype: torch.Tensor  # (M,) i32
    tex: torch.Tensor  # (M,) i32 texture index (albedo / emit)
    albedo: torch.Tensor  # (M, 3) f32 metal albedo
    fuzz: torch.Tensor  # (M,) f32 metal fuzz
    ir: torch.Tensor  # (M,) f32 dielectric refraction index

    def __len__(self):
        return self.mtype.shape[0]


@dataclasses.dataclass(frozen=True)
class TextureTable(_Table):
    ttype: torch.Tensor  # (T,) i32
    color: torch.Tensor  # (T, 3) f32 solid color
    density: torch.Tensor  # (T,) f32 checker density
    child_odd: torch.Tensor  # (T,) i32 checker sub-textures
    child_even: torch.Tensor  # (T,) i32
    scale: torch.Tensor  # (T,) f32 noise scale
    noise_depth: torch.Tensor  # (T,) i32 noise turbulence octaves
    noise_offset: torch.Tensor  # (T, 3) f32 per-texture domain shift
    image: torch.Tensor  # (T,) i32 index into images
    images: torch.Tensor  # (I, Hmax, Wmax, 3) f32 texel atlas (0..1)
    image_dims: torch.Tensor  # (I, 2) i32 (height, width)
    max_checker_depth: int = 1
    max_noise_depth: int = 0

    def __len__(self):
        return self.ttype.shape[0]


@dataclasses.dataclass(frozen=True)
class LightTable(_Table):
    """Importance-sampled primitives (reference src/scene.rs:52-61); a
    static list, so kinds and indices are plain tuples."""

    kind: tuple = ()
    index: tuple = ()
    transform: tuple = ()

    def __len__(self):
        return len(self.kind)


@dataclasses.dataclass(frozen=True)
class SceneData(_Table):
    """The whole compiled scene."""

    spheres: SphereTable
    triangles: TriangleTable
    rects: RectTable
    transforms: TransformTable
    materials: MaterialTable
    textures: TextureTable
    lights: LightTable
    background: torch.Tensor  # (3,) color for rays that miss everything
    environment: torch.Tensor  # (3,) color at depth exhaustion
    n_spheres: int = 0
    n_triangles: int = 0
    n_rects: int = 0
    n_lights: int = 0
    n_medium: int = 0

    @property
    def has_lights(self) -> bool:
        return self.n_lights > 0

    @property
    def has_motion(self) -> bool:
        return bool(self.n_spheres) and bool(torch.any(self.spheres.vel != 0))

    @property
    def device(self) -> torch.device:
        return self.background.device


def _tensors(cls, src, **static):
    """Build table ``cls`` from the same-named attributes of ``src``
    (numpy arrays, or anything ``np.asarray`` takes)."""
    kw = dict(static)
    for f in dataclasses.fields(cls):
        if f.name not in kw:
            kw[f.name] = torch.from_numpy(np.array(getattr(src, f.name)))
    return cls(**kw)


def scene_from_numpy(tree) -> SceneData:
    """The port's :class:`SceneData` from a scene whose leaves are numpy
    arrays: the JAX package's ``SceneData`` after
    ``jax.tree.map(np.asarray, scene)``, or a port scene on the CPU.

    Raises ``NotImplementedError`` for what the port cannot render yet:
    triangles, constant media, instancing transforms and moving spheres.
    """
    if tree.n_triangles or tree.n_medium:
        raise NotImplementedError(
            "triangles and constant media are not ported yet, see ROADMAP"
        )
    if np.any(np.asarray(tree.spheres.transform)) or np.any(
        np.asarray(tree.rects.transform)
    ):
        raise NotImplementedError("transforms are not ported yet, see ROADMAP")
    if np.any(np.asarray(tree.spheres.vel)):
        raise NotImplementedError("moving spheres are not ported yet, see ROADMAP")
    tt = tree.textures
    lt = tree.lights
    return SceneData(
        spheres=_tensors(SphereTable, tree.spheres),
        triangles=_tensors(TriangleTable, tree.triangles),
        rects=_tensors(RectTable, tree.rects),
        transforms=_tensors(TransformTable, tree.transforms),
        materials=_tensors(MaterialTable, tree.materials),
        textures=_tensors(
            TextureTable, tt,
            max_checker_depth=int(tt.max_checker_depth),
            max_noise_depth=int(tt.max_noise_depth),
        ),
        lights=LightTable(
            kind=tuple(int(x) for x in lt.kind),
            index=tuple(int(x) for x in lt.index),
            transform=tuple(int(x) for x in lt.transform),
        ),
        background=torch.from_numpy(np.array(tree.background)),
        environment=torch.from_numpy(np.array(tree.environment)),
        n_spheres=int(tree.n_spheres),
        n_triangles=0,
        n_rects=int(tree.n_rects),
        n_lights=int(tree.n_lights),
        n_medium=0,
    )


def identity_transform_table() -> TransformTable:
    eye = torch.eye(3, dtype=torch.float32)[None]
    zero = torch.zeros((1, 3), dtype=torch.float32)
    return TransformTable(fwd=eye, fwd_t=zero, inv=eye.clone(), inv_t=zero.clone())


def empty_triangle_table() -> TriangleTable:
    z3 = torch.zeros((0, 3), dtype=torch.float32)
    z2 = torch.zeros((0, 2), dtype=torch.float32)
    return TriangleTable(
        v0=z3, e12=z3, e13=z3, n0=z3, n1=z3, n2=z3, uv0=z2, uv1=z2, uv2=z2,
        material=torch.zeros((0,), dtype=torch.int32),
    )
