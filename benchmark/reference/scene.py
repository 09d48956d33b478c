"""Flat tensor scene representation, the PyTorch counterpart of
``ray_tracing_tpu/models/scene.py``.

The scene compiler (models/compiler.py) expands every JSON object into
primitive records grouped by type (spheres, axis-aligned rects), so
intersection is a dense sweep with no dynamic dispatch.  Every table is
a dataclass of tensors with a ``.to(device)`` method; static layout
facts (counts, the light list) are plain Python values.

The port renders spheres (moving ones too), axis-aligned rects and
triangles, instancing transforms and constant media.  Triangle tables
carry the dense-sweep constants and, when the compiler Morton-sorts
them, the two-level cluster tables; the port's compiler builds no BVH
(ops/bvh.py), a scene from the JAX package may bring one.
The tables compare field by field with the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .geometry import rect_basis, triangle_sweep_tables

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
        elif isinstance(v, tuple) and v and all(dataclasses.is_dataclass(x) for x in v):
            changes[f.name] = tuple(_to(x, device) for x in v)
    return dataclasses.replace(obj, **changes)


class _Table:
    def to(self, device):
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class SphereTable(_Table):
    center: torch.Tensor  # (S, 3) f32
    radius: torch.Tensor  # (S,) f32
    material: torch.Tensor  # (S,) i32 index into MaterialTable
    transform: torch.Tensor  # (S,) i32 index into TransformTable (0 = identity)
    vel: torch.Tensor  # (S, 3) f32; centre at shutter time t is center + t vel
    has_transforms: bool = False  # some row has a slot other than 0
    has_motion: bool = False  # some row moves (never with has_transforms)

    def __len__(self):
        return self.center.shape[0]


@dataclasses.dataclass(frozen=True)
class TriangleTable(_Table):
    """Triangles with their transforms baked into the vertices, plus the
    dense-sweep constants of :func:`pack_triangle_sweep` (None on an
    empty table) with the CUDA sweeps' tables of
    :func:`pack_sweep_kernel_tables`, and the cluster tables of
    :func:`pack_triangle_clusters` (None unless the table was
    Morton-sorted)."""

    v0: torch.Tensor  # (T, 3)
    e12: torch.Tensor  # (T, 3) v1 - v0
    e13: torch.Tensor  # (T, 3) v2 - v0
    n0: torch.Tensor  # (T, 3) per-vertex shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor  # (T, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    material: torch.Tensor  # (T,) i32
    sw_origin: Optional[torch.Tensor] = None  # (3,) translated origin
    sw_n: Optional[torch.Tensor] = None  # (T, 3) e12 x e13
    sw_g1: Optional[torch.Tensor] = None  # (T, 3) e13 x (v0 - origin)
    sw_g2: Optional[torch.Tensor] = None  # (T, 3) e12 x (v0 - origin)
    sw_d0: Optional[torch.Tensor] = None  # (T,) (v0 - origin) . n
    # the sweep constants cut into K clusters of C consecutive triangles
    # (ops/geometry.py:triangle_cluster_sweep_t); padding rows are zero
    cl_lo: Optional[torch.Tensor] = None  # (K, 3) cluster AABB min - sw_origin
    cl_hi: Optional[torch.Tensor] = None  # (K, 3)
    cl_e12: Optional[torch.Tensor] = None  # (K, C, 3)
    cl_e13: Optional[torch.Tensor] = None  # (K, C, 3)
    cl_n: Optional[torch.Tensor] = None  # (K, C, 3); n == 0 on padding (det masks it)
    cl_g1: Optional[torch.Tensor] = None  # (K, C, 3)
    cl_g2: Optional[torch.Tensor] = None  # (K, C, 3)
    cl_d0: Optional[torch.Tensor] = None  # (K, C)
    # the CUDA sweeps' tables (ops/cuda_triangles.py), packed once per
    # scene by pack_sweep_kernel_tables; None without sweep constants
    sw_table: Optional[torch.Tensor] = None  # (T, 16) [e12 e13 n g1 g2 d0]
    sw_aabb: Optional[torch.Tensor] = None  # (ceil(T / KERNEL_CLUSTER), 6) padded boxes

    def __len__(self):
        return self.v0.shape[0]

    @property
    def has_sweep(self) -> bool:
        return self.sw_n is not None

    @property
    def has_clusters(self) -> bool:
        return self.cl_d0 is not None


def pack_triangle_sweep(tris: TriangleTable) -> TriangleTable:
    """Attach the dense-sweep triple-product constants (host, float64 then
    float32; ops/geometry.py:triangle_sweep_tables)."""
    origin, n, g1, g2, d0 = (
        torch.from_numpy(x)
        for x in triangle_sweep_tables(tris.v0.numpy(), tris.e12.numpy(), tris.e13.numpy())
    )
    return dataclasses.replace(tris, sw_origin=origin, sw_n=n, sw_g1=g1, sw_g2=g2, sw_d0=d0)


KERNEL_CLUSTER = 128  # triangles per cluster of the CUDA sweeps (csrc/triangles.cu:kClusterTris)
AABB_PAD_ULPS = 4  # outward padding of a kernel cluster box, in float32 eps of its reach


def pack_triangle_table(tris: TriangleTable) -> torch.Tensor:
    """(T, 16) float32 rows [e12 e13 n g1 g2 d0] on the table's device
    (the row-major counterpart of pallas_triangles.py:pack_triangle_table)."""
    return torch.cat(
        [tris.e12, tris.e13, tris.sw_n, tris.sw_g1, tris.sw_g2, tris.sw_d0[:, None]], dim=1
    ).contiguous()


def pack_cluster_aabbs(tris: TriangleTable) -> torch.Tensor:
    """(Kc, 6) float32 rows [lo(3) hi(3)]: the AABB of each
    ``KERNEL_CLUSTER`` consecutive triangles in sweep-origin space, Kc =
    ceil(T / KERNEL_CLUSTER), grown on every side by ``AABB_PAD_ULPS`` x
    float32 eps x the box's reach (its largest |coordinate|), a few ulps
    of it: rounding on a face cannot cull a hit (the Pallas kernel's
    pack_chunk_aabbs at cl_chunk 128 gives the boxes before padding).
    The last cluster may be short; the kernels sweep only its real rows."""
    v0 = tris.v0 - tris.sw_origin
    corners = torch.stack([v0, v0 + tris.e12, v0 + tris.e13])  # (3, T, 3)
    t = v0.shape[0]
    pad = -t % KERNEL_CLUSTER
    kc = (t + pad) // KERNEL_CLUSTER

    def grouped(fill):
        c = torch.nn.functional.pad(corners, (0, 0, 0, pad), value=fill)
        return c.reshape(3, kc, KERNEL_CLUSTER, 3)

    lo = grouped(float("inf")).amin(dim=(0, 2))
    hi = grouped(-float("inf")).amax(dim=(0, 2))
    reach = torch.maximum(lo.abs(), hi.abs()).amax(dim=1, keepdim=True)
    margin = AABB_PAD_ULPS * float(np.finfo(np.float32).eps) * reach
    return torch.cat([lo - margin, hi + margin], dim=1).contiguous()


def pack_sweep_kernel_tables(tris: TriangleTable) -> TriangleTable:
    """Attach the CUDA sweeps' (T, 16) table and (Kc, 6) padded cluster
    boxes to a table with sweep constants, once per scene; ``.to``
    moves them with the rest."""
    return dataclasses.replace(tris, sw_table=pack_triangle_table(tris),
                               sw_aabb=pack_cluster_aabbs(tris))


CLUSTER_SIZE = 4096  # triangles per cluster of the two-level sweep


def pack_triangle_clusters(tris: TriangleTable) -> TriangleTable:
    """Cut a Morton-sorted, sweep-packed table into ``CLUSTER_SIZE``
    consecutive triangles per cluster (host, numpy; the counterpart of
    ray_tracing_tpu/models/scene.py:pack_triangle_clusters).  Padding
    rows are zero, so n == 0 and their det masks them out.  The cluster
    AABBs grow flat axes by 1e-3, as the BVH build does, and are stored
    translated by ``sw_origin``, the frame of the sweep constants."""
    if not tris.has_sweep:
        raise ValueError("pack_triangle_clusters needs sweep constants first")
    n, c = len(tris), CLUSTER_SIZE
    if n == 0:
        return tris
    k = -(-n // c)
    pad = k * c - n

    def padded(x, fill=0.0):
        x = np.asarray(x, np.float32)
        if pad:
            x = np.concatenate([x, np.full((pad,) + x.shape[1:], fill, np.float32)])
        return x.reshape((k, c) + x.shape[1:])

    v0 = tris.v0.numpy()
    v1 = v0 + tris.e12.numpy()
    v2 = v0 + tris.e13.numpy()
    origin = tris.sw_origin.numpy()
    lo = np.minimum(np.minimum(v0, v1), v2) - origin
    hi = np.maximum(np.maximum(v0, v1), v2) - origin
    flat = hi - lo == 0.0
    lo = np.where(flat, lo - 1e-3, lo)
    hi = np.where(flat, hi + 1e-3, hi)
    t = torch.from_numpy
    return dataclasses.replace(
        tris,
        cl_lo=t(padded(lo, np.inf).min(axis=1)), cl_hi=t(padded(hi, -np.inf).max(axis=1)),
        cl_e12=t(padded(tris.e12)), cl_e13=t(padded(tris.e13)), cl_n=t(padded(tris.sw_n)),
        cl_g1=t(padded(tris.sw_g1)), cl_g2=t(padded(tris.sw_g2)), cl_d0=t(padded(tris.sw_d0)),
    )


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
    transform: torch.Tensor  # (R,) i32 index into TransformTable (0 = identity)
    has_transforms: bool = False  # some row has a slot other than 0

    def __len__(self):
        return self.axis.shape[0]


@dataclasses.dataclass(frozen=True)
class TransformTable(_Table):
    """Affine instancing transforms x -> fwd x + fwd_t (reference
    transform.rs:16-31); slot 0 is the identity."""

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
class MediumBoundary(_Table):
    """The boundary primitives of one constant medium (reference
    constant_medium.rs:41-60 takes any inner shape; a cuboid becomes its
    six rects).  The counts per kind are static."""

    sph_center: torch.Tensor  # (Bs, 3)
    sph_radius: torch.Tensor  # (Bs,)
    rect_axis: torch.Tensor  # (Br,) i32 variant 0=xy/1=yz/2=zx
    rect_a0: torch.Tensor
    rect_a1: torch.Tensor
    rect_b0: torch.Tensor
    rect_b1: torch.Tensor
    rect_k: torch.Tensor
    tri_v0: torch.Tensor  # (Bt, 3)
    tri_e12: torch.Tensor
    tri_e13: torch.Tensor
    n_sph: int = 0
    n_rect: int = 0
    n_tri: int = 0


def make_medium_boundary(spheres=(), rects=(), tris=()) -> MediumBoundary:
    """spheres: [(center, radius)]; rects: [(axis, a0, a1, b0, b1, k)];
    tris: (Bt, 3, 3) vertices."""
    f32 = np.float32
    t = torch.from_numpy
    sc = np.stack([np.asarray(c, f32) for c, _ in spheres]) if spheres else np.zeros((0, 3), f32)
    sr = np.asarray([r for _, r in spheres], f32)
    ra = np.asarray([r[0] for r in rects], np.int32)
    rf = [np.asarray([r[i] for r in rects], f32) for i in range(1, 6)]
    tv = np.asarray(tris, f32).reshape(-1, 3, 3) if len(tris) else np.zeros((0, 3, 3), f32)
    return MediumBoundary(
        sph_center=t(sc), sph_radius=t(sr),
        rect_axis=t(ra), rect_a0=t(rf[0]), rect_a1=t(rf[1]),
        rect_b0=t(rf[2]), rect_b1=t(rf[3]), rect_k=t(rf[4]),
        tri_v0=t(np.ascontiguousarray(tv[:, 0])), tri_e12=t(tv[:, 1] - tv[:, 0]),
        tri_e13=t(tv[:, 2] - tv[:, 0]),
        n_sph=len(spheres), n_rect=len(rects), n_tri=tv.shape[0],
    )


@dataclasses.dataclass(frozen=True)
class MediumTable(_Table):
    """All constant media: one :class:`MediumBoundary` per medium, its
    ``neg_inv_density``, its phase-function material and the static
    transform slot around the whole medium."""

    boundaries: tuple
    niv: torch.Tensor  # (M,) f32 -1 / density
    material: torch.Tensor  # (M,) i32
    transform: tuple

    def __len__(self):
        return len(self.boundaries)


@dataclasses.dataclass(frozen=True)
class LightTable(_Table):
    """Importance-sampled primitives (reference src/scene.rs:52-61); a
    static list, so kinds and indices are plain tuples."""

    kind: tuple = ()
    index: tuple = ()
    transform: tuple = ()

    def __len__(self):
        return len(self.kind)


SPHERE_COLS = 4  # [cx cy cz r]
RECT_COLS = 14  # [ua(3) ub(3) uk(3) a0 a1 b0 b1 k]
TF_COLS = 12  # [inv(9) inv_t(3)] after the base columns of a transformed table
MOTION_COLS = 3  # [vx vy vz] after the base columns of a moving sphere table
META_COLS = 2  # [slot, row] as int32 bits after a phase-A kernel row


@dataclasses.dataclass(frozen=True)
class PhaseATables(_Table):
    """Phase A's sphere and rect tables in the layout of the kernels K1,
    K3 and K4 (csrc/intersect.cu) and of ops/cuda_intersect.py:
    phase_a_plain, derived from :func:`pack_primitive_tables` by
    :func:`pack_phase_a_tables`.

    A row is its table's base columns ([cx cy cz r], moving [cx cy cz r
    vx vy vz], or the rect's 14) followed by two int32 words stored as
    float32 bits: its transform slot (a row of ``slots``) and its row in
    the scene's own table.  A transformed table's rows are ordered by slot
    (ties in row order), so one object ray per ray and slot serves a run
    of rows; ``slots`` holds each distinct [inv(9) inv_t(3)] of the
    transformed tables once.  An untransformed table keeps its row order
    and slot 0, which nothing reads."""

    sph: torch.Tensor  # (S, 4 or 7 + META_COLS) f32
    rect: torch.Tensor  # (R, RECT_COLS + META_COLS) f32
    slots: torch.Tensor  # (X, TF_COLS) f32; X = 0 without transforms
    sph_tf: bool = False
    rect_tf: bool = False
    sph_motion: bool = False

    @property
    def transformed(self) -> bool:
        return self.sph_tf or self.rect_tf


def pack_primitive_tables(scene: "SceneData"):
    """Spheres (S, 4) = [cx cy cz r] and rects (R, 14) = [ua(3) ub(3)
    uk(3) a0 a1 b0 b1 k], float32 and contiguous, on the scene's device
    (the counterpart of pallas_intersect.py:pack_primitive_tables).  A
    table with instancing transforms gets [inv(9) inv_t(3)] on every
    row: (S, 16), (R, 26); a moving sphere table gets [vx vy vz]: (S, 7)."""
    sp, rc = scene.spheres, scene.rects
    tf = scene.transforms
    sph = torch.cat([sp.center, sp.radius[:, None]], dim=1)
    if sp.has_transforms and sp.has_motion:
        raise ValueError("moving spheres never share a table with transformed spheres")
    if sp.has_transforms:
        slot = sp.transform.long()
        sph = torch.cat([sph, tf.inv[slot].reshape(-1, 9), tf.inv_t[slot]], dim=1)
    elif sp.has_motion:
        sph = torch.cat([sph, sp.vel], dim=1)
    ua, ub, uk = rect_basis(rc.axis)
    bounds = torch.stack([rc.a0, rc.a1, rc.b0, rc.b1, rc.k], dim=1)
    rect = torch.cat([ua, ub, uk, bounds], dim=1)
    if rc.has_transforms:
        slot = rc.transform.long()
        rect = torch.cat([rect, tf.inv[slot].reshape(-1, 9), tf.inv_t[slot]], dim=1)
    return sph.contiguous(), rect.contiguous()


def pack_phase_a_tables(sph: torch.Tensor, rect: torch.Tensor) -> PhaseATables:
    """The kernels' layout (:class:`PhaseATables`) of the per-row tables
    of :func:`pack_primitive_tables`, on their device.  Transforms are
    told apart by their bits, so two rows share a slot exactly when their
    object rays are the same bits."""
    sph_motion = sph.shape[1] == SPHERE_COLS + MOTION_COLS
    sph_tf = sph.shape[1] == SPHERE_COLS + TF_COLS
    rect_tf = rect.shape[1] == RECT_COLS + TF_COLS
    if sph.shape[1] not in (SPHERE_COLS, SPHERE_COLS + TF_COLS, SPHERE_COLS + MOTION_COLS) \
            or rect.shape[1] not in (RECT_COLS, RECT_COLS + TF_COLS):
        raise ValueError(f"phase-A tables have (S, 4, 16 or 7) and (R, 14 or 26) columns, got "
                         f"{tuple(sph.shape)} and {tuple(rect.shape)}")
    tables = ((sph, SPHERE_COLS, sph_tf), (rect, RECT_COLS, rect_tf))
    tf_rows = [t[:, cols:].contiguous().view(torch.int32) for t, cols, tf in tables if tf]
    slots = torch.zeros((0, TF_COLS), dtype=torch.float32, device=sph.device)
    slot_of = [None, None]
    if tf_rows:
        bits, inverse = torch.unique(torch.cat(tf_rows), dim=0, return_inverse=True)
        slots = bits.view(torch.float32)
        inverse = inverse.to(torch.int32)
        if sph_tf:
            slot_of[0], inverse = inverse[:sph.shape[0]], inverse[sph.shape[0]:]
        if rect_tf:
            slot_of[1] = inverse

    def grouped(table, cols, slot):
        n = table.shape[0]
        row = torch.arange(n, dtype=torch.int32, device=table.device)
        base = table if slot is None else table[:, :cols]
        if slot is None:
            slot = torch.zeros_like(row)
        else:
            order = torch.argsort(slot, stable=True)
            base, slot, row = base[order], slot[order], row[order]
        meta = torch.stack([slot, row], dim=1).contiguous().view(torch.float32)
        return torch.cat([base, meta], dim=1).contiguous()

    return PhaseATables(
        sph=grouped(sph, SPHERE_COLS, slot_of[0]), rect=grouped(rect, RECT_COLS, slot_of[1]),
        slots=slots.contiguous(), sph_tf=sph_tf, rect_tf=rect_tf, sph_motion=sph_motion,
    )


def with_phase_a_tables(scene: "SceneData") -> "SceneData":
    """``scene`` with its phase-A tables packed (once per scene; ``.to``
    moves them with the rest)."""
    return dataclasses.replace(
        scene, phase_a=pack_phase_a_tables(*pack_primitive_tables(scene)))


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
    media: MediumTable
    n_spheres: int = 0
    n_triangles: int = 0
    n_rects: int = 0
    n_lights: int = 0
    n_medium: int = 0
    # the shutter window [time0, time1] of a scene with moving spheres
    # (models/camera.py:stamp_shutter); each ray's time is drawn per ray
    # id from it (ops/rng.py:ray_time)
    shutter: Optional[torch.Tensor] = None  # (2,) f32
    # phase A's sphere and rect tables in the kernels' layout, packed once
    # per scene by with_phase_a_tables (the compiler and scene_from_numpy)
    phase_a: Optional[PhaseATables] = None
    # the triangles' BVH (ops/bvh.py:BVHTable), walked when the table has
    # neither sweep nor cluster tables; from the JAX package's scene
    # (scene_from_numpy) or SceneBuilder.build(bvh=True)
    bvh: Optional["BVHTable"] = None

    @property
    def has_lights(self) -> bool:
        return self.n_lights > 0

    @property
    def has_motion(self) -> bool:
        return self.n_spheres > 0 and self.spheres.has_motion

    @property
    def device(self) -> torch.device:
        return self.background.device


def identity_transform_table(extra=None) -> TransformTable:
    """A transform table whose slot 0 is the identity; ``extra`` is a list
    of (fwd 3x3, translate 3) pairs appended after it, each inverted in
    float64 as the 4x4 affine map (reference transform.rs:18-22)."""
    fwds = [np.eye(3, dtype=np.float32)]
    ts = [np.zeros(3, dtype=np.float32)]
    invs = [np.eye(3, dtype=np.float32)]
    inv_ts = [np.zeros(3, dtype=np.float32)]
    for fwd, t in extra or []:
        fwd = np.asarray(fwd, dtype=np.float32)
        t = np.asarray(t, dtype=np.float32)
        m = np.eye(4, dtype=np.float64)
        m[:3, :3] = fwd
        m[:3, 3] = t
        mi = np.linalg.inv(m)
        fwds.append(fwd)
        ts.append(t)
        invs.append(mi[:3, :3].astype(np.float32))
        inv_ts.append(mi[:3, 3].astype(np.float32))
    return TransformTable(
        fwd=torch.from_numpy(np.stack(fwds)),
        fwd_t=torch.from_numpy(np.stack(ts)),
        inv=torch.from_numpy(np.stack(invs)),
        inv_t=torch.from_numpy(np.stack(inv_ts)),
    )
