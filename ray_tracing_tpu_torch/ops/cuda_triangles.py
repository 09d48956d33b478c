"""K5, the dense triangle sweep, and K6, the two-level cluster sweep,
with their plain PyTorch versions.

The counterpart of ``ray_tracing_tpu/ops/pallas_triangles.py``: the
CUDA kernels in ``csrc/triangles.cu`` replace ``pallas_triangles.py:
_kernel`` (K5, with its body ``_tri_sweep_body``) and
``_cluster_kernel`` / ``_cluster_kernel_paged`` (K6 and K7, one kernel
here).  Both run one traversal: each warp of 32 rays lists the
``CL_CHUNK``-triangle clusters whose padded box some lane enters, sorts
the list by entry distance and sweeps it front to back, skipping a
cluster that no lane can still hit before its best.  The work they must
do is counted by :func:`needed_cluster_pairs`.
:func:`triangle_sweep_plain` computes K5's function from the candidate
grids of ``geometry.triangle_sweep_t``, walking the table in chunks
with a running best so that its memory stays bounded;
:func:`cluster_sweep_plain` computes K6's with
``geometry.triangle_cluster_sweep_t`` on the scene's cluster tables.

:func:`triangle_sweep` and :func:`cluster_sweep` launch the kernels for
CUDA tensors and take the plain versions only for CPU tensors; both
read the (T, 16) table and the (Kc, 6) boxes that the compiler packed
once per scene (``TriangleTable.sw_table`` / ``sw_aabb``).  All are
selection only, on detached inputs; gradients flow through phase B
(ops/intersect.py).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ray_tracing_tpu_torch.models.scene import (  # noqa: F401 (re-exported)
    KERNEL_CLUSTER,
    TriangleTable,
    pack_cluster_aabbs,
    pack_triangle_table,
)
from ray_tracing_tpu_torch.ops import _build
from ray_tracing_tpu_torch.ops import geometry as geo

SOURCE = _build.CSRC / "triangles.cu"
TRI_COLS = 16  # [e12(3) e13(3) n(3) g1(3) g2(3) d0]
PLAIN_CHUNK = 1024  # triangles per candidate grid of the plain version
CL_CHUNK = KERNEL_CLUSTER  # triangles per cluster of K5 and K6 (csrc/triangles.cu:kClusterTris)
WARP_RAYS = 32  # rays per warp, the unit of the kernels' decisions
NEEDED_CHUNK = 8192  # rays per (rays x clusters) grid of needed_cluster_pairs

# The launch counts are not locked: counts taken while several threads launch
# are approximate.
LAUNCHES = 0  # K5 launches since the last reset
CL_LAUNCHES = 0  # K6 launches since the last reset

_lib = None
_lib_lock = threading.Lock()  # one load and binding per process


def cluster_sweep_plain(tris: TriangleTable, ro, rd, t_min: float, t_max: float):
    """Nearest triangle per ray in plain PyTorch by the two-level sweep
    over the scene's own cluster tables (models/scene.py:
    pack_triangle_clusters): (t (N,) f32, idx (N,) i32, found (N,) bool).
    It equals :func:`triangle_sweep_plain` wherever the cull is
    conservative: the cull only saves work."""
    return geo.triangle_cluster_sweep_t(
        ro, rd, tris.sw_origin, tris.cl_lo, tris.cl_hi, tris.cl_e12, tris.cl_e13, tris.cl_n,
        tris.cl_g1, tris.cl_g2, tris.cl_d0, t_min, t_max,
    )


def triangle_sweep_plain(tri, origin, ro, rd, t_min: float, t_max: float):
    """Nearest triangle per ray in plain PyTorch: (t (N,) f32, idx (N,)
    i32, found (N,) bool).  The table goes in ascending chunks of
    ``PLAIN_CHUNK`` triangles; a chunk's winner replaces the running one
    only with a strictly smaller t, so the lowest index wins a tie, as
    one argmin over the whole table would."""
    n = ro.shape[0]
    ro_s = ro - origin
    m = geo.cross(ro_s, rd)
    best_t = torch.full((n,), geo.INF, dtype=torch.float32, device=ro.device)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=ro.device)
    for start in range(0, tri.shape[0], PLAIN_CHUNK):
        c = tri[start:start + PLAIN_CHUNK]
        t, mask = geo.triangle_sweep_t(
            ro_s, rd, m, c[:, 0:3], c[:, 3:6], c[:, 6:9], c[:, 9:12], c[:, 12:15], c[:, 15],
            t_min, t_max,
        )
        t = torch.where(mask, t, geo.INF)
        idx = torch.argmin(t, dim=1)
        t = torch.gather(t, 1, idx[:, None])[:, 0]
        better = t < best_t
        best_t = torch.where(better, t, best_t)
        best_idx = torch.where(better, (idx + start).to(torch.int32), best_idx)
    return best_t, best_idx, best_t < geo.INF


def needed_cluster_pairs(aabb, origin, ro, rd, t_min: float, t_hit):
    """(Kc,) int64: per cluster, the rays that enter its box (``aabb``
    rows [lo hi] in the frame of ``origin``) within [t_min, t_hit], where
    ``t_hit`` (N,) is each ray's final winner, or t_max on a miss.  These
    (ray, cluster) pairs are the work that any front-to-back sweep over
    these clusters must do, whatever implements it.  The slab test is the
    kernels' (IEEE 1/rd, NaN-propagating min/max); a NaN slab (0 * inf,
    a ray in a face's plane) counts as entered."""
    counts = torch.zeros((aabb.shape[0],), dtype=torch.int64, device=ro.device)
    lo, hi = aabb[None, :, 0:3], aabb[None, :, 3:6]
    for s in range(0, ro.shape[0], NEEDED_CHUNK):
        ro_s = (ro[s:s + NEEDED_CHUNK] - origin)[:, None, :]
        inv = (1.0 / rd[s:s + NEEDED_CHUNK])[:, None, :]
        a, b = (lo - ro_s) * inv, (hi - ro_s) * inv
        near = torch.maximum(torch.minimum(a, b).amax(dim=2),
                             torch.full_like(a[..., 0], t_min))
        far = torch.minimum(torch.maximum(a, b).amin(dim=2), t_hit[s:s + NEEDED_CHUNK, None])
        counts += (~(near > far)).sum(dim=0)
    return counts


def _library():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build(SOURCE)))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            for fn in (lib.triangle_sweep_launch, lib.cluster_sweep_launch):
                fn.argtypes = [p, i, p, i, p, p, p, i, f, f, p, p, p, p, p]
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(name, x, device, shape):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != len(shape) or any(s is not None and a != s for a, s in zip(x.shape, shape)):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(entry: str, what: str, tri, aabb, origin, ro, rd, t_min, t_max, stats):
    """Check the inputs of K5 or K6, launch ``entry`` and return (t, idx,
    found); raises on a bad input or a failed launch."""
    device = ro.device
    if device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors, got {device}")
    n = ro.shape[0]
    n_tri = tri.shape[0]
    kc = -(-n_tri // CL_CHUNK)
    for name, x, shape in (("ro", ro, (n, 3)), ("rd", rd, (n, 3)), ("origin", origin, (3,)),
                           ("tri", tri, (None, TRI_COLS)), ("aabb", aabb, (kc, 6))):
        _check(name, x, device, shape)
    if n >= 2**31 or n_tri >= 2**31:
        raise ValueError(f"{what} takes fewer than 2**31 rays and triangles, got {n}, {n_tri}")
    if tri.data_ptr() % 16 or aabb.data_ptr() % 8:
        raise ValueError("tri must be 16-byte aligned and aabb 8-byte aligned")
    if stats is not None and (stats.device != device or stats.dtype != torch.int32
                              or stats.shape != (3,)):
        raise ValueError("stats must be an int32 tensor of shape (3,) on the rays' device")
    t = torch.empty((n,), dtype=torch.float32, device=device)
    idx = torch.empty((n,), dtype=torch.int32, device=device)
    found = torch.empty((n,), dtype=torch.bool, device=device)
    if n == 0:
        return t, idx, found
    fn = getattr(_library(), entry)
    with torch.cuda.device(device):
        err = fn(
            tri.data_ptr(), n_tri, aabb.data_ptr(), kc, origin.data_ptr(), ro.data_ptr(),
            rd.data_ptr(), n, t_min, t_max, t.data_ptr(), idx.data_ptr(), found.data_ptr(),
            None if stats is None else stats.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
    return t, idx, found


def triangle_sweep_cuda(tri, aabb, origin, ro, rd, t_min: float, t_max: float, stats=None):
    """K5 on CUDA tensors: ``tri`` the (T, 16) table of
    :func:`pack_triangle_table`, any T (K5 and K6 share one traversal of
    any number of clusters; the renderer takes K5 up to
    intersect.SWEEP_MAX_TRIS and above it for a table with neither
    cluster tables nor a BVH), ``aabb`` its (Kc, 6) cluster boxes
    (:func:`pack_cluster_aabbs`).  The same
    outputs as :func:`triangle_sweep_plain`, which has no cull.
    ``stats``, an int32 tensor of three zeros on the card, takes the
    clusters the warps listed, the (warp, cluster) sweeps and the (ray,
    cluster) pairs swept by a lane that could still hit the cluster."""
    global LAUNCHES
    out = _launch("triangle_sweep_launch", "K5", tri, aabb, origin, ro, rd, t_min, t_max, stats)
    if ro.shape[0]:
        LAUNCHES += 1
    return out


def cluster_sweep_cuda(tri, aabb, origin, ro, rd, t_min: float, t_max: float, stats=None):
    """K6 on CUDA tensors, with K5's arguments and ``stats``; any number
    of clusters.  The same outputs as :func:`cluster_sweep_plain` and
    :func:`triangle_sweep_plain` wherever the plain version's cull is
    conservative."""
    global CL_LAUNCHES
    out = _launch("cluster_sweep_launch", "K6", tri, aabb, origin, ro, rd, t_min, t_max, stats)
    if ro.shape[0]:
        CL_LAUNCHES += 1
    return out



def triangle_sweep(tris: TriangleTable, ro, rd, t_min: float, t_max: float):
    """The dense triangle sweep of a table with sweep constants: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if ro.device.type == "cuda":
        return triangle_sweep_cuda(tris.sw_table, tris.sw_aabb, tris.sw_origin, ro, rd, t_min,
                                   t_max)
    if ro.device.type == "cpu":
        return triangle_sweep_plain(tris.sw_table, tris.sw_origin, ro, rd, t_min, t_max)
    raise ValueError(f"the triangle sweep runs on CUDA or CPU tensors, got {ro.device}")


def cluster_sweep(tris: TriangleTable, ro, rd, t_min: float, t_max: float):
    """The cluster sweep of a table with cluster tables: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if ro.device.type == "cuda":
        return cluster_sweep_cuda(tris.sw_table, tris.sw_aabb, tris.sw_origin, ro, rd, t_min,
                                  t_max)
    if ro.device.type == "cpu":
        return cluster_sweep_plain(tris, ro, rd, t_min, t_max)
    raise ValueError(f"the cluster sweep runs on CUDA or CPU tensors, got {ro.device}")
