"""K5, the dense triangle sweep, and K6, the two-level cluster sweep,
with their plain PyTorch versions.

The counterpart of ``ray_tracing_tpu/ops/pallas_triangles.py``: the
CUDA kernels in ``csrc/triangles.cu`` replace ``pallas_triangles.py:
_kernel`` (K5, with its body ``_tri_sweep_body``) and
``_cluster_kernel`` / ``_cluster_kernel_paged`` (K6 and K7, one kernel
here).  Both are bound by arithmetic (~40 flops per ray-triangle pair)
and stream the (T, 16) table through shared memory; K6 loads a
``CL_CHUNK``-triangle cluster only when a ray of the block can still
hit its AABB.  :func:`triangle_sweep_plain` computes K5's function from
the candidate grids of ``geometry.triangle_sweep_t``, walking the table
in chunks with a running best so that its memory stays bounded;
:func:`cluster_sweep_plain` computes K6's with
``geometry.triangle_cluster_sweep_t`` on the scene's cluster tables.

:func:`triangle_sweep` and :func:`cluster_sweep` launch the kernels for
CUDA tensors and take the plain versions only for CPU tensors.  All are
selection only, on detached inputs; gradients flow through phase B
(ops/intersect.py).
"""

from __future__ import annotations

import ctypes

import torch

from ray_tracing_tpu_torch.models.scene import TriangleTable
from ray_tracing_tpu_torch.ops import _build
from ray_tracing_tpu_torch.ops import geometry as geo

SOURCE = _build.CSRC / "triangles.cu"
TRI_COLS = 16  # [e12(3) e13(3) n(3) g1(3) g2(3) d0]
PLAIN_CHUNK = 1024  # triangles per candidate grid of the plain version
CL_CHUNK = 128  # triangles per cluster of K6 (csrc/triangles.cu:kClusterTris)
CL_THREADS = 128  # rays per block of K6 (csrc/triangles.cu:kClusterThreads)

LAUNCHES = 0  # K5 launches since the last reset
CL_LAUNCHES = 0  # K6 launches since the last reset

_lib = None


def pack_triangle_table(tris: TriangleTable) -> torch.Tensor:
    """(T, 16) float32 rows [e12 e13 n g1 g2 d0] on the table's device
    (the row-major counterpart of pallas_triangles.py:pack_triangle_table)."""
    return torch.cat(
        [tris.e12, tris.e13, tris.sw_n, tris.sw_g1, tris.sw_g2, tris.sw_d0[:, None]], dim=1
    ).contiguous()


def pack_cluster_aabbs(tris: TriangleTable) -> torch.Tensor:
    """(Kc, 6) float32 rows [lo(3) hi(3)]: the AABB of each ``CL_CHUNK``
    consecutive triangles in sweep-origin space, Kc = ceil(T / CL_CHUNK)
    (the row-major counterpart of pallas_triangles.py:pack_chunk_aabbs).
    The last cluster may be short; K6 sweeps only its real rows, as if
    the table were zero-padded (n == 0, so det masks padding out)."""
    v0 = tris.v0 - tris.sw_origin
    corners = torch.stack([v0, v0 + tris.e12, v0 + tris.e13])  # (3, T, 3)
    t = v0.shape[0]
    pad = -t % CL_CHUNK
    kc = (t + pad) // CL_CHUNK

    def grouped(fill):
        c = torch.nn.functional.pad(corners, (0, 0, 0, pad), value=fill)
        return c.reshape(3, kc, CL_CHUNK, 3)

    lo = grouped(geo.INF).amin(dim=(0, 2))
    hi = grouped(-geo.INF).amax(dim=(0, 2))
    return torch.cat([lo, hi], dim=1).contiguous()


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


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build(SOURCE)))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = lib.triangle_sweep_launch
        fn.argtypes = [p, i, p, p, p, i, f, f, p, p, p, p]
        fn.restype = ctypes.c_int
        fn = lib.cluster_sweep_launch
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


def triangle_sweep_cuda(tri, origin, ro, rd, t_min: float, t_max: float):
    """K5 on CUDA tensors; the same outputs as :func:`triangle_sweep_plain`."""
    global LAUNCHES
    device = ro.device
    if device.type != "cuda":
        raise ValueError(f"K5 takes CUDA tensors, got {device}")
    n = ro.shape[0]
    for name, x, shape in (("ro", ro, (n, 3)), ("rd", rd, (n, 3)), ("origin", origin, (3,)),
                           ("tri", tri, (None, TRI_COLS))):
        _check(name, x, device, shape)
    if n >= 2**31 or tri.shape[0] >= 2**31:
        raise ValueError(f"K5 takes fewer than 2**31 rays and triangles, got {n}, {tri.shape[0]}")
    if tri.data_ptr() % 16:
        raise ValueError("tri must be 16-byte aligned")
    t = torch.empty((n,), dtype=torch.float32, device=device)
    idx = torch.empty((n,), dtype=torch.int32, device=device)
    found = torch.empty((n,), dtype=torch.bool, device=device)
    if n == 0:
        return t, idx, found
    fn = _library().triangle_sweep_launch
    with torch.cuda.device(device):
        err = fn(
            tri.data_ptr(), tri.shape[0], origin.data_ptr(), ro.data_ptr(), rd.data_ptr(), n,
            t_min, t_max, t.data_ptr(), idx.data_ptr(), found.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K5 launch failed: cudaError {err}")
    LAUNCHES += 1
    return t, idx, found


def triangle_sweep(tri, origin, ro, rd, t_min: float, t_max: float):
    """The triangle sweep: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if ro.device.type == "cuda":
        return triangle_sweep_cuda(tri, origin, ro, rd, t_min, t_max)
    if ro.device.type == "cpu":
        return triangle_sweep_plain(tri, origin, ro, rd, t_min, t_max)
    raise ValueError(f"the triangle sweep runs on CUDA or CPU tensors, got {ro.device}")


def cluster_sweep_cuda(tri, aabb, origin, ro, rd, t_min: float, t_max: float, stats=None):
    """K6 on CUDA tensors: ``tri`` the (T, 16) table of
    :func:`pack_triangle_table`, ``aabb`` its (Kc, 6) cluster boxes
    (:func:`pack_cluster_aabbs`).  The same outputs as
    :func:`cluster_sweep_plain` wherever both culls are conservative.
    ``stats``, an int32 tensor of three zeros on the card, takes the
    (block, cluster) loads, the (warp, cluster) sweeps and the (ray,
    cluster) pairs that the cull let through in the launch."""
    global CL_LAUNCHES
    device = ro.device
    if device.type != "cuda":
        raise ValueError(f"K6 takes CUDA tensors, got {device}")
    n = ro.shape[0]
    n_tri = tri.shape[0]
    kc = -(-n_tri // CL_CHUNK)
    for name, x, shape in (("ro", ro, (n, 3)), ("rd", rd, (n, 3)), ("origin", origin, (3,)),
                           ("tri", tri, (None, TRI_COLS)), ("aabb", aabb, (kc, 6))):
        _check(name, x, device, shape)
    if n >= 2**31 or n_tri >= 2**31:
        raise ValueError(f"K6 takes fewer than 2**31 rays and triangles, got {n}, {n_tri}")
    if tri.data_ptr() % 16:
        raise ValueError("tri must be 16-byte aligned")
    if stats is not None and (stats.device != device or stats.dtype != torch.int32
                              or stats.shape != (3,)):
        raise ValueError("stats must be an int32 tensor of shape (3,) on the rays' device")
    t = torch.empty((n,), dtype=torch.float32, device=device)
    idx = torch.empty((n,), dtype=torch.int32, device=device)
    found = torch.empty((n,), dtype=torch.bool, device=device)
    if n == 0:
        return t, idx, found
    fn = _library().cluster_sweep_launch
    with torch.cuda.device(device):
        err = fn(
            tri.data_ptr(), n_tri, aabb.data_ptr(), kc, origin.data_ptr(), ro.data_ptr(),
            rd.data_ptr(), n, t_min, t_max, t.data_ptr(), idx.data_ptr(), found.data_ptr(),
            None if stats is None else stats.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K6 launch failed: cudaError {err}")
    CL_LAUNCHES += 1
    return t, idx, found


def cluster_sweep(tris: TriangleTable, ro, rd, t_min: float, t_max: float):
    """The cluster sweep of a table with cluster tables: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if ro.device.type == "cuda":
        return cluster_sweep_cuda(pack_triangle_table(tris), pack_cluster_aabbs(tris),
                                  tris.sw_origin, ro, rd, t_min, t_max)
    if ro.device.type == "cpu":
        return cluster_sweep_plain(tris, ro, rd, t_min, t_max)
    raise ValueError(f"the cluster sweep runs on CUDA or CPU tensors, got {ro.device}")
