"""K5, the dense triangle sweep, and its plain PyTorch version.

The counterpart of ``ray_tracing_tpu/ops/pallas_triangles.py``: the
CUDA kernel in ``csrc/triangles.cu`` replaces ``pallas_triangles.py:
_kernel`` (and its body ``_tri_sweep_body``).  Every ray meets every
triangle, so it is bound by arithmetic (~40 flops per ray-triangle
pair); the (T, 16) table streams through shared memory in chunks.
:func:`triangle_sweep_plain` computes the same function from the
candidate grids of ``geometry.triangle_sweep_t``, walking the table in
chunks with a running best so that its memory stays bounded.

:func:`triangle_sweep` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors.  Both are selection only, on
detached inputs; gradients flow through phase B (ops/intersect.py).
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

LAUNCHES = 0  # kernel launches since the last reset

_lib = None


def pack_triangle_table(tris: TriangleTable) -> torch.Tensor:
    """(T, 16) float32 rows [e12 e13 n g1 g2 d0] on the table's device
    (the row-major counterpart of pallas_triangles.py:pack_triangle_table)."""
    return torch.cat(
        [tris.e12, tris.e13, tris.sw_n, tris.sw_g1, tris.sw_g2, tris.sw_d0[:, None]], dim=1
    ).contiguous()


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
        fn = lib.triangle_sweep_launch
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, p, p, p, i, f, f, p, p, p, p]
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
