"""K1, the phase-A intersection kernel, and its plain PyTorch version.

The counterpart of ``ray_tracing_tpu/ops/pallas_intersect.py``: the
CUDA kernel in ``csrc/intersect.cu`` replaces ``pallas_intersect.py:
_kernel`` in its plain variant (no transforms, no motion).  It is bound
by its 36 B/ray of device-memory traffic (rays in, winner out) against
~20 flops per primitive, and keeps the primitive tables in shared
memory.  :func:`phase_a_plain` computes the same function from the
candidate grids of ops/intersect.py.

:func:`phase_a` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors.  The kernel is built with ``nvcc``
for ``sm_90a`` at first use, from the source in this package, into
``build/kernels/`` beside the package, keyed by a hash of the source
and flags; it is loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from ray_tracing_tpu_torch.models.scene import SceneData
from ray_tracing_tpu_torch.ops import geometry as geo
from ray_tracing_tpu_torch.ops.intersect import (
    INF,
    KIND_NONE,
    KIND_RECT,
    KIND_SPHERE,
    _rect_phase_a,
    _sphere_phase_a,
)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "intersect.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)
SPHERE_COLS = 4
RECT_COLS = 14
SMEM_LIMIT = 48 * 1024  # default dynamic shared memory a block may take

LAUNCHES = 0  # kernel launches since the last reset

_lib = None


def pack_primitive_tables(scene: SceneData):
    """Spheres (S, 4) = [cx cy cz r] and rects (R, 14) = [ua(3) ub(3)
    uk(3) a0 a1 b0 b1 k], float32 and contiguous, on the scene's device
    (the counterpart of pallas_intersect.py:pack_primitive_tables)."""
    sp, rc = scene.spheres, scene.rects
    sph = torch.cat([sp.center, sp.radius[:, None]], dim=1)
    ua, ub, uk = geo.rect_basis(rc.axis)
    bounds = torch.stack([rc.a0, rc.a1, rc.b0, rc.b1, rc.k], dim=1)
    rect = torch.cat([ua, ub, uk, bounds], dim=1)
    return sph.contiguous(), rect.contiguous()


def phase_a_plain(sph, rect, ro, rd, t_min: float, t_max: float):
    """Nearest sphere/rect hit per ray in plain PyTorch: (t (N,) f32,
    kind (N,) i32 with -1 on a miss, idx (N,) i32).  Spheres first, then
    rects; a kind wins only with a strictly smaller t, and within a kind
    the lowest index wins a tie."""
    n = ro.shape[0]
    best_t = torch.full((n,), INF, dtype=torch.float32, device=ro.device)
    best_kind = torch.full((n,), KIND_NONE, dtype=torch.int32, device=ro.device)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=ro.device)
    for kind, table, sweep in (
        (KIND_SPHERE, sph, _sphere_phase_a),
        (KIND_RECT, rect, _rect_phase_a),
    ):
        if table.shape[0] == 0:
            continue
        t, mask = sweep(table, ro, rd, t_min, t_max)
        t = torch.where(mask, t, INF)
        idx = torch.argmin(t, dim=1)
        t = torch.gather(t, 1, idx[:, None])[:, 0]
        better = t < best_t
        best_t = torch.where(better, t, best_t)
        best_kind = torch.where(better, kind, best_kind)
        best_idx = torch.where(better, idx.to(torch.int32), best_idx)
    return best_t, best_kind, best_idx


def build() -> Path:
    """Compile csrc/intersect.cu into a shared library (once per source
    and flags) and return its path.  Raises if the build fails."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"intersect_{digest}.so"
    if lib.exists():
        return lib
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("building K1 needs the CUDA toolkit (nvcc); none was found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
    cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.phase_a_launch
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, p, i, p, p, i, f, f, p, p, p, p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name, x, device, cols):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != cols:
        raise ValueError(f"{name} must have shape (n, {cols}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def phase_a_cuda(sph, rect, ro, rd, t_min: float, t_max: float):
    """K1 on CUDA tensors; the same outputs as :func:`phase_a_plain`."""
    global LAUNCHES
    device = ro.device
    if device.type != "cuda":
        raise ValueError(f"K1 takes CUDA tensors, got {device}")
    for name, x, cols in (("ro", ro, 3), ("rd", rd, 3), ("sph", sph, SPHERE_COLS),
                          ("rect", rect, RECT_COLS)):
        _check(name, x, device, cols)
    n = ro.shape[0]
    if rd.shape[0] != n:
        raise ValueError(f"ro has {n} rays, rd {rd.shape[0]}")
    if n >= 2**31:
        raise ValueError(f"K1 takes fewer than 2**31 rays, got {n}")
    smem = 4 * (SPHERE_COLS * sph.shape[0] + RECT_COLS * rect.shape[0])
    if smem > SMEM_LIMIT:
        raise ValueError(f"primitive tables take {smem} B, over K1's {SMEM_LIMIT} B")
    t = torch.empty((n,), dtype=torch.float32, device=device)
    kind = torch.empty((n,), dtype=torch.int32, device=device)
    idx = torch.empty((n,), dtype=torch.int32, device=device)
    if n == 0:
        return t, kind, idx
    fn = _library().phase_a_launch
    with torch.cuda.device(device):
        err = fn(
            sph.data_ptr(), sph.shape[0], rect.data_ptr(), rect.shape[0],
            ro.data_ptr(), rd.data_ptr(), n, t_min, t_max,
            t.data_ptr(), kind.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    LAUNCHES += 1
    return t, kind, idx


def phase_a(sph, rect, ro, rd, t_min: float, t_max: float):
    """Phase A: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if ro.device.type == "cuda":
        return phase_a_cuda(sph, rect, ro, rd, t_min, t_max)
    if ro.device.type == "cpu":
        return phase_a_plain(sph, rect, ro, rd, t_min, t_max)
    raise ValueError(f"phase A runs on CUDA or CPU tensors, got {ro.device}")
