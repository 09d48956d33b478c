"""K1, K3 and K4, the phase-A intersection kernels, and their plain
PyTorch version.

The counterpart of ``ray_tracing_tpu/ops/pallas_intersect.py``: the
CUDA kernel template in ``csrc/intersect.cu`` replaces ``pallas_intersect.py:
_kernel``.  K1 is its plain variant; K3 its transformed variants, taken
when the sphere or the rect table carries instancing transforms (every
row of such a table is then extended with [inv(9) inv_t(3)], the
identity for slot 0); K4 its motion variant, taken for a moving sphere
table (every row extended with its velocity [vx vy vz]; each ray sees
the sphere at its own shutter time ``t_ray``).  All are bound by their
36 B/ray of device-memory traffic (rays in, winner out; K4 40 B with
``t_ray``) against ~20 flops per primitive (~60 with a transform), and
keep the primitive tables in shared memory.  :func:`phase_a_plain`
computes the same function from the candidate grids of
ops/intersect.py.

:func:`phase_a` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors.  The kernel is built at first use
by ops/_build.py and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tracing_tpu_torch.models.scene import SceneData
from ray_tracing_tpu_torch.ops import _build
from ray_tracing_tpu_torch.ops import geometry as geo
from ray_tracing_tpu_torch.ops.intersect import (
    INF,
    KIND_NONE,
    KIND_RECT,
    KIND_SPHERE,
    _rect_phase_a,
    _sphere_phase_a,
)

SOURCE = _build.CSRC / "intersect.cu"
SPHERE_COLS = 4
RECT_COLS = 14
TF_COLS = 12  # [inv(9) inv_t(3)] after the base columns of a transformed table
MOTION_COLS = 3  # [vx vy vz] after the base columns of a moving sphere table
SMEM_LIMIT = 48 * 1024  # default dynamic shared memory a block may take

LAUNCHES = 0  # K1 launches (no table transformed) since the last reset
TF_LAUNCHES = 0  # K3 launches (a table transformed) since the last reset
MOTION_LAUNCHES = 0  # K4 launches (moving spheres) since the last reset

_lib = None


def pack_primitive_tables(scene: SceneData):
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
    ua, ub, uk = geo.rect_basis(rc.axis)
    bounds = torch.stack([rc.a0, rc.a1, rc.b0, rc.b1, rc.k], dim=1)
    rect = torch.cat([ua, ub, uk, bounds], dim=1)
    if rc.has_transforms:
        slot = rc.transform.long()
        rect = torch.cat([rect, tf.inv[slot].reshape(-1, 9), tf.inv_t[slot]], dim=1)
    return sph.contiguous(), rect.contiguous()


def phase_a_plain(sph, rect, ro, rd, t_min: float, t_max: float, t_ray=None):
    """Nearest sphere/rect hit per ray in plain PyTorch: (t (N,) f32,
    kind (N,) i32 with -1 on a miss, idx (N,) i32).  Spheres first, then
    rects; a kind wins only with a strictly smaller t, and within a kind
    the lowest index wins a tie.  A transformed table (see
    :func:`pack_primitive_tables`) is tested in each row's object space
    over the window [t_min nrm, t_max nrm] and compared in world t =
    t_obj / nrm.  A moving sphere table is tested at each ray's centre
    c + t_ray v, at time 0 when ``t_ray`` is None; ``t_ray`` is ignored
    for a static table."""
    n = ro.shape[0]
    best_t = torch.full((n,), INF, dtype=torch.float32, device=ro.device)
    best_kind = torch.full((n,), KIND_NONE, dtype=torch.int32, device=ro.device)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=ro.device)
    for kind, table, sweep in (
        (KIND_SPHERE, sph, functools.partial(_sphere_phase_a, t_ray=t_ray)),
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


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build(SOURCE)))
        fn = lib.phase_a_launch
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, i, i, p, i, i, p, p, p, i, f, f, p, p, p, p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name, x, device, cols):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] not in cols:
        raise ValueError(f"{name} must have shape (n, {' or '.join(map(str, cols))}), "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def phase_a_cuda(sph, rect, ro, rd, t_min: float, t_max: float, t_ray=None):
    """K1 (plain tables), K3 (a transformed table) or K4 (a moving sphere
    table) on CUDA tensors; the same outputs as :func:`phase_a_plain`."""
    global LAUNCHES, TF_LAUNCHES, MOTION_LAUNCHES
    device = ro.device
    if device.type != "cuda":
        raise ValueError(f"K1/K3/K4 take CUDA tensors, got {device}")
    sph_cols = (SPHERE_COLS, SPHERE_COLS + TF_COLS, SPHERE_COLS + MOTION_COLS)
    for name, x, cols in (("ro", ro, (3,)), ("rd", rd, (3,)), ("sph", sph, sph_cols),
                          ("rect", rect, (RECT_COLS, RECT_COLS + TF_COLS))):
        _check(name, x, device, cols)
    n = ro.shape[0]
    if rd.shape[0] != n:
        raise ValueError(f"ro has {n} rays, rd {rd.shape[0]}")
    if n >= 2**31:
        raise ValueError(f"K1/K3/K4 take fewer than 2**31 rays, got {n}")
    sph_tf = sph.shape[1] == SPHERE_COLS + TF_COLS
    sph_motion = sph.shape[1] == SPHERE_COLS + MOTION_COLS
    rect_tf = rect.shape[1] != RECT_COLS
    if sph_motion:
        if t_ray is None:
            t_ray = torch.zeros((n,), dtype=torch.float32, device=device)
        if t_ray.device != device or t_ray.dtype != torch.float32 or t_ray.shape != (n,) \
                or not t_ray.is_contiguous():
            raise ValueError(f"t_ray must be a contiguous float32 ({n},) tensor on {device}")
    smem = 4 * (sph.numel() + rect.numel())
    if smem > SMEM_LIMIT:
        raise ValueError(f"primitive tables take {smem} B, over K1/K3/K4's {SMEM_LIMIT} B")
    t = torch.empty((n,), dtype=torch.float32, device=device)
    kind = torch.empty((n,), dtype=torch.int32, device=device)
    idx = torch.empty((n,), dtype=torch.int32, device=device)
    if n == 0:
        return t, kind, idx
    fn = _library().phase_a_launch
    with torch.cuda.device(device):
        err = fn(
            sph.data_ptr(), sph.shape[0], int(sph_tf), int(sph_motion), rect.data_ptr(),
            rect.shape[0], int(rect_tf), ro.data_ptr(), rd.data_ptr(),
            t_ray.data_ptr() if sph_motion else None, n, t_min, t_max,
            t.data_ptr(), kind.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K1/K3/K4 launch failed: cudaError {err}")
    if sph_motion:
        MOTION_LAUNCHES += 1
    elif sph_tf or rect_tf:
        TF_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return t, kind, idx


def phase_a(sph, rect, ro, rd, t_min: float, t_max: float, t_ray=None):
    """Phase A: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if ro.device.type == "cuda":
        return phase_a_cuda(sph, rect, ro, rd, t_min, t_max, t_ray)
    if ro.device.type == "cpu":
        return phase_a_plain(sph, rect, ro, rd, t_min, t_max, t_ray)
    raise ValueError(f"phase A runs on CUDA or CPU tensors, got {ro.device}")
