"""K1, K3 and K4, the phase-A intersection kernels, and their plain
PyTorch version.

The counterpart of ``ray_tracing_tpu/ops/pallas_intersect.py``: the
CUDA kernel template in ``csrc/intersect.cu`` replaces ``pallas_intersect.py:
_kernel``.  K1 is its plain variant; K3 its transformed variants, taken
when the sphere or the rect table carries instancing transforms (each
ray is tested in a row's object space); K4 its motion variant, taken for
a moving sphere table (each ray sees the sphere at its own shutter time
``t_ray``).

Both versions read the tables of :class:`~ray_tracing_tpu_torch.models.
scene.PhaseATables` (``scene.phase_a``, packed once per scene): a
transformed table's rows are grouped by transform slot, so each ray's
object ray is computed once per distinct transform, not once per row.
The winner is the least (t, kind, row) in that order: spheres before
rects on equal t, then the lower row, whatever order the rows are
visited in.  :func:`phase_a_plain` computes the same function from the
candidate grids of ops/geometry.py.

:func:`phase_a` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors.  The kernel is built at first use
by ops/_build.py and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ray_tracing_tpu_torch.models.scene import (  # noqa: F401  (re-exported)
    META_COLS,
    MOTION_COLS,
    RECT_COLS,
    SPHERE_COLS,
    TF_COLS,
    PhaseATables,
    pack_phase_a_tables,
    pack_primitive_tables,
)
from ray_tracing_tpu_torch.ops import _build
from ray_tracing_tpu_torch.ops import geometry as geo
from ray_tracing_tpu_torch.ops.intersect import INF, KIND_NONE, KIND_RECT, KIND_SPHERE

SOURCE = _build.CSRC / "intersect.cu"

# The launch counts are not locked: counts taken while several threads launch
# are approximate.
LAUNCHES = 0  # K1 launches (no table transformed) since the last reset
TF_LAUNCHES = 0  # K3 launches (a table transformed) since the last reset
MOTION_LAUNCHES = 0  # K4 launches (moving spheres) since the last reset

_lib = None
_lib_lock = threading.Lock()  # one load and binding per process


def _sphere_grid(rows, ro, rd, lo, hi, t_ray=None):
    """(N, S) candidate grid of (t, mask) of rays ``ro``, ``rd`` ((N, 1
    or S, 3)) against sphere rows [cx cy cz r], or moving rows [cx cy cz
    r vx vy vz] tested at each ray's centre c + t_ray v (time 0 when
    ``t_ray`` is None)."""
    if rows.shape[1] == SPHERE_COLS + MOTION_COLS + META_COLS:
        if t_ray is None:
            t_ray = torch.zeros((ro.shape[0],), dtype=torch.float32, device=ro.device)
        center = rows[None, :, 0:3] + t_ray[:, None, None] * rows[None, :, 4:7]
        return geo.sphere_t(ro, rd, center, rows[:, 3], lo, hi)
    return geo.sphere_t(ro, rd, rows[:, 0:3], rows[:, 3], lo, hi)


def _rect_grid(rows, ro, rd, lo, hi):
    """(N, R) candidate grid of (t, mask) against rect rows [ua ub uk a0
    a1 b0 b1 k]."""
    t, mask, _, _ = geo.rect_t(
        ro, rd,
        rows[:, 0:3], rows[:, 3:6], rows[:, 6:9],
        rows[:, 9], rows[:, 10], rows[:, 11], rows[:, 12], rows[:, 13],
        lo, hi,
    )
    return t, mask


def phase_a_plain(tables: PhaseATables, ro, rd, t_min: float, t_max: float, t_ray=None):
    """Nearest sphere/rect hit per ray in plain PyTorch: (t (N,) f32,
    kind (N,) i32 with -1 on a miss, idx (N,) i32, the row in the
    scene's own table).  A kind wins only with a strictly smaller t than
    the spheres' best; within a kind the lowest row wins a tie.  A
    transformed table is tested in each row's object space over the
    window [t_min nrm, t_max nrm] and compared in world t = t_obj / nrm,
    one object ray per ray and slot.  A moving sphere table is tested at
    each ray's centre c + t_ray v, at time 0 when ``t_ray`` is None;
    ``t_ray`` is ignored for a static table."""
    n = ro.shape[0]
    best_t = torch.full((n,), INF, dtype=torch.float32, device=ro.device)
    best_kind = torch.full((n,), KIND_NONE, dtype=torch.int32, device=ro.device)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=ro.device)
    ro_n, rd_n = ro[:, None, :], rd[:, None, :]
    if tables.transformed:
        slots = tables.slots
        ro_o, rd_o, nrm = geo.transform_ray(slots[:, :9].reshape(-1, 3, 3), slots[:, 9:],
                                            ro_n, rd_n)  # (N, X, 3), (N, X)
    for kind, rows, tf, grid in (
        (KIND_SPHERE, tables.sph, tables.sph_tf, functools.partial(_sphere_grid, t_ray=t_ray)),
        (KIND_RECT, tables.rect, tables.rect_tf, _rect_grid),
    ):
        if rows.shape[0] == 0:
            continue
        meta = rows[:, -META_COLS:].contiguous().view(torch.int32)
        row = meta[:, 1]
        if tf:
            slot = meta[:, 0].long()
            s_nrm = nrm[:, slot]
            t, mask = grid(rows, ro_o[:, slot], rd_o[:, slot], t_min * s_nrm, t_max * s_nrm)
            t = t / s_nrm
        else:
            t, mask = grid(rows, ro_n, rd_n, t_min, t_max)
        t = torch.where(mask, t, INF)
        t_best = t.amin(dim=1)
        idx = torch.where(t == t_best[:, None], row, torch.iinfo(torch.int32).max).amin(dim=1)
        better = t_best < best_t
        best_t = torch.where(better, t_best, best_t)
        best_kind = torch.where(better, kind, best_kind)
        best_idx = torch.where(better, idx, best_idx)
    return best_t, best_kind, best_idx


def _library():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build(SOURCE)))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.phase_a_launch.argtypes = [p, i, p, i, p, i, i, i, p, p, p, i, f, f, p, p, p, p]
            lib.phase_a_launch.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check_rays(name, x, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"{name} must have shape (n, 3), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def phase_a_cuda(tables: PhaseATables, ro, rd, t_min: float, t_max: float, t_ray=None):
    """K1 (plain tables), K3 (a transformed table) or K4 (a moving sphere
    table) on CUDA tensors; the same outputs as :func:`phase_a_plain`.
    Tables of any size: above what shared memory holds the kernel
    streams them through it in chunks."""
    global LAUNCHES, TF_LAUNCHES, MOTION_LAUNCHES
    device = ro.device
    if device.type != "cuda":
        raise ValueError(f"K1/K3/K4 take CUDA tensors, got {device}")
    _check_rays("ro", ro, device)
    _check_rays("rd", rd, device)
    if tables.sph.device != device:
        raise ValueError(f"the phase-A table sph is on {tables.sph.device}, expected {device}")
    n = ro.shape[0]
    if rd.shape[0] != n:
        raise ValueError(f"ro has {n} rays, rd {rd.shape[0]}")
    if n >= 2**31:
        raise ValueError(f"K1/K3/K4 take fewer than 2**31 rays, got {n}")
    if tables.sph_motion:
        if t_ray is None:
            t_ray = torch.zeros((n,), dtype=torch.float32, device=device)
        if t_ray.device != device or t_ray.dtype != torch.float32 or t_ray.shape != (n,) \
                or not t_ray.is_contiguous():
            raise ValueError(f"t_ray must be a contiguous float32 ({n},) tensor on {device}")
    t = torch.empty((n,), dtype=torch.float32, device=device)
    kind = torch.empty((n,), dtype=torch.int32, device=device)
    idx = torch.empty((n,), dtype=torch.int32, device=device)
    if n == 0:
        return t, kind, idx
    fn = _library().phase_a_launch
    with _build.on_device(device):
        err = fn(
            tables.sph.data_ptr(), tables.sph.shape[0], tables.rect.data_ptr(),
            tables.rect.shape[0], tables.slots.data_ptr(), int(tables.sph_tf),
            int(tables.rect_tf), int(tables.sph_motion), ro.data_ptr(), rd.data_ptr(),
            t_ray.data_ptr() if tables.sph_motion else None, n, t_min, t_max,
            t.data_ptr(), kind.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K1/K3/K4 launch failed: cudaError {err}")
    if tables.sph_motion:
        MOTION_LAUNCHES += 1
    elif tables.transformed:
        TF_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return t, kind, idx


def phase_a(tables: PhaseATables, ro, rd, t_min: float, t_max: float, t_ray=None):
    """Phase A: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if ro.device.type == "cuda":
        return phase_a_cuda(tables, ro, rd, t_min, t_max, t_ray)
    if ro.device.type == "cpu":
        return phase_a_plain(tables, ro, rd, t_min, t_max, t_ray)
    raise ValueError(f"phase A runs on CUDA or CPU tensors, got {ro.device}")
