"""K2, the atlas-texel gradient scatter-add, and its plain PyTorch version.

The counterpart of ``ray_tracing_tpu/ops/pallas_scatter.py``: the CUDA
kernel in ``csrc/scatter.cu`` replaces ``pallas_scatter.py:_kernel``.
It adds masked (N, 3) contribution rows into the texel-major (P, 3)
image-gradient table at flat texel ids; duplicate ids sum, and rows
whose texel is negative are skipped.  The TPU kernel's channel-planar
table and its chunk and block live flags exist for the TPU's on-chip
memories and have no counterpart here.

:func:`scatter_add` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors.  The kernel is built at first use by
ops/_build.py and loaded with ``ctypes``.  Its atomics sum duplicates in
a varying order, so on the card two runs agree to float rounding, not
bit for bit; the plain version on the CPU is deterministic.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tracing_tpu_torch.ops import _build

SOURCE = _build.CSRC / "scatter.cu"

LAUNCHES = 0  # kernel launches since the last reset

_lib = None


def scatter_add_plain(gimg, texel, contrib, mask):
    """``gimg[texel[r]] += contrib[r]`` over the rows with ``mask`` set and
    ``texel >= 0``, as an ``index_add_`` of those rows; returns ``gimg``."""
    live = mask & (texel >= 0)
    return gimg.index_add_(0, texel[live].long(), contrib[live])


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build.build(SOURCE)))
        fn = lib.scatter_add_launch
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, ll, p, p, p, ll, p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name, x, device, dtype, shape):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def scatter_add_cuda(gimg, texel, contrib, mask):
    """K2 on CUDA tensors: the same update as :func:`scatter_add_plain`,
    in place on ``gimg``; returns ``gimg``."""
    global LAUNCHES
    device = gimg.device
    if device.type != "cuda":
        raise ValueError(f"K2 takes CUDA tensors, got {device}")
    if gimg.dim() != 2:
        raise ValueError(f"gimg must have shape (P, 3), got {tuple(gimg.shape)}")
    p, n = gimg.shape[0], texel.shape[0]
    _check("gimg", gimg, device, torch.float32, (p, 3))
    _check("texel", texel, device, torch.int32, (n,))
    _check("contrib", contrib, device, torch.float32, (n, 3))
    _check("mask", mask, device, torch.bool, (n,))
    if n == 0:
        return gimg
    fn = _library().scatter_add_launch
    with torch.cuda.device(device):
        err = fn(
            gimg.data_ptr(), p, texel.data_ptr(), contrib.data_ptr(), mask.data_ptr(),
            n, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {err}")
    LAUNCHES += 1
    return gimg


def scatter_add(gimg, texel, contrib, mask):
    """The scatter-add: the kernel for CUDA tensors, the plain version for
    CPU tensors.  Updates ``gimg`` in place and returns it."""
    if gimg.device.type == "cuda":
        return scatter_add_cuda(gimg, texel, contrib, mask)
    if gimg.device.type == "cpu":
        return scatter_add_plain(gimg, texel, contrib, mask)
    raise ValueError(f"the scatter-add runs on CUDA or CPU tensors, got {gimg.device}")
