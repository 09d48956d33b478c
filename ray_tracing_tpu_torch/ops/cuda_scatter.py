"""K2, the atlas-texel gradient scatter-add, and its plain PyTorch version.

The counterpart of ``ray_tracing_tpu/ops/pallas_scatter.py``: the CUDA
kernel in ``csrc/scatter.cu`` replaces ``pallas_scatter.py:_kernel``.
It adds masked (N, 3) contribution rows into the texel-major (P, 3)
image-gradient table at flat texel ids; rows whose texel is negative are
skipped.  The rows come as segments, ``(texel (N,) i32, contrib (N, 3)
f32, mask (N,) bool)`` triples, one per stage of a tile's tape sweep,
and one call of the kernel (two launches) takes them all, up to
``_max_segments`` segments and ``_max_blocks`` blocks of ``_block_rows``
rows; a longer list is cut into calls in row order.  The TPU kernel's channel-planar table
and its chunk and block live flags exist for the TPU's on-chip memories
and have no counterpart here.

Each texel's rows are added to its old value one at a time in row order
(the segments in order, then each segment's rows), as the TPU kernel
does and as ``index_add_`` does on the CPU: the kernel's result is the
same bits on every run and equals :func:`scatter_add_plain` run on the
CPU.  The plain version on the card adds with atomics and is
repeatable only to rounding.

:func:`scatter_add` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors.  The kernel is built at first use by
ops/_build.py and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ray_tracing_tpu_torch.ops import _build

SOURCE = _build.CSRC / "scatter.cu"

# The launch counts are not locked: counts taken while several threads launch
# are approximate.
LAUNCHES = 0  # calls of the kernel (two launches each) since the last reset

_lib = None
_lib_lock = threading.Lock()  # one load and binding per process
_max_segments = None
_max_blocks = None
_block_rows = None
# (device index, stream) -> [generation, head, count, next, len, placed,
# touched]: the kernel's scratch, kept; head and count start zeroed
_scratch = {}


def scatter_add_plain(gimg, segments):
    """``gimg[texel[r]] += contrib[r]`` over the rows of every ``(texel,
    contrib, mask)`` segment with ``mask`` set and ``texel >= 0``, as one
    ``index_add_`` of those rows in row order; returns ``gimg``."""
    live = [(t, c, m & (t >= 0)) for t, c, m in segments]
    if not live:
        return gimg
    return gimg.index_add_(0, torch.cat([t[m] for t, _, m in live]).long(),
                           torch.cat([c[m] for _, c, m in live]))


def bind(lib):
    """Set the argument types of a loaded build of csrc/scatter.cu;
    returns it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.scatter_add_launch.argtypes = [p, i, p, p, p, p, i, p, p, p, p, p, p, ctypes.c_uint, p]
    lib.scatter_add_launch.restype = i
    for name in ("scatter_add_max_segments", "scatter_add_max_blocks", "scatter_add_block_rows"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    # an empty kernel through the same route: the launch floor, for
    # measurements
    lib.empty_launch.argtypes = [p]
    lib.empty_launch.restype = i
    return lib


def _library():
    global _lib, _max_segments, _max_blocks, _block_rows
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = bind(ctypes.CDLL(str(_build.build(SOURCE))))
            _max_segments = lib.scatter_add_max_segments()
            _max_blocks = lib.scatter_add_max_blocks()
            _block_rows = lib.scatter_add_block_rows()
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


def _scratch_for(device, stream: int, p: int, rows: int):
    """The kept scratch of ``device`` and ``stream``, grown to ``p``
    texels and ``rows`` block rows, with a new generation for this call:
    a list entry of an older generation reads as empty, so the kernel
    clears nothing.  Past 2**32 - 1 generations the tagged tables start
    over."""
    key = (device.index, stream)
    sc = _scratch.get(key)
    if sc is None or sc[0] == 2**32 - 1:
        i32 = dict(dtype=torch.int32, device=device)
        sc = [0, torch.zeros((0,), dtype=torch.int64, device=device), torch.zeros((2,), **i32),
              torch.empty((0,), dtype=torch.int64, device=device), torch.empty((0,), **i32),
              torch.empty((0,), dtype=torch.float32, device=device), torch.empty((0,), **i32)]
        _scratch[key] = sc
    if sc[1].numel() < p:
        sc[1] = torch.zeros((p,), dtype=torch.int64, device=device)
    if sc[3].numel() < rows:
        sc[3] = torch.empty((rows,), dtype=torch.int64, device=device)
        sc[4] = torch.empty((rows,), dtype=torch.int32, device=device)
        sc[5] = torch.empty((3 * rows,), dtype=torch.float32, device=device)
        sc[6] = torch.empty((rows,), dtype=torch.int32, device=device)
    sc[0] += 1
    return sc


def _calls(pieces):
    """The segments ``(texel, contrib, mask pointers, rows)`` grouped into
    calls of at most ``_max_segments`` segments and ``_max_blocks``
    blocks, a segment cut where a call is full; the rows keep their
    order."""
    calls, call, blocks = [], [], 0
    for texel, contrib, mask, n in pieces:
        a = 0
        while a < n:
            take = min(n - a, (_max_blocks - blocks) * _block_rows)
            call.append((texel + 4 * a, contrib + 12 * a, mask + a, take))
            blocks += -(-take // _block_rows)
            a += take
            if blocks == _max_blocks or len(call) == _max_segments:
                calls.append(call)
                call, blocks = [], 0
    return calls + [call] if call else calls


def scatter_add_cuda(gimg, segments):
    """K2 on CUDA tensors: the same update as :func:`scatter_add_plain`
    run on the CPU, in place on ``gimg``, in one call of the kernel's two
    launches (more where :func:`_calls` cuts the rows); returns
    ``gimg``."""
    global LAUNCHES
    device = gimg.device
    if device.type != "cuda":
        raise ValueError(f"K2 takes CUDA tensors, got {device}")
    if gimg.dim() != 2:
        raise ValueError(f"gimg must have shape (P, 3), got {tuple(gimg.shape)}")
    p = gimg.shape[0]
    _check("gimg", gimg, device, torch.float32, (p, 3))
    if p >= 2**31:
        raise ValueError(f"K2 takes fewer than 2**31 texels, got {p}")
    lib = _library()
    pieces = []  # (texel, contrib, mask pointers, rows) of each segment with rows
    for texel, contrib, mask in segments:
        n = texel.shape[0]
        _check("texel", texel, device, torch.int32, (n,))
        _check("contrib", contrib, device, torch.float32, (n, 3))
        _check("mask", mask, device, torch.bool, (n,))
        if n:
            pieces.append((texel.data_ptr(), contrib.data_ptr(), mask.data_ptr(), n))
    stream = torch.cuda.current_stream(device).cuda_stream
    with _build.on_device(device):
        for group in _calls(pieces):
            k = len(group)
            rows = sum(-(-piece[3] // _block_rows) for piece in group) * _block_rows
            gen, *buffers = _scratch_for(device, stream, p, rows)
            ptrs = [(ctypes.c_void_p * k)(*col) for col in list(zip(*group))[:3]]
            counts = (ctypes.c_int * k)(*(piece[3] for piece in group))
            err = lib.scatter_add_launch(gimg.data_ptr(), p, *ptrs, counts, k,
                                         *(b.data_ptr() for b in buffers), gen, stream)
            if err != 0:
                raise RuntimeError(f"K2 launch failed: cudaError {err}")
            LAUNCHES += 1
    return gimg


def scatter_add(gimg, segments):
    """The scatter-add of ``(texel, contrib, mask)`` segments: the kernel
    for CUDA tensors, the plain version for CPU tensors.  Updates
    ``gimg`` in place and returns it."""
    if gimg.device.type == "cuda":
        return scatter_add_cuda(gimg, segments)
    if gimg.device.type == "cpu":
        return scatter_add_plain(gimg, segments)
    raise ValueError(f"the scatter-add runs on CUDA or CPU tensors, got {gimg.device}")
