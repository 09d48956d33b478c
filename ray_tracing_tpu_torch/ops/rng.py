"""Counter-hash RNG for per-ray uniforms, the PyTorch counterpart of
``ray_tracing_tpu/ops/rng.py``.

Every uniform is a pure function of (key, ray id, stream, column), so
a ray's path does not depend on where it sits in the wavefront.  The
words are bit-equal to the JAX package's: the same double PCG hash, and
keys derived by the same threefry-2x32 ``key``/``split``, done here on
the host in numpy, as is ``fold_in``, which the CLI and
``Renderer.render_to_noise`` draw every pass key from.

PyTorch has no ``uint32`` add or shift on the CPU, so the hash runs in
int64 holding values below 2**32 and masks after every operation that
can carry past bit 31.  A key is a numpy ``uint32`` array of shape (2,),
the counterpart of ``jax.random.key_data(key)``.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def pcg(x):
    """One PCG-RXS-M-XS round on 32-bit words held in int64 (a tensor,
    a numpy array or a Python int), a well-mixed permutation."""
    x = (x * 747796405 + 2891336453) & M32
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & M32
    return (x >> 22) ^ x


def mul32(x, c: int):
    """``x * c`` modulo 2**32 for words ``x`` below 2**32 and a constant
    ``c`` below 2**32, without overflowing int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _stream_seeds(key, stream: int):
    """Fold the key words and the stream index into two 32-bit seeds
    (host Python ints)."""
    s1 = 0x9E3779B9
    for w in np.asarray(key, np.uint32).reshape(-1):
        s1 = pcg(s1 ^ int(w))
    s1 = pcg((s1 + (int(stream) & M32)) & M32)
    s2 = pcg(s1 ^ 0x85EBCA6B)
    return s1, s2


def ray_uniforms(key, ids: torch.Tensor, stream: int, n_cols: int) -> torch.Tensor:
    """(n, n_cols) float32 uniforms in [0, 1) keyed per ray id: a pure
    function of (key, ray id, stream, column).  ``ids`` is an integer
    tensor; ids are taken modulo 2**32 as the JAX package's
    ``astype(uint32)`` does."""
    s1, s2 = _stream_seeds(key, stream)
    base = pcg((ids.to(torch.int64) & M32) ^ s1)  # (n,)
    cols = torch.arange(n_cols, dtype=torch.int64, device=ids.device)
    cols = pcg((cols * 0x632BE59B + s2) & M32)  # (n_cols,)
    h = pcg((base[:, None] + cols[None, :]) & M32)  # (n, n_cols)
    # 24 high bits -> [0, 1), the jax.random.uniform convention
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


# the stream of the per-ray shutter time, far from every bounce index
TIME_STREAM = 0x7F000001


def ray_time(key, ids: torch.Tensor, shutter: torch.Tensor) -> torch.Tensor:
    """(n,) shutter times in [shutter[0], shutter[1]], a pure function of
    (key, ray id): every bounce of a path, a compacted trace and every
    replay see the same instant without carrying it."""
    u = ray_uniforms(key, ids, TIME_STREAM, 1)[:, 0]
    return shutter[0] + u * (shutter[1] - shutter[0])


# ---------------------------------------------------------------------- #
# key derivation: threefry-2x32, as jax.random.key / jax.random.split /
# jax.random.fold_in (partitionable mode) compute it
# ---------------------------------------------------------------------- #

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds on uint32 word arrays."""
    k0, k1 = (np.uint32(w) for w in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """The two words of ``jax.random.key(seed)`` for a 32-bit seed."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return np.array([0, seed & M32], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """(num, 2) words of ``jax.random.split(key, num)``: subkey i is
    threefry(key, (0, i))."""
    with np.errstate(over="ignore"):
        hi, lo = threefry2x32(
            key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32)
        )
    return np.stack([hi, lo], axis=1)


def fold_in(key, data: int) -> np.ndarray:
    """The two words of ``jax.random.fold_in(key, data)`` for a uint32
    ``data``: threefry(key, (0, data)).  Values outside [0, 2**32) are
    refused, not wrapped."""
    data = int(data)
    if not 0 <= data <= M32:
        raise ValueError(f"fold_in data {data} is not a uint32")
    with np.errstate(over="ignore"):
        hi, lo = threefry2x32(key, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return np.array([hi[0], lo[0]], np.uint32)
