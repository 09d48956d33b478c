"""The port against the independent scalar-NumPy oracle
(tests/oracle_numpy.py), which shares no code with either package.

The five oracle classes of tests/test_oracle_numpy.py (Cornell with
metal and glass, the weekend spheres without important lights, a
constant medium, the earthmap texture and instancing transforms) are
built by that file's own makers with the port's SceneBuilder and
rendered by the port's Renderer on the CPU, at the same 16x16, 48 spp
and with the same two asserts.  The Perlin texture, which no oracle
class covers, is evaluated point by point in float64 Python from its
definition (the lattice hash, the twelve edge gradients, Hermite
weights and the octave sum of ops/textures.py) over zy's compiled noise
textures and held against the port's texture_value."""

import math

import numpy as np
import pytest
import torch

import ray_tracing_tpu_torch as prt
import test_oracle_numpy as oracle_tests
from ray_tracing_tpu_torch.models.scene import TEX_NOISE
from ray_tracing_tpu_torch.ops.textures import texture_value
from tests import oracle_numpy as onp

torch.set_num_threads(2)

W, H, SPP = oracle_tests.W, oracle_tests.H, oracle_tests.SPP
M32 = 0xFFFFFFFF


def _port_render(scene, cam_param, depth, keys):
    r = prt.Renderer(prt.RendererParam(W, H, max_depth=depth), cam_param, scene, device="cpu",
                     tile_size=W * H)
    acc = np.zeros((H, W, 3), np.float64)
    for k in keys:
        acc += r.render(k).numpy().astype(np.float64)
    return acc / len(keys)


@pytest.mark.parametrize("maker", ["cornell_scenes", "weekend_scenes", "smoke_scenes",
                                   "earthmap_scenes", "transform_scenes"])
def test_port_matches_independent_oracle(maker, monkeypatch):
    """tests/test_oracle_numpy.py:250-269 with the port in place of the
    JAX package: the port-to-oracle difference inside 1.5x the port's
    own two-key noise floor, and the global means within 6 floors /
    sqrt(W)."""
    monkeypatch.setattr(oracle_tests, "SceneBuilder", prt.SceneBuilder)
    monkeypatch.setattr(oracle_tests, "CameraParam", prt.CameraParam)
    scene, cam, oracle_scene, ocam, depth = getattr(oracle_tests, maker)()

    port_a = _port_render(scene, cam, depth, range(0, SPP))
    port_b = _port_render(scene, cam, depth, range(1000, 1000 + SPP))
    orac = onp.render(oracle_scene, ocam, W, H, SPP, depth, seed=7)

    d_self = np.abs(port_a - port_b).mean()
    d_cross = 0.5 * (np.abs(port_a - orac).mean() + np.abs(port_b - orac).mean())
    assert d_cross < 1.5 * d_self + 1e-4, (d_cross, d_self)
    assert abs(port_a.mean() - orac.mean()) < 6 * d_self / np.sqrt(W), (
        port_a.mean(), orac.mean(), d_self)


def _hash(i: int, j: int, k: int) -> int:
    """The lattice hash of a point, in Python integers."""
    h = ((i & M32) * 73856093 ^ (j & M32) * 19349663 ^ (k & M32) * 83492791) & M32
    h ^= h >> 13
    h = (h * 0x85EBCA6B) & M32
    return h ^ (h >> 16)


def _grad_dot(h: int, x: float, y: float, z: float) -> float:
    """One of the twelve cube-edge gradients, chosen by the hash, dotted
    with the offset (improved noise)."""
    h4 = h & 15
    u = x if h4 < 8 else y
    v = y if h4 < 4 else (x if h4 in (12, 14) else z)
    return (u if h4 & 1 == 0 else -u) + (v if h4 & 2 == 0 else -v)


def _noise(q) -> float:
    """Gradient noise at q with Hermite weights, scaled by 0.7071."""
    cell = [math.floor(c) for c in q]
    f = [c - i for c, i in zip(q, cell)]
    s = [t * t * (3.0 - 2.0 * t) for t in f]
    total = 0.0
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                weight = ((s[0] if di else 1.0 - s[0]) * (s[1] if dj else 1.0 - s[1])
                          * (s[2] if dk else 1.0 - s[2]))
                h = _hash(cell[0] + di, cell[1] + dj, cell[2] + dk)
                total += weight * _grad_dot(h, f[0] - di, f[1] - dj, f[2] - dk)
    return total * 0.7071


def _turbulence(q, depth: int) -> float:
    """|sum over octaves o < depth of 0.5^o noise(2^o q)|."""
    return abs(sum(0.5 ** o * _noise([c * 2.0 ** o for c in q]) for o in range(depth)))


def test_noise_texture_matches_float64_oracle():
    """zy's noise textures at 2,048 seeded points in its box: the port's
    texture_value (float32) within 1e-5 of the float64 evaluation.  The
    oracle starts from the float32 domain point scale * p + offset, the
    port's own input to the noise (two float32 roundings)."""
    tt = prt.load_scene_json("data/zy_scene.json").scene.textures
    leaves = np.nonzero(tt.ttype.numpy() == TEX_NOISE)[0]
    assert len(leaves) >= 2
    r = np.random.RandomState(0)
    n = 2048
    idx = leaves[r.randint(0, len(leaves), n)]
    p = r.uniform(0.0, 555.0, (n, 3)).astype(np.float32)
    got = texture_value(tt, torch.from_numpy(idx), torch.zeros((n, 2)), torch.from_numpy(p))
    scale, offset = tt.scale.numpy(), tt.noise_offset.numpy()
    depth = tt.noise_depth.numpy()
    want = np.empty(n)
    for m in range(n):
        q = scale[idx[m]] * p[m] + offset[idx[m]]  # float32, as the port rounds it
        want[m] = _turbulence([float(c) for c in q], int(depth[idx[m]]))
    got = got.numpy()
    assert np.array_equal(got[:, 0], got[:, 2]) and np.array_equal(got[:, 0], got[:, 1])
    np.testing.assert_allclose(got[:, 0], want, rtol=1e-5, atol=1e-5)
    assert want.std() > 0.05  # the points span the texture's range
