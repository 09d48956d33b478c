"""The port's autograd surface (render/prb_scalar.py:prb_radiance_all, a
torch.autograd.Function, and its wrappers prb_radiance_full,
prb_radiance, scalar_radiance) and the taped sweep, against the direct
path and the JAX package, on the small scenes of the JAX package's PRB
tests with rays made by numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracing_tpu as jrt
import ray_tracing_tpu_torch as prt
from ray_tracing_tpu.render.prb import grads_image_flat as jgrads_image_flat
from ray_tracing_tpu.render.prb import prb_grad_dense as jprb_grad_dense
from ray_tracing_tpu.render.prb_scalar import params_of as jparams_of
from ray_tracing_tpu.render.prb_scalar import prb_radiance_all as jprb_radiance_all
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.render.integrator import trace_compacted
from ray_tracing_tpu_torch.render.prb import PrbParams, prb_radiance, prb_radiance_full
from ray_tracing_tpu_torch.render.prb_scalar import (
    AllParams,
    ScalarParams,
    _with_all,
    params_of,
    prb_loss_and_grad_all,
    prb_radiance_all,
    scalar_radiance,
)
from ray_tracing_tpu_torch.render.prb_tape import tape_sweep, trace_taped
from test_torch_prb import _rays, _textured_cornell, _weights

torch.set_num_threads(2)

COLOR_LINEAR = ("color", "images", "metal_albedo")
ENV = (0.3, 0.4, 0.5)  # depth 1: a nonzero environment makes the albedos live


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _loss(w):
    """A non-uniform cotangent (tests/test_prb_scalar.py:305)."""
    return lambda rad: torch.sum(w * rad) + torch.sum(rad ** 2) / rad.numel()


def _surface_grads(scene, ro, rd, key, depth, w, **kw):
    """(loss, radiance, AllParams) of _loss(w) through prb_radiance_all and
    loss.backward()."""
    leaves = AllParams(*(x.clone().requires_grad_(True) for x in params_of(scene)))
    rad = prb_radiance_all(leaves, scene, ro, rd, key, depth, **kw)
    loss = _loss(w)(rad)
    loss.backward()
    return loss.detach(), rad.detach(), AllParams(*(x.grad for x in leaves))


def _assert_leaves(got, want, rtol=1e-6):
    """Color-linear leaves bit for bit, fuzz and IR to ``rtol``."""
    for name, a, b in zip(AllParams._fields, got, want):
        if name in COLOR_LINEAR:
            assert torch.equal(a, b), name
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=1e-12, err_msg=name)


@pytest.fixture(scope="module")
def textured():
    return _textured_cornell(prt.SceneBuilder)


def test_surface_equals_direct_path(textured):
    """Depth 6: the forward equals the trace it runs bit for bit, and
    loss.backward() gives prb_loss_and_grad_all's five leaves (the color
    linear ones bit for bit, fuzz and IR to rtol 1e-6), also with tiles
    smaller than the wavefront against the direct path's tiled protocol
    (one tile here)."""
    ro, rd = _t(*_rays(1024, 3))
    w = torch.from_numpy(_weights(1024, 4))
    key = rng.key(11)
    loss, rad, grads = _surface_grads(textured, ro, rd, key, 6, w)
    assert torch.equal(rad, trace_compacted(textured, ro, rd, key, 6))
    l_dir, g_dir = prb_loss_and_grad_all(_loss(w), params_of(textured), textured, ro, rd, key, 6)
    assert torch.equal(loss, l_dir)
    _assert_leaves(grads, g_dir)
    for name in ("color", "images", "metal_albedo", "fuzz", "ir"):
        assert float(getattr(grads, name).abs().sum()) > 1e-6, name
    _, rad_t, tiled = _surface_grads(textured, ro, rd, key, 6, w, tile_size=256)
    assert torch.equal(rad_t, rad)
    for name, a, b in zip(AllParams._fields, tiled, grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-9, err_msg=name)


@pytest.fixture(scope="module")
def jax_depth_one():
    """One compile: jax.grad of sum(w * prb_radiance_all) and the dense
    replay prb_grad_dense at depth 1, as the JAX package's own tests run
    them on the CPU (its texel scatter is XLA's there)."""
    scene = _textured_cornell(jrt.SceneBuilder, ENV)

    @jax.jit
    def run(p, ro, rd, kd, w, g):
        key = jax.random.wrap_key_data(kd)
        loss, grads = jax.value_and_grad(
            lambda q: jnp.sum(w * jprb_radiance_all(q, scene, ro, rd, key, 1)))(p)
        rad = jprb_radiance_all(p, scene, ro, rd, key, 1)
        gacc, replayed, touched = jprb_grad_dense(scene, ro, rd, key, 1, rad, g)
        return loss, grads, (gacc[0], jgrads_image_flat(gacc, scene), gacc[2]), replayed, touched

    def get(ro, rd, key, w, g):
        out = run(jparams_of(scene), jnp.asarray(ro), jnp.asarray(rd),
                  jnp.asarray(key, jnp.uint32), jnp.asarray(w), jnp.asarray(g))
        return jax.tree.map(np.asarray, out)

    return get


def test_surface_matches_jax_at_depth_one(jax_depth_one):
    """Depth 1: the loss and the five leaves of loss.backward() within
    1e-5 of jax.grad through the JAX package's prb_radiance_all."""
    scene = _textured_cornell(prt.SceneBuilder, ENV)
    ro_np, rd_np = _rays(2048, 3)
    w_np = _weights(2048, 6)
    key = rng.key(7)
    leaves = AllParams(*(x.clone().requires_grad_(True) for x in params_of(scene)))
    ro, rd, w = _t(ro_np, rd_np, w_np)
    loss = torch.sum(w * prb_radiance_all(leaves, scene, ro, rd, key, 1))
    loss.backward()
    l_ref, g_ref, _, _, _ = jax_depth_one(ro_np, rd_np, key, w_np, w_np)
    np.testing.assert_allclose(float(loss.detach()), l_ref, rtol=1e-5)
    for name, a, b in zip(AllParams._fields, leaves, g_ref):
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-5, atol=1e-6, err_msg=name)
    for name in COLOR_LINEAR:
        assert float(getattr(leaves, name).grad.abs().sum()) > 1e-3, name


def test_dense_replay_matches_jax_at_depth_one(jax_depth_one):
    """Depth 1: the taped forward's radiance and touched bitmask and its
    sweep's three accumulators against the JAX package's dense replay
    prb_grad_dense (1e-5)."""
    scene = _textured_cornell(prt.SceneBuilder, ENV)
    ro_np, rd_np = _rays(2048, 3)
    w_np = _weights(2048, 6)
    g_np = _weights(2048, 9)
    key = rng.key(7)
    ro, rd, g = _t(ro_np, rd_np, g_np)
    rad, touched, tape = trace_taped(scene, ro, rd, key, 1)
    gacc = tape_sweep(scene, tape, rad, g)
    _, _, jacc, jrad, jtouched = jax_depth_one(ro_np, rd_np, key, w_np, g_np)
    np.testing.assert_allclose(rad.numpy(), jrad, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(touched.numpy(), jtouched)
    for name, a, b in zip(("color", "images", "metal_albedo"), gacc, jacc):
        np.testing.assert_allclose(a.numpy(), b[: a.shape[0]], rtol=1e-5, atol=1e-6, err_msg=name)
        assert float(a.abs().sum()) > 1e-3, name


def test_surface_inside_noise_floor_at_depth_eight(textured):
    """Depth 8: for every leaf, the port's surface gradient differs from
    jax.grad through the JAX package's prb_radiance_all at the same key
    by at most 0.6x the port's own difference between two keys."""
    jscene = _textured_cornell(jrt.SceneBuilder)
    ro_np, rd_np = _rays(2048, 3)
    w_np = _weights(2048, 6)
    ro, rd, w = _t(ro_np, rd_np, w_np)

    def mine(key):
        leaves = AllParams(*(x.clone().requires_grad_(True) for x in params_of(textured)))
        torch.sum(w * prb_radiance_all(leaves, textured, ro, rd, key, 8)).backward()
        return [x.grad.numpy() for x in leaves]

    theirs = jax.jit(jax.grad(lambda p, kd: jnp.sum(jnp.asarray(w_np) * jprb_radiance_all(
        p, jscene, jnp.asarray(ro_np), jnp.asarray(rd_np), jax.random.wrap_key_data(kd), 8))))(
        jparams_of(jscene), jnp.asarray(rng.key(7), jnp.uint32))
    for name, a, b, c in zip(AllParams._fields, mine(rng.key(7)), theirs, mine(rng.key(8))):
        matched, floor = np.abs(a - np.asarray(b)).sum(), np.abs(a - c).sum()
        assert floor > 0 and matched <= 0.6 * floor, (name, matched, floor)


def test_wrappers_give_the_matching_leaves(textured):
    """prb_radiance_full (colors, texels, metal albedo), prb_radiance
    (colors) and scalar_radiance (fuzz, IR) give the same radiance and
    the matching leaves as prb_radiance_all."""
    ro, rd = _t(*_rays(1024, 9))
    w = torch.from_numpy(_weights(1024, 10))
    key = rng.key(4)
    loss, rad, full = _surface_grads(textured, ro, rd, key, 6, w)
    p = params_of(textured)

    lin = PrbParams(*(x.clone().requires_grad_(True) for x in (p.color, p.images, p.metal_albedo)))
    out = prb_radiance_full(lin, textured, ro, rd, key, 6)
    _loss(w)(out).backward()
    assert torch.equal(out.detach(), rad)
    for name, leaf in zip(COLOR_LINEAR, lin):
        assert torch.equal(leaf.grad, getattr(full, name)), name

    colors = p.color.clone().requires_grad_(True)
    _loss(w)(prb_radiance(colors, textured, ro, rd, key, 6)).backward()
    assert torch.equal(colors.grad, full.color)

    scal = ScalarParams(*(x.clone().requires_grad_(True) for x in (p.fuzz, p.ir)))
    out = scalar_radiance(scal, textured, ro, rd, key, 6)
    _loss(w)(out).backward()
    assert torch.equal(out.detach(), rad)
    for name, leaf in zip(("fuzz", "ir"), scal):
        np.testing.assert_allclose(leaf.grad.numpy(), getattr(full, name).numpy(), rtol=1e-6,
                                   atol=1e-12, err_msg=name)


def test_surface_fuzz_matches_central_difference():
    """A smooth mirror onto a Perlin wall (tests/test_prb_scalar.py:120):
    the fuzz gradient of loss.backward() through prb_radiance_all against
    central differences of the same estimator (rtol 0.1)."""
    b = prt.SceneBuilder(background=(1.0, 1.0, 1.0))
    metal = b.add_metal((0.9, 0.9, 0.9), 0.05)
    noisy = b.add_lambertian(b.add_texture_noise(0.7, 4))
    b.add_rect("zx", -50, 50, -50, 50, 0.0, metal, positive=True)
    b.add_rect("xy", -200, 200, -200, 200, -30.0, noisy, positive=True)
    scene = b.build()
    n = 4096
    r = np.random.RandomState(9)
    d = np.stack([r.uniform(-0.2, 0.2, n), -np.ones(n), r.uniform(-1.2, -0.8, n)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ro, rd = _t(np.tile([[0.0, 8.0, 8.0]], (n, 1)).astype(np.float32), d.astype(np.float32))
    key = rng.key(12)

    def with_fuzz(f0):
        fuzz = torch.cat([f0.reshape(1), scene.materials.fuzz[1:]])
        return params_of(scene)._replace(fuzz=fuzz)

    f0 = torch.tensor(0.05, requires_grad=True)
    torch.mean(prb_radiance_all(with_fuzz(f0), scene, ro, rd, key, 3)).backward()

    def loss(f):
        s = _with_all(scene, with_fuzz(torch.tensor(f)))
        return float(torch.mean(trace_compacted(s, ro, rd, key, 3)))

    fd = np.mean([(loss(0.05 + eps) - loss(0.05 - eps)) / (2 * eps) for eps in (3e-4, 2e-4, 1e-4)])
    assert abs(float(f0.grad)) > 1e-4, "no fuzz signal"
    np.testing.assert_allclose(float(f0.grad), fd, rtol=0.1)
