"""The port's full-parameter gradient pass (taped PRB for the color-linear
parameters, forward-mode tangents for fuzz and IR) against the JAX
package's and against torch autograd of the port's dense trace, on the
small scenes of the JAX package's own PRB tests, with rays made by
numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracing_tpu as jrt
import ray_tracing_tpu_torch as prt
from ray_tracing_tpu.ops.intersect import Hit as JHit
from ray_tracing_tpu.ops.materials import shade as jshade
from ray_tracing_tpu.render.prb_scalar import _with_all as jwith_all
from ray_tracing_tpu.render.prb_scalar import params_of as jparams_of
from ray_tracing_tpu.render.prb_scalar import prb_loss_and_grad_all as jloss_and_grad
from ray_tracing_tpu.render.prb_tape import trace_taped as jtrace_taped
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.ops.intersect import Hit
from ray_tracing_tpu_torch.ops.materials import shade
from ray_tracing_tpu_torch.render.integrator import trace, trace_compacted
from ray_tracing_tpu_torch.render.prb_scalar import (
    AllParams,
    _tangent_batches,
    _with_all,
    params_of,
    prb_loss_and_grad_all,
    scalar_tangent_pass,
)
from ray_tracing_tpu_torch.render.prb_tape import trace_taped
from test_torch_shading import _noise_atol, hits, zy  # noqa: F401  (fixtures)

torch.set_num_threads(2)

# the JAX package's bound for PRB against dense reverse-mode AD
# (tests/test_prb_scalar.py:114)
AD_TOL = dict(rtol=2e-3, atol=3e-4)


def _textured_cornell(builder, environment=(0.0, 0.0, 0.0)):
    """Image-textured floor, fuzzy metal, glass and a light: every
    gradient family is live (tests/test_prb_tape.py:23-40)."""
    img = np.random.RandomState(7).uniform(0.2, 0.9, (4, 6, 3)).astype(np.float32)
    b = builder(background=(0.05, 0.05, 0.05), environment=environment)
    floor = b.add_lambertian(b.add_texture_image(img))
    red = b.add_lambertian(b.add_texture_solid((0.65, 0.15, 0.12)))
    light = b.add_diffuse_light(b.add_texture_solid((4.0, 3.5, 3.0)))
    metal = b.add_metal((0.9, 0.85, 0.8), 0.2)
    glass = b.add_dielectric(1.5)
    b.add_rect("zx", -2, 2, -2, 2, 0.0, floor, positive=True)
    b.add_rect("xy", -2, 2, 0, 2, -2.0, red, positive=True)
    b.add_rect("zx", -1, 1, -1, 1, 3.0, light, positive=False, important=True)
    b.add_sphere((-0.6, 0.5, -0.6), 0.45, metal)
    b.add_sphere((0.7, 0.5, -0.7), 0.4, glass)
    return b.build()


def _cornell(builder):
    """tests/test_prb_scalar.py:22-34."""
    b = builder(background=(0.05, 0.05, 0.05))
    white = b.add_lambertian(b.add_texture_solid((0.73, 0.7, 0.68)))
    red = b.add_lambertian(b.add_texture_solid((0.65, 0.15, 0.12)))
    light = b.add_diffuse_light(b.add_texture_solid((4.0, 3.5, 3.0)))
    glass = b.add_dielectric(1.5)
    metal = b.add_metal((0.9, 0.85, 0.8), 0.25)
    b.add_rect("zx", -2, 2, -2, 2, 0.0, white, positive=True)
    b.add_rect("xy", -2, 2, 0, 2, -2.0, red, positive=True)
    b.add_rect("zx", -1, 1, -1, 1, 3.0, light, positive=False, important=True)
    b.add_sphere((0.8, 0.5, -0.8), 0.4, glass)
    b.add_sphere((-0.8, 0.5, -0.8), 0.4, metal)
    return b.build()


def _rays(n, seed):
    """Camera-like rays of the JAX PRB tests, as numpy."""
    r = np.random.RandomState(seed)
    ro = np.tile([[0.0, 1.2, 1.8]], (n, 1)).astype(np.float32)
    d = np.stack([r.uniform(-0.5, 0.5, n), r.uniform(-0.8, 0.1, n), -np.ones(n)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return ro, d.astype(np.float32)


def _weights(n, seed):
    return np.random.RandomState(seed).uniform(0, 1, (n, 3)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jkey(words):
    return jax.random.wrap_key_data(jnp.asarray(words, jnp.uint32))


def _port_grads(scene, ro, rd, key, depth, w, **kw):
    """(loss, AllParams) of sum(w * rad) through the port, as numpy."""
    ro_t, rd_t, w_t = _t(ro, rd, w)
    loss, g = prb_loss_and_grad_all(lambda r: torch.sum(w_t * r), params_of(scene), scene,
                                    ro_t, rd_t, key, depth, **kw)[:2]
    return float(loss), AllParams(*(x.numpy() for x in g))


def _autograd_grads(scene, ro, rd, key, depth, w):
    """The same gradients from torch reverse autograd through the dense
    trace at the same key, as numpy."""
    params = AllParams(*(x.clone().requires_grad_(True) for x in params_of(scene)))
    ro_t, rd_t, w_t = _t(ro, rd, w)
    loss = torch.sum(w_t * trace(_with_all(scene, params), ro_t, rd_t, key, depth))
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return AllParams(*(np.zeros(p.shape, np.float32) if g is None else g.numpy()
                       for p, g in zip(params, grads)))


@pytest.fixture(scope="module")
def textured():
    return _textured_cornell(prt.SceneBuilder), _textured_cornell(jrt.SceneBuilder)


@pytest.fixture(scope="module")
def cornell():
    return _cornell(prt.SceneBuilder)


def test_shade_aux_matches_jax(zy, hits):  # noqa: F811
    """zy's solid, noise and image leaves: the aux facts are equal, the
    texture value meets the shading tolerance of test_torch_shading.py."""
    hit, rd, u = hits
    fields = {f: np.ascontiguousarray(getattr(hit, f))
              for f in ("p", "normal", "t", "uv", "front_face", "mask", "material", "kind", "index")}
    ours = shade(zy[0].scene, Hit(**{k: torch.from_numpy(v) for k, v in fields.items()}),
                 torch.from_numpy(rd), torch.from_numpy(u), with_aux=True)
    theirs = jshade(zy[1].scene, JHit(**{k: jnp.asarray(v) for k, v in fields.items()}),
                    jnp.asarray(rd), jnp.asarray(u), with_aux=True)
    plain = shade(zy[0].scene, Hit(**{k: torch.from_numpy(v) for k, v in fields.items()}),
                  torch.from_numpy(rd), torch.from_numpy(u))
    # with_aux leaves emission and scatter as they were
    assert torch.equal(ours[0], plain[0])
    assert all(torch.equal(a, b) for a, b in zip(ours[1], plain[1]))
    aux, jaux = ours[2], theirs[2]
    for name in ("leaf_tex", "leaf_is_solid", "leaf_is_image", "texel"):
        np.testing.assert_array_equal(getattr(aux, name).numpy(), np.asarray(getattr(jaux, name)),
                                      err_msg=name)
    assert aux.leaf_is_image.any() and aux.leaf_is_solid.any()
    leaf = aux.leaf_tex.numpy()
    atol = _noise_atol(zy[0].scene.textures, leaf, fields["p"])[:, None]
    want = np.asarray(jaux.tex_value)
    assert np.all(np.abs(aux.tex_value.numpy() - want) <= atol + 1e-5 * np.abs(want))


def test_taped_forward_bit_equal(textured):
    """Depth 12 (three stages): the taped forward's radiance equals the
    compacted and the dense trace bit for bit; at depth 1 its touched
    bitmask equals the JAX tape's."""
    scene = textured[0]
    ro, rd = _t(*_rays(4096, 1))
    key = rng.key(3)
    rad, touched, tape = trace_taped(scene, ro, rd, key, 12)
    assert len(tape.alive_counts) == 3 and tape.alive_counts[2] < tape.alive_counts[1] < 4096
    assert torch.equal(rad, trace_compacted(scene, ro, rd, key, 12))
    assert torch.equal(rad, trace(scene, ro, rd, key, 12))
    assert (touched & 1).any() and (touched & 2).any()

    ro_np, rd_np = _rays(4096, 1)
    _, touched1, _ = trace_taped(scene, ro, rd, key, 1)
    _, jtouched1, _ = jax.jit(lambda ro, rd: jtrace_taped(textured[1], ro, rd, _jkey(key), 1))(
        jnp.asarray(ro_np), jnp.asarray(rd_np))
    np.testing.assert_array_equal(touched1.numpy(), np.asarray(jtouched1))


def test_sweep_matches_autograd(textured):
    """The tape sweep's color, texel and metal-albedo gradients against
    reverse autograd of the dense trace (same paths; the sweep multiplies
    by 1/A where autograd differentiates the product)."""
    scene = textured[0]
    ro, rd = _rays(4096, 2)
    w = _weights(4096, 4)
    key = rng.key(5)
    _, ours = _port_grads(scene, ro, rd, key, 12, w, defer_scalars=True)
    ad = _autograd_grads(scene, ro, rd, key, 12, w)
    for name in ("color", "images", "metal_albedo"):
        a, b = getattr(ours, name), getattr(ad, name)
        assert np.abs(b).sum() > 1e-3, name
        np.testing.assert_allclose(a, b, err_msg=name, **AD_TOL)


def test_fuzz_ir_match_autograd(cornell):
    """Forward-mode fuzz and IR gradients of the compacted subset trace
    against reverse autograd of the dense trace (tests/test_prb_scalar.py
    test_all_params_dense_matches_ad_exactly)."""
    ro, rd = _rays(2048, 3)
    w = _weights(2048, 4)
    key = rng.key(6)
    _, ours = _port_grads(cornell, ro, rd, key, 6, w)
    ad = _autograd_grads(cornell, ro, rd, key, 6, w)
    for name in ("fuzz", "ir"):
        a, b = getattr(ours, name), getattr(ad, name)
        assert np.abs(a).sum() > 1e-3 and np.abs(b).sum() > 1e-3, name
        np.testing.assert_allclose(a, b, err_msg=name, **AD_TOL)


def test_fuzz_matches_own_finite_difference():
    """A smooth mirror onto a Perlin wall (tests/test_prb_scalar.py:
    165-205): the fuzz gradient of the compacted estimator against
    central differences of the same estimator."""
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
    _, g = prb_loss_and_grad_all(torch.mean, params_of(scene), scene, ro, rd, key, 3)

    def loss(fuzz0):
        fuzz = scene.materials.fuzz.clone()
        fuzz[0] = fuzz0
        s = _with_all(scene, params_of(scene)._replace(fuzz=fuzz))
        return float(torch.mean(trace_compacted(s, ro, rd, key, 3)))

    fd = np.mean([(loss(0.05 + eps) - loss(0.05 - eps)) / (2 * eps) for eps in (3e-4, 2e-4, 1e-4)])
    assert abs(float(g.fuzz[0])) > 1e-3, "no fuzz signal through the compacted path"
    np.testing.assert_allclose(float(g.fuzz[0]), fd, rtol=0.15)


@pytest.fixture(scope="module")
def jax_grads():
    """The JAX package's loss and gradients of sum(w * rad), one compile
    per depth, keys passed as data."""
    cache = {}

    def get(scene, ro, rd, key_words, depth, w):
        if depth not in cache:
            cache[depth] = jax.jit(lambda p, ro, rd, kd, w: jloss_and_grad(
                lambda r: jnp.sum(w * r), p, scene, ro, rd, jax.random.wrap_key_data(kd), depth))
        loss, g = cache[depth](jparams_of(scene), jnp.asarray(ro), jnp.asarray(rd),
                               jnp.asarray(key_words, jnp.uint32), jnp.asarray(w))
        return float(loss), AllParams(*(np.asarray(x) for x in g))

    return get


def test_depth_one_matches_jax(jax_grads):
    """Depth 1 with a nonzero environment, so emission, albedo, texel and
    metal-albedo gradients are all live: the loss and all five leaves
    allclose to JAX's."""
    env = (0.3, 0.4, 0.5)
    ours_s, ref_s = _textured_cornell(prt.SceneBuilder, env), _textured_cornell(jrt.SceneBuilder, env)
    ro, rd = _rays(2048, 3)
    w = _weights(2048, 6)
    key = rng.key(7)
    l_ours, g_ours = _port_grads(ours_s, ro, rd, key, 1, w)
    l_ref, g_ref = jax_grads(ref_s, ro, rd, key, 1, w)
    np.testing.assert_allclose(l_ours, l_ref, rtol=1e-5)
    for name, a, b in zip(AllParams._fields, g_ours, g_ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)
    for name in ("color", "images", "metal_albedo"):
        assert np.abs(getattr(g_ours, name)).sum() > 1e-3, name


def test_depth_eight_inside_noise_floor(textured, jax_grads):
    """Depth 8: for every leaf, the port's difference to JAX at the same
    key is at most 0.6x the port's own difference between two keys."""
    ro, rd = _rays(2048, 3)
    w = _weights(2048, 6)
    _, mine = _port_grads(textured[0], ro, rd, rng.key(7), 8, w)
    _, other = _port_grads(textured[0], ro, rd, rng.key(8), 8, w)
    _, theirs = jax_grads(textured[1], ro, rd, rng.key(7), 8, w)
    for name, a, b, c in zip(AllParams._fields, mine, theirs, other):
        matched, floor = np.abs(a - b).sum(), np.abs(a - c).sum()
        assert floor > 0 and matched <= 0.6 * floor, (name, matched, floor)


def test_tiled_ids_base_deferred_equals_full_width(textured):
    """Tiles traced under one key with ids_base, defer_scalars and one
    global scalar_tangent_pass equal the full-width call
    (tests/test_prb_tape.py:158)."""
    scene = textured[0]
    n, tile, depth = 4096, 2048, 8
    ro_np, rd_np = _rays(n, 5)
    w_np = _weights(n, 8)
    key = rng.key(13)
    l_full, g_full = _port_grads(scene, ro_np, rd_np, key, depth, w_np)
    ro, rd, w = _t(ro_np, rd_np, w_np)
    params = params_of(scene)
    loss, grads, rads, gcos, touches = 0.0, None, [], [], []
    for start in range(0, n, tile):
        sl = slice(start, start + tile)
        l_i, g_i, (rad_i, g_ray_i, touched_i) = prb_loss_and_grad_all(
            lambda r, w_t=w[sl]: torch.sum(w_t * r), params, scene, ro[sl], rd[sl], key, depth,
            ids_base=start, defer_scalars=True,
        )
        loss += float(l_i)
        grads = g_i if grads is None else AllParams(*(a + b for a, b in zip(grads, g_i)))
        rads.append(rad_i)
        gcos.append(g_ray_i)
        touches.append(touched_i)
    gfuzz, gir = scalar_tangent_pass(params, scene, ro, rd, key, depth, torch.cat(rads),
                                     torch.cat(gcos), torch.cat(touches))
    grads = grads._replace(fuzz=gfuzz, ir=gir)
    np.testing.assert_allclose(loss, l_full, rtol=1e-6)
    for name, a, b in zip(AllParams._fields, g_full, grads):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-9, err_msg=name)
    assert np.abs(gfuzz.numpy()).sum() > 1e-7 and np.abs(gir.numpy()).sum() > 1e-7


def test_tangent_batches_exact_when_cap_does_not_divide_count(cornell):
    """24 rays all aimed at the metal sphere: batches of 16 (the second
    partial) and of 8 equal one batch of 24 (tests/test_prb_scalar.py:328)."""
    n = 24
    r = np.random.RandomState(3)
    target = np.asarray([-0.8, 0.5, -0.8]) - np.asarray([0.0, 1.2, 1.8])
    d = target[None, :] + r.uniform(-0.12, 0.12, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ro, rd = _t(np.tile([[0.0, 1.2, 1.8]], (n, 1)).astype(np.float32), d.astype(np.float32))
    key = rng.key(2)
    params = params_of(cornell)
    metal = torch.tensor([4])
    mask = torch.ones(n, dtype=torch.bool)
    g = torch.ones((n, 3))

    def scene_of(theta):
        return _with_all(cornell, params._replace(fuzz=params.fuzz.index_copy(0, metal, theta)))

    def run(cap):
        return _tangent_batches(scene_of, params.fuzz[metal], mask, ro, rd, key, 5, g,
                                tangent_cap=cap, ids_base=0)

    ref = run(24)
    assert float(ref.abs().sum()) > 1e-6, "rays must touch"
    for cap in (16, 8):
        np.testing.assert_allclose(run(cap).numpy(), ref.numpy(), rtol=1e-5, atol=1e-10,
                                   err_msg=f"cap={cap}")
    _, full = prb_loss_and_grad_all(torch.sum, params, cornell, ro, rd, key, 5, tangent_cap=16)
    np.testing.assert_allclose(full.fuzz[metal].numpy(), ref.numpy(), rtol=1e-5)


@pytest.mark.parametrize("changed", [False, True], ids=["compiled", "changed"])
def test_params_of_across_packages(textured, changed):
    """params_of of a JAX scene carried across with scene_from_numpy
    equals the JAX params_of leaf for leaf, also after the parameters
    were changed on the JAX side (so a JAX fit's AllParams maps one to
    one onto the port's)."""
    scene = textured[1]
    if changed:
        p = jparams_of(scene)
        scene = jwith_all(scene, p._replace(
            color=p.color * 0.5, images=1.0 - p.images, metal_albedo=p.metal_albedo[:, ::-1],
            fuzz=p.fuzz + 0.1, ir=p.ir * 1.25))
    ours = params_of(prt.scene_from_numpy(jax.tree.map(np.asarray, scene)))
    for name, a, b in zip(AllParams._fields, ours, jparams_of(scene)):
        assert a.dtype == torch.float32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
