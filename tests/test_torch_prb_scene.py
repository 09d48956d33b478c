"""The port's full-parameter gradient pass on scenes with triangles,
transforms and media, against the JAX package's and against torch
autograd of the port's dense trace: a small scene built with both
packages' SceneBuilders (a mesh of a few triangles, a metal triangle, a
rotated checker cuboid, a constant-medium sphere with isotropic albedo,
a dielectric and an image sphere; a rotated rect light and a triangle
light) and data/scene.json,
with rays made by numpy from a seed.  Also the triangle and transformed
lights against JAX's, and the order in which phase A's kinds win a tie
(the TPU's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracing_tpu as jrt
import ray_tracing_tpu_torch as prt
from ray_tracing_tpu.ops.lights import lights_generate as jlights_generate
from ray_tracing_tpu.ops.lights import lights_value as jlights_value
from ray_tracing_tpu.render.prb_scalar import params_of as jparams_of
from ray_tracing_tpu.render.prb_scalar import prb_loss_and_grad_all as jloss_and_grad
from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
from ray_tracing_tpu_torch.models.scene import MAT_ISOTROPIC
from ray_tracing_tpu_torch.ops import cuda_triangles, rng
from ray_tracing_tpu_torch.ops import materials as mt
from ray_tracing_tpu_torch.ops.geometry import EPSILON, INF
from ray_tracing_tpu_torch.ops.intersect import (
    KIND_RECT,
    KIND_SPHERE,
    KIND_TRIANGLE,
    intersect_scene,
)
from ray_tracing_tpu_torch.ops.lights import lights_generate, lights_value
from ray_tracing_tpu_torch.ops.sampling import cosine_pdf_generate
from ray_tracing_tpu_torch.models.scene import LIGHT_TRIANGLE
from ray_tracing_tpu_torch.ops.rng import ray_uniforms
from ray_tracing_tpu_torch.render.integrator import trace, trace_compacted
from ray_tracing_tpu_torch.render.prb_scalar import (
    AllParams,
    _with_all,
    params_of,
    prb_loss_and_grad_all,
    scalar_tangent_pass,
)
from ray_tracing_tpu_torch.render.prb_tape import trace_taped

torch.set_num_threads(2)

N_RAYS = 2048
# the JAX package's bound for PRB against dense reverse-mode AD
# (tests/test_prb_scalar.py:114), as tests/test_torch_prb.py holds it
AD_TOL = dict(rtol=2e-3, atol=3e-4)
TH = np.deg2rad(25.0)
ROT_Y = np.array([[np.cos(TH), 0.0, np.sin(TH)], [0.0, 1.0, 0.0], [-np.sin(TH), 0.0, np.cos(TH)]])


def _mixed(builder, environment=(0.3, 0.4, 0.5), self_lit=False):
    """Every primitive kind and gradient family of data/scene.json in a
    box of unit scale: image floor and image sphere (atlas texels), solid
    walls and mesh (colors), a metal triangle (metal albedo and fuzz), a
    glass sphere (IR), a rotated checker cuboid (K3's transformed rects,
    checker leaves), a fog sphere with isotropic albedo (free flights),
    and two lights: a rotated rect and a triangle.  ``self_lit`` makes
    one face of the mesh an important light as well: a lambertian
    triangle that samples itself."""
    img = np.random.RandomState(7).uniform(0.2, 0.9, (4, 6, 3)).astype(np.float32)
    globe_img = np.random.RandomState(8).uniform(0.1, 0.9, (5, 8, 3)).astype(np.float32)
    b = builder(background=(0.05, 0.05, 0.05), environment=environment)
    floor = b.add_lambertian(b.add_texture_image(img))
    wall = b.add_lambertian(b.add_texture_solid((0.65, 0.15, 0.12)))
    light = b.add_diffuse_light(b.add_texture_solid((4.0, 3.5, 3.0)))
    metal = b.add_metal((0.9, 0.85, 0.8), 0.2)
    glass = b.add_dielectric(1.5)
    mesh = b.add_lambertian(b.add_texture_solid((0.3, 0.6, 0.4)))
    checker = b.add_lambertian(b.add_texture_checker(
        b.add_texture_solid((0.9, 0.9, 0.2)), b.add_texture_solid((0.2, 0.3, 0.8)), 6.0))
    fog = b.add_isotropic(b.add_texture_solid((0.8, 0.7, 0.9)))
    globe = b.add_lambertian(b.add_texture_image(globe_img))
    b.add_rect("zx", -2, 2, -2, 2, 0.0, floor, positive=True)
    b.add_rect("xy", -2, 2, 0, 2, -2.0, wall, positive=True)
    b.add_rect("zx", -1, 1, -1, 1, 3.0, light, positive=False, important=True,
               transform=(ROT_Y, np.zeros(3)))
    apex = np.array([0.9, 1.1, -0.9])
    base = np.array([[0.5, 0.3, -0.5], [1.3, 0.3, -0.5], [1.3, 0.3, -1.3], [0.5, 0.3, -1.3]])
    for i in range(4):  # a pyramid: a mesh of four triangles
        b.add_triangle([base[i], base[(i + 1) % 4], apex], mesh, important=self_lit and i == 0)
    b.add_triangle([[1.2, 2.9, 0.4], [1.9, 2.9, 0.4], [1.5, 2.9, 1.2]], light, important=True)
    b.add_triangle([[-1.6, 0.05, -1.6], [-0.4, 0.05, -1.9], [-1.0, 1.4, -1.95]], metal)
    b.add_cuboid((-0.3, 0.0, -0.3), (0.3, 0.6, 0.3), checker,
                 transform=(ROT_Y, np.array([-0.7, 0.0, 0.2])))
    b.add_medium(1.2, fog, spheres=[((0.6, 0.45, 0.3), 0.4)])
    b.add_sphere((0.0, 0.35, 0.9), 0.3, glass)
    b.add_sphere((-0.2, 1.2, -1.2), 0.35, globe)
    return b.build()


def _rays(n, seed):
    """Camera-like rays toward the mixed scene, as numpy."""
    r = np.random.RandomState(seed)
    ro = np.tile([[0.0, 1.2, 2.6]], (n, 1)).astype(np.float32)
    d = np.stack([r.uniform(-0.7, 0.7, n), r.uniform(-0.8, 0.2, n), -np.ones(n)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return ro, d.astype(np.float32)


def _weights(n, seed):
    return np.random.RandomState(seed).uniform(0, 1, (n, 3)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _port_grads(scene, ro, rd, key, depth, w, **kw):
    """(loss, AllParams) of sum(w * rad) through the port, as numpy."""
    ro_t, rd_t, w_t = _t(ro, rd, w)
    loss, g = prb_loss_and_grad_all(lambda r: torch.sum(w_t * r), params_of(scene), scene,
                                    ro_t, rd_t, key, depth, **kw)[:2]
    return float(loss), AllParams(*(x.numpy() for x in g))


@pytest.fixture(scope="module")
def mixed():
    return _mixed(prt.SceneBuilder), _mixed(jrt.SceneBuilder)


@pytest.fixture(scope="module")
def mixed_lit():
    return _mixed(prt.SceneBuilder, self_lit=True), _mixed(jrt.SceneBuilder, self_lit=True)


@pytest.fixture(scope="module")
def scene_json():
    bundle = prt.load_scene_json("data/scene.json")
    ro, rd, _, key = camera_rays(Camera.build(bundle.camera, 1.0), rng.key(4), 32, 32)
    return bundle.scene, ro, rd, key


@pytest.fixture(scope="module")
def jax_grads():
    """The JAX package's loss and gradients of sum(w * rad), one compile
    per scene and depth, keys passed as data."""
    cache = {}

    def get(scene, ro, rd, key_words, depth, w):
        if (id(scene), depth) not in cache:
            cache[id(scene), depth] = jax.jit(lambda p, ro, rd, kd, w: jloss_and_grad(
                lambda r: jnp.sum(w * r), p, scene, ro, rd, jax.random.wrap_key_data(kd), depth))
        loss, g = cache[id(scene), depth](jparams_of(scene), jnp.asarray(ro), jnp.asarray(rd),
                               jnp.asarray(key_words, jnp.uint32), jnp.asarray(w))
        return float(loss), AllParams(*(np.asarray(x) for x in g))

    return get


def test_depth_one_matches_jax(mixed_lit, jax_grads):
    """Depth 1 with a nonzero environment, on the mixed scene with one
    mesh face also an important light: the loss and all five leaves
    allclose to JAX's; colors, texels, metal albedo and the fog's
    isotropic albedo are live.  The rays that the face scatters within
    its own plane (a few per thousand) are weighted 0: there the two
    packages round the face's light pdf apart
    (test_self_sampling_triangle_light_in_plane)."""
    ours, ref = mixed_lit
    ro, rd = _rays(N_RAYS, 4)  # seven in-plane rays, four of them rounded apart
    key = rng.key(7)
    in_plane = _in_plane_rays(ours, *_t(ro, rd), key)[0]
    assert 0 < int(in_plane.sum()) <= N_RAYS // 100, int(in_plane.sum())
    w = _weights(N_RAYS, 6) * (~in_plane.numpy())[:, None]
    l_ours, g_ours = _port_grads(ours, ro, rd, key, 1, w)
    l_ref, g_ref = jax_grads(ref, ro, rd, key, 1, w)
    np.testing.assert_allclose(l_ours, l_ref, rtol=1e-5)
    for name, a, b in zip(AllParams._fields, g_ours, g_ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)
    for name in ("color", "images", "metal_albedo"):
        assert np.abs(getattr(g_ours, name)).sum() > 1e-3, name
    mat = ours.materials
    fog_leaf = int(mat.tex[mat.mtype == MAT_ISOTROPIC][0])
    assert np.abs(g_ours.color[fog_leaf]).sum() > 1e-3, "the fog's albedo row"


def _in_plane_rays(scene, ro, rd, key):
    """The rays whose first bounce lands on an important triangle and
    scatters within 1e-4 of its plane, as the integrator draws the
    bounce (integrator._bounce, materials._scatter_given_tex): there the
    triangle's own light pdf is t^2 / (|cos| A) with det = -|e12 x e13|
    cos of Moeller-Trumbore near 0, so whether the sweep hits the
    triangle seen edge-on, and the MIS weight with it, is decided by
    rounding.  Returns (mask, the lambertian albedo of each ray)."""
    ids = torch.arange(ro.shape[0])
    u = ray_uniforms(key, ids, 0, mt.N_SCATTER_U + scene.n_medium)
    hit = intersect_scene(scene, ro, rd, EPSILON, INF, u[:, mt.N_SCATTER_U:])
    cos_dir = cosine_pdf_generate(hit.normal, u[:, mt.U_COS_1], u[:, mt.U_COS_2])
    light_dir = lights_generate(scene, hit.p, u[:, mt.U_LIGHT_PICK], u[:, mt.U_LIGHT_1],
                                u[:, mt.U_LIGHT_2])
    mix_dir = torch.where((u[:, mt.U_MIX_SELECT] < 0.5)[:, None], light_dir, cos_dir)
    on_light = torch.zeros_like(hit.mask)
    lt = scene.lights
    for kind, index in zip(lt.kind, lt.index):
        if kind == LIGHT_TRIANGLE:
            on_light |= hit.mask & (hit.kind == KIND_TRIANGLE) & (hit.index == index)
    grazing = torch.abs((mix_dir * hit.normal).sum(-1)) < 1e-4
    tex = scene.textures.color[scene.materials.tex[hit.material].long()]
    return on_light & grazing, tex


def test_self_sampling_triangle_light_in_plane(mixed_lit):
    """A lambertian mesh face that is also an important light samples
    its own plane.  On the rays it scatters within that plane the light
    pdf of the edge-on triangle is decided by rounding, and XLA-CPU,
    which fuses Moeller-Trumbore into FMAs, and the port round it apart
    (off the plane test_depth_one_matches_jax holds them together): the
    MIS weight p_mat / (p_light / 2 + p_mat / 2) is 2 where the sweep
    misses the triangle and ~0 where it hits it with |cos| ~ 1e-7.  The
    limit toward the plane, p_mat -> 0 and p_light -> inf, is 0.  Both
    hold the estimator's bound there: the depth-1 radiance, albedo *
    weight * environment, lies in [0, 2 albedo environment]."""
    ours, ref = mixed_lit
    assert sum(k == LIGHT_TRIANGLE for k in ours.lights.kind) == 2
    ro, rd = _rays(N_RAYS, 4)
    key = rng.key(7)
    in_plane, tex = _in_plane_rays(ours, *_t(ro, rd), key)
    rad = trace(ours, *_t(ro, rd), key, 1)[in_plane].numpy()
    j_rad = _jax_rad(ref, ro, rd, key)[in_plane.numpy()]
    top = 2.0 * (tex[in_plane] * ours.environment).numpy() * (1 + 1e-6)
    for r in (rad, j_rad):
        assert (r >= 0).all() and (r <= top).all(), (r, top)


def _jax_rad(scene, ro, rd, key):
    """The JAX package's depth-1 radiance of the rays, as numpy."""
    from ray_tracing_tpu.render.integrator import trace as jtrace

    return np.asarray(jax.jit(lambda ro, rd, kd: jtrace(
        scene, ro, rd, jax.random.wrap_key_data(kd), 1))(
            jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(key, jnp.uint32)))


def test_depth_eight_inside_noise_floor(mixed, jax_grads):
    """Depth 8: for every leaf, fuzz and IR included, the port's
    difference to JAX at the same key is at most 0.6x the port's own
    difference between two keys."""
    ro, rd = _rays(N_RAYS, 3)
    w = _weights(N_RAYS, 6)
    _, mine = _port_grads(mixed[0], ro, rd, rng.key(7), 8, w)
    _, other = _port_grads(mixed[0], ro, rd, rng.key(8), 8, w)
    _, theirs = jax_grads(mixed[1], ro, rd, rng.key(7), 8, w)
    for name, a, b, c in zip(AllParams._fields, mine, theirs, other):
        matched, floor = np.abs(a - b).sum(), np.abs(a - c).sum()
        assert floor > 0 and matched <= 0.6 * floor, (name, matched, floor)


def _mixed_rays(mixed):
    ro, rd = _t(*_rays(N_RAYS, 1))
    return mixed[0], ro, rd, rng.key(3)


@pytest.mark.parametrize("which", ["mixed", "scene.json"])
def test_taped_forward_bit_equal(mixed, scene_json, which):
    """Depth 12 (three stages): the taped forward's radiance equals the
    compacted and the dense trace bit for bit, and some paths reach a
    metal and a dielectric."""
    scene, ro, rd, key = _mixed_rays(mixed) if which == "mixed" else scene_json
    rad, touched, tape = trace_taped(scene, ro, rd, key, 12)
    assert len(tape.alive_counts) == 3
    assert torch.equal(rad, trace_compacted(scene, ro, rd, key, 12))
    assert torch.equal(rad, trace(scene, ro, rd, key, 12))
    assert (touched & 1).any() and (touched & 2).any()


def _autograd_grads(scene, ro, rd, key, depth, w):
    """The gradients of sum(w * rad) from torch reverse autograd through
    the dense trace at the same key, as numpy."""
    params = AllParams(*(x.clone().requires_grad_(True) for x in params_of(scene)))
    ro_t, rd_t, w_t = _t(ro, rd, w)
    loss = torch.sum(w_t * trace(_with_all(scene, params), ro_t, rd_t, key, depth))
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return AllParams(*(np.zeros(p.shape, np.float32) if g is None else g.numpy()
                       for p, g in zip(params, grads)))


def test_all_leaves_match_autograd(mixed):
    """Depth 6: the tape sweep's color, texel and metal-albedo gradients
    and the forward-mode fuzz and IR gradients (through free flights in
    the fog, the rotated cuboid and the triangles) against reverse
    autograd of the dense trace on the same paths."""
    ro, rd = _rays(N_RAYS, 2)
    w = _weights(N_RAYS, 4)
    key = rng.key(5)
    _, ours = _port_grads(mixed[0], ro, rd, key, 6, w)
    ad = _autograd_grads(mixed[0], ro, rd, key, 6, w)
    for name, a, b in zip(AllParams._fields, ours, ad):
        assert np.abs(b).sum() > 1e-3, name
        np.testing.assert_allclose(a, b, err_msg=name, **AD_TOL)


@pytest.mark.parametrize("which", ["mixed", "scene.json"])
def test_tiled_ids_base_deferred_equals_full_width(mixed, scene_json, which):
    """Tiles traced under one key with ids_base, defer_scalars and one
    global scalar_tangent_pass equal the full-width call."""
    scene, ro, rd, key = _mixed_rays(mixed) if which == "mixed" else scene_json
    n, depth = ro.shape[0], 8
    tile = n // 2
    w = torch.from_numpy(_weights(n, 8))
    params = params_of(scene)
    l_full, g_full = prb_loss_and_grad_all(lambda r: torch.sum(w * r), params, scene, ro, rd,
                                           key, depth)
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
    np.testing.assert_allclose(loss, float(l_full), rtol=1e-6)
    for name, a, b in zip(AllParams._fields, g_full, grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-9, err_msg=name)
        assert np.isfinite(b.numpy()).all(), name
        assert np.abs(b.numpy()).sum() > 0.0, name


def test_gradient_pass_on_scene_json(scene_json):
    """data/scene.json, 32x32 at depth 12: every leaf finite and nonzero
    (the earth's texels, the solid colors, the metal triangle's albedo and
    fuzz, the glass sphere's IR), the fog's isotropic albedo row too."""
    scene, ro, rd, key = scene_json
    loss, g = prb_loss_and_grad_all(torch.mean, params_of(scene), scene, ro, rd, key, 12)
    assert np.isfinite(float(loss))
    for name in AllParams._fields:
        x = getattr(g, name).numpy()
        assert np.isfinite(x).all(), name
        assert np.abs(x).sum() > 0.0, name
    mat = scene.materials
    fog_leaf = int(mat.tex[mat.mtype == MAT_ISOTROPIC][0])
    assert float(g.color[fog_leaf].abs().sum()) > 0.0, "the fog's albedo row"


def test_fuzz_matches_own_finite_difference_on_triangle():
    """A smooth metal floor of two triangles onto a Perlin wall
    (tests/test_torch_prb.py's case with the mirror on the triangle
    sweep): the fuzz gradient of the compacted estimator against central
    differences of the same estimator."""
    b = prt.SceneBuilder(background=(1.0, 1.0, 1.0))
    metal = b.add_metal((0.9, 0.9, 0.9), 0.05)
    noisy = b.add_lambertian(b.add_texture_noise(0.7, 4))
    corners = np.array([[-50, 0, -50], [50, 0, -50], [50, 0, 50], [-50, 0, 50]], np.float32)
    b.add_triangle(corners[[0, 2, 1]], metal)
    b.add_triangle(corners[[0, 3, 2]], metal)
    b.add_rect("xy", -200, 200, -200, 200, -30.0, noisy, positive=True)
    scene = b.build()
    assert scene.n_triangles == 2
    n = 4096  # as tests/test_torch_prb.py: the difference quotient is noisy at fewer rays
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
    assert abs(float(g.fuzz[0])) > 1e-3, "no fuzz signal through the triangle sweep"
    np.testing.assert_allclose(float(g.fuzz[0]), fd, rtol=0.15)


def _light_scene(builder, case):
    """One important light of the given case beside a lambertian floor."""
    b = builder(background=(0.0, 0.0, 0.0))
    white = b.add_lambertian(b.add_texture_solid((0.73, 0.73, 0.73)))
    light = b.add_diffuse_light(b.add_texture_solid((5.0, 5.0, 5.0)))
    b.add_rect("zx", -4, 4, -4, 4, 0.0, white, positive=True)
    scale = np.diag([1.5, 0.75, 1.0]) @ ROT_Y
    if case == "triangle":
        b.add_triangle([[-1.0, 3.0, -1.0], [1.0, 3.0, -1.0], [0.0, 3.0, 1.0]], light,
                       important=True)
    elif case == "transformed sphere":
        b.add_sphere((0.0, 2.0, 0.0), 1.0, light, important=True,
                     transform=(scale, np.array([0.2, 0.1, -0.3])))
    elif case == "transformed rect":
        b.add_rect("zx", -1, 1, -1, 1, 3.0, light, positive=False, important=True,
                   transform=(ROT_Y, np.array([0.3, 0.0, -0.2])))
    else:  # a mesh light (two triangles) and a transformed cuboid light in one mixture
        pts = np.array([[[-1.0, 3.0, -1.0], [1.0, 3.0, -1.0], [0.0, 3.0, 1.0]],
                        [[1.0, 3.0, -1.0], [1.5, 3.0, 0.5], [0.0, 3.0, 1.0]]], np.float32)
        nrm = np.tile(np.array([0.0, -1.0, 0.0], np.float32), (2, 3, 1))
        b.add_mesh_triangles(pts, nrm, np.zeros((2, 3, 2), np.float32), light, important=True)
        b.add_cuboid((-0.5, 1.0, -0.5), (0.5, 2.0, 0.5), light, important=True,
                     transform=(scale, np.array([0.0, 0.5, 0.0])))
    return b.build()


def _light_points(case):
    """Query points and directions: the corner cases of
    tests/test_lights_edges.py for each light (inside and at the centre of
    the light sphere, directions in and near the light's plane) and 256
    seeded points between the floor and the light, aimed at seeded points
    around the lights."""
    r = np.random.RandomState(11)
    p = np.stack([r.uniform(-2, 2, 256), r.uniform(0.05, 2.5, 256), r.uniform(-2, 2, 256)], -1)
    target = np.stack([r.uniform(-1, 1, 256), r.uniform(1.0, 3.2, 256), r.uniform(-1, 1, 256)], -1)
    d = target - p
    if case == "transformed sphere":  # the sphere's world centre, inside, just inside
        edge_p = [[0.2, 1.6, -0.3], [0.4, 1.6, -0.3], [0.2, 2.34, -0.3]]
        edge_d = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    else:  # on the light's plane along it, a hair above it, straight up
        edge_p = [[3.0, 3.0, 0.0], [2.0, 3.00005, 0.0], [0.0, 1.0, 0.0]]
        edge_d = [[-1.0, 0.0, 0.0], [-1.0, -2e-5, 0.0], [0.0, 1.0, 0.0]]
    p = np.concatenate([np.asarray(edge_p), p]).astype(np.float32)
    d = np.concatenate([np.asarray(edge_d), d])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    u = r.uniform(0.0, 1.0, (3, p.shape[0])).astype(np.float32)
    return p, d, u


@pytest.mark.parametrize("case", ["triangle", "transformed sphere", "transformed rect",
                                  "mesh and cuboid"])
def test_lights_match_jax(case):
    """lights_value and lights_generate of triangle and transformed lights
    against the JAX package's: pdf values to rtol 1e-5 (saturated pdfs
    equal), directions to atol 1e-5, no NaN; every light of the mixture
    reached by some direction."""
    ours, ref = _light_scene(prt.SceneBuilder, case), _light_scene(jrt.SceneBuilder, case)
    assert ours.lights.kind == ref.lights.kind and ours.lights.transform == ref.lights.transform
    p, d, u = _light_points(case)
    val = lights_value(ours, *_t(p, d)).numpy()
    jval = np.asarray(jlights_value(ref, jnp.asarray(p), jnp.asarray(d)))
    assert not np.isnan(val).any()
    np.testing.assert_allclose(val, jval, rtol=1e-5)
    assert (val > 0).sum() > 10
    gen = lights_generate(ours, *_t(p, *u)).numpy()
    jgen = np.asarray(jlights_generate(ref, *(jnp.asarray(x) for x in (p, *u))))
    np.testing.assert_allclose(gen, jgen, atol=1e-5)
    # a generated direction toward the light has a positive pdf
    assert (lights_value(ours, *_t(p, gen)).numpy()[3:] > 0).mean() > 0.9


def test_json_important_triangle_cuboid_and_sphere_differentiate():
    """JSON "important": true on a triangle, a rotated cuboid and a
    translated sphere (once refused by the port): the light tables equal
    the JAX package's, and the port's gradient pass takes the scene
    (every leaf finite, the colors live)."""
    lam = {"type": "lambertian", "texture": {"type": "solid-color", "color": [0.7, 0.7, 0.7]}}
    lit = {"type": "diffuse-light", "emit": {"type": "solid-color", "color": [4, 4, 4]}}
    param = {
        "renderer": {"width": 16, "height": 16, "max_depth": 4},
        "camera": {"look_from": [0, 1.5, 4], "look_at": [0, 1, 0], "vfov": 60, "aperture": 0},
        "background": [0.1, 0.1, 0.1],
        "objects": [
            {"shape": {"type": "zx-rect", "z0": -4, "z1": 4, "x0": -4, "x1": 4, "y": 0,
                       "positive": True}, "material": lam},
            {"shape": {"type": "triangle", "vertices": [[-1, 3, -1], [1, 3, -1], [0, 3, 1]]},
             "material": lit, "important": True},
            {"shape": {"type": "cuboid", "p0": [-0.5, 0, -0.5], "p1": [0.5, 1, 0.5],
                       "transform": ROT_Y.tolist(), "translate": [0.5, 0, 0]},
             "material": lit, "important": True},
            {"shape": {"type": "sphere", "center": [-1.5, 0.5, 0], "radius": 0.4,
                       "translate": [0, 0.2, 0]}, "material": lit, "important": True},
        ],
    }
    ours, ref = prt.build_scene(param), jrt.build_scene(param)
    for f in ("kind", "index", "transform"):
        assert getattr(ours.scene.lights, f) == tuple(getattr(ref.scene.lights, f)), f
    assert any(ours.scene.lights.transform) and 1 in ours.scene.lights.kind
    ro, rd, _, key = camera_rays(Camera.build(ours.camera, 1.0), rng.key(1), 16, 16)
    _, g = prb_loss_and_grad_all(torch.mean, params_of(ours.scene), ours.scene, ro, rd, key, 4)
    for name in AllParams._fields:
        assert np.isfinite(getattr(g, name).numpy()).all(), name
    assert float(g.color.abs().sum()) > 0.0


def _tie_scene(other):
    """A triangle in the plane z = -2 and, at the same t = 2 along -z from
    the origin, either a rect in that plane or a sphere touching it."""
    b = prt.SceneBuilder()
    m = [b.add_lambertian(b.add_texture_solid((0.1 * i, 0.5, 0.5))) for i in range(1, 3)]
    b.add_triangle([[-1.0, -1.0, -2.0], [3.0, -1.0, -2.0], [-1.0, 3.0, -2.0]], m[0])
    if other == "rect":
        b.add_rect("xy", -1, 1, -1, 1, -2.0, m[1], positive=True)
    else:
        b.add_sphere((0.0, 0.0, -3.0), 1.0, m[1])
    return b.build()


@pytest.mark.parametrize("other", ["rect", "sphere"])
def test_kind_order_follows_the_tpu(other):
    """At an equal t the TPU's order decides (ray_tracing_tpu/ops/
    intersect.py:36-43 with the Pallas phase A first): spheres and rects
    (K1/K3/K4) win over triangles (K5/K6), which win only with a
    strictly smaller t.  JAX's XLA path on the CPU tests triangles before
    rects and would pick the triangle over the rect; the port keeps the
    TPU's order, on the CPU plain path as on the card."""
    scene = _tie_scene(other)
    ro = torch.tensor([[0.0, 0.0, 0.0], [0.25, -0.5, 0.0], [1.5, -0.5, 0.0]])
    rd = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    t_tri, _, on_tri = cuda_triangles.triangle_sweep(scene.triangles, ro, rd, 1e-3, float("inf"))
    assert on_tri.all() and t_tri.tolist() == [2.0, 2.0, 2.0]
    hit = intersect_scene(scene, ro, rd, 1e-3, float("inf"))
    assert hit.t.tolist() == [2.0, 2.0 if other == "rect" else hit.t[1].item(), 2.0]
    tied = [0, 1] if other == "rect" else [0]  # the sphere is at t = 2 on the axis only
    assert hit.kind[tied].tolist() == [KIND_RECT if other == "rect" else KIND_SPHERE] * len(tied)
    # off the rect and the sphere the triangle wins
    assert int(hit.kind[2]) == KIND_TRIANGLE
