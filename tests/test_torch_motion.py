"""The port's motion blur against the JAX package's, on the scene of
examples/motion_blur.py (a checker floor, one static and two moving
spheres, shutter [0, 1]) and the moving sphere of tests/test_motion.py:
the per-ray shutter times, the tables, the motion phase A (the plain
version of K4) against the XLA phase A and the Pallas kernel in
interpret mode, the renders and the depth-1 gradients.  The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracing_tpu as jrt
import ray_tracing_tpu_torch as prt
from ray_tracing_tpu.models.camera import Camera as JCamera
from ray_tracing_tpu.models.camera import camera_rays as jcamera_rays
from ray_tracing_tpu.ops import intersect as ji
from ray_tracing_tpu.ops import pallas_intersect as jpallas
from ray_tracing_tpu.ops.rng import ray_time as jray_time
from ray_tracing_tpu.render.prb_scalar import params_of as jparams_of
from ray_tracing_tpu.render.prb_scalar import prb_loss_and_grad_all as jloss_and_grad
from ray_tracing_tpu_torch import scenes
from ray_tracing_tpu_torch.models.camera import Camera, stamp_shutter
from ray_tracing_tpu_torch.models.compiler import build_scene
from ray_tracing_tpu_torch.ops import cuda_intersect as ci
from ray_tracing_tpu_torch.ops import intersect as pi
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.render.integrator import trace, trace_compacted
from ray_tracing_tpu_torch.render.prb_scalar import AllParams, params_of, prb_loss_and_grad_all

from test_torch_scene import _assert_tables_equal
from test_torch_tile import dense_pass

torch.set_num_threads(2)

SIZE = 32
EPS32 = float(np.finfo(np.float32).eps)
SHUTTER = np.array([0.0, 1.0], np.float32)
# The example's checker floor lies on its texture's zero plane y = 0, where
# the cell is the sign of p.y's rounding: XLA-CPU fuses ro + rd t into an
# FMA under jit on hosts that have one, the port rounds the product, so the
# floor's cells differ ray by ray (ROADMAP Queue 3).  Image and gradient
# comparisons with JAX lift the whole scene off that plane.
LIFT = 0.1


def _motion_scene(builder_cls, environment=(0.0, 0.0, 0.0), lift=0.0):
    """examples/motion_blur.py:build_scene in either package, translated
    up by ``lift``."""
    b = builder_cls(background=(0.70, 0.80, 1.00), environment=environment)
    checker = b.add_lambertian(b.add_texture_checker(
        b.add_texture_solid((0.2, 0.3, 0.1)), b.add_texture_solid((0.9, 0.9, 0.9)), 10.0))
    red = b.add_lambertian(b.add_texture_solid((0.85, 0.15, 0.1)))
    green = b.add_lambertian(b.add_texture_solid((0.15, 0.75, 0.2)))
    blue = b.add_lambertian(b.add_texture_solid((0.15, 0.25, 0.85)))
    y = 0.45 + lift
    b.add_rect("zx", -10, 10, -10, 10, lift, checker, positive=True)
    b.add_sphere((-1.2, y, 0.0), 0.45, red)
    b.add_sphere_moving((-0.2, y, 0.0), (0.3, y, 0.0), 0.45, green)
    b.add_sphere_moving((0.9, y, 0.0), (2.1, y, 0.0), 0.45, blue)
    return b.build()


def _motion_camera(lift=0.0):
    """The example's camera, translated up by ``lift``."""
    return ((0.3, 1.5 + lift, 4.5), (0.3, 0.45 + lift, 0.0), 35)


@pytest.fixture(scope="module")
def motion():
    scene, cam, param = scenes.motion_blur()
    return scene, cam, param, _motion_scene(jrt.SceneBuilder)


def _stamped(scene, jscene):
    return (dataclasses.replace(scene, shutter=torch.from_numpy(SHUTTER)),
            jscene.replace(shutter=jnp.asarray(SHUTTER)))


def test_ray_time_bit_equal_jax():
    ids = np.random.RandomState(0).randint(0, 2**31 - 1, 5000)
    for seed, shutter in ((3, (0.0, 1.0)), (11, (0.25, 2.0))):
        s = np.asarray(shutter, np.float32)
        mine = rng.ray_time(rng.key(seed), torch.from_numpy(ids), torch.from_numpy(s))
        theirs = jray_time(jax.random.key(seed), jnp.asarray(ids), jnp.asarray(s))
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    assert rng.TIME_STREAM == 0x7F000001


def test_motion_scene_tables_equal_jax(motion):
    scene, cam, param, jscene = motion
    _assert_tables_equal(scene, jscene)
    assert scene.has_motion and scene.spheres.has_motion and not scene.spheres.has_transforms
    assert (param.width, param.height, param.max_depth) == (384, 384, 8)
    assert (cam.time0, cam.time1) == (0.0, 1.0)


_MOVING = {"type": "moving-sphere", "center0": [0, 0, 0], "center1": [1, 0, 0], "radius": 1,
           "time0": 0.5, "time1": 2.0}
_WHITE = {"type": "lambertian", "texture": {"type": "solid-color", "color": [0.5, 0.5, 0.5]}}
_PARAM = {"renderer": {"width": 4, "height": 4}, "camera": {
    "look_from": [0, 0, -5], "look_at": [0, 0, 0], "vfov": 40, "time0": 0.0, "time1": 1.0}}


def test_json_moving_sphere_equals_jax():
    param = dict(_PARAM, objects=[{"shape": _MOVING, "material": _WHITE},
                                  {"shape": {"type": "sphere", "center": [0, 3, 0], "radius": 1},
                                   "material": _WHITE}])
    ours, ref = build_scene(param).scene, jrt.build_scene(param).scene
    _assert_tables_equal(ours, ref)
    assert ours.has_motion and ours.spheres.vel[0, 0] == np.float32(1 / 1.5)


@pytest.mark.parametrize("how", ["builder", "json-transform", "json-important"])
def test_motion_with_transform_or_light_is_refused(how):
    """Moving spheres take no transform and are no lights, in both
    packages; a moving and a transformed sphere never share a table."""
    for build, builder_cls in ((build_scene, prt.SceneBuilder), (jrt.build_scene, jrt.SceneBuilder)):
        with pytest.raises(NotImplementedError):
            if how == "builder":
                b = builder_cls()
                m = b.add_lambertian(b.add_texture_solid((0.5, 0.5, 0.5)))
                b.add_sphere_moving((0, 0, 0), (1, 0, 0), 1.0, m)
                b.add_sphere((0, 3, 0), 1.0, m, transform=(np.eye(3), np.ones(3)))
                b.build()
            else:
                extra = ({"translate": [1, 0, 0]} if how == "json-transform"
                         else {})
                obj = {"shape": dict(_MOVING, **extra), "material": _WHITE,
                       "important": how == "json-important"}
                build(dict(_PARAM, objects=[obj]))


def test_packed_tables_match_pallas_packing(motion):
    scene, _, _, jscene = motion
    sph, rect = ci.pack_primitive_tables(scene)
    jsph, jrect = jpallas.pack_primitive_tables(jscene)
    assert sph.shape == (3, 7)
    np.testing.assert_array_equal(sph.numpy(), np.asarray(jsph))
    np.testing.assert_array_equal(rect.numpy(), np.asarray(jrect))


def _rays(motion, n_random):
    """The 32x32 camera rays (key 3) and ``n_random`` rays from above the
    floor toward the spheres, with seeded shutter times in [0, 1]."""
    _, _, _, jscene = motion
    jcam = jrt.CameraParam(*_motion_camera(), time0=0.0, time1=1.0)
    jro, jrd, _, _ = jcamera_rays(JCamera.build(jcam, 1.0), jax.random.key(3), SIZE, SIZE)
    r = np.random.RandomState(0)
    ro = r.uniform([-3, 0.1, -3], [3, 2.5, 3], (n_random, 3))
    rd = r.uniform([-1.5, 0.2, -0.5], [2.5, 0.7, 0.5], (n_random, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro = np.concatenate([np.array(jro), ro]).astype(np.float32)
    rd = np.concatenate([np.array(jrd), rd]).astype(np.float32)
    return ro, rd, r.uniform(0.0, 1.0, ro.shape[0]).astype(np.float32)


def _sphere_t_bound(sph, ro, rd, t_ray, t, kind, idx):
    """rtol 1e-5, widened on sphere hits by the root's conditioning
    (tests/test_torch_intersect.py:_t_bound) at the ray's own centre
    c + t_ray v."""
    bound = 1e-5 * np.abs(t).astype(np.float64)
    sp = kind == 0
    row = sph[idx[sp]].astype(np.float64)
    c = row[:, 0:3] + t_ray[sp, None].astype(np.float64) * row[:, 4:7]
    oc = ro[sp].astype(np.float64) - c
    half_b = np.sum(oc * rd[sp], axis=1)
    disc = half_b * half_b - (np.sum(oc * oc, axis=1) - row[:, 3] ** 2)
    bound[sp] += 2 * EPS32 * np.sum(oc * oc, axis=1) / (2 * np.sqrt(np.maximum(disc, 1e-30)))
    return bound


@pytest.mark.parametrize("reference", ["xla", "pallas-interpret"])
def test_motion_phase_a_matches_jax(motion, reference):
    """phase_a_plain with t_ray against the XLA phase A (spheres, then
    rects) and against pallas_phase_a(t_ray, interpret=True): winners
    equal on every ray, t to rtol 1e-5 widened by the sphere root's
    conditioning (ROADMAP Queue 3, grazing sphere hits)."""
    scene, _, _, jscene = motion
    ro, rd, t_ray = _rays(motion, 3072)
    sph, _ = ci.pack_primitive_tables(scene)
    t, kind, idx = (x.numpy() for x in ci.phase_a_plain(
        scene.phase_a, torch.from_numpy(ro), torch.from_numpy(rd), 1e-3, np.inf,
        torch.from_numpy(t_ray)))
    jro, jrd, jt = jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t_ray)
    if reference == "xla":
        n = ro.shape[0]
        rt, rkind, ridx = np.full(n, np.inf, np.float32), np.full(n, -1), np.zeros(n, np.int64)
        for k, grid in ((0, ji._sphere_phase_a(jscene, jro, jrd, 1e-3, jnp.inf, jt)),
                        (2, ji._rect_phase_a(jscene, jro, jrd, 1e-3, jnp.inf))):
            tg = np.where(np.asarray(grid[1]), np.asarray(grid[0]), np.inf)
            i = tg.argmin(axis=1)
            tb = tg[np.arange(n), i]
            better = tb < rt
            rt, rkind, ridx = (np.where(better, tb, rt), np.where(better, k, rkind),
                               np.where(better, i, ridx))
    else:
        rt, rkind, ridx = (np.asarray(x) for x in jpallas.pallas_phase_a(
            jscene, jro, jrd, jt, interpret=True))
    np.testing.assert_array_equal(kind, rkind)
    hit = kind >= 0
    np.testing.assert_array_equal(idx[hit], ridx[hit])
    assert (kind == 0).sum() > 500 and (idx[kind == 0] > 0).sum() > 300, "moving spheres hit"
    dt = np.abs(t[hit].astype(np.float64) - rt[hit])
    bound = _sphere_t_bound(sph.numpy(), ro[hit], rd[hit], t_ray[hit], rt[hit], kind[hit],
                            idx[hit])
    assert np.all(dt <= bound), (dt / bound).max()


def test_phase_a_without_t_ray_tests_time_zero(motion):
    """t_ray None on a moving table is time 0 (pallas_intersect.py:301),
    and a static table ignores t_ray."""
    scene, _, _, _ = motion
    ro, rd, t_ray = (torch.from_numpy(x) for x in _rays(motion, 512))
    sph, rect = ci.pack_primitive_tables(scene)
    tables = scene.phase_a
    none = ci.phase_a(tables, ro, rd, 1e-3, np.inf)
    zero = ci.phase_a(tables, ro, rd, 1e-3, np.inf, torch.zeros_like(t_ray))
    static = ci.phase_a(ci.pack_phase_a_tables(sph[:, :4].contiguous(), rect), ro, rd, 1e-3,
                        np.inf, t_ray)
    for a, b, c in zip(none, zero, static):
        assert torch.equal(a, b) and torch.equal(a, c)
    moved = ci.phase_a(tables, ro, rd, 1e-3, np.inf, t_ray)
    assert not torch.equal(moved[0], none[0])


def test_hit_record_matches_jax(motion):
    """intersect_scene with t_ray: kind, index, material, mask and front
    face equal; t, p, normal and uv as tests/test_torch_scene_json.py
    holds them (t widened on sphere hits by the root's conditioning)."""
    scene, _, _, jscene = motion
    ro, rd, t_ray = _rays(motion, 1024)
    mine = pi.intersect_scene(scene, torch.from_numpy(ro), torch.from_numpy(rd), 1e-3, np.inf,
                              None, torch.from_numpy(t_ray))
    hit = jax.tree.map(np.asarray, ji.intersect_scene(
        jscene, jnp.asarray(ro), jnp.asarray(rd), 1e-3, jnp.inf, None, jnp.asarray(t_ray)))
    for name in ("kind", "index", "material", "mask", "front_face"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(), getattr(hit, name),
                                      err_msg=name)
    m = hit.mask
    sph = ci.pack_primitive_tables(scene)[0].numpy()
    dt = np.abs(mine.t.numpy()[m].astype(np.float64) - hit.t[m])
    assert np.all(dt <= _sphere_t_bound(sph, ro[m], rd[m], t_ray[m], hit.t[m], hit.kind[m],
                                        hit.index[m]))
    dp = np.abs(mine.p.numpy()[m].astype(np.float64) - hit.p[m])
    scale = np.linalg.norm(ro[m], axis=1) + hit.t[m] * np.linalg.norm(rd[m], axis=1)
    assert np.all(dp <= 1e-5 * scale[:, None]), (dp / scale[:, None]).max()
    for name in ("normal", "uv"):
        np.testing.assert_allclose(getattr(mine, name).numpy()[m], getattr(hit, name)[m],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def _renderer(scene, cam, depth, size=SIZE, **kw):
    return prt.Renderer(prt.RendererParam(size, size, max_depth=depth), cam, scene,
                        device="cpu", **kw)


def test_zero_shutter_renders_as_static():
    """With time0 == time1 == 0 every ray sees time 0: the moving sphere
    renders bit for bit as a static sphere at center0
    (tests/test_motion.py:49)."""
    cam = prt.CameraParam((0, 0, 4), (0, 0, 0), 40, time0=0.0, time1=0.0)
    imgs = []
    for moving in (True, False):
        b = prt.SceneBuilder(background=(0.1, 0.1, 0.1))
        red = b.add_lambertian(b.add_texture_solid((0.9, 0.1, 0.1)))
        if moving:
            b.add_sphere_moving((-0.8, 0.0, 0.0), (0.8, 0.0, 0.0), 0.35, red)
        else:
            b.add_sphere((-0.8, 0.0, 0.0), 0.35, red)
        imgs.append(_renderer(b.build(), cam, 3, size=48).render(0))
    assert torch.equal(imgs[0], imgs[1])


@pytest.mark.parametrize("depth", [3, 8])
def test_compacted_equals_dense(motion, depth):
    """The renderer's radiance and segment count equal the dense loop's
    bit for bit: each ray's time is keyed by its id, so compaction does
    not move it."""
    scene, cam, _, _ = motion
    compact = _renderer(scene, cam, depth, tile_size=600)
    img_c, seg_c = compact.render_with_stats(2)
    img_d, seg_d = dense_pass(compact, 2)
    assert torch.equal(img_c, img_d)
    assert seg_c == seg_d > SIZE * SIZE


def test_stamp_shutter_and_missing_shutter_warning(motion):
    scene, cam, _, _ = motion
    camera = Camera.build(cam, 1.0)
    stamped = stamp_shutter(scene, camera)
    assert scene.shutter is None and torch.equal(stamped.shutter, torch.tensor([0.0, 1.0]))
    static = scenes.bunny_grid()[0]
    assert stamp_shutter(static, camera) is static
    ro = torch.tensor([[0.0, 1.0, 4.0]])
    rd = torch.tensor([[0.0, 0.0, -1.0]])
    with pytest.warns(UserWarning, match="shutter is None"):
        frozen = trace(scene, ro, rd, rng.key(0), 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        at_zero = trace(dataclasses.replace(scene, shutter=torch.zeros(2)), ro, rd, rng.key(0), 2)
    assert torch.equal(frozen, at_zero)


def test_depth_one_image_equals_jax(motion):
    scene, cam, _, jscene = motion
    jcam = jrt.CameraParam(**dataclasses.asdict(cam))
    a = _renderer(scene, cam, 1).render(0).numpy()
    b = np.asarray(jrt.Renderer(jrt.RendererParam(SIZE, SIZE, max_depth=1), jcam,
                                jscene).render(jax.random.key(0)))
    assert np.array_equal(a, b)


def test_depth_eight_inside_noise_floor():
    """Matched key 42 against JAX's render of the same pass at the
    scene's own depth 8, both lifted by LIFT: the mean difference is at
    most 0.6x the port's own difference between keys 42 and 43."""
    scene, jscene = _motion_scene(prt.SceneBuilder, lift=LIFT), _motion_scene(jrt.SceneBuilder,
                                                                               lift=LIFT)
    cam = prt.CameraParam(*_motion_camera(LIFT), time0=0.0, time1=1.0)
    jcam = jrt.CameraParam(*_motion_camera(LIFT), time0=0.0, time1=1.0)
    ours = _renderer(scene, cam, 8)
    mine = ours.render(42).numpy()
    ref = np.asarray(jrt.Renderer(jrt.RendererParam(SIZE, SIZE, max_depth=8), jcam,
                                  jscene).render(jax.random.key(42)))
    matched = np.abs(mine - ref).mean()
    floor = np.abs(mine - ours.render(43).numpy()).mean()
    assert floor > 0 and matched <= 0.6 * floor, (matched, floor)


def test_depth_one_gradients_match_jax():
    """The full-parameter gradient pass on the motion scene with a
    nonzero environment (so the albedo gradients live at depth 1), its
    shutter stamped, lifted by LIFT: loss and the five leaves to rtol
    1e-5 / atol 1e-6 (tests/test_motion.py:97 holds the JAX pass to
    dense AD)."""
    env = (0.3, 0.4, 0.5)
    ours, ref = _stamped(_motion_scene(prt.SceneBuilder, env, LIFT),
                         _motion_scene(jrt.SceneBuilder, env, LIFT))
    ro, rd, _ = _rays((None, None, None, ref), 1024)
    ro[:, 1] += LIFT
    w = np.random.RandomState(6).uniform(0, 1, (ro.shape[0], 3)).astype(np.float32)
    key = rng.key(7)
    w_t = torch.from_numpy(w)
    loss, g = prb_loss_and_grad_all(lambda r: torch.sum(w_t * r), params_of(ours), ours,
                                    torch.from_numpy(ro), torch.from_numpy(rd), key, 1)[:2]
    jloss, jg = jloss_and_grad(lambda r: jnp.sum(jnp.asarray(w) * r), jparams_of(ref), ref,
                               jnp.asarray(ro), jnp.asarray(rd),
                               jax.random.wrap_key_data(jnp.asarray(key, jnp.uint32)), 1)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for name, a, b in zip(AllParams._fields, g, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=name)
    assert np.abs(g.color.numpy()).sum() > 1e-3


def test_unlifted_scene_matches_unfused_jax(motion):
    """The example's own scene (floor on y = 0) at depth 8 against JAX's
    render without XLA's fusion (jax.disable_jit: p = ro + rd t rounds the
    product, as the port does, so the floor's checker cells agree): the
    matched-key difference is at most 0.6x the port's own noise floor,
    and both means lie in the range chip_smoke.py holds the card's
    384^2 passes to (MB_MEAN)."""
    from chip_smoke import MB_MEAN

    scene, cam, _, jscene = motion
    jcam = jrt.CameraParam(**dataclasses.asdict(cam))
    ours = _renderer(scene, cam, 8)
    mine = ours.render(42).numpy()
    with jax.disable_jit():
        ref = np.asarray(jrt.Renderer(jrt.RendererParam(SIZE, SIZE, max_depth=8), jcam,
                                      jscene).render(jax.random.key(42)))
    matched = np.abs(mine - ref).mean()
    floor = np.abs(mine - ours.render(43).numpy()).mean()
    assert floor > 0 and matched <= 0.6 * floor, (matched, floor)
    for img in (mine, ref):
        assert MB_MEAN[0] < img.astype(np.float64).mean() < MB_MEAN[1], img.mean()
