"""The port's transformed phase A (the plain version of K3) and constant
media against the JAX package's, on data/scene.json (a rotated,
translated cuboid; a medium inside a sphere) and on the transformed
scene of tests/test_pallas.py:_transformed_scene (a transformed cuboid,
a scaled and rotated sphere, identity rows in the same tables): the XLA
phase A, the Pallas kernel's own semantics (interpret mode), the full
hit record, and the media's free-flight phase with seeded uniforms.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

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
from ray_tracing_tpu_torch.ops import cuda_intersect as ci
from ray_tracing_tpu_torch.ops import intersect as pi

torch.set_num_threads(2)

EPS32 = float(np.finfo(np.float32).eps)


def _transformed_scene(builder_cls):
    """tests/test_pallas.py:_transformed_scene, in either package."""
    b = builder_cls(background=(0.5, 0.6, 0.7))
    m = b.add_lambertian(b.add_texture_solid((0.7, 0.7, 0.7)))
    th = np.deg2rad(31.0)
    rot_y = np.array([[np.cos(th), 0.0, np.sin(th)], [0.0, 1.0, 0.0],
                      [-np.sin(th), 0.0, np.cos(th)]])
    scale = np.diag([1.4, 0.8, 1.0])
    b.add_cuboid((100, 0, 100), (260, 180, 260), m,
                 transform=(rot_y, np.array([40.0, 0.0, 30.0])))
    b.add_sphere((400, 90, 300), 90, m,
                 transform=(rot_y @ scale, np.array([-20.0, 10.0, 0.0])))
    b.add_sphere((150, 380, 200), 60, m)  # identity slot in the same table
    b.add_rect("zx", 0, 555, 0, 555, 0, m, positive=True)
    return b.build()


def _media_scene(builder_cls):
    """Constant media over a transformed cuboid, a rect, a triangle and a
    sphere, beside a transformed rect."""
    b = builder_cls()
    iso = b.add_isotropic(b.add_texture_solid((0.9, 0.9, 0.9)))
    m = b.add_lambertian(b.add_texture_solid((0.5, 0.5, 0.5)))
    th = np.deg2rad(-20.0)
    rot = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0], [0, 0, 1.0]])
    b.add_medium(0.01, iso, cuboids=[((50, 50, 50), (250, 300, 200))],
                 transform=(rot, np.array([30.0, 20.0, 100.0])))
    b.add_medium(0.05, iso, rects=[(2, 300, 500, 300, 500, 200)])
    b.add_medium(0.02, iso, triangles=[[[300, 50, 300], [500, 60, 320], [400, 250, 480]]])
    b.add_medium(0.004, iso, spheres=[((400, 400, 300), 120)])
    b.add_rect("xy", 0, 555, 0, 555, 555, m, positive=False,
               transform=(np.eye(3), np.array([0.0, 0.0, -1.0])))
    return b.build()


SCENES = {
    "scene-json": lambda cls: (prt.load_scene_json if cls is prt.SceneBuilder
                               else jrt.load_scene_json)("data/scene.json").scene,
    "transformed": _transformed_scene,
    "media": _media_scene,
}


@pytest.fixture(scope="module", params=["scene-json", "transformed"])
def scenes(request):
    make = SCENES[request.param]
    return make(prt.SceneBuilder), make(jrt.SceneBuilder)


def _camera_rays(n):
    """tests/test_pallas.py:_rays: rays from the Cornell camera position."""
    r = np.random.RandomState(7)
    ro = np.tile([[278.0, 278.0, -800.0]], (n, 1)).astype(np.float32)
    d = np.stack([r.uniform(-0.5, 0.5, n), r.uniform(-0.5, 0.5, n), np.ones(n)], -1)
    return ro, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _interior_rays(n, seed=1):
    r = np.random.RandomState(seed)
    ro = r.uniform(1.0, 554.0, (n, 3)).astype(np.float32)
    rd = r.normal(size=(n, 3))
    return ro, (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)


RAYS = {"camera": lambda: _camera_rays(2048), "interior": lambda: _interior_rays(2048)}


def _xla_phase_a(scene, ro, rd):
    """The JAX package's XLA phase A over spheres then rects (the K1/K3
    part of intersect_scene), merged with strict <."""
    n = ro.shape[0]
    best = (np.full(n, np.inf, np.float32), np.full(n, -1, np.int32), np.zeros(n, np.int32))
    for kind, fn in ((0, ji._sphere_phase_a), (2, ji._rect_phase_a)):
        t, mask = (np.asarray(x) for x in fn(scene, jnp.asarray(ro), jnp.asarray(rd), 1e-3, jnp.inf))
        t = np.where(mask, t, np.inf)
        idx = t.argmin(axis=1)
        t = t[np.arange(n), idx]
        better = t < best[0]
        best = (np.where(better, t, best[0]), np.where(better, kind, best[1]),
                np.where(better, idx, best[2]))
    return best


def _t_bound(sph, rect, ro, rd, t, kind, idx):
    """Allowed |dt| between two float32 evaluations of the same winner:
    rtol 1e-5, widened per ray by the conditioning of the winner's test.
    A transformed row's object-space origin inv ro + inv_t is known to a
    few ulps of its terms (eps_o); a rect's t moves by eps_o over the
    object-space cosine d2, a sphere's root by eps_o (1 + |oc| /
    sqrt(disc)) plus the cancellation of disc = half_b^2 - c
    (tests/test_torch_intersect.py:_t_bound); world t = t_obj / nrm."""
    bound = 1e-5 * np.abs(t).astype(np.float64)
    for i in np.flatnonzero(kind >= 0):
        row = (sph if kind[i] == 0 else rect)[idx[i]].astype(np.float64)
        base = 4 if kind[i] == 0 else 14
        o, d, nrm, eps_o = ro[i].astype(np.float64), rd[i].astype(np.float64), 1.0, 0.0
        if row.shape[0] > base:
            m, mt = row[base:base + 9].reshape(3, 3), row[base + 9:base + 12]
            eps_o = 4 * EPS32 * np.max(np.abs(m) @ np.abs(o) + np.abs(mt))
            o, d = m @ o + mt, m @ d
            nrm = np.linalg.norm(d)
            d = d / nrm
        if kind[i] == 0:
            oc = o - row[:3]
            half_b = oc @ d
            sq = np.sqrt(max(half_b * half_b - (oc @ oc - row[3] ** 2), 1e-30))
            extra = eps_o * (1 + np.linalg.norm(oc) / sq) + 2 * EPS32 * (oc @ oc) / (2 * sq)
        else:
            extra = eps_o / max(abs(d @ row[6:9]), 1e-30)
        bound[i] += extra / nrm
    return bound


def test_packed_tables_match_pallas_packing(scenes):
    ours, ref = scenes
    sph, rect = ci.pack_primitive_tables(ours)
    jsph, jrect = jpallas.pack_primitive_tables(ref)
    assert rect.shape[1] == 26 and ours.rects.has_transforms
    assert sph.shape[1] == (16 if ref.spheres.has_transforms else 4)
    np.testing.assert_array_equal(sph.numpy(), np.asarray(jsph))
    np.testing.assert_array_equal(rect.numpy(), np.asarray(jrect))


@pytest.mark.parametrize("rays", ["camera", "interior"])
def test_transformed_phase_a_matches_jax_xla(scenes, rays):
    """Winners (found, kind, idx) equal and t to rtol 1e-5: the same
    object-space grid (world t = t_obj / nrm, window [t_min nrm, t_max
    nrm]) as the XLA phase A."""
    ours, ref = scenes
    ro, rd = RAYS[rays]()
    t, kind, idx = (x.numpy() for x in ci.phase_a_plain(
        ours.phase_a, torch.from_numpy(ro), torch.from_numpy(rd), 1e-3, np.inf))
    rt, rkind, ridx = _xla_phase_a(ref, ro, rd)
    np.testing.assert_array_equal(kind, rkind)
    np.testing.assert_array_equal(idx[kind >= 0], ridx[rkind >= 0])
    hit = kind >= 0
    np.testing.assert_allclose(t[hit], rt[hit], rtol=1e-5)
    # the winners include transformed rects
    tf_rect = (kind == 2) & (ours.rects.transform.numpy()[np.where(kind == 2, idx, 0)] > 0)
    assert tf_rect.sum() > 20


@pytest.mark.parametrize("rays", ["camera", "interior"])
def test_transformed_phase_a_matches_pallas_kernel_semantics(scenes, rays):
    """Against pallas_phase_a(interpret=True): winners equal on every
    ray; t to rtol 1e-5 widened per ray by the winner's conditioning
    (_t_bound).  The Pallas kernel scales rd_o by 1 / nrm and bounds
    object-space roots by best_t nrm, the plain grid divides and bounds
    by [t_min nrm, t_max nrm]; their object-space origins round apart by
    a few ulps of |inv ro| (ROADMAP Queue 3)."""
    ours, ref = scenes
    ro, rd = RAYS[rays]()
    sph, rect = ci.pack_primitive_tables(ours)
    t, kind, idx = (x.numpy() for x in ci.phase_a_plain(
        ours.phase_a, torch.from_numpy(ro), torch.from_numpy(rd), 1e-3, np.inf))
    rt, rkind, ridx = (np.asarray(x) for x in jpallas.pallas_phase_a(
        ref, jnp.asarray(ro), jnp.asarray(rd), interpret=True))
    np.testing.assert_array_equal(kind, rkind)
    np.testing.assert_array_equal(idx[kind >= 0], ridx[rkind >= 0])
    hit = kind >= 0
    dt = np.abs(t[hit].astype(np.float64) - rt[hit])
    bound = _t_bound(sph.numpy(), rect.numpy(), ro[hit], rd[hit], rt[hit], kind[hit], idx[hit])
    assert np.all(dt <= bound), (dt / bound).max()


def _extent(scene, kind, index):
    """Per hit, the world size over which an error in the object-space
    hit point turns into an error of the normal or uv: a sphere's radius
    times the smallest stretch of its transform, a rect's shorter side
    times the smallest stretch of its transform."""
    sp, rc, fwd = scene.spheres, scene.rects, scene.transforms.fwd.numpy()
    stretch = np.linalg.svd(fwd, compute_uv=False).min(axis=1)
    sph = sp.radius.numpy() * stretch[sp.transform.numpy()]
    side = np.minimum(rc.a1.numpy() - rc.a0.numpy(), rc.b1.numpy() - rc.b0.numpy())
    rect = side * stretch[rc.transform.numpy()]
    return np.where(kind == pi.KIND_SPHERE, sph[np.where(kind == pi.KIND_SPHERE, index, 0)],
                    rect[np.where(kind == pi.KIND_RECT, index, 0)])


def test_transformed_hit_record_matches_jax():
    """The whole hit record on the transformed scene: kind, index,
    material and front face equal; t to rtol 1e-5.  p is rebuilt as
    fwd p_obj + fwd_t and carries phase A's t error along the ray (up to
    7e-6 relative of t here): |dp| <= e = 1e-5 (|p| + t).  The normal and
    uv come from the object-space hit point and carry that error over the
    primitive's extent L (:func:`_extent`): |dn|, |duv| <= max(1e-6,
    e / L) on the rows of a table that carries transforms (every row of
    such a table, its identity slots too, is tested in object space);
    rtol 1e-5 / atol 1e-6 on the others (ROADMAP Queue 3)."""
    ours, ref = _transformed_scene(prt.SceneBuilder), _transformed_scene(jrt.SceneBuilder)
    object_space = [k for k, table in ((pi.KIND_SPHERE, ours.spheres), (pi.KIND_RECT, ours.rects))
                    if table.has_transforms]
    for ro, rd in (_camera_rays(2048), _interior_rays(2048)):
        mine = pi.intersect_scene(ours, torch.from_numpy(ro), torch.from_numpy(rd), 1e-3, np.inf)
        hit = jax.tree.map(np.asarray, ji.intersect_scene(ref, jnp.asarray(ro), jnp.asarray(rd),
                                                          1e-3, jnp.inf))
        for name in ("kind", "index", "material", "mask", "front_face"):
            np.testing.assert_array_equal(getattr(mine, name).numpy(), getattr(hit, name),
                                          err_msg=name)
        m = hit.mask
        np.testing.assert_allclose(mine.t.numpy()[m], hit.t[m], rtol=1e-5)
        err = 1e-5 * (np.abs(hit.p) + hit.t[:, None])
        dp = np.abs(mine.p.numpy() - hit.p)
        assert np.all(dp[m] <= err[m])
        tf = m & np.isin(hit.kind, object_space)
        bound = np.maximum(1e-6, err.max(axis=1) / _extent(ours, hit.kind, hit.index))[:, None]
        for name in ("normal", "uv"):
            d = np.abs(getattr(mine, name).numpy() - getattr(hit, name))
            assert np.all(d[tf] <= bound[tf]), (name, (d[tf] / bound[tf]).max())
            np.testing.assert_allclose(getattr(mine, name).numpy()[m & ~tf],
                                       getattr(hit, name)[m & ~tf], rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", params=["scene-json", "media"])
def media_scenes(request):
    make = SCENES[request.param]
    return make(prt.SceneBuilder), make(jrt.SceneBuilder)


@pytest.mark.parametrize("rays", ["camera", "interior"])
def test_medium_phase_a_matches_jax(media_scenes, rays):
    """Free flights with seeded uniforms: masks equal; t = t1 + flight to
    rtol 1e-5 of the larger of |t1| and |flight| (t1 < 0 for a ray that
    starts inside the medium, so t itself may cancel)."""
    ours, ref = media_scenes
    ro, rd = RAYS[rays]()
    med_u = np.random.RandomState(2).uniform(0.0, 1.0, (ro.shape[0], ours.n_medium))
    med_u = med_u.astype(np.float32)
    t, mask = (x.numpy() for x in pi._medium_phase_a(
        ours, torch.from_numpy(ro), torch.from_numpy(rd), 1e-3, np.inf, torch.from_numpy(med_u)))
    rt, rmask = (np.asarray(x) for x in ji._medium_phase_a(
        ref, jnp.asarray(ro), jnp.asarray(rd), 1e-3, jnp.inf, jnp.asarray(med_u)))
    np.testing.assert_array_equal(mask, rmask)
    # a flat boundary (rect, triangle) has no second hit and never
    # scatters; the cuboid and sphere media do
    assert mask.any(), "some ray must scatter in a medium"
    flight = ours.media.niv.numpy()[None, :] * np.log(np.maximum(med_u, 1e-38))
    scale = np.where(mask, np.maximum(np.abs(rt - flight), flight), 0.0)  # |t1|, |flight|
    np.testing.assert_array_less(np.abs(t[mask] - rt[mask]), 1e-5 * scale[mask] + 1e-30)


@pytest.mark.parametrize("rays", ["camera", "interior"])
def test_boundary_nearest_matches_jax(media_scenes, rays):
    """Both boundary hits of every medium, over (-inf, inf) and from the
    first hit + EPSILON: found equal, t to rtol 1e-5."""
    ours, ref = media_scenes
    ro, rd = RAYS[rays]()
    for bd, jbd in zip(ours.media.boundaries, ref.media.boundaries):
        t1, m1 = pi._boundary_nearest(bd, torch.from_numpy(ro), torch.from_numpy(rd), -np.inf,
                                      np.inf)
        rt1, rm1 = ji._boundary_nearest(jbd, jnp.asarray(ro), jnp.asarray(rd), -jnp.inf, jnp.inf)
        np.testing.assert_array_equal(m1.numpy(), np.asarray(rm1))
        np.testing.assert_allclose(t1.numpy()[m1.numpy()], np.asarray(rt1)[m1.numpy()],
                                   rtol=1e-5)
        t2, m2 = pi._boundary_nearest(bd, torch.from_numpy(ro), torch.from_numpy(rd), t1 + 1e-3,
                                      np.inf)
        rt2, rm2 = ji._boundary_nearest(jbd, jnp.asarray(ro), jnp.asarray(rd), rt1 + 1e-3, jnp.inf)
        np.testing.assert_array_equal(m2.numpy(), np.asarray(rm2))
        np.testing.assert_allclose(t2.numpy()[m2.numpy()], np.asarray(rt2)[m2.numpy()],
                                   rtol=1e-5)


def test_scene_json_camera_rays_hit_the_transformed_cuboid():
    """The K3 path matters for scene.json's own camera: its 32x32 rays hit
    the rotated cuboid's faces."""
    ours = prt.load_scene_json("data/scene.json")
    ref = jrt.load_scene_json("data/scene.json")
    jro, jrd, _, _ = jcamera_rays(JCamera.build(ref.camera, 1.0), jax.random.key(3), 32, 32)
    _, kind, idx = ci.phase_a_plain(ours.scene.phase_a, torch.from_numpy(np.array(jro)),
                                    torch.from_numpy(np.array(jrd)), 1e-3, np.inf)
    on_cuboid = (kind == 2) & (ours.scene.rects.transform[idx.long()] == 1)
    assert int(on_cuboid.sum()) > 50
