"""The port's camera rays and scene intersection against the JAX
package's, on data/zy_scene.json with the 64x64 camera rays: the XLA
phase A, the Pallas kernel's own semantics (interpret mode), and the
full hit record.  The CUDA kernel itself is held against its plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracing_tpu as jrt
import ray_tracing_tpu_torch as prt
from ray_tracing_tpu.models.camera import Camera as JCamera
from ray_tracing_tpu.models.camera import camera_rays as jcamera_rays
from ray_tracing_tpu.ops import pallas_intersect as jpallas
from ray_tracing_tpu.ops.intersect import intersect_scene as jintersect
from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
from ray_tracing_tpu_torch.ops import cuda_intersect as ci
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.ops.intersect import intersect_scene

torch.set_num_threads(2)

ZY = "data/zy_scene.json"
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def zy():
    return prt.load_scene_json(ZY), jrt.load_scene_json(ZY)


@pytest.fixture(scope="module")
def rays(zy):
    """64x64 zy camera rays from both packages under key 3."""
    ours, ref = zy
    ro, rd, _, _ = camera_rays(Camera.build(ours.camera, 1.0), rng.key(3), 64, 64)
    jro, jrd, _, _ = jcamera_rays(JCamera.build(ref.camera, 1.0), jax.random.key(3), 64, 64)
    return ro, rd, np.array(jro), np.array(jrd)


def test_camera_rays_match_jax(rays):
    ro, rd, jro, jrd = rays
    np.testing.assert_allclose(ro.numpy(), jro, rtol=1e-6)
    np.testing.assert_allclose(rd.numpy(), jrd, rtol=1e-6)


def _t_bound(sph, ro, rd, t, kind, idx):
    """Allowed |dt| between two float32 evaluations of the same winner:
    rtol 1e-5, widened on grazing sphere hits by the formula's own
    conditioning.  disc = half_b^2 - c cancels to within a few ulps of
    |oc|^2, and the root moves by that error over 2 sqrt(disc)."""
    bound = 1e-5 * np.abs(t)
    sp = kind == 0
    c = sph[idx[sp], :3].astype(np.float64)
    r = sph[idx[sp], 3].astype(np.float64)
    oc = ro[sp].astype(np.float64) - c
    half_b = np.sum(oc * rd[sp], axis=1)
    disc = half_b * half_b - (np.sum(oc * oc, axis=1) - r * r)
    bound[sp] += 2 * EPS32 * np.sum(oc * oc, axis=1) / (2 * np.sqrt(np.maximum(disc, 1e-30)))
    return bound


def _assert_phase_a_agrees(ours, ref, sph, ro, rd):
    t, kind, idx = (x.numpy() for x in ours)
    rt, rkind, ridx = (np.asarray(x) for x in ref)
    found, rfound = kind >= 0, rkind >= 0
    np.testing.assert_array_equal(found, rfound)
    same = (kind == rkind) & (idx == ridx)
    assert same.mean() >= 0.999
    # every other winner is a tie: the two hits lie at the same t
    ties = ~same & found
    assert np.all(np.abs(t[ties] - rt[ties]) <= 1e-4 * rt[ties])
    sel = same & found
    dt = np.abs(t[sel] - rt[sel])
    bound = _t_bound(sph, ro[sel], rd[sel], rt[sel], rkind[sel], ridx[sel])
    assert np.all(dt <= bound), (dt / bound).max()


def test_phase_a_plain_matches_jax_xla_phase_a(zy, rays):
    ours, ref = zy
    ro, rd, jro, jrd = rays
    sph, rect = ci.pack_primitive_tables(ours.scene)
    hit = jintersect(ref.scene, jnp.asarray(jro), jnp.asarray(jrd), 1e-3, jnp.inf)
    res = ci.phase_a_plain(ours.scene.phase_a, torch.from_numpy(jro), torch.from_numpy(jrd),
                           1e-3, np.inf)
    _assert_phase_a_agrees(res, (hit.t, hit.kind, hit.index), sph.numpy(), jro, jrd)
    # on these rays the XLA phase A rounds exactly as the port does
    np.testing.assert_allclose(res[0].numpy(), np.asarray(hit.t), rtol=1e-5)


def test_phase_a_plain_matches_pallas_kernel_semantics(zy, rays):
    ours, ref = zy
    _, _, jro, jrd = rays
    sph, rect = ci.pack_primitive_tables(ours.scene)
    kernel = jpallas.pallas_phase_a(ref.scene, jnp.asarray(jro), jnp.asarray(jrd), interpret=True)
    res = ci.phase_a_plain(ours.scene.phase_a, torch.from_numpy(jro), torch.from_numpy(jrd),
                           1e-3, np.inf)
    _assert_phase_a_agrees(res, kernel, sph.numpy(), jro, jrd)


def test_packed_tables_match_pallas_packing(zy):
    ours, ref = zy
    sph, rect = ci.pack_primitive_tables(ours.scene)
    jsph, jrect = jpallas.pack_primitive_tables(ref.scene)
    np.testing.assert_array_equal(sph.numpy(), np.asarray(jsph))
    np.testing.assert_array_equal(rect.numpy(), np.asarray(jrect))


def test_rect_basis_matches_jax_tables():
    from ray_tracing_tpu.ops import geometry as jgeo
    from ray_tracing_tpu_torch.ops import geometry as geo

    axis = torch.tensor([0, 1, 2, 2, 0], dtype=torch.int32)
    for got, table in zip(geo.rect_basis(axis), (jgeo.RECT_UA, jgeo.RECT_UB, jgeo.RECT_UK)):
        np.testing.assert_array_equal(got.numpy(), table[axis.numpy()])


def _interior_rays(n=4096, seed=0):
    """Secondary-bounce-like rays: origins inside the box, any direction."""
    r = np.random.RandomState(seed)
    ro = r.uniform(1.0, 554.0, (n, 3)).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


@pytest.mark.parametrize("which", ["camera", "interior"])
def test_hit_record_matches_jax(zy, rays, which):
    ours, ref = zy
    ro, rd = (rays[2], rays[3]) if which == "camera" else _interior_rays()
    hit = jax.tree.map(np.asarray, jintersect(ref.scene, jnp.asarray(ro), jnp.asarray(rd), 1e-3, jnp.inf))
    mine = intersect_scene(ours.scene, torch.from_numpy(ro), torch.from_numpy(rd), 1e-3, np.inf)
    same = (mine.kind.numpy() == hit.kind) & (mine.index.numpy() == hit.index)
    assert same.mean() >= 0.999
    np.testing.assert_array_equal(mine.mask.numpy(), hit.mask)
    np.testing.assert_allclose(mine.p.numpy()[same], hit.p[same], atol=1e-3)
    np.testing.assert_allclose(mine.uv.numpy()[same], hit.uv[same], atol=1e-3)
    np.testing.assert_allclose(mine.normal.numpy()[same], hit.normal[same], atol=1e-5)
    np.testing.assert_array_equal(mine.front_face.numpy()[same], hit.front_face[same])
    np.testing.assert_array_equal(mine.material.numpy()[same], hit.material[same])


def test_phase_a_on_cpu_takes_the_plain_version(zy, rays):
    ro, rd, _, _ = rays
    tables = zy[0].scene.phase_a
    before = ci.LAUNCHES
    got = ci.phase_a(tables, ro, rd, 1e-3, np.inf)
    want = ci.phase_a_plain(tables, ro, rd, 1e-3, np.inf)
    assert ci.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        ci.phase_a_cuda(tables, ro, rd, 1e-3, np.inf)
