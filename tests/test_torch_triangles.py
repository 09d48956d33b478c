"""The port's triangle sweep (the plain version of K5) and triangle hit
record against the JAX package's: the Pallas sweep in interpret mode,
the XLA triple-product sweep + argmin, and Moeller-Trumbore phase B, on
the bunny (the scene of tests/test_pallas_triangles.py).  The CUDA
kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracing_tpu as jrt
from ray_tracing_tpu.models.mesh import load_triangles as jload_triangles
from ray_tracing_tpu.ops import geometry as jgeo
from ray_tracing_tpu.ops import intersect as jintersect
from ray_tracing_tpu.ops.pallas_triangles import pallas_triangle_sweep
from ray_tracing_tpu_torch.models.compiler import SceneBuilder
from ray_tracing_tpu_torch.models.mesh import load_triangles
from ray_tracing_tpu_torch.ops import cuda_triangles as ct
from ray_tracing_tpu_torch.ops import geometry as geo
from ray_tracing_tpu_torch.ops import intersect as pintersect

torch.set_num_threads(2)


def _bunny(builder_cls, loader):
    b = builder_cls(background=(0.2, 0.2, 0.2))
    white = b.add_lambertian(b.add_texture_solid((0.7, 0.7, 0.7)))
    b.add_mesh_triangles(*loader("data/bunny.obj"), white)
    return b.build()


@pytest.fixture(scope="module")
def scenes():
    return _bunny(SceneBuilder, load_triangles), _bunny(jrt.SceneBuilder, jload_triangles)


def _rays(n, seed):
    """tests/test_pallas_triangles.py:_rays: rays aimed at the bunny."""
    rng = np.random.RandomState(seed)
    ro = (rng.uniform(-0.05, 0.05, (n, 3)) + [[0, 0.1, 0.4]]).astype(np.float32)
    d = rng.normal(size=(n, 3)) * 0.3
    d[:, 2] -= 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return ro, d.astype(np.float32)


def _xla_winner(scene, ro, rd):
    tr = scene.triangles
    t, mask = jgeo.triangle_sweep_t(
        jnp.asarray(ro), jnp.asarray(rd), tr.e12, tr.e13, tr.sw_origin, tr.sw_n, tr.sw_g1,
        tr.sw_g2, tr.sw_d0, jgeo.EPSILON, jnp.inf,
    )
    t = np.where(np.asarray(mask), np.asarray(t), np.inf)
    idx = t.argmin(axis=1)
    return t[np.arange(len(ro)), idx], idx, np.asarray(mask).any(axis=1)


def _plain(scene, ro, rd):
    tri = ct.pack_triangle_table(scene.triangles)
    return [x.numpy() for x in ct.triangle_sweep_plain(
        tri, scene.triangles.sw_origin, torch.from_numpy(ro), torch.from_numpy(rd), 1e-3,
        np.inf)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("reference", ["pallas-interpret", "xla"])
def test_plain_sweep_matches_jax(scenes, seed, reference):
    """found and idx equal, t to rtol 1e-6 (the same formulas in the same
    order; tests/test_pallas_triangles.py holds Pallas to XLA alike)."""
    ours, ref = scenes
    ro, rd = _rays(512, seed)
    t, idx, found = _plain(ours, ro, rd)
    if reference == "xla":
        rt, ridx, rfound = _xla_winner(ref, ro, rd)
    else:
        rt, ridx, rfound = (np.asarray(x) for x in pallas_triangle_sweep(
            ref, jnp.asarray(ro), jnp.asarray(rd), interpret=True))
    assert found.mean() > 0.1, "rays must hit the mesh for this to test"
    np.testing.assert_array_equal(found, rfound)
    np.testing.assert_array_equal(idx[found], ridx[rfound])
    np.testing.assert_allclose(t[found], rt[rfound], rtol=1e-6)


@pytest.mark.parametrize("chunk", [7, 1024, 4968])
def test_chunked_sweep_equals_one_grid(scenes, chunk, monkeypatch):
    """A running best over chunks with strict < picks the winner of one
    argmin over the whole table, bit for bit, ties included: the table
    here holds every triangle twice, so every hit is a tie."""
    ours, _ = scenes
    tr = ours.triangles
    tri = ct.pack_triangle_table(tr)
    doubled = torch.cat([tri, tri])
    ro, rd = (torch.from_numpy(x) for x in _rays(256, 2))
    ro_s = ro - tr.sw_origin
    t, mask = geo.triangle_sweep_t(ro_s, rd, geo.cross(ro_s, rd), *(
        doubled[:, i:i + 3] for i in range(0, 15, 3)), doubled[:, 15], 1e-3, np.inf)
    t = torch.where(mask, t, np.inf)
    want_t, want_idx = t.min(dim=1)
    monkeypatch.setattr(ct, "PLAIN_CHUNK", chunk)
    got_t, got_idx, found = ct.triangle_sweep_plain(doubled, tr.sw_origin, ro, rd, 1e-3, np.inf)
    assert bool(found.any())
    assert torch.equal(got_t, want_t)
    assert torch.equal(got_idx[found], want_idx[found].to(torch.int32))
    assert bool((got_idx[found] < tri.shape[0]).all())


def test_packed_table_matches_pallas_packing(scenes):
    from ray_tracing_tpu.ops.pallas_triangles import pack_triangle_table as jpack

    ours, ref = scenes
    tri = ct.pack_triangle_table(ours.triangles).numpy()
    jtri = np.asarray(jpack(ref.triangles))  # (16, T padded to 1024)
    np.testing.assert_array_equal(tri, jtri[:, : tri.shape[0]].T)


@pytest.mark.parametrize("seed", [0, 1])
def test_triangle_phase_b_matches_jax(scenes, seed):
    """The hit record of each ray's winning triangle: p, normal and uv to
    rtol 1e-5 / atol 1e-6, front face equal."""
    ours, ref = scenes
    ro, rd = _rays(512, seed)
    _, idx, found = _plain(ours, ro, rd)
    ro, rd, idx = ro[found], rd[found], idx[found]
    mine = pintersect._triangle_phase_b(ours, torch.from_numpy(ro), torch.from_numpy(rd), 1e-3,
                                        np.inf, torch.from_numpy(idx).long())
    theirs = jintersect._triangle_phase_b(ref, jnp.asarray(ro), jnp.asarray(rd), 1e-3, jnp.inf,
                                          jnp.asarray(idx))
    p, normal, t, uv, front = (np.asarray(x) for x in theirs)
    for name, a, b in (("p", mine[0], p), ("normal", mine[1], normal), ("uv", mine[2], uv)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(mine[3].numpy(), front)


def test_triangle_t_matches_jax():
    r = np.random.RandomState(3)
    ro, rd = _rays(2000, 3)
    v0 = r.uniform(-0.1, 0.1, (2000, 3)) + [[0, 0.1, 0]]
    e12 = r.normal(size=(2000, 3)) * 0.2
    e13 = r.normal(size=(2000, 3)) * 0.2
    args = [x.astype(np.float32) for x in (v0, e12, e13)]
    mine = geo.triangle_t(torch.from_numpy(ro), torch.from_numpy(rd),
                          *map(torch.from_numpy, args), 1e-3, np.inf)
    theirs = jgeo.triangle_t(jnp.asarray(ro), jnp.asarray(rd), *map(jnp.asarray, args),
                             1e-3, jnp.inf)
    hit = mine[1].numpy()
    np.testing.assert_array_equal(hit, np.asarray(theirs[1]))
    assert hit.mean() > 0.01
    # t, u, v and det where the triangle is hit (a missed lane's values
    # may be ill-conditioned and are never used)
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], rtol=1e-5, atol=1e-6)


def test_sweep_on_cpu_takes_the_plain_version(scenes):
    ours, _ = scenes
    tri = ct.pack_triangle_table(ours.triangles)
    ro, rd = (torch.from_numpy(x) for x in _rays(300, 4))
    before = ct.LAUNCHES
    got = ct.triangle_sweep(ours.triangles, ro, rd, 1e-3, np.inf)
    want = ct.triangle_sweep_plain(tri, ours.triangles.sw_origin, ro, rd, 1e-3, np.inf)
    assert ct.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        ct.triangle_sweep_cuda(tri, ct.pack_cluster_aabbs(ours.triangles),
                               ours.triangles.sw_origin, ro, rd, 1e-3, np.inf)


def test_mesh_strategy_is_the_sweep_or_refuses(scenes):
    """The dense sweep up to SWEEP_MAX_TRIS, the cluster sweep above it or
    without sweep constants, as the JAX package chooses; a table without
    cluster tables that the sweep cannot take needs the BVH walk, which
    is refused."""
    ours, ref = scenes
    assert pintersect.mesh_strategy(ours) == "sweep"
    too_many = dataclasses.replace(ours, n_triangles=pintersect.SWEEP_MAX_TRIS + 1)
    no_sweep = dataclasses.replace(
        ours, triangles=dataclasses.replace(ours.triangles, sw_n=None))
    for scene in (too_many, no_sweep):
        assert pintersect.mesh_strategy(scene) == "cluster"
    assert jintersect.mesh_strategy(ref.replace(n_triangles=pintersect.SWEEP_MAX_TRIS + 1)) == "cluster"
    unclustered = [dataclasses.replace(s, triangles=dataclasses.replace(s.triangles, cl_d0=None))
                   for s in (too_many, no_sweep)]
    for scene in unclustered:
        with pytest.raises(NotImplementedError, match="not ported yet"):
            pintersect.mesh_strategy(scene)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        pintersect.intersect_scene(unclustered[1], torch.zeros((4, 3)), torch.ones((4, 3)), 1e-3,
                                   np.inf)
