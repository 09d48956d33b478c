"""The port's large-mesh path against the JAX package's, on configuration
C6 (examples/render_baselines.py:scene_c6, a 4x4 grid of bunnies,
79,488 triangles) and on the bunny grids of
tests/test_pallas_triangles.py:_grid_scene: the cluster tables, the
plain cluster sweep (the plain version of K6) against the XLA cluster
sweep, the Pallas cluster kernels in interpret mode (K6, and K7 past
1024 clusters) and the dense sweep, the hit record, the depth-1 image
and the depth-4 image against JAX's.  The CUDA kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracing_tpu as jrt
import ray_tracing_tpu_torch as prt
from ray_tracing_tpu.models.camera import Camera as JCamera
from ray_tracing_tpu.models.camera import camera_rays as jcamera_rays
from ray_tracing_tpu.models.mesh import load_triangles as jload_triangles
from ray_tracing_tpu.ops import intersect as ji
from ray_tracing_tpu.ops.materials import N_SCATTER_U as J_N_SCATTER_U
from ray_tracing_tpu.ops.materials import shade as jshade
from ray_tracing_tpu.ops.pallas_triangles import pack_chunk_aabbs, pallas_cluster_sweep
from ray_tracing_tpu.ops.rng import ray_uniforms as jray_uniforms
from ray_tracing_tpu_torch import scenes
from ray_tracing_tpu_torch.ops import cuda_triangles as ct
from ray_tracing_tpu_torch.ops import intersect as pi

from test_torch_scene import _assert_tables_equal

torch.set_num_threads(2)

SIZE = 32
EPS32 = float(np.finfo(np.float32).eps)


def _jax_c6():
    """examples/render_baselines.py:scene_c6, built by the JAX package."""
    b = jrt.SceneBuilder(background=(0.7, 0.8, 1.0))
    white = b.add_lambertian(b.add_texture_solid((0.73, 0.73, 0.73)))
    ground = b.add_lambertian(b.add_texture_solid((0.4, 0.5, 0.4)))
    pts, nrm, uvs = jload_triangles("data/bunny.obj")
    allp = [pts + np.asarray([(i - 1.5) * 0.25, 0.0, (j - 1.5) * 0.25], np.float32)
            for i in range(4) for j in range(4)]
    b.add_mesh_triangles(np.concatenate(allp), np.concatenate([nrm] * 16),
                         np.concatenate([uvs] * 16), white)
    b.add_rect("zx", -5, 5, -5, 5, 0.033, ground, positive=True)
    return b.build(), jrt.CameraParam((-0.7, 0.8, 1.2), (0.0, 0.1, 0.0), 40)


@pytest.fixture(scope="module")
def c6():
    scene, cam, param = scenes.bunny_grid()
    jscene, jcam = _jax_c6()
    return scene, cam, param, jscene, jcam


def _jax_grid_scene(copies):
    """tests/test_pallas_triangles.py:_grid_scene, as scenes.bunny_copies
    builds it in the port."""
    b = jrt.SceneBuilder(background=(0.2, 0.2, 0.2))
    white = b.add_lambertian(b.add_texture_solid((0.7, 0.7, 0.7)))
    pts, nrm, uvs = jload_triangles("data/bunny.obj")
    if copies <= 4:
        offs = [(-0.15, 0.0), (0.15, 0.0), (0.0, -0.15), (0.0, 0.15)][:copies]
    else:
        offs = [(0.3 * (i % 6) - 0.75, 0.3 * (i // 6) - 0.75) for i in range(copies)]
    allp = [pts + np.asarray([dx, 0.0, dz], np.float32) for dx, dz in offs]
    b.add_mesh_triangles(np.concatenate(allp), np.concatenate([nrm] * copies),
                         np.concatenate([uvs] * copies), white)
    return b.build()


def _bunny_rays(n, seed):
    """tests/test_pallas_triangles.py:_rays: rays aimed at the bunny at
    the origin."""
    rng = np.random.RandomState(seed)
    ro = (rng.uniform(-0.05, 0.05, (n, 3)) + [[0, 0.1, 0.4]]).astype(np.float32)
    d = rng.normal(size=(n, 3)) * 0.3
    d[:, 2] -= 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return ro, d.astype(np.float32)


def _grid_rays(n, seed):
    """Rays from around C6's camera aimed at random points of the grid's
    box."""
    r = np.random.RandomState(seed)
    ro = np.array([-0.7, 0.8, 1.2]) + r.uniform(-0.2, 0.2, (n, 3))
    rd = r.uniform([-0.5, 0.03, -0.5], [0.5, 0.19, 0.5], (n, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


def _sweep_t_slack(tris, ro, rd, idx):
    """How far two float32 evaluations of the winner's t = (ro_s . n -
    d0) / -(rd . n) may part beyond rtol: a few ulps of the terms of the
    numerator, which cancel, over |det| (a grazing hit makes it large)."""
    o = ro.astype(np.float64) - tris.sw_origin.numpy()
    n = tris.sw_n.numpy()[idx].astype(np.float64)
    det = np.abs(np.sum(rd.astype(np.float64) * n, axis=1))
    num = np.linalg.norm(o, axis=1) * np.linalg.norm(n, axis=1) + np.abs(tris.sw_d0.numpy()[idx])
    return 4 * EPS32 * num / det


def _normal_slack(tris, ro, rd, idx):
    """How far two float32 evaluations of a triangle's interpolated
    shading normal may part: the barycentrics u = t_vec . p_vec / det and
    v = rd . q_vec / det cancel by |t_vec| |p_vec| / |det| and
    |rd| |q_vec| / |det| (tiny triangles seen from afar), and the normal
    moves by their error times the spread of the vertex normals."""
    v0, e12, e13, n0, n1, n2 = (getattr(tris, f).numpy()[idx].astype(np.float64)
                                for f in ("v0", "e12", "e13", "n0", "n1", "n2"))
    o, d = ro.astype(np.float64), rd.astype(np.float64)
    p = np.cross(d, e13)
    det = np.abs(np.sum(e12 * p, axis=1))
    tv = o - v0
    q = np.cross(tv, e12)
    cond = (np.linalg.norm(tv, axis=1) * np.linalg.norm(p, axis=1)
            + np.linalg.norm(d, axis=1) * np.linalg.norm(q, axis=1)) / det
    u = np.sum(tv * p, axis=1) / (np.sum(e12 * p, axis=1))
    v = np.sum(d * q, axis=1) / (np.sum(e12 * p, axis=1))
    interp = n0 * (1 - u - v)[:, None] + n1 * u[:, None] + n2 * v[:, None]
    spread = np.linalg.norm(n1 - n0, axis=1) + np.linalg.norm(n2 - n0, axis=1)
    return 4 * EPS32 * cond * spread / np.linalg.norm(interp, axis=1)


def _plain(scene, ro, rd):
    return [x.numpy() for x in ct.cluster_sweep_plain(
        scene.triangles, torch.from_numpy(ro), torch.from_numpy(rd), 1e-3, np.inf)]


def test_c6_tables_equal_jax(c6):
    """The whole SceneData, triangle sweep and cluster tables included,
    equals the JAX builder's bit for bit; both pick the cluster sweep."""
    scene, cam, param, jscene, jcam = c6
    _assert_tables_equal(scene, jscene)
    assert scene.n_triangles == 79488 and scene.triangles.cl_d0.shape == (20, 4096)
    assert pi.mesh_strategy(scene) == ji.mesh_strategy(jscene) == "cluster"
    assert dataclasses.asdict(cam) == dataclasses.asdict(jcam)
    assert (param.width, param.height, param.max_depth) == (512, 512, None)


def test_cluster_aabbs_match_pallas_packing(c6):
    """K6's (Kc, 6) boxes of 128 triangles are the Pallas kernel's chunk
    AABBs at cl_chunk 128 (which pads the table to a multiple of 1024
    with empty boxes), each grown outward by AABB_PAD_ULPS float32 eps x
    the box's reach (its largest |coordinate|), bit for bit."""
    from ray_tracing_tpu_torch.models.scene import AABB_PAD_ULPS

    scene, _, _, jscene, _ = c6
    aabb = ct.pack_cluster_aabbs(scene.triangles).numpy()
    jaabb = np.asarray(pack_chunk_aabbs(jscene.triangles, chunk=ct.CL_CHUNK)).T
    assert aabb.shape == (621, 6)
    lo, hi = jaabb[:621, 0:3], jaabb[:621, 3:6]
    reach = np.maximum(np.abs(lo), np.abs(hi)).max(axis=1, keepdims=True)
    margin = np.float32(AABB_PAD_ULPS * EPS32) * reach
    np.testing.assert_array_equal(aabb, np.concatenate([lo - margin, hi + margin], axis=1))
    assert np.all(np.isinf(jaabb[621:]))


def test_cluster_sweep_matches_jax_xla(c6):
    """1,024 seeded rays aimed at the grid: found and idx equal to the
    XLA cluster sweep, t to rtol 1e-6."""
    scene, _, _, jscene, _ = c6
    ro, rd = _grid_rays(1024, 0)
    t, idx, found = _plain(scene, ro, rd)
    rt, ridx, rfound = (np.asarray(x) for x in ji._triangle_cluster_phase_a(
        jscene, jnp.asarray(ro), jnp.asarray(rd), 1e-3, jnp.inf))
    assert found.mean() > 0.2
    np.testing.assert_array_equal(found, rfound)
    np.testing.assert_array_equal(idx[found], ridx[rfound])
    np.testing.assert_allclose(t[found], rt[rfound], rtol=1e-6)


def test_cluster_sweep_equals_dense_sweep(c6):
    """The cull only saves work: bit-equal to triangle_sweep_plain."""
    scene, _, _, _, _ = c6
    ro, rd = (torch.from_numpy(x) for x in _grid_rays(1024, 1))
    got = ct.cluster_sweep_plain(scene.triangles, ro, rd, 1e-3, np.inf)
    tri = ct.pack_triangle_table(scene.triangles)
    want = ct.triangle_sweep_plain(tri, scene.triangles.sw_origin, ro, rd, 1e-3, np.inf)
    assert bool(want[2].any())
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert torch.equal(got[1][got[2]], want[1][want[2]])


@pytest.mark.parametrize("copies", [4, 27], ids=["K6-grid4", "K7-grid27"])
def test_cluster_sweep_matches_pallas_interpret(copies):
    """Against pallas_cluster_sweep(interpret=True) at cl_chunk 128 on
    512 rays: 4 copies (156 clusters, _run_cluster) and 27 copies
    (134,136 triangles, 1,048 clusters, past the 1,024 of one AABB page:
    _run_cluster_paged), tables equal to JAX's.  found and idx equal,
    t to rtol 1e-6 widened per ray by the conditioning of the winner's
    t (_sweep_t_slack): the interpreted kernel's dot products round
    apart on grazing hits (ROADMAP Queue 3)."""
    ours, ref = scenes.bunny_copies(copies), _jax_grid_scene(copies)
    _assert_tables_equal(ours, ref)
    assert -(-ours.n_triangles // ct.CL_CHUNK) > (1024 if copies == 27 else 128)
    ro, rd = _bunny_rays(512, copies)
    t, idx, found = _plain(ours, ro, rd)
    rt, ridx, rfound = (np.asarray(x) for x in pallas_cluster_sweep(
        ref, jnp.asarray(ro), jnp.asarray(rd), interpret=True, cl_chunk=ct.CL_CHUNK))
    assert found.mean() > 0.1
    np.testing.assert_array_equal(found, rfound)
    np.testing.assert_array_equal(idx[found], ridx[rfound])
    dt = np.abs(t[found].astype(np.float64) - rt[rfound])
    bound = 1e-6 * np.abs(rt[rfound]) + _sweep_t_slack(ours.triangles, ro[found], rd[found],
                                                        idx[found])
    assert np.all(dt <= bound), (dt / bound).max()


def test_cluster_sweep_on_cpu_takes_the_plain_version(c6):
    scene, _, _, _, _ = c6
    ro, rd = (torch.from_numpy(x) for x in _grid_rays(300, 2))
    before = (ct.LAUNCHES, ct.CL_LAUNCHES)
    got = ct.cluster_sweep(scene.triangles, ro, rd, 1e-3, np.inf)
    want = ct.cluster_sweep_plain(scene.triangles, ro, rd, 1e-3, np.inf)
    assert (ct.LAUNCHES, ct.CL_LAUNCHES) == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    tr = scene.triangles
    with pytest.raises(ValueError, match="CUDA"):
        ct.cluster_sweep_cuda(ct.pack_triangle_table(tr), ct.pack_cluster_aabbs(tr),
                              tr.sw_origin, ro, rd, 1e-3, np.inf)


@pytest.fixture(scope="module")
def hit_rays(c6):
    """32x32 C6 camera rays (key 3) and, from JAX's own first bounce, the
    second-bounce rays of those that scatter."""
    _, _, _, jscene, jcam = c6
    jro, jrd, _, _ = jcamera_rays(JCamera.build(jcam, 1.0), jax.random.key(3), SIZE, SIZE)
    n = SIZE * SIZE
    hit = ji.intersect_scene(jscene, jro, jrd, 1e-3, jnp.inf)
    u = jray_uniforms(jax.random.key(5), jnp.arange(n), 0, J_N_SCATTER_U)
    _, sc = jshade(jscene, hit, jrd, u)
    live = np.resize(np.flatnonzero(np.asarray(hit.mask & sc.scattered)), n)
    return {
        "camera": (np.array(jro), np.array(jrd)),
        "second-bounce": (np.asarray(hit.p)[live], np.asarray(sc.direction)[live]),
    }


@pytest.mark.parametrize("which", ["camera", "second-bounce"])
def test_hit_matches_jax(c6, hit_rays, which):
    """kind, index, material, mask and front face equal; uv to rtol 1e-5
    / atol 1e-6; p to 1e-5 (|ro| + t |rd|) per component
    (tests/test_torch_scene_json.py:test_hit_matches_jax); t to rtol
    1e-5 and the normal to rtol 1e-5 / atol 1e-6, each widened on
    triangle hits by its conditioning (_sweep_t_slack for t,
    _normal_slack for the barycentrics; ROADMAP Queue 3)."""
    scene, _, _, jscene, _ = c6
    ro, rd = hit_rays[which]
    mine = pi.intersect_scene(scene, torch.from_numpy(ro), torch.from_numpy(rd), 1e-3, np.inf)
    hit = jax.tree.map(np.asarray, ji.intersect_scene(jscene, jnp.asarray(ro), jnp.asarray(rd),
                                                      1e-3, jnp.inf))
    for name in ("kind", "index", "material", "mask", "front_face"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(), getattr(hit, name),
                                      err_msg=name)
    m = hit.mask
    tri = hit.kind == pi.KIND_TRIANGLE
    assert tri.sum() > 100 and (hit.kind == pi.KIND_RECT).sum() > 20
    t_slack = np.zeros(len(m))
    t_slack[tri] = _sweep_t_slack(scene.triangles, ro[tri], rd[tri], hit.index[tri])
    dt = np.abs(mine.t.numpy()[m].astype(np.float64) - hit.t[m])
    assert np.all(dt <= 1e-5 * hit.t[m] + t_slack[m]), (dt / (1e-5 * hit.t[m] + t_slack[m])).max()
    dp = np.abs(mine.p.numpy()[m].astype(np.float64) - hit.p[m])
    scale = np.linalg.norm(ro[m], axis=1) + hit.t[m] * np.linalg.norm(rd[m], axis=1)
    assert np.all(dp <= 1e-5 * scale[:, None]), (dp / scale[:, None]).max()
    slack = np.zeros(len(m))
    slack[tri] = _normal_slack(scene.triangles, ro[tri], rd[tri], hit.index[tri])
    dn = np.abs(mine.normal.numpy()[m].astype(np.float64) - hit.normal[m])
    bound = 1e-5 * np.abs(hit.normal[m]) + 1e-6 + slack[m][:, None]
    assert np.all(dn <= bound), (dn / bound).max()
    np.testing.assert_allclose(mine.uv.numpy()[m], hit.uv[m], rtol=1e-5, atol=1e-6)


def _jax_renderer(c6, depth):
    _, _, _, jscene, jcam = c6
    return jrt.Renderer(jrt.RendererParam(SIZE, SIZE, max_depth=depth), jcam, jscene)


def _renderer(c6, depth, **kw):
    scene, cam, _, _, _ = c6
    return prt.Renderer(prt.RendererParam(SIZE, SIZE, max_depth=depth), cam, scene,
                        device="cpu", **kw)


def test_depth_one_image_equals_jax(c6):
    a = _renderer(c6, 1).render(0).numpy()
    b = np.asarray(_jax_renderer(c6, 1).render(jax.random.key(0)))
    assert a.shape == b.shape == (SIZE, SIZE, 3)
    assert np.array_equal(a, b)


def test_depth_four_inside_noise_floor(c6):
    """Matched key 42 against JAX's render of the same pass: the mean
    difference is at most 0.6x the port's own difference between keys 42
    and 43; and the pass takes the cluster sweep without a launch."""
    ours = _renderer(c6, 4)
    before = (ct.LAUNCHES, ct.CL_LAUNCHES)
    mine = ours.render(42).numpy()
    assert (ct.LAUNCHES, ct.CL_LAUNCHES) == before
    ref = np.asarray(_jax_renderer(c6, 4).render(jax.random.key(42)))
    matched = np.abs(mine - ref).mean()
    floor = np.abs(mine - ours.render(43).numpy()).mean()
    assert np.isfinite(mine).all() and (mine >= 0).all()
    assert floor > 0 and matched <= 0.6 * floor, (matched, floor)


def test_jax_mean_inside_smoke_range(c6):
    """JAX's 32^2 renders of C6 at the default depth 20 (keys 0 and 1)
    have means inside the range chip_smoke.py holds the card's 512^2
    passes to (C6_MEAN)."""
    from chip_smoke import C6_MEAN

    r = _jax_renderer(c6, 20)
    for key in (0, 1):
        mean = np.asarray(r.render(jax.random.key(key))).astype(np.float64).mean()
        assert C6_MEAN[0] < mean < C6_MEAN[1], mean
