"""The port's forward render of data/scene.json (the bunny mesh, a
transformed cuboid, a constant medium) against the JAX package's: the
hit record of camera and second-bounce rays, the depth-1 image, the
matched-key image at depth 4 inside the noise floor, and the port's own
invariants (compaction equals the dense loop; a pass is a pure function
of its key; scenes without media draw the same uniforms as before).
The gradient pass on the scene is tests/test_torch_prb_scene.py's."""

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
from ray_tracing_tpu.ops.materials import N_SCATTER_U as J_N_SCATTER_U
from ray_tracing_tpu.ops.materials import shade as jshade
from ray_tracing_tpu.ops.rng import ray_uniforms as jray_uniforms
from ray_tracing_tpu_torch.ops import cuda_intersect as ci
from ray_tracing_tpu_torch.ops import cuda_triangles as ct
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.ops.intersect import KIND_SPHERE, intersect_scene
from ray_tracing_tpu_torch.ops.materials import N_SCATTER_U

torch.set_num_threads(2)

SCENE = "data/scene.json"
SIZE = 32


@pytest.fixture(scope="module")
def bundles():
    return prt.load_scene_json(SCENE), jrt.load_scene_json(SCENE)


def _renderer(bundle, depth, **kw):
    return prt.Renderer(prt.RendererParam(SIZE, SIZE, max_depth=depth), bundle.camera,
                        bundle.scene, device="cpu", **kw)


@pytest.fixture(scope="module")
def hit_rays(bundles):
    """32x32 camera rays (key 3) and, from JAX's own first bounce, the
    second-bounce rays of those that scatter; seeded medium uniforms."""
    _, ref = bundles
    jro, jrd, _, _ = jcamera_rays(JCamera.build(ref.camera, 1.0), jax.random.key(3), SIZE, SIZE)
    n = SIZE * SIZE
    med_u = np.random.RandomState(0).uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    hit = ji.intersect_scene(ref.scene, jro, jrd, 1e-3, jnp.inf, jnp.asarray(med_u))
    u = jray_uniforms(jax.random.key(5), jnp.arange(n), 0, J_N_SCATTER_U)
    _, sc = jshade(ref.scene, hit, jrd, u)
    # the scattered rays, repeated up to n so that JAX's eager ops reuse
    # the executables they compiled for the camera rays
    live = np.resize(np.flatnonzero(np.asarray(hit.mask & sc.scattered)), n)
    return {
        "camera": (np.array(jro), np.array(jrd), med_u),
        "second-bounce": (np.asarray(hit.p)[live], np.asarray(sc.direction)[live], med_u[live]),
    }


@pytest.mark.parametrize("which", ["camera", "second-bounce"])
def test_hit_matches_jax(bundles, hit_rays, which):
    """kind, index, material, mask and front face equal on every ray;
    normal and uv to rtol 1e-5 / atol 1e-6 (unit-scale values, some
    components near 0); t to rtol 1e-5 except on sphere hits, where
    disc = half_b^2 - c cancels for rays leaving the surface (ROADMAP
    Queue 3, grazing sphere hits).  p = ro + rd t carries the rounding
    of that sum and t's own error along the ray, so each component is
    held to 1e-5 (|ro| + t |rd|): a component that should be 0 on a
    rect's plane comes out as 0 or as a few ulps of the terms (ROADMAP
    Queue 3, parity bounds)."""
    ours, ref = bundles
    ro, rd, med_u = hit_rays[which]
    mine = intersect_scene(ours.scene, torch.from_numpy(ro), torch.from_numpy(rd), 1e-3, np.inf,
                           torch.from_numpy(med_u))
    hit = jax.tree.map(np.asarray, ji.intersect_scene(
        ref.scene, jnp.asarray(ro), jnp.asarray(rd), 1e-3, jnp.inf, jnp.asarray(med_u)))
    for name in ("kind", "index", "material", "mask", "front_face"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(), getattr(hit, name),
                                      err_msg=name)
    assert len(set(hit.kind.tolist()) - {-1}) == 4, "spheres, triangles, rects and the medium"
    m = hit.mask
    dp = np.abs(mine.p.numpy()[m].astype(np.float64) - hit.p[m])
    scale = np.linalg.norm(ro[m], axis=1) + hit.t[m] * np.linalg.norm(rd[m], axis=1)
    assert np.all(dp <= 1e-5 * scale[:, None]), (dp / scale[:, None]).max()
    np.testing.assert_allclose(mine.normal.numpy()[m], hit.normal[m], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mine.uv.numpy()[m], hit.uv[m], rtol=1e-5, atol=1e-6)
    surf = m & (hit.kind != KIND_SPHERE)
    np.testing.assert_allclose(mine.t.numpy()[surf], hit.t[surf], rtol=1e-5)


@pytest.fixture(scope="module")
def jax_depth_one(bundles):
    _, ref = bundles
    return jrt.Renderer(jrt.RendererParam(SIZE, SIZE, max_depth=1), ref.camera, ref.scene)


@pytest.mark.parametrize("key", [0, 7])
def test_depth_one_image_equals_jax(bundles, jax_depth_one, key):
    """At depth 1 a pixel is pure emission or background."""
    a = _renderer(bundles[0], 1).render(key).numpy()
    b = np.asarray(jax_depth_one.render(key))
    assert a.shape == b.shape == (SIZE, SIZE, 3)
    assert np.array_equal(a, b)
    assert a.max() > 1.0, "the camera sees the light"


def test_depth_four_inside_noise_floor(bundles):
    """Matched key 42 against JAX's dense render of the same pass
    (tests/golden/scene_32_d4_key42.npy, tests/test_integrator.py:281):
    the mean difference is at most 0.6x the port's own difference
    between keys 42 and 43."""
    ours = _renderer(bundles[0], 4)
    mine = ours.render(42).numpy()
    golden = np.load("tests/golden/scene_32_d4_key42.npy")
    matched = np.abs(mine - golden).mean()
    floor = np.abs(mine - ours.render(43).numpy()).mean()
    assert floor > 0 and matched <= 0.6 * floor, (matched, floor)


@pytest.mark.parametrize("depth", [3, 12])
def test_compacted_equals_dense(bundles, depth):
    """Bit-identical radiance and segment count, with tiles that split the
    image unevenly."""
    img_c, seg_c = _renderer(bundles[0], depth, tile_size=600).render_with_stats(2)
    img_d, seg_d = _renderer(bundles[0], depth, tile_size=600,
                             compaction=False).render_with_stats(2)
    assert torch.equal(img_c, img_d)
    assert seg_c == seg_d > SIZE * SIZE


def test_full_depth_render_on_cpu_takes_the_plain_versions(bundles):
    """scene.json at its own depth 50: finite, non-negative, a pure
    function of its key, and drawn without a kernel launch on the CPU."""
    ours = _renderer(bundles[0], 50)
    before = (ci.LAUNCHES, ci.TF_LAUNCHES, ct.LAUNCHES)
    img = ours.render(0)
    assert (ci.LAUNCHES, ci.TF_LAUNCHES, ct.LAUNCHES) == before
    assert torch.isfinite(img).all() and (img >= 0).all()
    assert 0.3 < img.mean().item() < 1.0
    assert torch.equal(img, ours.render(0))
    assert not torch.equal(img, ours.render(1))


def test_uniform_columns_do_not_depend_on_the_medium_count():
    """The integrator draws N_SCATTER_U + n_medium columns per bounce; the
    scatter block is the same for any medium count, so scenes without
    media (zy) render exactly as before."""
    ids = torch.arange(5000, dtype=torch.int64) * 7 + 3
    key = rng.key(11)
    base = rng.ray_uniforms(key, ids, 4, N_SCATTER_U)
    for n_medium in (1, 3):
        wide = rng.ray_uniforms(key, ids, 4, N_SCATTER_U + n_medium)
        assert torch.equal(wide[:, :N_SCATTER_U], base)


def test_zy_image_unchanged_by_the_medium_columns():
    """zy at depth 4 against JAX's dense render of key 42
    (tests/golden/zy_32_d4_key42.npy): inside the noise floor, as before."""
    zy = prt.load_scene_json("data/zy_scene.json")
    ours = _renderer(zy, 4)
    mine = ours.render(42).numpy()
    golden = np.load("tests/golden/zy_32_d4_key42.npy")
    matched = np.abs(mine - golden).mean()
    floor = np.abs(mine - ours.render(43).numpy()).mean()
    assert matched <= 0.6 * floor, (matched, floor)
