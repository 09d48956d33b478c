"""The port's BVH (ray_tracing_tpu_torch/ops/bvh.py) against the JAX
package's (ray_tracing_tpu/ops/bvh.py), the counterparts of
tests/test_bvh.py: the structure on the bunny, the tree array for array,
the walk against brute force and against JAX's walk on rays from a shell
around the bunny, and scene.json's hits and depth-1 image through the
walk against the dense sweep.  A scene reaches the walk with a BVH and
neither sweep nor cluster tables (``SceneBuilder.build(bvh=True)``)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracing_tpu as jrt
import ray_tracing_tpu_torch as prt
from ray_tracing_tpu.ops.bvh import bvh_traverse_triangles as jax_walk
from ray_tracing_tpu_torch import scenes
from ray_tracing_tpu_torch.ops import bvh
from ray_tracing_tpu_torch.ops import geometry as geo
from ray_tracing_tpu_torch.ops.intersect import intersect_scene, mesh_strategy

torch.set_num_threads(2)

INF = float("inf")


def _jax_c4():
    root = os.path.join(os.path.dirname(__file__), "..", "examples")
    sys.path.insert(0, root)
    try:
        from render_baselines import scene_c4
    finally:
        sys.path.remove(root)
    return scene_c4()[0].build()


@pytest.fixture(scope="module")
def bunny():
    """The port's C4 with its BVH, and the JAX package's C4."""
    return scenes.bunny(bvh=True)[0], _jax_c4()


def _shell_rays(n=512):
    """tests/test_bvh.py's rays: origins on a shell, aimed at the bunny."""
    rng = np.random.RandomState(0)
    origins = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    origins[:, 2] += 0.5
    targets = rng.uniform(-0.05, 0.15, (n, 3)).astype(np.float32)
    d = targets - origins
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return origins, d


def test_bvh_structure_invariants(bunny):
    """Miss links advance (the walk halts), the leaves partition the
    triangles, and each leaf's box holds its triangles."""
    scene, _ = bunny
    tree = scene.bvh
    m = tree.n_nodes
    miss, start, count = (x.numpy() for x in (tree.miss_link, tree.leaf_start, tree.leaf_count))
    assert (miss > np.arange(m)).all() and miss.max() == m
    leaf = start >= 0
    assert count[leaf].sum() == scene.n_triangles and count.max() <= bvh.LEAF_SIZE
    covered = np.zeros(scene.n_triangles, bool)
    for s, c in zip(start[leaf], count[leaf]):
        assert not covered[s:s + c].any()
        covered[s:s + c] = True
    assert covered.all()
    tr = scene.triangles
    verts = torch.stack([tr.v0, tr.v0 + tr.e12, tr.v0 + tr.e13], dim=1).numpy()
    nmin, nmax = tree.node_min.numpy(), tree.node_max.numpy()
    for i in np.nonzero(leaf)[0]:
        tv = verts[start[i]:start[i] + count[i]].reshape(-1, 3)
        assert (tv >= nmin[i] - 1e-6).all() and (tv <= nmax[i] + 1e-6).all()
    np.testing.assert_array_equal(tree.node_f.numpy(), np.concatenate([nmin, nmax], axis=1))


@pytest.mark.parametrize("which", ["bunny", "scene.json"])
def test_with_bvh_equals_jax_tree(bunny, which):
    """SceneBuilder.build(bvh=True) (ops/bvh.py:with_bvh) builds the JAX
    SceneBuilder's tree over the same Morton order, every array exactly,
    leaves out the sweep and cluster tables, and ``.to`` moves the tree
    with the scene."""
    if which == "bunny":
        ours, ref = bunny
    else:
        ours = prt.load_scene_json("data/scene.json", bvh=True).scene
        ref = jrt.load_scene_json("data/scene.json").scene
    assert ours.bvh.n_nodes == ref.bvh.n_nodes and mesh_strategy(ours) == "bvh"
    assert ours.triangles.sw_table is None and ours.triangles.cl_d0 is None
    for f in ("node_min", "node_max", "miss_link", "leaf_start", "leaf_count", "node_f",
              "node_i", "leaf_tris"):
        mine, theirs = getattr(ours.bvh, f).numpy(), np.asarray(getattr(ref.bvh, f))
        assert mine.dtype == theirs.dtype, f
        np.testing.assert_array_equal(mine, theirs, err_msg=f)
    moved = ours.to("meta").bvh
    assert moved.node_f.device.type == "meta" and moved.n_nodes == ours.bvh.n_nodes


def test_walk_matches_brute_force(bunny):
    """The walk against triangle_t over all 4,968 triangles: the same rays
    hit, t to rtol 1e-5, and the winner's own t is the brute-force one."""
    scene, _ = bunny
    tr = scene.triangles
    o, d = _shell_rays()
    ro, rd = torch.from_numpy(o), torch.from_numpy(d)
    hit = bvh.bvh_traverse_triangles(scene.bvh, ro, rd, 1e-3, INF)
    t, mask, *_ = geo.triangle_t(ro[:, None], rd[:, None], tr.v0, tr.e12, tr.e13, 1e-3, INF)
    brute = torch.where(mask, t, INF).amin(dim=1)
    found = torch.isfinite(brute)
    assert torch.equal(hit.mask, found) and int(found.sum()) > 50
    np.testing.assert_allclose(hit.t[found].numpy(), brute[found].numpy(), rtol=1e-5)
    assert torch.equal(hit.t[found], t[found, hit.index[found].long()])


def test_walk_matches_jax_walk(bunny):
    """The port's walk against the JAX package's on its own tree: mask
    and index equal, t to rtol 1e-6 (XLA-CPU may fuse the triple
    products); every step reads one flag, counted in ``bvh.STEPS``."""
    scene, ref = bunny
    o, d = _shell_rays()
    before = (bvh.WALKS, bvh.STEPS)
    hit = bvh.bvh_traverse_triangles(scene.bvh, torch.from_numpy(o), torch.from_numpy(d), 1e-3,
                                     INF)
    assert bvh.WALKS == before[0] + 1 and bvh.STEPS - before[1] > 10
    want = jax_walk(ref.bvh, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.inf)
    mask = np.asarray(want.mask)
    np.testing.assert_array_equal(hit.mask.numpy(), mask)
    np.testing.assert_array_equal(hit.index.numpy(), np.asarray(want.index))
    np.testing.assert_allclose(hit.t.numpy()[mask], np.asarray(want.t)[mask], rtol=1e-6)
    assert np.isinf(hit.t.numpy()[~mask]).all()


@pytest.fixture(scope="module")
def scene_json():
    bundle = prt.load_scene_json("data/scene.json")
    return bundle, prt.load_scene_json("data/scene.json", bvh=True).scene


def test_intersect_scene_walk_matches_sweep(scene_json):
    """tests/test_bvh.py::test_scene_json_render_with_bvh on the port:
    camera-like rays into scene.json through the walk and through the
    dense sweep, mask and material equal, t rtol 1e-5, p rtol 1e-4 atol
    1e-3."""
    bundle, walked = scene_json
    assert mesh_strategy(walked) == "bvh" and mesh_strategy(bundle.scene) == "sweep"
    rng = np.random.RandomState(1)
    n = 256
    ro = torch.from_numpy(np.tile([[278.0, 278.0, -500.0]], (n, 1)).astype(np.float32))
    d = np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.4, 0.4, n), np.ones(n)],
                 -1).astype(np.float32)
    rd = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    med_u = torch.full((n, 1), 0.5)
    walks = bvh.WALKS
    got = intersect_scene(walked, ro, rd, 1e-3, INF, med_u)
    assert bvh.WALKS == walks + 1
    want = intersect_scene(bundle.scene, ro, rd, 1e-3, INF, med_u)
    assert torch.equal(got.mask, want.mask) and torch.equal(got.material, want.material)
    assert int((got.kind == 1).sum()) > 10  # the bunny is hit
    np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got.p.numpy(), want.p.numpy(), rtol=1e-4, atol=1e-3)


def test_depth_one_render_through_the_walk_equals_the_sweep(scene_json):
    """A 32x32 depth-1 pass of scene.json through the walk equals the
    sweep's: phase B rebuilds the record from the winning index."""
    bundle, walked = scene_json
    param = prt.RendererParam(32, 32, max_depth=1)
    got = prt.Renderer(param, bundle.camera, walked, device="cpu").render(0)
    want = prt.Renderer(param, bundle.camera, bundle.scene, device="cpu").render(0)
    assert torch.equal(got, want) and float(want.amax()) > 0
