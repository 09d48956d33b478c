"""The CUDA sweeps' tables and yardstick on the CPU: the (T, 16) table
and the padded (Kc, 6) cluster boxes that the compiler packs once per
scene, the count of (ray, cluster) pairs that a front-to-back sweep
needs (cuda_triangles.needed_cluster_pairs) against a brute-force numpy
count.  The kernels themselves are held against the plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import ray_tracing_tpu_torch as prt
from ray_tracing_tpu_torch import scenes
from ray_tracing_tpu_torch.models.scene import AABB_PAD_ULPS, scene_from_numpy
from ray_tracing_tpu_torch.ops import cuda_triangles as ct

torch.set_num_threads(2)

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def tables():
    return {
        "scene.json": prt.load_scene_json("data/scene.json").scene.triangles,
        "C6": scenes.bunny_grid()[0].triangles,
        "27 bunnies": scenes.bunny_copies(27).triangles,
    }


@pytest.mark.parametrize("name", ["scene.json", "C6", "27 bunnies"])
def test_cached_tables_equal_fresh_packs(tables, name):
    """The compiler's sw_table / sw_aabb equal a fresh pack, come through
    scene_from_numpy, and move with .to."""
    tr = tables[name]
    assert torch.equal(tr.sw_table, ct.pack_triangle_table(tr))
    assert torch.equal(tr.sw_aabb, ct.pack_cluster_aabbs(tr))
    assert tr.sw_table.shape == (len(tr), ct.TRI_COLS)
    assert tr.sw_aabb.shape == (-(-len(tr) // ct.CL_CHUNK), 6)
    moved = tr.to("meta")
    assert moved.sw_table.device.type == moved.sw_aabb.device.type == "meta"
    back = tr.to("cpu")
    assert torch.equal(back.sw_table, tr.sw_table) and torch.equal(back.sw_aabb, tr.sw_aabb)


def test_scene_from_numpy_packs_the_kernel_tables(tables):
    scene = prt.load_scene_json("data/scene.json").scene
    bridged = scene_from_numpy(scene).triangles
    assert torch.equal(bridged.sw_table, tables["scene.json"].sw_table)
    assert torch.equal(bridged.sw_aabb, tables["scene.json"].sw_aabb)


@pytest.mark.parametrize("name", ["scene.json", "C6"])
def test_padded_boxes_hold_their_vertices(tables, name):
    """Every vertex (in the sweep frame, as the boxes are computed) lies
    inside its cluster's box, and each side is grown by at least one and
    at most 2 * AABB_PAD_ULPS + 1 float32 ulps of the box's reach (its
    largest |coordinate|; the margin is AABB_PAD_ULPS eps x reach, and
    the two roundings of padding and difference add one ulp)."""
    tr = tables[name]
    v0 = (tr.v0 - tr.sw_origin).numpy()
    corners = np.stack([v0, v0 + tr.e12.numpy(), v0 + tr.e13.numpy()], axis=1)  # (T, 3, 3)
    aabb = tr.sw_aabb.numpy()
    cluster = np.arange(len(tr)) // ct.CL_CHUNK
    lo, hi = aabb[cluster, None, 0:3], aabb[cluster, None, 3:6]
    assert np.all(corners >= lo) and np.all(corners <= hi)
    exact_lo = np.full((aabb.shape[0], 3), np.inf, np.float32)
    exact_hi = np.full((aabb.shape[0], 3), -np.inf, np.float32)
    np.minimum.at(exact_lo, cluster, corners.min(axis=1))
    np.maximum.at(exact_hi, cluster, corners.max(axis=1))
    reach = np.maximum(np.abs(exact_lo), np.abs(exact_hi)).max(axis=1, keepdims=True)
    ulp = np.spacing(reach.astype(np.float32))
    for grown in (exact_lo - aabb[:, 0:3], aabb[:, 3:6] - exact_hi):
        assert np.all(grown >= ulp) and np.all(grown <= (2 * AABB_PAD_ULPS + 1) * ulp)


def _numpy_needed(aabb, ro, rd, t_min, t_hit):
    """(Kc,) brute-force count of the rays that enter each box within
    [t_min, t_hit], in float32 with NaN-propagating min/max (a NaN slab
    counts as entered)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = (np.float32(1.0) / rd)[:, None, :]
        a = (aabb[None, :, 0:3] - ro[:, None, :]) * inv
        b = (aabb[None, :, 3:6] - ro[:, None, :]) * inv
    near = np.maximum(np.minimum(a, b).max(axis=2), np.float32(t_min))
    far = np.minimum(np.maximum(a, b).min(axis=2), t_hit[:, None])
    return (~(near > far)).sum(axis=0)


def test_needed_pairs_match_a_brute_force_count(tables):
    """Seeded rays against scene.json's 39 clusters: aimed at the bunny
    (hits), away from it (misses), axis-parallel (1/rd = inf), and
    axis-parallel in a box face's plane (0 * inf = NaN, entered); t_hit
    the dense sweep's winners, t_max on a miss."""
    tr = tables["scene.json"]
    aabb = tr.sw_aabb.numpy()
    r = np.random.RandomState(0)
    n = 400
    ro = r.uniform(20.0, 535.0, (n, 3)).astype(np.float32)
    target = r.uniform([250, 30, 140], [360, 190, 270], (n, 3)).astype(np.float32)
    rd = target - ro
    rd[n // 4:n // 2] *= -1.0  # away from the bunny
    axis = r.randint(0, 3, n // 4)
    par = np.zeros((n // 4, 3), np.float32)
    par[np.arange(n // 4), axis] = 1.0
    rd[n // 2:3 * n // 4] = par
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    # the last quarter in the sweep frame: axis-parallel from a box's
    # lo face plane on another axis, so that (lo - ro) * inf is NaN
    ro_s = (ro - tr.sw_origin.numpy()).astype(np.float32)
    k = r.randint(0, aabb.shape[0], n // 4)
    face = (axis + 1) % 3
    ro_s[3 * n // 4:][np.arange(n // 4), face] = aabb[k, face]
    rd[3 * n // 4:] = par
    ro_t, rd_t = torch.from_numpy(ro_s), torch.from_numpy(rd)
    zero = torch.zeros(3)
    t, _, found = ct.triangle_sweep_plain(tr.sw_table, zero, ro_t, rd_t, 1e-3, np.inf)
    assert 0.1 < float(found.float().mean()) < 0.9
    t_hit = torch.where(found, t, torch.tensor(np.inf))
    got = ct.needed_cluster_pairs(tr.sw_aabb, zero, ro_t, rd_t, 1e-3, t_hit).numpy()
    want = _numpy_needed(aabb, ro_s, rd, 1e-3, t_hit.numpy())
    np.testing.assert_array_equal(got, want)
    # the NaN rays count their face's box as entered
    with np.errstate(invalid="ignore"):
        nan_rows = np.isnan((aabb[k, face] - ro_s[3 * n // 4:][np.arange(n // 4), face]) * np.inf)
    assert nan_rows.all()
    assert got.sum() > 0 and got.sum() < n * aabb.shape[0]
    # a finite t_hit window only removes pairs
    short = ct.needed_cluster_pairs(tr.sw_aabb, zero, ro_t, rd_t, 1e-3, torch.minimum(
        t_hit, torch.tensor(50.0))).numpy()
    assert np.all(short <= got) and short.sum() < got.sum()

