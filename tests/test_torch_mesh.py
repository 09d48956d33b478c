"""The port's mesh surface against the JAX package's: OBJ arrays, the
Morton order of the triangle table, the sweep constants, and the whole
compiled data/scene.json (triangle, rect, transform, medium, material
and light tables), all compared exactly."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import ray_tracing_tpu as jrt
import ray_tracing_tpu_torch as prt
from ray_tracing_tpu.models import mesh as jmesh
from ray_tracing_tpu.ops import bvh as jbvh
from ray_tracing_tpu.ops import geometry as jgeo
from ray_tracing_tpu_torch.models import compiler, mesh
from ray_tracing_tpu_torch.ops import geometry as geo
from test_torch_scene import _assert_tables_equal as assert_tables_equal

torch.set_num_threads(2)

SCENE = "data/scene.json"
BUNNY = "data/bunny.obj"


@pytest.fixture(scope="module")
def bundles():
    return prt.load_scene_json(SCENE), jrt.load_scene_json(SCENE)


def test_bunny_obj_arrays_equal_jax_loader():
    ours = mesh.load_triangles(BUNNY)
    ref = jmesh.load_triangles(BUNNY)
    assert ours[0].shape == (4968, 3, 3)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


_QUAD = ("o quad\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
         "vn 0 0 1\nf 1/1/1 2/2/1 3/3/1 4/4/1\n")
_TWO = ("o first\nv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"
        "g second\nv 0 0 1\nv 2 0 1\nv 0 1 1\nv 2 2 3\nf -4 -3 -2\nf 4/ 5 6 7\n")


@pytest.mark.parametrize("text, model", [(_QUAD, None), (_TWO, None), (_TWO, 1),
                                         (_TWO, "second")],
                         ids=["fan-with-normals-and-uvs", "first", "by-index", "by-name"])
def test_small_obj_files_equal_jax_parser(tmp_path, text, model):
    """Fan triangulation, file normals and uvs, negative indices, corners
    without a vt, and model selection, against the JAX package's own
    parser (mesh_triangles(parse_obj(...)))."""
    path = tmp_path / "m.obj"
    path.write_text(text)
    ours = mesh.mesh_triangles(mesh.parse_obj(str(path)), model)
    ref = jmesh.mesh_triangles(jmesh.parse_obj(str(path)), model)
    for a, b in zip(ours, ref):
        # smooth normals: float64 here, float32 in the JAX parser (the JAX
        # package's native loader, which it prefers, sums in float64)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours[0], ref[0])


def test_morton_order_equals_jax():
    r = np.random.RandomState(0)
    lo = r.uniform(-5, 5, (3000, 3)).astype(np.float32)
    hi = lo + r.uniform(0, 0.5, (3000, 3)).astype(np.float32)
    lo[:40] = lo[0]  # duplicated centroids: the stable order decides
    hi[:40] = hi[0]
    ours = compiler.morton_order(lo, hi)
    np.testing.assert_array_equal(ours, jbvh.morton_order(lo, hi))
    np.testing.assert_array_equal(ours[ours < 40], np.arange(40))  # one code, file order
    x = r.uniform(0, 1, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(compiler._morton3(x), jbvh._morton3(x))


def test_sweep_tables_equal_jax():
    pts, _, _ = mesh.load_triangles(BUNNY)
    v0, e12, e13 = pts[:, 0], pts[:, 1] - pts[:, 0], pts[:, 2] - pts[:, 0]
    for a, b in zip(geo.triangle_sweep_tables(v0, e12, e13),
                    jgeo.triangle_sweep_tables(v0, e12, e13)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_scene_json_tables_equal_jax(bundles):
    ours, ref = bundles
    assert_tables_equal(ours.scene, ref.scene)
    s = ours.scene
    assert (s.n_triangles, s.n_rects, s.n_spheres, s.n_medium) == (4969, 12, 3, 1)
    assert s.rects.has_transforms and not s.spheres.has_transforms
    assert s.triangles.has_sweep and s.transforms.inv.shape == (2, 3, 3)
    assert ours.renderer == prt.RendererParam(**dataclasses.asdict(ref.renderer))
    assert dataclasses.asdict(ours.camera) == dataclasses.asdict(ref.camera)


def test_scene_json_is_morton_sorted_as_jax(bundles):
    """The bunny's triangles are not in file order: the loose triangle
    (material 2, the metal) lands where the Morton order puts it."""
    ours, ref = bundles
    metal = np.flatnonzero(ours.scene.triangles.material.numpy() == 2)
    np.testing.assert_array_equal(metal, np.flatnonzero(np.asarray(ref.scene.triangles.material) == 2))
    assert metal.tolist() != [4968]


def test_scene_from_numpy_bridges_scene_json(bundles):
    ours, ref = bundles
    bridged = prt.scene_from_numpy(jax.tree.map(np.asarray, ref.scene))
    assert_tables_equal(bridged, ref.scene)
    assert_tables_equal(prt.scene_from_numpy(ours.scene), ours.scene)
    moved = bridged.to("cpu")
    assert_tables_equal(moved, ref.scene)


_CAMERA = {"look_from": [0, 0, -5], "look_at": [0, 0, 0], "vfov": 40}
_WHITE = {"type": "lambertian", "texture": {"type": "solid-color", "color": [0.5, 0.5, 0.5]}}
_ISO = {"type": "isotropic", "albedo": {"type": "solid-color", "color": [0.9, 0.8, 0.7]}}
_TF = {"transform": [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 2.0]], "translate": [1, 2, 3]}


@pytest.mark.parametrize(
    "objects",
    [
        [{"shape": {"type": "mesh", "file": "bunny.obj", **_TF}, "material": _WHITE,
          "important": True}],
        [{"shape": {"type": "triangle", "vertices": [[0, 0, 0], [1, 0, 0], [0, 1, 0]], **_TF},
          "material": _WHITE, "important": True},
         {"shape": {"type": "sphere", "center": [0, 0, 0], "radius": 1, **_TF},
          "material": _WHITE, "important": True},
         {"shape": {"type": "xy-rect", "x0": 0, "x1": 1, "y0": 0, "y1": 1, "z": 0,
                    "translate": [0, 0, 1]}, "material": _WHITE}],
        [{"shape": {"type": "constant-medium", "density": 0.2, **_TF,
                    "shape": {"type": "cuboid", "p0": [0, 0, 0], "p1": [1, 2, 3]}},
          "material": _ISO}],
        [{"shape": {"type": "constant-medium", "density": 0.5,
                    "shape": {"type": "zx-rect", "z0": 0, "z1": 1, "x0": 0, "x1": 1, "y": 0}},
          "material": _ISO},
         {"shape": {"type": "constant-medium", "density": 0.5,
                    "shape": {"type": "triangle", "vertices": [[0, 0, 0], [1, 0, 0], [0, 1, 0]]}},
          "material": _ISO}],
        [{"shape": {"type": "constant-medium", "density": 3.0, "translate": [0, 1, 0],
                    "shape": {"type": "mesh", "file": "bunny.obj"}}, "material": _ISO}],
    ],
    ids=["transformed-mesh-light", "transformed-triangle-sphere-rect", "medium-cuboid",
         "media-rect-triangle", "medium-mesh"],
)
def test_shapes_equal_jax(objects):
    """Surface scene.json does not reach: transformed meshes, triangles,
    spheres and rects, important triangles (Morton-remapped light
    indices), and constant media over each inner shape kind."""
    param = {"renderer": {"width": 8, "height": 8}, "camera": _CAMERA, "objects": objects}
    ours = compiler.build_scene(param, base_dir="data").scene
    ref = jrt.build_scene(param, base_dir="data").scene
    assert_tables_equal(ours, ref)
    assert ours.n_lights == ref.n_lights
