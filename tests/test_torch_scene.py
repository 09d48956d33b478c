"""The port's scene compiler against the JAX package's: identical tables
for data/zy_scene.json, the scene bridge, the unported surface, and the
port's independence from JAX."""

import dataclasses
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

import ray_tracing_tpu as jrt
import ray_tracing_tpu_torch as prt
from ray_tracing_tpu_torch.models.compiler import build_scene, load_image

torch.set_num_threads(2)

ZY = "data/zy_scene.json"
PKG = os.path.dirname(prt.__file__)


def _assert_tables_equal(ours, ref, path="scene"):
    """Every field of the port's table equals the same-named field of
    the JAX table exactly (values, dtype and shape); the JAX package's
    BVH and cluster tables, which the port does not build, are not
    fields of the port's tables.  The CUDA sweeps' packed tables
    (``sw_table``, ``sw_aabb``) and phase A's (``phase_a``) have no JAX
    field of that name; tests/test_torch_sweep_cull.py and
    tests/test_torch_phase_a_tables.py hold them against fresh packs."""
    for f in dataclasses.fields(ours):
        if f.name in ("sw_table", "sw_aabb", "phase_a"):
            continue
        mine, theirs = getattr(ours, f.name), getattr(ref, f.name)
        where = f"{path}.{f.name}"
        if isinstance(mine, torch.Tensor):
            theirs = np.asarray(theirs)
            assert mine.numpy().dtype == theirs.dtype, where
            np.testing.assert_array_equal(mine.numpy(), theirs, err_msg=where)
        elif dataclasses.is_dataclass(mine):
            _assert_tables_equal(mine, theirs, where)
        elif isinstance(mine, tuple) and mine and dataclasses.is_dataclass(mine[0]):
            assert len(mine) == len(theirs), where
            for i, (a, b) in enumerate(zip(mine, theirs)):
                _assert_tables_equal(a, b, f"{where}[{i}]")
        elif isinstance(mine, tuple):
            assert mine == tuple(theirs), where
        else:
            assert mine == theirs, where


@pytest.fixture(scope="module")
def bundles():
    return prt.load_scene_json(ZY), jrt.load_scene_json(ZY)


def test_zy_tables_equal_jax(bundles):
    ours, ref = bundles
    _assert_tables_equal(ours.scene, ref.scene)
    assert ours.scene.n_spheres == 9 and ours.scene.n_rects == 6
    assert ours.renderer == prt.RendererParam(**dataclasses.asdict(ref.renderer))
    assert dataclasses.asdict(ours.camera) == dataclasses.asdict(ref.camera)


def test_scene_from_numpy_round_trips(bundles):
    ours, ref = bundles
    bridged = prt.scene_from_numpy(jax.tree.map(np.asarray, ref.scene))
    _assert_tables_equal(bridged, ref.scene)
    _assert_tables_equal(prt.scene_from_numpy(bridged), ref.scene)
    _assert_tables_equal(prt.scene_from_numpy(ours.scene), ours.scene)


def test_scene_from_numpy_refuses_unported_jax_scene():
    """A mesh above SWEEP_MAX_TRIS without cluster tables needs the BVH
    walk, which is not ported.  Moving spheres (K4) and cluster tables
    (K6) bridge with their velocities and tables."""
    b = jrt.SceneBuilder()
    b.add_sphere_moving((0, 0, 0), (1, 0, 0), 1.0, b.add_lambertian(b.add_texture_solid((1, 1, 1))))
    moving = b.build()
    _assert_tables_equal(prt.scene_from_numpy(jax.tree.map(np.asarray, moving)), moving)
    scene = jrt.load_scene_json("data/scene.json").scene.replace(n_triangles=40000)
    assert prt.scene_from_numpy(jax.tree.map(np.asarray, scene)).triangles.has_clusters
    scene = scene.replace(triangles=scene.triangles.replace(cl_d0=None))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        prt.scene_from_numpy(jax.tree.map(np.asarray, scene))


def test_scene_to_device_keeps_tables(bundles):
    scene = bundles[0].scene
    moved = scene.to("cpu")
    _assert_tables_equal(moved, scene)
    assert moved.device == torch.device("cpu")


_CAMERA = {"look_from": [0, 0, -5], "look_at": [0, 0, 0], "vfov": 40}
_WHITE = {"type": "lambertian", "texture": {"type": "solid-color", "color": [0.5, 0.5, 0.5]}}


@pytest.mark.parametrize(
    "objects, match",
    [
        ([{"shape": {"type": "moving-sphere", "center0": [0, 0, 0], "center1": [1, 0, 0],
                     "radius": 1, "translate": [1, 0, 0]}, "material": _WHITE}],
         "does not take a transform"),
    ],
    # a transformed moving sphere
    ids=["moving-sphere"],
)
def test_unported_surface_raises(objects, match):
    """What the port cannot draw raises when the scene is built or at the
    first render, instead of drawing something else: a moving sphere with
    a transform (refused by the JAX package too).  Meshes above
    SWEEP_MAX_TRIS, moving spheres, and triangle, mesh and transformed
    lights render (tests/test_torch_clusters.py, tests/test_torch_motion.py,
    tests/test_torch_prb_scene.py)."""
    param = {"renderer": {"width": 4, "height": 4, "max_depth": 1}, "camera": _CAMERA,
             "objects": objects}
    with pytest.raises(NotImplementedError, match=match):
        bundle = build_scene(param, base_dir="data")
        prt.Renderer(bundle.renderer, bundle.camera, bundle.scene, device="cpu").render(0)


def test_cuboid_checker_scene_equals_jax():
    """Shapes and textures zy does not use: cuboid, checker, rect lights."""
    checker = {"type": "checker", "density": 0.1,
               "odd": {"type": "solid-color", "color": [0.1, 0.2, 0.3]},
               "even": {"type": "solid-color", "color": [0.9, 0.8, 0.7]}}
    param = {
        "renderer": {"width": 8, "height": 8},
        "camera": _CAMERA,
        "background": [0.1, 0.2, 0.3],
        "objects": [
            {"shape": {"type": "cuboid", "p0": [0, 0, 0], "p1": [1, 2, 3]},
             "material": {"type": "lambertian", "texture": checker}, "important": True},
            {"shape": {"type": "sphere", "center": [0, 5, 0], "radius": 1},
             "material": {"type": "metal", "albedo": [0.9, 0.8, 0.7], "fuzz": 0.2}},
        ],
    }
    ours = build_scene(param, noise_seed=3).scene
    ref = jrt.build_scene(param, noise_seed=3).scene
    _assert_tables_equal(ours, ref)
    assert ours.n_lights == 6


def test_earthmap_npy_equals_pillow_decode():
    from PIL import Image

    with Image.open("data/earthmap.jpg") as im:
        decoded = np.asarray(im.convert("RGB"))
    stored = np.load("data/earthmap.npy")
    assert stored.dtype == np.uint8 and stored.shape == (512, 1024, 3)
    np.testing.assert_array_equal(stored, decoded)
    np.testing.assert_array_equal(load_image("data/earthmap.jpg"), decoded)


def test_image_without_npy_or_pillow_names_pillow(tmp_path, monkeypatch):
    path = tmp_path / "tex.jpg"
    path.write_bytes(b"not decoded here")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        load_image(str(path))


def test_port_never_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|ray_tracing_tpu|v4ray_tpu|v4ray_frontend_tpu)\b", re.M)
    sources = []
    for root, _, files in os.walk(PKG):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    sources.append("chip_smoke.py")
    assert len(sources) > 10
    for src in sources:
        with open(src) as fh:
            assert not pattern.search(fh.read()), src
