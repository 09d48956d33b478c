"""The gallery's C3 and C4 built by the port (``scenes.earth_sphere``,
``scenes.bunny``) against ``examples/render_baselines.py:scene_c3`` and
``scene_c4`` built by the JAX package: the scene tables, the low-depth
images, the depth-4 image against the JAX package's goldens
(``tests/golden/earth_32_d4_key42.npy``, ``bunny_32_d4_key42.npy``),
and JAX's means inside the ranges ``chip_smoke.py`` holds the card's
512^2 passes to.  32x32 images."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

import ray_tracing_tpu as jrt
import ray_tracing_tpu_torch as prt
from ray_tracing_tpu_torch import scenes
from ray_tracing_tpu_torch.ops import cuda_intersect as ci
from ray_tracing_tpu_torch.ops import cuda_triangles as ct
from ray_tracing_tpu_torch.ops import intersect as pi

from test_torch_scene import _assert_tables_equal

torch.set_num_threads(2)

SIZE = 32
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _jax_builders():
    root = os.path.join(os.path.dirname(__file__), "..", "examples")
    sys.path.insert(0, root)
    try:
        from render_baselines import scene_c3, scene_c4
    finally:
        sys.path.remove(root)
    return {"C3": scene_c3, "C4": scene_c4}


@pytest.fixture(scope="module", params=["C3", "C4"])
def gallery(request):
    name = request.param
    scene, cam, param = {"C3": scenes.earth_sphere, "C4": scenes.bunny}[name]()
    builder, jcam = _jax_builders()[name]()
    return name, scene, cam, param, builder.build(), jcam


def _renderers(gallery, depth):
    _, scene, cam, _, jscene, jcam = gallery
    return (prt.Renderer(prt.RendererParam(SIZE, SIZE, max_depth=depth), cam, scene,
                         device="cpu"),
            jrt.Renderer(jrt.RendererParam(SIZE, SIZE, max_depth=depth), jcam, jscene))


def test_tables_equal_jax(gallery):
    """Every table equals the JAX builder's bit for bit, the camera and
    the gallery's 512^2 at the default depth too; C3 has no triangles
    (its earth comes from data/earthmap.npy), C4 takes the dense sweep."""
    name, scene, cam, param, jscene, jcam = gallery
    _assert_tables_equal(scene, jscene)
    assert dataclasses.asdict(cam) == dataclasses.asdict(jcam)
    assert (param.width, param.height, param.max_depth) == (512, 512, None)
    assert pi.mesh_strategy(scene) == ("none" if name == "C3" else "sweep")
    assert scene.n_triangles == (0 if name == "C3" else 4968)


def _equal_share(ours, ref, key):
    a = ours.render(key).numpy()
    b = np.asarray(ref.render(jax.random.key(key)))
    assert a.shape == b.shape == (SIZE, SIZE, 3)
    return np.all(a == b, axis=-1).mean(), a


def test_depth_one_image_equals_jax(gallery):
    """At depth 1 a pixel is pure emission or background (C3's light and
    sky; C4 has no emitter and is black): >= 99.9 % of the pixels equal
    JAX's (tests/test_torch_render.py's rule), keys 0 and 3."""
    name = gallery[0]
    ours, ref = _renderers(gallery, 1)
    for key in (0, 3):
        share, img = _equal_share(ours, ref, key)
        assert share >= 0.999
        assert (img.max() > 0) == (name == "C3")


def test_c4_depth_two_image_equals_jax():
    """C4's depth-1 image is black, so at depth 2, where its pixels carry
    the sky through one lambertian bounce, the same rule holds."""
    scene, cam, _ = scenes.bunny()
    builder, jcam = _jax_builders()["C4"]()
    param = dict(width=SIZE, height=SIZE, max_depth=2)
    ours = prt.Renderer(prt.RendererParam(**param), cam, scene, device="cpu")
    ref = jrt.Renderer(jrt.RendererParam(**param), jcam, builder.build())
    for key in (0, 3):
        share, img = _equal_share(ours, ref, key)
        assert share >= 0.999 and img.max() > 0


def test_depth_four_inside_noise_floor_of_golden(gallery):
    """Key 42 at depth 4 against the JAX package's golden render of the
    same pass (tests/test_integrator.py): the mean difference is at most
    0.6x the port's own difference between keys 42 and 43.  On the CPU
    the pass takes the kernels' plain versions, launching nothing."""
    name, *_ = gallery
    ours, _ = _renderers(gallery, 4)
    before = (ci.LAUNCHES, ct.LAUNCHES, ct.CL_LAUNCHES)
    mine = ours.render(42).numpy()
    assert (ci.LAUNCHES, ct.LAUNCHES, ct.CL_LAUNCHES) == before
    golden = np.load(os.path.join(GOLDEN, {"C3": "earth", "C4": "bunny"}[name]
                                  + "_32_d4_key42.npy"))
    matched = np.abs(mine - golden).mean()
    floor = np.abs(mine - ours.render(43).numpy()).mean()
    assert np.isfinite(mine).all() and (mine >= 0).all()
    assert floor > 0 and matched <= 0.6 * floor, (matched, floor)


def test_jax_mean_inside_smoke_range(gallery):
    """JAX's 32^2 renders at the default depth 20 (keys 0 and 1) have
    means inside the range chip_smoke.py holds the card's 512^2 passes
    to (C3_MEAN, C4_MEAN)."""
    from chip_smoke import C3_MEAN, C4_MEAN

    name = gallery[0]
    lo, hi = {"C3": C3_MEAN, "C4": C4_MEAN}[name]
    _, ref = _renderers(gallery, 20)
    for key in (0, 1):
        mean = np.asarray(ref.render(jax.random.key(key))).astype(np.float64).mean()
        assert lo < mean < hi, (name, mean)
