"""The port's gallery runner and motion-blur demo
(``ray_tracing_tpu_torch/examples/render_baselines.py``,
``motion_blur.py``) against the JAX package's scripts
(``examples/render_baselines.py``, ``examples/motion_blur.py``): the
flags, ``stats.json`` and its merge across partial runs, PNGs written
without Pillow, and images at the same keys against the JAX package's
``Renderer.accumulate`` under the noise-floor rule
(.claude/skills/verify/SKILL.md: the matched-key difference at most
0.6x the port's own two-key difference).  16x16 images, a few spp."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import ray_tracing_tpu as jrt
import ray_tracing_tpu_torch as prt
from ray_tracing_tpu_torch.examples import motion_blur, render_baselines
from ray_tracing_tpu_torch.ops import rng

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("size", "spp", "seconds_per_pass", "total_seconds", "mean_radiance", "image")
RES_SCALE, SPP_SCALE = "0.01", "0.03125"  # every size 16; spp 1, 2, 2, 4, 8, 1


def _jax_example(name):
    root = os.path.join(ROOT, "examples")
    sys.path.insert(0, root)
    try:
        return __import__(name)
    finally:
        sys.path.remove(root)


@pytest.fixture(scope="module")
def gallery(tmp_path_factory):
    """Two partial runs into one directory, as the JAX script allows,
    with Pillow hidden: (the directory, the merged stats)."""
    out = str(tmp_path_factory.mktemp("baselines"))
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None  # an import of Pillow fails
    try:
        for configs in ("C1,C2,C3", "C4,C5,C6"):
            render_baselines.main(["--out", out, "--configs", configs, "--res-scale", RES_SCALE,
                                   "--spp-scale", SPP_SCALE, "--device", "cpu"])
    finally:
        if saved is None:
            del sys.modules["PIL"]
        else:
            sys.modules["PIL"] = saved
    with open(os.path.join(out, "stats.json")) as fh:
        return out, json.load(fh)


def test_stats_carry_every_config_with_the_jax_keys(gallery):
    """All six configurations after two partial runs, each with the JAX
    script's keys, its size and spp from the same arithmetic, and a PNG
    that decodes to its size."""
    from PIL import Image

    out, stats = gallery
    assert sorted(stats) == list(render_baselines.CONFIGS)
    spp = {"C1": 16, "C2": 64, "C3": 64, "C4": 128, "C5": 256, "C6": 32}
    for name, rec in stats.items():
        assert tuple(rec) == KEYS, name
        assert rec["size"] == 16 and rec["spp"] == max(int(spp[name] * float(SPP_SCALE)), 1)
        assert np.isfinite(rec["mean_radiance"]) and rec["mean_radiance"] > 0, name
        assert rec["image"] == os.path.join(out, f"{name}_16x16_{rec['spp']}spp.png")
        with Image.open(rec["image"]) as im:
            assert im.size == (16, 16) and im.mode == "RGB"


def _port_image(name, spp, first=0):
    scene, cam, _, _ = render_baselines.build(name)
    r = prt.Renderer(prt.RendererParam(16, 16, max_depth=None), cam, scene, device="cpu")
    acc = None
    for i in range(first, first + spp):
        acc = r.accumulate(rng.fold_in(rng.key(0), i), acc)
    return acc.numpy() / spp


def _jax_image(name, spp):
    ex = _jax_example("render_baselines")
    if name == "C2":
        bd = jrt.load_scene_json(os.path.join(ROOT, "data", "zy_scene.json"))
        scene, cam = bd.scene, bd.camera
    else:
        b, cam = ex.scene_c3()
        scene = b.build()
    r = jrt.Renderer(jrt.RendererParam(16, 16, max_depth=None), cam, scene)
    acc = None
    for i in range(spp):
        acc = r.accumulate(jax.random.fold_in(jax.random.key(0), i), acc)
    return np.asarray(acc) / spp


@pytest.mark.parametrize("name", ["C2", "C3"])
def test_image_matches_jax_accumulate(gallery, name):
    """The runner's PNG is the tone map of the port's accumulated passes
    at keys fold_in(key(0), i), its mean the recorded one, and that image
    against the JAX package's accumulate at the same keys is inside 0.6x
    the port's noise floor (passes at keys 100.. against 0..)."""
    from PIL import Image

    _, stats = gallery
    rec = stats[name]
    mine = _port_image(name, rec["spp"])
    assert rec["mean_radiance"] == float(mine.mean())
    with Image.open(rec["image"]) as im:
        np.testing.assert_array_equal(np.asarray(im), render_baselines.tone_map(mine))
    ref = _jax_image(name, rec["spp"])
    matched = np.abs(mine - ref).mean()
    floor = np.abs(mine - _port_image(name, rec["spp"], first=100)).mean()
    assert floor > 0 and matched <= 0.6 * floor, (matched, floor)


def test_motion_blur_matches_jax_accumulate(tmp_path):
    """motion_blur.main at 16x16, 2 spp: the PNG is written, the printed
    mean is the image's, and the image against the JAX example's scene
    accumulated at the same keys without XLA's fusion (jax.disable_jit:
    the floor lies on y = 0, tests/test_torch_motion.py) is inside 0.6x
    the port's noise floor."""
    from PIL import Image

    out = str(tmp_path / "mb" / "motion.png")
    mean = motion_blur.main(["--out", out, "--size", "16", "--spp", "2", "--device", "cpu"])
    with Image.open(out) as im:
        png = np.asarray(im)
    scene, cam, _ = prt.scenes.motion_blur()
    r = prt.Renderer(prt.RendererParam(16, 16, max_depth=8), cam, scene, device="cpu")

    def port(first):
        acc = r.accumulate(rng.fold_in(rng.key(0), first))
        return (r.accumulate(rng.fold_in(rng.key(0), first + 1), acc) / 2).numpy()

    mine = port(0)
    assert mean == float(mine.mean())
    np.testing.assert_array_equal(png, render_baselines.tone_map(mine))
    jscene, jcam = _jax_example("motion_blur").build_scene()
    jr = jrt.Renderer(jrt.RendererParam(16, 16, max_depth=8), jcam, jscene)
    with jax.disable_jit():
        acc = jr.accumulate(jax.random.fold_in(jax.random.key(0), 0))
        ref = np.asarray(jr.accumulate(jax.random.fold_in(jax.random.key(0), 1), acc)) / 2
    matched = np.abs(mine - ref).mean()
    floor = np.abs(mine - port(100)).mean()
    assert floor > 0 and matched <= 0.6 * floor, (matched, floor)


@pytest.mark.parametrize("script", ["render_baselines", "motion_blur"])
def test_cuda_device_without_a_gpu_exits_one(script, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    run = subprocess.run([sys.executable, "-m", f"ray_tracing_tpu_torch.examples.{script}",
                          "--out", str(tmp_path / "x.png"), "--device", "cuda"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert run.returncode == 1 and "no CUDA device" in run.stderr
    assert not os.listdir(tmp_path)


def test_epsilon_is_exported_as_in_the_jax_package():
    assert "EPSILON" in prt.__all__ and prt.EPSILON == jrt.EPSILON
