"""The reference against the port's CPU path at tiny sizes: images of
both configurations, and one fit step's loss and leaves."""

import numpy as np
import pytest
import torch

from conftest import c6_train

from harness import seeds
from harness.cells import load_cell
from reference import render as ref_render
from reference import train as ref_train


def _scene(name, size, depth):
    cell = load_cell(name)
    scene = dict(cell.scene)
    scene["renderer"] = {**scene["renderer"], "width": size, "height": size, "max_depth": depth}
    return cell, scene


@pytest.mark.parametrize("name,size", [("zy_scene.render", 32), ("bunny_grid_c6.render", 16)])
def test_image_equals_port(name, size):
    """A whole 1-spp pass: the reference's dense loop over every pixel
    equals the port's Renderer.render on the CPU, pixel for pixel."""
    from ray_tracing_tpu_torch import Renderer, build_scene

    cell, scene = _scene(name, size, 3)
    bundle = build_scene(scene, base_dir=cell.data_dir)
    key = seeds.pass_key(2**40 + 7, 3)
    img = Renderer(bundle.renderer, bundle.camera, bundle.scene, device="cpu").render(key)
    pixels = torch.arange(size * size)
    ref = ref_render.sampled_sum(scene, cell.data_dir, [key], pixels, "cpu")
    assert float(img.mean()) > 0.01
    np.testing.assert_array_equal(img.reshape(-1, 3).double().numpy(), ref.numpy())


def test_sampled_pixels_equal_whole_image():
    """Sampled pixels traced alone equal the same pixels of a whole pass."""
    cell, scene = _scene("zy_scene.render", 24, 3)
    keys = [seeds.pass_key(5, i) for i in range(2)]
    whole = ref_render.sampled_sum(scene, cell.data_dir, keys, torch.arange(24 * 24), "cpu")
    pixels = seeds.sample_pixels(5, 24 * 24, 40)
    part = ref_render.sampled_sum(scene, cell.data_dir, keys, pixels, "cpu")
    np.testing.assert_array_equal(part.numpy(), whole[pixels].numpy())


def _port_step(cell, scene_json, seed, size, depth):
    from ray_tracing_tpu_torch import build_scene
    from ray_tracing_tpu_torch.models.camera import Camera
    from ray_tracing_tpu_torch.parallel.mesh import make_mesh, make_prb_train_step_all_direct
    from ray_tracing_tpu_torch.render.prb_scalar import AllParams, params_of

    tr = cell.traffic
    b = build_scene(scene_json, base_dir=cell.data_dir)
    camera = Camera.build(b.camera, 1.0)
    step = make_prb_train_step_all_direct(camera, b.scene, width=size, height=size,
                                          max_depth=depth, mesh=make_mesh("cpu"), lr=tr["lr"])
    p0 = AllParams(**seeds.perturb(params_of(b.scene)._asdict(), seed, tr["perturb"]))
    target = seeds.target_image(seed, size, size, tr["target_grid"], *tr["target_range"], "cpu")
    p1, loss = step(p0, b.scene, seeds.pass_key(seed, 0), target)
    grads = {k: (getattr(p0, k) - getattr(p1, k)) / tr["lr"] for k in AllParams._fields}
    return float(loss), grads, target, p0.images


def _ref_step(cell, scene_json, seed, size, depth, target):
    tr = cell.traffic
    scene, camera, *_ = ref_render.compile_scene(scene_json, cell.data_dir, "cpu")
    p0 = seeds.perturb(ref_train.params_of(scene), seed, tr["perturb"])
    return ref_train.loss_and_grad(scene, camera, size, size, depth, p0,
                                   seeds.pass_key(seed, 0), target, 65536)


@pytest.mark.parametrize("name", ["zy_scene.train", "bunny_grid_c6.train"])
def test_step_loss_and_leaves(name):
    """One SGD step of the direct full-parameter step against reverse
    autograd of the reference's dense loop: the loss, and each leaf's
    gradient as the update gives it, to float32 rounding of the update;
    the image leaf on the texels whose value is not 0 (on those that are,
    the port's gradient is 0: test_bench_zero_texel.py)."""
    size, depth = 16, 3
    cell = c6_train() if name == "bunny_grid_c6.train" else load_cell(name)
    scene = dict(cell.scene)
    scene["renderer"] = {**scene["renderer"], "width": size, "height": size, "max_depth": depth}
    seed = 3 * 2**33 + 1
    loss, grads, target, p0_images = _port_step(cell, scene, seed, size, depth)
    ref_loss, ref_grads = _ref_step(cell, scene, seed, size, depth, target)
    nonzero = p0_images != 0
    grads["images"], ref_grads["images"] = grads["images"][nonzero], ref_grads["images"][nonzero]
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    assert float(ref_grads["color"].norm()) > 0
    for k, g in ref_grads.items():
        # (p0 - p1) / lr carries the rounding of p1 = p0 - lr g: half an
        # ulp of the parameter over lr
        atol = 2 * torch.finfo(torch.float32).eps * 2.0 / cell.traffic["lr"]
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=1e-3, atol=atol, err_msg=k)
