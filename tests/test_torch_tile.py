"""The tile rule (render/renderer.py:tile_rule) on the CPU: the CPU's
tiles at the cells' and scenes' own sizes and primitive counts, the
card's whole-wavefront tile and its cap (a pure function of the ray
count and the device, so no card is needed), and the invariants the
card's one tile rests on, here at 64x64 depth 3: an image does not
depend on its tiles, and a gradient only by the float order of the
tiles' and tangent batches' sums.  :func:`dense_pass` is a renderer's
pass by the dense loop, what the compacted renderer is held to here and
in the render tests of the other files (this file imports no JAX)."""

import os

import pytest
import torch

import ray_tracing_tpu_torch as prt
from ray_tracing_tpu_torch import scenes
from ray_tracing_tpu_torch.models.camera import Camera, camera_rays, stamp_shutter
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.render.integrator import trace
from ray_tracing_tpu_torch.render.prb_scalar import AllParams, params_of, tiled_loss_and_grad
from ray_tracing_tpu_torch.render.renderer import CARD_TILE, tile_rule

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, DEPTH = 64, 3
# benchmark/workloads/zy_scene.train.json's limits
LOSS_GAP, GRAD_GAP = 2e-4, 1.5e-2

# (what, rays, spheres + rects of a renderer or None for the gradient
# path, CPU tile, card tile)
CASES = [
    ("C6 512^2 render (1 rect)", 512 * 512, 1, 65536, 262144),
    ("zy 800^2 render (9 spheres, 6 rects)", 800 * 800, 15, 65536, 640000),
    ("weekend 1200x800 render (485 spheres)", 1200 * 800, 485, 8192, 960000),
    ("bench 1024^2 render", 1024 * 1024, 15, 65536, 1048576),
    ("zy 64^2 render", 64 * 64, 15, 4096, 4096),
    ("web preview 96x72 render (3 spheres)", 96 * 72, 3, 4096, 6912),
    ("zy 800^2 gradient", 800 * 800, None, 65536, 640000),
    ("C6 512^2 gradient", 512 * 512, None, 65536, 262144),
    ("zy 64^2 gradient", 64 * 64, None, 65536, 4096),
    ("past the cap, render", CARD_TILE + 1, 15, 65536, CARD_TILE),
    ("past the cap, gradient", 4 * CARD_TILE, None, 65536, CARD_TILE),
]


@pytest.mark.parametrize("what,rays,prims,cpu,card", CASES, ids=[c[0] for c in CASES])
def test_tile_rule(what, rays, prims, cpu, card):
    """The CPU keeps the tiles it had (the renderer's grid budget, 512 to
    65,536 rays; the gradient path's 65,536); the card takes the whole
    wavefront up to the cap of 2**20 rays, whatever the primitives."""
    assert CARD_TILE == 1 << 20
    for device, want in (("cpu", cpu), ("cuda", card), ("cuda:0", card)):
        assert tile_rule(rays, torch.device(device), prims) == want
        assert tile_rule(rays, device, prims) == want


def dense_pass(renderer, key):
    """``(image, traced segments)`` of ``renderer``'s pass at ``key``, by
    the dense loop integrator.trace over the pass's own camera rays and
    ray ids, in one call."""
    p = renderer.param
    scene = stamp_shutter(renderer.scene, renderer.camera)
    ro, rd, _, k_trace = camera_rays(renderer.camera, renderer._as_key(key), p.width, p.height,
                                     renderer.antialias)
    rad, segments = trace(scene, ro, rd, k_trace, renderer.max_depth, with_stats=True)
    return rad.reshape(p.height, p.width, 3), int(segments)


@pytest.fixture(scope="module")
def zy():
    return prt.load_scene_json(os.path.join(ROOT, "data", "zy_scene.json"))


def test_cpu_renderer_keeps_its_tile(zy):
    """A CPU renderer of zy at its own 800x800 tiles by 65,536, at 64x64
    by its whole 4,096 rays."""
    for size, want in ((800, 65536), (SIZE, SIZE * SIZE)):
        param = prt.RendererParam(size, size, max_depth=DEPTH)
        assert prt.Renderer(param, zy.camera, zy.scene, device="cpu").tile_size == want


def test_one_tile_image_equals_tiles_of_1024(zy):
    """The default tile (one tile of 4,096 rays here) renders the image
    that tiles of 1,024 render, bit for bit."""
    param = prt.RendererParam(SIZE, SIZE, max_depth=DEPTH)
    one = prt.Renderer(param, zy.camera, zy.scene, device="cpu", tile_size=None)
    four = prt.Renderer(param, zy.camera, zy.scene, device="cpu", tile_size=1024)
    assert one.tile_size == SIZE * SIZE
    assert torch.equal(one.render(11), four.render(11))


def _gradient_scene(which):
    """(scene, camera) of the gradient cases: zy; data/scene.json (mesh,
    transformed cuboid, medium); the gallery's C6 (79,488 triangles through
    the cluster sweep; lambertian only, so no fuzz or IR)."""
    if which == "c6":
        scene, cam, _ = scenes.bunny_grid()
        return scene, cam
    bundle = prt.load_scene_json(os.path.join(ROOT, "data", f"{which}.json"))
    return bundle.scene, bundle.camera


# (scene, image side, tile, whether it has a fuzz row): C6's plain
# cluster sweep costs the CPU ~10 ms a ray at depth 3, so it runs 32x32
# in four tiles
GRADIENT_CASES = [("zy_scene", SIZE, 1024, True), ("scene", SIZE, 1024, True),
                  ("c6", 32, 256, False)]


@pytest.mark.parametrize("which,size,tile,has_fuzz", GRADIENT_CASES,
                         ids=["zy", "scene.json", "c6"])
def test_one_tile_gradient_matches_tiles_of_1024(which, size, tile, has_fuzz):
    """tiled_loss_and_grad at its default tile (one tile) against tiles of
    1,024 (C6: 256) under the same key: the loss within the train cell's
    loss_gap, each leaf's gradient within its grad_gap (the gap's norm
    over the larger of the leaf's norm and the median nonzero leaf's)."""
    scene, cam = _gradient_scene(which)
    camera = Camera.build(cam, 1.0)
    ro, rd, _, k_trace = camera_rays(camera, rng.key(7), size, size, True)
    target = torch.full((size * size, 3), 0.25)
    params = params_of(scene)

    def tile_loss(rad, rows):
        return torch.sum((rad - target[rows]) ** 2) / (size * size * 3)

    def run(tile_size):
        return tiled_loss_and_grad(tile_loss, params, scene, ro, rd, k_trace, DEPTH,
                                   tile_size=tile_size)

    loss_1, grads_1 = run(None)
    loss_4, grads_4 = run(tile)
    assert abs(float(loss_1) - float(loss_4)) <= LOSS_GAP * abs(float(loss_4))
    norms = torch.tensor([float(g.double().norm()) for g in grads_4])
    # colors; fuzz, through the tangent batches
    assert norms[0] > 0 and (norms[3] > 0) == has_fuzz
    median = float(norms[norms > 0].median())
    for name, a, b, norm in zip(AllParams._fields, grads_1, grads_4, norms):
        gap = float((a.double() - b.double()).norm()) / max(float(norm), median)
        assert gap <= GRAD_GAP, (name, gap)
