"""The tile rule (render/renderer.py:tile_rule) on the CPU: the CPU's
tiles at the cells' and scenes' own sizes and primitive counts, the
card's whole-wavefront tile and its cap (a pure function of the ray
count and the device, so no card is needed), and the invariants the
card's one tile rests on, here at 64x64 depth 3: an image does not
depend on its tiles, and a gradient only by the float order of the
tiles' and tangent batches' sums."""

import os

import pytest
import torch

import ray_tracing_tpu_torch as prt
from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.parallel.mesh import tiled_loss_and_grad
from ray_tracing_tpu_torch.render.prb_scalar import AllParams, params_of
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


def test_one_tile_gradient_matches_tiles_of_1024(zy):
    """tiled_loss_and_grad at its default tile (one tile) against tiles of
    1,024 under the same key: the loss within the train cell's loss_gap,
    each leaf's gradient within its grad_gap (the gap's norm over the
    larger of the leaf's norm and the median leaf's)."""
    scene = zy.scene
    camera = Camera.build(zy.camera, 1.0)
    ro, rd, _, k_trace = camera_rays(camera, rng.key(7), SIZE, SIZE, True)
    target = torch.full((SIZE * SIZE, 3), 0.25)
    params = params_of(scene)

    def tile_loss(rad, rows):
        return torch.sum((rad - target[rows]) ** 2) / (SIZE * SIZE * 3)

    def run(tile_size):
        return tiled_loss_and_grad(tile_loss, params, scene, ro, rd, k_trace, DEPTH,
                                   tile_size=tile_size)

    loss_1, grads_1 = run(None)
    loss_4, grads_4 = run(1024)
    assert abs(float(loss_1) - float(loss_4)) <= LOSS_GAP * abs(float(loss_4))
    norms = torch.tensor([float(g.double().norm()) for g in grads_4])
    assert norms[0] > 0 and norms[3] > 0  # colors; fuzz, through the tangent batches
    median = float(norms.median())
    for name, a, b, norm in zip(AllParams._fields, grads_1, grads_4, norms):
        gap = float((a.double() - b.double()).norm()) / max(float(norm), median)
        assert gap <= GRAD_GAP, (name, gap)
