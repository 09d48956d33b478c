"""The port's forward render of data/zy_scene.json at 64x64 against the
JAX package's, and the port's own invariants (compaction equals the
dense loop bit for bit; a pass is a pure function of its key)."""

import numpy as np
import pytest
import torch

import ray_tracing_tpu as jrt
import ray_tracing_tpu_torch as prt
from ray_tracing_tpu_torch.render.integrator import stage_schedule

torch.set_num_threads(2)

ZY = "data/zy_scene.json"
SIZE = 64


@pytest.fixture(scope="module")
def zy():
    return prt.load_scene_json(ZY), jrt.load_scene_json(ZY)


def _renderers(zy, depth, **kw):
    ours, ref = zy
    param = dict(width=SIZE, height=SIZE, max_depth=depth)
    return (
        prt.Renderer(prt.RendererParam(**param), ours.camera, ours.scene, device="cpu", **kw),
        jrt.Renderer(jrt.RendererParam(**param), ref.camera, ref.scene),
    )


@pytest.mark.parametrize("key", [0, 5])
def test_depth_one_image_equals_jax(zy, key):
    """At depth 1 a pixel is pure emission or background."""
    ours, ref = _renderers(zy, 1)
    a = ours.render(key).numpy()
    b = np.asarray(ref.render(key))
    assert a.shape == b.shape == (SIZE, SIZE, 3)
    assert np.all(a == b, axis=-1).mean() >= 0.999


def test_depth_ten_inside_noise_floor(zy):
    """Matched-key difference to JAX at most 0.6x the port's own
    different-key noise floor (8 spp each)."""
    ours, ref = _renderers(zy, 10)
    mine = np.mean([ours.render(k).numpy() for k in range(8)], axis=0)
    theirs = np.mean([np.asarray(ref.render(k)) for k in range(8)], axis=0)
    other = np.mean([ours.render(100 + k).numpy() for k in range(8)], axis=0)
    matched = np.abs(mine - theirs).mean()
    floor = np.abs(mine - other).mean()
    assert matched <= 0.6 * floor, (matched, floor)


@pytest.mark.parametrize("depth", [3, 10])
def test_compacted_equals_dense(zy, depth):
    """Compaction is an execution strategy: bit-identical radiance and
    segment count, with tiles that split the image unevenly."""
    compact, _ = _renderers(zy, depth, tile_size=1536)
    dense, _ = _renderers(zy, depth, tile_size=1536, compaction=False)
    img_c, seg_c = compact.render_with_stats(2)
    img_d, seg_d = dense.render_with_stats(2)
    assert torch.equal(img_c, img_d)
    assert seg_c == seg_d > SIZE * SIZE


def test_image_independent_of_tile_size(zy):
    a, _ = _renderers(zy, 6, tile_size=512)
    b, _ = _renderers(zy, 6, tile_size=4096)
    assert torch.equal(a.render(9), b.render(9))


def test_render_deterministic_and_keyed(zy):
    ours, _ = _renderers(zy, 10)
    img = ours.render(0)
    assert torch.isfinite(img).all() and (img >= 0).all()
    assert 0.1 < img.mean().item() < 0.4
    assert torch.equal(img, ours.render(0))
    assert not torch.equal(img, ours.render(1))


def test_accumulate_and_render_result(zy):
    ours, _ = _renderers(zy, 4)
    acc = ours.accumulate(0)
    acc = ours.accumulate(1, acc)
    assert torch.equal(acc, ours.render(0) + ours.render(1))
    result = prt.RenderResult(SIZE, SIZE)
    assert result.get_raw() is None
    result.add(ours.render(0))
    raw, count = result.get_raw()
    assert raw.dtype == np.uint8 and raw.shape == (SIZE, SIZE, 3) and count == 1


def test_stage_schedule_matches_jax():
    from ray_tracing_tpu.render.integrator import stage_schedule as jstage_schedule

    for depth in (1, 4, 5, 8, 9, 20):
        assert stage_schedule(depth, 4) == jstage_schedule(depth, 4)
