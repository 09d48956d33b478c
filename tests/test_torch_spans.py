"""The port's spans (ray_tracing_tpu_torch/utils/profiling.py) on the CPU:
which spans a render pass, a tiled gradient and the web editor's edit
and preview emit under ``torch.profiler``, and how they nest; that no
span is recorded, and no record function entered, without a profiler;
and that the profiler changes no bit of an image or a gradient."""

import base64
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ray_tracing_tpu_torch as prt
from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.render.prb_scalar import params_of, tiled_loss_and_grad
from ray_tracing_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 16
RENDER_DEPTH = 6  # two stages: a compaction before the second


def _spans(fn):
    """(fn's value, [(name, start ns, end ns)] of the ``rtt.`` host events
    of one profiled call, by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("rtt.")]
    return out, sorted(events, key=lambda ev: (ev[1], -ev[2]))


def _inside(inner, outers) -> bool:
    return any(s <= inner[1] and inner[2] <= e for _, s, e in outers)


def _zy(depth):
    bundle = prt.load_scene_json(os.path.join(ROOT, "data", "zy_scene.json"))
    param = prt.RendererParam(SIZE, SIZE, max_depth=depth)
    return bundle, prt.Renderer(param, bundle.camera, bundle.scene, device="cpu")


def _pyramid():
    """A small mesh scene: a pyramid of four lambertian triangles and a
    metal one on a ground rect, under an important rect light."""
    b = prt.SceneBuilder(background=(0.2, 0.3, 0.4))
    ground = b.add_lambertian(b.add_texture_solid((0.5, 0.5, 0.4)))
    mesh = b.add_lambertian(b.add_texture_solid((0.3, 0.6, 0.4)))
    light = b.add_diffuse_light(b.add_texture_solid((4.0, 3.5, 3.0)))
    metal = b.add_metal((0.9, 0.85, 0.8), 0.2)
    b.add_rect("zx", -3, 3, -3, 3, 0.0, ground, positive=True)
    b.add_rect("zx", -1, 1, -1, 1, 3.0, light, positive=False, important=True)
    apex = np.array([0.0, 1.0, 0.0])
    base = np.array([[-0.6, 0.0, -0.6], [0.6, 0.0, -0.6], [0.6, 0.0, 0.6], [-0.6, 0.0, 0.6]])
    for i in range(4):
        b.add_triangle([base[i], base[(i + 1) % 4], apex], mesh)
    b.add_triangle([[-1.6, 0.05, -1.6], [-0.4, 0.05, -1.9], [-1.0, 1.4, -1.95]], metal)
    cam = prt.CameraParam((0.0, 1.5, 3.5), (0.0, 0.5, 0.0), 40)
    param = prt.RendererParam(SIZE, SIZE, max_depth=RENDER_DEPTH)
    return prt.Renderer(param, cam, b.build(), device="cpu")


@pytest.fixture(scope="module")
def renderers():
    return {"zy": _zy(RENDER_DEPTH)[1], "mesh": _pyramid()}


@pytest.mark.parametrize("which", ["zy", "mesh"])
def test_render_spans_nest(renderers, which):
    """One pass: one ``rtt.tile`` (16x16 on the CPU), holding each
    bounce's ``rtt.intersect`` then its ``rtt.shade``, one each and
    apart; ``rtt.compact`` before the second stage with its live count
    inside; every other span a sync span, none of them the textures' (an
    image or noise texture is a masked select with no host read), the
    pass's host copy outside every span."""
    r = renderers[which]
    result = prt.RenderResult(SIZE, SIZE)
    _, spans = _spans(lambda: result.add(r.render(3)))
    by = lambda name: [sp for sp in spans if sp[0] == name]  # noqa: E731
    tile = by("rtt.tile")
    intersect, shade, compact = by("rtt.intersect"), by("rtt.shade"), by("rtt.compact")
    assert len(tile) == 1
    assert len(intersect) == len(shade) > RENDER_DEPTH // 2
    assert len(compact) == 1
    assert all(_inside(sp, tile) for sp in intersect + shade + compact)
    for i, s in zip(intersect, shade):
        assert i[2] <= s[1]
    for a, b in zip(shade, intersect[1:]):
        assert a[2] <= b[1]
    syncs = [sp for sp in spans if sp[0].startswith("rtt.sync.")]
    assert len(syncs) + len(tile) + len(intersect) + len(shade) + len(compact) == len(spans)
    names = {sp[0] for sp in syncs}
    assert {"rtt.sync.integrator.live_count", "rtt.sync.integrator.alive_any",
            "rtt.sync.renderer.to_host"} <= names
    assert all(_inside(sp, compact) for sp in by("rtt.sync.integrator.live_count"))
    assert not [sp for sp in syncs if sp[0].startswith("rtt.sync.textures.")]
    assert not _inside(by("rtt.sync.renderer.to_host")[0], tile + intersect + shade + compact)


def _tiled(bundle, tile_size):
    camera = Camera.build(bundle.camera, 1.0)
    ro, rd, _, k_trace = camera_rays(camera, rng.key(5), SIZE, SIZE, True)
    params = params_of(bundle.scene)
    target = torch.full((SIZE * SIZE, 3), 0.2)

    def tile_loss(rad, rows):
        return torch.sum((rad - target[rows]) ** 2) / rad.numel()

    return lambda: tiled_loss_and_grad(tile_loss, params, bundle.scene, ro, rd, k_trace, 3,
                                       tile_size=tile_size)


def test_train_spans_per_tile():
    """``tiled_loss_and_grad`` over two tiles: one ``rtt.tile`` per tile,
    holding ``rtt.taped_forward`` and ``rtt.tape_sweep``, in that order,
    and then one ``rtt.tangent_pass`` outside the tiles, which holds its
    own bounces and sync spans."""
    bundle, _ = _zy(3)
    _, spans = _spans(_tiled(bundle, SIZE * SIZE // 2))
    top = [sp for sp in spans if sp[0] in ("rtt.taped_forward", "rtt.tape_sweep",
                                           "rtt.tangent_pass")]
    assert [sp[0] for sp in top] == ["rtt.taped_forward", "rtt.tape_sweep"] * 2 + [
        "rtt.tangent_pass"]
    for a, b in zip(top, top[1:]):
        assert a[2] <= b[1]
    tiles = [sp for sp in spans if sp[0] == "rtt.tile"]
    assert len(tiles) == 2
    for i, tile in enumerate(tiles):
        assert all(_inside(sp, [tile]) for sp in top[2 * i:2 * i + 2])
    tangent = top[-1:]
    assert not _inside(tangent[0], tiles)
    assert any(sp[0] == "rtt.sync.prb_scalar.touched" and _inside(sp, tangent) for sp in spans)
    assert any(sp[0] == "rtt.intersect" and _inside(sp, tangent) for sp in spans)


class _Refused:
    """A stand-in record function that fails when it is made."""

    def __init__(self, name):
        raise AssertionError(f"record function entered for {name!r}")


def test_no_profiler_no_record_function(renderers, monkeypatch):
    """Without a profiler a span is the one shared null context and no
    record function is made; under one, the same pass makes them."""
    monkeypatch.setattr(profiling, "_RecordFunction", _Refused)
    assert profiling.span("rtt.x") is profiling._OFF
    assert profiling.sync("x") is profiling._OFF
    renderers["mesh"].render(1)
    with pytest.raises(AssertionError, match="record function entered"):
        _spans(lambda: renderers["mesh"].render(1))


def test_profiler_changes_no_bits(renderers):
    """Images and gradients equal bit for bit with and without a
    profiler recording the spans."""
    for r in renderers.values():
        plain = r.render(7)
        traced, spans = _spans(lambda r=r: r.render(7))
        assert spans and torch.equal(plain, traced)
    step = _tiled(_zy(3)[0], SIZE * SIZE // 2)
    loss, grads = step()
    (loss_t, grads_t), spans = _spans(step)
    assert spans and torch.equal(loss, loss_t)
    for a, b in zip(grads, grads_t):
        assert torch.equal(a, b)


EDITOR_SPANS = ("rtt.edit", "rtt.state", "rtt.generate", "rtt.compile", "rtt.png",
                "rtt.sync.web.to_host")


def _editor_round():
    """An editor session on its default document (device="cpu") and one
    round of its handlers' work: an edit and the state's reply, a
    preview and its reply, an undo and the state's reply."""
    from ray_tracing_tpu_torch.editor.web import EditorSession

    session = EditorSession(device="cpu")
    key = next(k for k, o in session.tree.document.objects.items() if o.name == "sphere")

    def round_():
        edit = session.post("/api/edit", {"action": "set_shape", "key": str(key),
                                          "kind": "sphere", "values": [0.1, 0.5, 0.0, 0.5]})
        preview = session.render_reply(1)
        undo = session.post("/api/undo", {})
        return edit, preview, undo

    return round_


def test_editor_spans_in_order():
    """The edit and its state reply (``rtt.edit``, ``rtt.state``), the
    preview's ``rtt.generate`` and ``rtt.compile``, its pass's tiles, its
    host copy (``rtt.sync.web.to_host``) and its PNG (``rtt.png`` twice:
    tone map and encode, then base64 and JSON), then the undo and its
    state reply, each apart from the others."""
    (edit, preview, undo), spans = _spans(_editor_round())
    assert json.loads(edit)["can_undo"] and not json.loads(undo)["can_undo"]
    assert base64.b64decode(json.loads(preview)["png"])[:4] == b"\x89PNG"
    mine = [sp for sp in spans if sp[0] in EDITOR_SPANS]
    assert [sp[0] for sp in mine] == [
        "rtt.edit", "rtt.state", "rtt.generate", "rtt.compile", "rtt.sync.web.to_host",
        "rtt.png", "rtt.png", "rtt.edit", "rtt.state"]
    for a, b in zip(mine, mine[1:]):
        assert a[2] <= b[1], (a, b)
    tiles = [sp for sp in spans if sp[0] == "rtt.tile"]  # the CPU's tiles of 96x72
    assert tiles and all(mine[3][2] <= t[1] and t[2] <= mine[4][1] for t in tiles)


def test_editor_no_profiler_no_record_function(monkeypatch):
    """Without a profiler the editor's round enters no record function."""
    round_ = _editor_round()
    monkeypatch.setattr(profiling, "_RecordFunction", _Refused)
    round_()
    with pytest.raises(AssertionError, match="record function entered"):
        _spans(round_)
