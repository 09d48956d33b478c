"""The pieces of the fuzz / IR replay's CUDA graphs that run on the CPU
(render/stage_graphs.py): the texture select with no host read against
the ``nonzero`` version it replaced, its backward on the lanes it does
not select, the key as device data (ops/rng.py:StreamKey), the stage
width rule (stage_graphs.stage_width), the replay's gradients with stage 0
padded by dead rays and with every stage at its bucket width, and the
reader of ``tangent_graph_pct.train``.  The graphs themselves run only
on the card (tests/test_torch_cuda.py)."""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

import ray_tracing_tpu_torch as prt
from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
from ray_tracing_tpu_torch.models.scene import TEX_IMAGE, TEX_NOISE
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.ops.geometry import EPSILON, INF
from ray_tracing_tpu_torch.ops.intersect import intersect_scene
from ray_tracing_tpu_torch.ops.textures import (
    image_value,
    perlin_turb,
    resolve_leaf,
    texture_value,
)
from ray_tracing_tpu_torch.render.integrator import trace_subset_dot
from ray_tracing_tpu_torch.render.prb_scalar import _active_rows, _with_all, params_of
from ray_tracing_tpu_torch.render.prb_tape import trace_taped
from ray_tracing_tpu_torch.render.stage_graphs import (
    FLOOR,
    HEADROOM,
    ReplayGraphs,
    replay_graphs,
    stage_width,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZY = os.path.join(ROOT, "data", "zy_scene.json")


@pytest.fixture(scope="module")
def zy():
    return prt.load_scene_json(ZY)


def _texture_value_nonzero(tt, idx, uv, p):
    """texture_value as it was: the image and noise lanes picked by
    ``torch.nonzero`` (a host read each) and written in place."""
    idx = resolve_leaf(tt, idx.long(), p)
    ttype = tt.ttype[idx]
    out = tt.color[idx]
    if tt.images.shape[0] > 0:
        sel = torch.nonzero(ttype == TEX_IMAGE).squeeze(1)
        if sel.numel():
            out[sel] = image_value(tt, tt.image[idx[sel]], uv[sel])
    if tt.max_noise_depth > 0:
        sel = torch.nonzero(ttype == TEX_NOISE).squeeze(1)
        if sel.numel():
            leaf = idx[sel]
            turb = perlin_turb(tt.scale[leaf][:, None] * p[sel] + tt.noise_offset[leaf],
                               tt.noise_depth[leaf], tt.max_noise_depth)
            out[sel] = turb[:, None].expand(-1, 3)
    return out


def _lanes(zy, case, n=3000):
    """(texture ids, uv, p) of ``n`` lanes: every texture, only zy's image
    texture, only its noise textures, or the hits of camera rays."""
    tt = zy.scene.textures
    r = np.random.RandomState(12)
    if case == "hits":
        ro, rd, _, _ = camera_rays(Camera.build(zy.camera, 1.0), rng.key(13), 48, 48)
        hit = intersect_scene(zy.scene, ro, rd, EPSILON, INF)
        return zy.scene.materials.tex[hit.material], hit.uv, hit.p
    kinds = {"all": np.arange(len(tt)),
             "image": np.nonzero(tt.ttype.numpy() == TEX_IMAGE)[0],
             "noise": np.nonzero(tt.ttype.numpy() == TEX_NOISE)[0]}[case]
    idx = torch.from_numpy(r.choice(kinds, n).astype(np.int32))
    uv = torch.from_numpy(r.uniform(-0.1, 1.1, (n, 2)).astype(np.float32))
    p = torch.from_numpy(r.uniform(-10.0, 565.0, (n, 3)).astype(np.float32))
    return idx, uv, p


@pytest.mark.parametrize("case", ["all", "image", "noise", "hits"])
def test_texture_select_equals_nonzero_version(zy, case):
    """On zy's textures (solid, an earthmap image, Perlin noise of up to
    10 octaves) the masked select gives every lane the bits the nonzero
    version gave it."""
    tt = zy.scene.textures
    idx, uv, p = _lanes(zy, case)
    want = _texture_value_nonzero(tt, idx, uv, p)
    got, leaf = texture_value(tt, idx, uv, p, with_leaf=True)
    assert torch.equal(got, want)
    assert torch.equal(leaf, resolve_leaf(tt, idx.long(), p))
    if case != "all":
        assert (tt.ttype[leaf] != 0).any()


@pytest.mark.parametrize("case", ["all", "hits"])
def test_texture_select_backward_zero_off_its_lanes(zy, case):
    """Through a hit position that requires grad, a lane whose leaf is
    not a noise texture gets exactly zero and no lane a NaN; the noise
    lanes get the nonzero version's gradient.  Misses (p = 0) included."""
    tt = zy.scene.textures
    idx, uv, p = _lanes(zy, case)
    p = torch.cat([p, torch.zeros((64, 3))])
    idx = torch.cat([idx, idx[:64]])
    uv = torch.cat([uv, uv[:64]])
    w = torch.from_numpy(np.random.RandomState(14).uniform(-1, 1, (p.shape[0], 3))
                         .astype(np.float32))
    grads = []
    for fn in (texture_value, _texture_value_nonzero):
        x = p.clone().requires_grad_(True)
        (fn(tt, idx, uv, x) * w).sum().backward()
        grads.append(x.grad)
    got, want = grads
    noise = tt.ttype[resolve_leaf(tt, idx.long(), p)] == TEX_NOISE
    assert torch.isfinite(got).all()
    assert (got[~noise] == 0).all()
    assert noise.any() and (got[noise] != 0).any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


def test_stream_key_gives_the_host_key_bits():
    """Uniforms and shutter times drawn from the key's stream seeds as
    device data equal the host key's, bit for bit, in every stream."""
    key = rng.fold_in(rng.key(1718281902), 3)
    streams = [*range(20), rng.TIME_STREAM]
    dkey = rng.stream_key(key, streams, "cpu")
    assert dkey.seeds.dtype == torch.int64 and dkey.seeds.shape == (21, 2)
    ids = torch.from_numpy(np.random.RandomState(15).randint(0, 2**40, 5000))
    for stream in streams:
        assert torch.equal(rng.ray_uniforms(dkey, ids, stream, 13),
                           rng.ray_uniforms(key, ids, stream, 13)), stream
    shutter = torch.tensor([0.25, 0.75])
    assert torch.equal(rng.ray_time(dkey, ids, shutter), rng.ray_time(key, ids, shutter))


@pytest.mark.parametrize("rule", ["floor", "padding", "monotone", "buckets"])
def test_replay_width_bounds(rule):
    """The width rule of a stage (stage_width).  A new width holds the
    live count and a quarter more and the floor, lies at most 1/16 above
    that, grows with the live count and takes 16 values an octave; a
    width the stage took last is kept while it holds the live count and
    is at most twice it, and replaced otherwise; none passes the stage's
    full width."""
    xs = np.unique(np.concatenate([np.arange(1, 70000, 7), 2 ** np.arange(1, 24),
                                   2 ** np.arange(13, 24) + 1, 2 ** np.arange(13, 24) - 1,
                                   np.random.RandomState(16).randint(1, 2**23, 4000)]))
    widths = np.array([stage_width(int(x)) for x in xs])
    want = np.maximum(xs + xs // HEADROOM, FLOOR)
    assert (widths >= want).all()
    if rule == "floor":
        assert (widths[want == FLOOR] == FLOOR).all()
        assert stage_width(100, n=1000) == 1000 and stage_width(100, FLOOR, n=1000) == 1000
    elif rule == "padding":
        assert ((widths - want) * 16 <= want).all()
        r = np.random.RandomState(21)
        for live, last in zip(r.randint(1, 2**20, 4000), r.randint(1, 2**21, 4000)):
            live, last = int(live), int(last)
            width = stage_width(live, last)
            kept = live <= last <= 2 * live
            assert width == (last if kept else stage_width(live)), (live, last)
            assert stage_width(live, last, n=live) == live
    elif rule == "monotone":
        assert (np.diff(widths) >= 0).all()
    else:
        for k in range(13, 23):
            lives = np.arange(2**k * 4 // 5 - 8, 2**(k + 1) * 4 // 5 + 8, 2**(k - 8))
            octave = {stage_width(int(x)) for x in lives
                      if 2**k < int(x) + int(x) // HEADROOM <= 2**(k + 1)}
            assert len(octave) == 16, k


def test_stage_width_holds_through_drift():
    """A stage's width (ReplayGraphs.width): a new one is the rule's for
    the live count; it is kept while it holds the live count and is at
    most twice it, and replaced past either side; it never passes the
    stage's full width."""
    graphs = ReplayGraphs(torch.device("cpu"))
    width = graphs.width("stage", 50000)
    assert width == stage_width(50000) == 63488
    for live in (63488, 60000, 40000, 31744):
        assert graphs.width("stage", live) == width
    assert graphs.width("stage", 31743) == stage_width(31743) == 40960
    assert graphs.width("stage", 40961) == stage_width(40961) == 53248
    assert graphs.width("other", 50000, n=52000) == graphs.width("other", 49000, n=52000) == 52000
    assert graphs.width("other", 50000, n=51000) == 51000


@pytest.fixture(scope="module")
def replay(zy):
    """zy at 64x64, depth 6: the taped forward's touched rays, the
    cotangent and the active rows."""
    scene = zy.scene
    ro, rd, _, key = camera_rays(Camera.build(zy.camera, 1.0), rng.key(17), 64, 64)
    w = torch.from_numpy(np.random.RandomState(18).uniform(0.5, 1.5, (ro.shape[0], 3))
                         .astype(np.float32))
    _, touched, _ = trace_taped(scene, ro, rd, key, 6)
    picked = torch.nonzero((touched & 3) != 0).squeeze(1)
    return scene, ro, rd, key, w, picked


def _replay_grads(replay, pad: int, stages=None, device_key=False):
    """(gfuzz rows, gir rows) of one replay of the picked rays with
    ``pad`` dead rays (copies of input row 0, cotangent 0) after them."""
    scene, ro, rd, key, g, picked = replay
    count = picked.shape[0]
    alive0 = torch.arange(count + pad) < count
    sub = torch.nn.functional.pad(picked, (0, pad))
    p = params_of(scene)
    rows = _active_rows(scene)
    leaves = [p.fuzz[rows[0]].requires_grad_(True), p.ir[rows[1]].requires_grad_(True)]
    s = _with_all(scene, p._replace(fuzz=p.fuzz.index_copy(0, rows[0], leaves[0]),
                                    ir=p.ir.index_copy(0, rows[1], leaves[1])))
    if device_key:
        key = rng.stream_key(key, [*range(6), rng.TIME_STREAM], "cpu")
    val = trace_subset_dot(s, ro[sub], rd[sub], key, 6,
                           torch.where(alive0[:, None], g[sub], 0.0), alive0, sub, stages=stages)
    return torch.autograd.grad(val, leaves)


@pytest.mark.parametrize("case", ["bucket", "one_ray", "bucket_widths_every_stage"])
def test_padded_replay_equals_unpadded(replay, case):
    """zy 64x64 d6: stage 0 padded by dead rays to its width bucket, or by
    one, gives the fuzz and IR gradients of the unpadded replay bit for
    bit; so does the graphs' stage runner run eagerly on the CPU (every
    stage at its bucket width, every bounce, the key as device data)."""
    count = replay[-1].shape[0]
    assert 0 < count < FLOOR
    want = _replay_grads(replay, 0)
    if case == "bucket":
        got = _replay_grads(replay, stage_width(count) - count)
    elif case == "one_ray":
        got = _replay_grads(replay, 1)
    else:
        got = _replay_grads(replay, stage_width(count) - count,
                            stages=ReplayGraphs(torch.device("cpu")), device_key=True)
    for a, b in zip(got, want):
        assert torch.isfinite(b).all() and (b != 0).all()
        assert torch.equal(a, b)


def test_no_graphs_on_the_cpu(zy):
    """The replay takes no graphs for CPU tensors."""
    assert replay_graphs(zy.scene, "cpu") is None


def _reader():
    bench = os.path.join(ROOT, "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    spec = importlib.util.spec_from_file_location(
        "tangent_graph_pct_train", os.path.join(bench, "metrics", "tangent_graph_pct.train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("events,want", [
    ([(0, 5, "rtt.tangent_pass"), (1, 2, "rtt.tangent_graph"), (2, 3, "rtt.tangent_graph"),
      (3, 4, "rtt.tangent_graph")], 100.0),
    ([(0, 5, "rtt.tangent_pass"), (1, 2, "rtt.tangent_capture"), (2, 3, "rtt.tangent_graph"),
      (3, 4, "rtt.tangent_graph"), (4, 5, "rtt.tangent_capture")], 50.0),
    ([(0, 5, "rtt.tangent_pass"), (1, 2, "rtt.intersect")], None),
    ([(0, 5, "aten::mul")], None),
], ids=["replays", "captures", "eager", "no_spans"])
def test_tangent_graph_pct_reader(events, want):
    """``tangent_graph_pct.train``: 100 x replays / (replays + captures)
    in the traced train step; nothing where the program replayed no stage
    from a graph, nor in another loop."""
    mod = _reader()
    trace = types.SimpleNamespace(cpu=events)
    got = mod.read(types.SimpleNamespace(loop="train", trace=trace))
    assert got == want
    assert mod.read(types.SimpleNamespace(loop="render", trace=trace)) is None
    assert mod.UNIT == "%"
