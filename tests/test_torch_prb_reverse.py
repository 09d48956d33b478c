"""The port's fuzz / IR pass (render/prb_scalar.py: one reverse-mode
replay per batch of the rays that reached an active family) against a
forward-mode reference written here: one ``torch.autograd.forward_ad``
tangent per active material row, pushed through the same replay of the
rays of that row's family alone, on scenes of every kind the tangent
pass meets: spheres and rects, a mesh with a transform and a medium
(data/scene.json), and moving spheres.  Also: one replay a batch however
many rows are active, and the render path's stage writes still in
place."""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from torch.profiler import ProfilerActivity, profile

import ray_tracing_tpu_torch as prt
from ray_tracing_tpu_torch.models.camera import Camera, camera_rays, stamp_shutter
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.render import integrator
from ray_tracing_tpu_torch.render.integrator import trace_compacted, trace_subset_dot
from ray_tracing_tpu_torch.render.prb_scalar import (
    _active_rows,
    _with_all,
    params_of,
    scalar_tangent_pass,
)
from ray_tracing_tpu_torch.render.prb_tape import trace_taped
from test_torch_prb import _cornell, _rays, _t, _weights

torch.set_num_threads(2)


def _forward_reference(params, scene, ro, rd, key, depth, g, touched):
    """(gfuzz, gir) by forward mode: per family, its touched rays in one
    batch; per active row, one dual replay whose tangent is that row's
    unit vector."""
    out = []
    for name, rows, bit in zip(("fuzz", "ir"), _active_rows(scene), (1, 2)):
        base = getattr(params, name)
        grad = torch.zeros_like(base)
        sub = torch.nonzero((touched & bit) != 0).squeeze(1)
        alive = torch.ones_like(sub, dtype=torch.bool)
        for row in rows:
            unit = torch.zeros_like(base)
            unit[row] = 1.0
            with fwAD.dual_level():
                s = _with_all(scene, params._replace(**{name: fwAD.make_dual(base, unit)}))
                val = trace_subset_dot(s, ro[sub], rd[sub], key, depth, g[sub], alive, sub)
                tangent = fwAD.unpack_dual(val).tangent
            if tangent is not None:
                grad[row] = tangent
        out.append(grad)
    return tuple(out)


def _cotangents(scene, ro, rd, key, depth, w):
    """(params, g, touched) of sum(w * rad): the cotangent is w, the
    bitmask the taped forward's."""
    _, touched, _ = trace_taped(scene, ro, rd, key, depth)
    return params_of(scene), w, touched


def _json_rays(path, size):
    bundle = prt.load_scene_json(path)
    ro, rd, _, key = camera_rays(Camera.build(bundle.camera, 1.0), rng.key(4), size, size)
    w = torch.from_numpy(_weights(ro.shape[0], 5))
    return bundle.scene, ro, rd, key, w


def _cornell_rays():
    ro, rd, w = _t(*_rays(2048, 3), _weights(2048, 4))
    return _cornell(prt.SceneBuilder), ro, rd, rng.key(6), w


def _motion_rays():
    """A fuzzy metal sphere and a glass sphere in motion over a Perlin
    floor under an important light, shutter [0, 1]: every ray's time is
    keyed by its id, so the gathered replay must draw the same times."""
    b = prt.SceneBuilder(background=(0.05, 0.05, 0.05))
    floor = b.add_lambertian(b.add_texture_noise(0.7, 4))
    light = b.add_diffuse_light(b.add_texture_solid((4.0, 3.5, 3.0)))
    metal = b.add_metal((0.9, 0.85, 0.8), 0.2)
    glass = b.add_dielectric(1.5)
    b.add_rect("zx", -2, 2, -2, 2, 0.0, floor, positive=True)
    b.add_rect("zx", -1, 1, -1, 1, 3.0, light, positive=False, important=True)
    b.add_sphere_moving((-0.8, 0.5, -0.8), (-0.5, 0.5, -0.8), 0.4, metal)
    b.add_sphere_moving((0.8, 0.5, -0.8), (0.8, 0.7, -0.8), 0.4, glass)
    camera = Camera.build(prt.CameraParam((0.0, 1.2, 1.8), (0.0, 0.5, -0.8), 60, time0=0.0,
                                          time1=1.0), 1.0)
    ro, rd, _, key = camera_rays(camera, rng.key(8), 32, 32)
    w = torch.from_numpy(_weights(ro.shape[0], 9))
    return stamp_shutter(b.build(), camera), ro, rd, key, w


CASES = {
    "cornell": _cornell_rays,
    "zy": lambda: _json_rays("data/zy_scene.json", 32),
    "scene_json": lambda: _json_rays("data/scene.json", 32),
    "motion": _motion_rays,
}


@pytest.mark.parametrize("case,depth", [("cornell", 6), ("zy", 5), ("scene_json", 4),
                                        ("motion", 5)],
                         ids=["cornell", "zy_d5", "scene_json_d4", "motion_d5"])
def test_reverse_pass_matches_forward_mode(case, depth):
    """Both families' gradients from one reverse replay per batch equal
    the per-row forward-mode tangents."""
    scene, ro, rd, key, w = CASES[case]()
    params, g, touched = _cotangents(scene, ro, rd, key, depth, w)
    got = scalar_tangent_pass(params, scene, ro, rd, key, depth, g, touched)
    want = _forward_reference(params, scene, ro, rd, key, depth, g, touched)
    for name, a, b in zip(("fuzz", "ir"), got, want):
        assert float(b.abs().sum()) > 1e-6, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-9, err_msg=name)


def _metals_and_glass():
    """Three metal spheres of different fuzz and a glass one over a
    lambertian floor, under an important light."""
    b = prt.SceneBuilder(background=(0.05, 0.05, 0.05))
    white = b.add_lambertian(b.add_texture_solid((0.73, 0.7, 0.68)))
    light = b.add_diffuse_light(b.add_texture_solid((4.0, 3.5, 3.0)))
    metals = [b.add_metal((0.9, 0.85, 0.8), fuzz) for fuzz in (0.1, 0.25, 0.4)]
    glass = b.add_dielectric(1.5)
    b.add_rect("zx", -2, 2, -2, 2, 0.0, white, positive=True)
    b.add_rect("zx", -1, 1, -1, 1, 3.0, light, positive=False, important=True)
    for x, mat in zip((-0.9, -0.3, 0.3), metals):
        b.add_sphere((x, 0.4, -0.8), 0.28, mat)
    b.add_sphere((0.9, 0.4, -0.8), 0.28, glass)
    return b.build()


def _replays(fn):
    """``fn()``'s result and its number of ``rtt.tangent_replay`` spans."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sum(e.name == "rtt.tangent_replay" for e in prof.events())


def test_one_replay_per_batch_for_many_rows():
    """Three active metal rows and a dielectric row: one batch is one
    replay, every row's gradient equals its forward-mode tangent, and
    batches of a tile that does not divide the touched count give the
    same gradients in one replay each."""
    scene = _metals_and_glass()
    fuzz_rows, ir_rows = _active_rows(scene)
    assert len(fuzz_rows) == 3 and len(ir_rows) == 1
    ro, rd, w = _t(*_rays(2048, 7), _weights(2048, 8))
    key = rng.key(9)
    params, g, touched = _cotangents(scene, ro, rd, key, 6, w)
    count = int(((touched & 3) != 0).sum())
    (gfuzz, gir), replays = _replays(lambda: scalar_tangent_pass(
        params, scene, ro, rd, key, 6, g, touched, tile_size=ro.shape[0]))
    assert replays == 1
    want = _forward_reference(params, scene, ro, rd, key, 6, g, touched)
    # the third metal row sums its rays' terms to 0.054 from 6.9 in
    # magnitude: each path's derivative carries float32 rounding (~1e-7 of
    # its term) in either mode, which shows at ~1.5e-5 of that one sum
    for name, a, b, rows in zip(("fuzz", "ir"), (gfuzz, gir), want, (fuzz_rows, ir_rows)):
        assert (b[rows].abs() > 1e-2).all(), name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=2e-6, err_msg=name)
    tile = count // 3 + 1
    (bfuzz, bir), replays = _replays(lambda: scalar_tangent_pass(
        params, scene, ro, rd, key, 6, g, touched, tile_size=tile))
    assert replays == -(-count // tile) == 3
    np.testing.assert_allclose(bfuzz.numpy(), gfuzz.numpy(), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(bir.numpy(), gir.numpy(), rtol=1e-5, atol=1e-9)


def test_render_stage_writes_stay_in_place(monkeypatch):
    """A no-grad compacted trace writes each stage's prefix back into the
    full-width state in place (the render cells' ops); the replay under
    autograd builds it out of place."""
    real, in_place = integrator.run_stage, []

    def spy(bounce_fn, bounces, carry, live):
        out = real(bounce_fn, bounces, carry, live)
        in_place.append(all(a is b for a, b in zip(out, carry) if b.dim()))
        return out

    monkeypatch.setattr(integrator, "run_stage", spy)
    scene, ro, rd, key, w = _cornell_rays()
    with torch.no_grad():
        rad = trace_compacted(scene, ro, rd, key, 12)
    assert in_place == [True, True]
    params, g, touched = _cotangents(scene, ro, rd, key, 12, w)
    in_place.clear()
    scalar_tangent_pass(params, scene, ro, rd, key, 12, g, touched)
    assert in_place and not any(in_place)
