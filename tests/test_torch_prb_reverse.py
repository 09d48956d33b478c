"""The port's fuzz / IR pass (render/prb_scalar.py: one reverse-mode
replay per batch of the rays that reached an active family) against a
forward-mode reference written here: one ``torch.autograd.forward_ad``
tangent per active material row, pushed through the same replay of the
rays of that row's family alone.  Also: one replay a batch however many
rows are active, and the render path's stage writes still in place."""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from torch.profiler import ProfilerActivity, profile

import ray_tracing_tpu_torch as prt
from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.render import integrator
from ray_tracing_tpu_torch.render.integrator import trace_compacted, trace_subset_dot
from ray_tracing_tpu_torch.render.prb import prb_grad_dense
from ray_tracing_tpu_torch.render.prb_scalar import (
    _active_rows,
    _with_all,
    params_of,
    prb_loss_and_grad_all,
    scalar_tangent_pass,
)
from test_torch_prb import _cornell, _rays, _t, _weights

torch.set_num_threads(2)


def _forward_reference(params, scene, ro, rd, key, depth, g, touched, compaction):
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
                if compaction:
                    val = trace_subset_dot(s, ro[sub], rd[sub], key, depth, g[sub], alive, sub)
                else:
                    rad = prb_grad_dense(s, ro[sub], rd[sub], key, depth, None, g[sub],
                                         alive0=alive, ids0=sub, accumulate=False)[1]
                    val = (g[sub] * rad).sum(dtype=torch.float64)
                tangent = fwAD.unpack_dual(val).tangent
            if tangent is not None:
                grad[row] = tangent
        out.append(grad)
    return tuple(out)


def _cotangents(scene, ro, rd, key, depth, w, compaction=True):
    """(params, g, touched) of sum(w * rad) from the deferred forward."""
    params = params_of(scene)
    _, _, (_, g, touched) = prb_loss_and_grad_all(lambda r: torch.sum(w * r), params, scene, ro,
                                                  rd, key, depth, compaction=compaction,
                                                  defer_scalars=True)
    return params, g, touched


def _zy_rays():
    bundle = prt.load_scene_json("data/zy_scene.json")
    ro, rd, _, key = camera_rays(Camera.build(bundle.camera, 1.0), rng.key(4), 32, 32)
    w = torch.from_numpy(_weights(ro.shape[0], 5))
    return bundle.scene, ro, rd, key, w


def _cornell_rays():
    ro, rd, w = _t(*_rays(2048, 3), _weights(2048, 4))
    return _cornell(prt.SceneBuilder), ro, rd, rng.key(6), w


@pytest.mark.parametrize("case,depth,compaction", [
    ("cornell", 6, True),
    ("zy", 5, True),
    ("cornell", 6, False),
    ("zy", 5, False),
], ids=["cornell", "zy_d5", "cornell_dense", "zy_d5_dense"])
def test_reverse_pass_matches_forward_mode(case, depth, compaction):
    """Both families' gradients from one reverse replay per batch equal
    the per-row forward-mode tangents, compacted and dense."""
    scene, ro, rd, key, w = _cornell_rays() if case == "cornell" else _zy_rays()
    params, g, touched = _cotangents(scene, ro, rd, key, depth, w, compaction)
    got = scalar_tangent_pass(params, scene, ro, rd, key, depth, None, g, touched,
                              compaction=compaction)
    want = _forward_reference(params, scene, ro, rd, key, depth, g, touched, compaction)
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
    batches of a cap that does not divide the touched count give the
    same gradients in one replay each."""
    scene = _metals_and_glass()
    fuzz_rows, ir_rows = _active_rows(scene)
    assert len(fuzz_rows) == 3 and len(ir_rows) == 1
    ro, rd, w = _t(*_rays(2048, 7), _weights(2048, 8))
    key = rng.key(9)
    params, g, touched = _cotangents(scene, ro, rd, key, 6, w)
    count = int(((touched & 3) != 0).sum())
    (gfuzz, gir), replays = _replays(lambda: scalar_tangent_pass(
        params, scene, ro, rd, key, 6, None, g, touched, tangent_cap=ro.shape[0]))
    assert replays == 1
    want = _forward_reference(params, scene, ro, rd, key, 6, g, touched, True)
    # the third metal row sums its rays' terms to 0.054 from 6.9 in
    # magnitude: each path's derivative carries float32 rounding (~1e-7 of
    # its term) in either mode, which shows at ~1.5e-5 of that one sum
    for name, a, b, rows in zip(("fuzz", "ir"), (gfuzz, gir), want, (fuzz_rows, ir_rows)):
        assert (b[rows].abs() > 1e-2).all(), name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=2e-6, err_msg=name)
    cap = count // 3 + 1
    (bfuzz, bir), replays = _replays(lambda: scalar_tangent_pass(
        params, scene, ro, rd, key, 6, None, g, touched, tangent_cap=cap))
    assert replays == -(-count // cap) == 3
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
    scalar_tangent_pass(params, scene, ro, rd, key, 12, rad, g, touched)
    assert in_place and not any(in_place)
