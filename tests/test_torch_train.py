"""The port's train steps (ray_tracing_tpu_torch/parallel/mesh.py) and
process-group helpers (parallel/distributed.py): the direct and the
autograd-surface full-parameter steps against the JAX package's on a
one-device mesh at depth 1, against each other, the dense autograd step
descending, two gloo processes against one process, and the fuzz and IR
gradients of a depth-20 fit against central differences in float64."""

import dataclasses
import inspect
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tracing_tpu as jrt
import ray_tracing_tpu_torch as prt
from ray_tracing_tpu.parallel import mesh as jmesh
from ray_tracing_tpu.render.prb_scalar import params_of as jparams_of
from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
from ray_tracing_tpu_torch.models.scene import MAT_DIFFUSE_LIGHT
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.parallel import distributed, mesh
from ray_tracing_tpu_torch.render.integrator import trace, trace_compacted
from ray_tracing_tpu_torch.render.prb_scalar import (
    AllParams,
    _active_rows,
    _with_all,
    params_of,
    scalar_tangent_pass,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 15  # 225 rays: padded to 232 on one rank, 240 on two


def _scene(builder, environment=(0.0, 0.0, 0.0)):
    """tests/test_parallel.py:149-160: a wall, a metal and a glass sphere
    and a light, so all five leaves move at depth > 1.  At depth 1 a
    nonzero environment makes the albedos live."""
    b = builder(background=(0.3, 0.3, 0.3), environment=environment)
    green = b.add_lambertian(b.add_texture_solid((0.2, 0.8, 0.2)))
    metal = b.add_metal((0.9, 0.8, 0.7), 0.2)
    glass = b.add_dielectric(1.5)
    light = b.add_diffuse_light(b.add_texture_solid((3.0, 3.0, 3.0)))
    b.add_rect("xy", -5, 5, -5, 5, -3.0, green, positive=True)
    b.add_sphere((-0.7, 0.0, -1.8), 0.5, metal)
    b.add_sphere((0.7, 0.0, -1.8), 0.5, glass)
    b.add_rect("zx", -1, 1, -3, -1, 3.0, light, positive=False, important=True)
    return b.build()


def _camera():
    return Camera.build(prt.CameraParam((0, 0, 1), (0, 0, -1), 90), 1.0)


def _target(seed=0):
    return np.random.RandomState(seed).uniform(0.2, 0.8, (H, W, 3)).astype(np.float32)


ENV1 = (0.3, 0.4, 0.5)  # the environment of the depth-1 cases


def _steps(depth, lr=0.3, environment=(0.0, 0.0, 0.0)):
    """The port's direct and autograd-surface steps on a single process."""
    m = mesh.make_mesh("cpu")
    scene = _scene(prt.SceneBuilder, environment)
    kw = dict(width=W, height=H, max_depth=depth, mesh=m, lr=lr)
    return (scene, mesh.make_prb_train_step_all_direct(_camera(), scene, **kw),
            mesh.make_prb_train_step_all(_camera(), scene, **kw))


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's two steps on a one-device mesh at depth 1, one
    compile each; keys passed as data."""
    scene = _scene(jrt.SceneBuilder, ENV1)
    cam = jrt.Camera.build(jrt.CameraParam((0, 0, 1), (0, 0, -1), 90), 1.0)
    kw = dict(width=W, height=H, max_depth=1, mesh=jmesh.make_mesh(1), lr=0.3)
    direct = jmesh.make_prb_train_step_all_direct(cam, scene, **kw)
    ad = jmesh.make_prb_train_step_all(cam, scene, **kw)

    def run(step, key_words, target):
        p, loss = step(jparams_of(scene), scene,
                       jax.random.wrap_key_data(jnp.asarray(key_words, jnp.uint32)),
                       jnp.asarray(target))
        return float(loss), AllParams(*(np.asarray(x) for x in p))

    return {"direct": lambda k, t: run(direct, k, t), "ad": lambda k, t: run(ad, k, t)}


@pytest.mark.parametrize("which", ["direct", "ad"])
def test_step_matches_jax_at_depth_one(jax_steps, which):
    """One step at depth 1 (a nonzero environment, so the colors and the
    metal albedo move; fuzz and IR cannot change a depth-1 radiance):
    loss and updated parameters within 1e-5 of the JAX package's step on
    make_mesh(1)."""
    scene, direct, ad = _steps(1, environment=ENV1)
    key, target = rng.key(5), _target()
    p, loss = (direct if which == "direct" else ad)(params_of(scene), scene, key,
                                                    torch.from_numpy(target))
    l_ref, p_ref = jax_steps[which](key, target)
    np.testing.assert_allclose(float(loss), l_ref, rtol=1e-5)
    start = params_of(scene)
    for name, a, b, s in zip(AllParams._fields, p, p_ref, start):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6, err_msg=name)
    moved = {f: float((a - s).abs().sum()) for f, a, s in zip(AllParams._fields, p, start)}
    assert moved["color"] > 0 and moved["metal_albedo"] > 0, moved


def test_direct_step_equals_ad_step():
    """Depth 4: the direct step equals the autograd-surface step on the
    same key (the same forward, replay and tangent pass): the loss and
    the color-linear leaves bit for bit, fuzz and IR to rtol 1e-6."""
    scene, direct, ad = _steps(4)
    params, target = params_of(scene), torch.from_numpy(_target(1))
    p_d, l_d = direct(params, scene, rng.key(5), target)
    p_a, l_a = ad(params, scene, rng.key(5), target)
    np.testing.assert_allclose(float(l_d), float(l_a), rtol=1e-6)
    for name, a, b in zip(AllParams._fields, p_d, p_a):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-9, err_msg=name)
    for name in ("color", "images", "metal_albedo"):
        assert torch.equal(getattr(p_d, name), getattr(p_a, name)), name
    for name in ("color", "metal_albedo", "fuzz", "ir"):
        assert not torch.equal(getattr(p_d, name), getattr(params, name)), name


def test_train_step_reduces_loss():
    """Dense autograd through sharded_render_pass (tests/test_parallel.py:
    118): fitting a wall albedo toward a gray target more than halves the
    loss in 8 steps, and the colour-only PRB step descends too."""
    b = prt.SceneBuilder(background=(0.9, 0.9, 0.9))
    b.add_rect("xy", -5, 5, -5, 5, -3.0, b.add_lambertian(b.add_texture_solid((0.2, 0.8, 0.2))),
               positive=True)
    scene0 = b.build()
    m = mesh.make_mesh("cpu")
    target = torch.full((16, 16, 3), 0.55)
    for make, depth, lr in ((mesh.make_train_step, 2, 0.8), (mesh.make_prb_train_step, 2, 0.8)):
        step = make(_camera(), width=16, height=16, max_depth=depth, mesh=m, lr=lr)
        scene, losses = scene0, []
        for it in range(8):
            scene, loss = step(scene, rng.key(it), target)
            losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.5, (make.__name__, losses)
        c = scene.textures.color[0]
        assert abs(float(c[0] - c[1])) < 0.45, make.__name__


def test_sharded_trace_single_process_equals_trace():
    """Without a process group the mesh is one rank: sharded_trace is the
    tiled dense trace with ids from 0."""
    scene = _scene(prt.SceneBuilder)
    r = np.random.RandomState(0)
    n = 8 * 40
    ro = torch.from_numpy(np.tile([[0.0, 0.0, 1.0]], (n, 1)).astype(np.float32))
    d = np.stack([r.uniform(-.3, .3, n), r.uniform(-.3, .3, n), -np.ones(n)], -1)
    rd = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))
    m = mesh.make_mesh("cpu")
    assert (m.rank, m.world, m.collective) == (0, 1, False)
    out = mesh.sharded_trace(scene, ro, rd, rng.key(7), 4, m, tile_size=128)
    assert torch.equal(out, trace(scene, ro, rd, rng.key(7), 4))


def test_initialize_is_a_no_op_alone_and_raises_when_configured(monkeypatch, tmp_path):
    """No arguments and no cluster variables: nothing to join.  A
    configured group that fails raises; it is never a single process."""
    for var in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert distributed.process_info()["process_count"] == 1
    with pytest.raises((ValueError, RuntimeError, AssertionError), match="no-such-backend"):
        distributed.initialize("no-such-backend", init_method=f"file://{tmp_path}/init",
                               world_size=1, rank=0)
    assert not torch.distributed.is_initialized()


_WORKER = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    import ray_tracing_tpu_torch as prt
    from ray_tracing_tpu_torch.models.camera import Camera
    from ray_tracing_tpu_torch.ops import rng
    from ray_tracing_tpu_torch.parallel import distributed, mesh
    from ray_tracing_tpu_torch.render.prb_scalar import params_of

    torch.set_num_threads(1)
    # helpers
    rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    if world > 1:
        distributed.initialize("gloo", init_method=init, world_size=world, rank=rank)
    m = distributed.global_mesh("cpu")
    assert (m.rank, m.world) == (rank, world)
    scene = _scene(prt.SceneBuilder)
    img = mesh.sharded_render_pass(scene, _camera(), rng.key(7), width=W, height=H,
                                   max_depth=3, antialias=True, mesh=m)
    step = mesh.make_prb_train_step_all_direct(_camera(), scene, width=W, height=H,
                                               max_depth=3, mesh=m, lr=0.3)
    p, loss = step(params_of(scene), scene, rng.key(5), torch.from_numpy(_target()))
    if rank == 0:
        np.savez(out, img=img.numpy(), loss=loss.numpy(), *[x.numpy() for x in p])
    if world > 1:
        torch.distributed.destroy_process_group()
    """
)


def _run_ranks(tmp_path, world: int):
    """Run the worker on ``world`` gloo ranks (one process each); returns
    rank 0's results.  Each process has its own timeout, so a hung rank
    fails the test instead of the suite."""
    worker = tmp_path / "worker.py"
    # the worker imports the port only (no JAX), with this file's scene
    helpers = "".join(inspect.getsource(f) + "\n" for f in (_scene, _camera, _target))
    worker.write_text(_WORKER.replace("# helpers\n", f"W = H = {W}\n{helpers}"))
    out = tmp_path / f"world{world}.npz"
    init = f"file://{tmp_path}/init{world}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), str(world), init,
                               str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    return np.load(out)


def test_two_gloo_processes_match_one_process(tmp_path):
    """Two gloo ranks (a file:// rendezvous) against one process: the
    sharded image equal, the direct step's loss and parameters within
    rtol 1e-6 (the two ranks' partial sums are added in another order)."""
    two = _run_ranks(tmp_path, 2)
    one = _run_ranks(tmp_path, 1)
    np.testing.assert_array_equal(two["img"], one["img"])
    assert float(np.abs(one["img"]).sum()) > 0
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-6)
    for i, name in enumerate(AllParams._fields):
        np.testing.assert_allclose(two[f"arr_{i}"], one[f"arr_{i}"], rtol=1e-6, atol=1e-9,
                                   err_msg=name)


def _float64(table):
    """A copy of a compiled scene with every float32 tensor in float64,
    except phase A's packed tables, whose int32 words are float32 bits
    (their float columns are exact in either precision)."""
    if isinstance(table, torch.Tensor):
        return table.double() if table.dtype == torch.float32 else table
    if dataclasses.is_dataclass(table):
        return dataclasses.replace(table, **{
            f.name: getattr(table, f.name) if f.name == "phase_a"
            else _float64(getattr(table, f.name)) for f in dataclasses.fields(table)})
    return table


ZY_SIZE, ZY_DEPTH, ZY_LR = 64, 20, 0.05  # the learning rate of chip_smoke.py's phase 28


@pytest.fixture(scope="module")
def zy_float64():
    """zy at 64^2 depth 20 in float64 on the CPU, the fit of chip_smoke.py's
    phase 28: wall colors at 0.5 (the emitter pinned) toward a target
    rendered at the true parameters under the same key; the fuzz and IR
    gradient of the L2 loss by the tangent pass."""
    bundle = prt.load_scene_json(os.path.join(REPO, "data", "zy_scene.json"))
    scene = _float64(bundle.scene)
    cam = Camera.build(bundle.camera, 1.0)
    n = ZY_SIZE * ZY_SIZE
    ro, rd, _, key = camera_rays(cam, rng.key(0), ZY_SIZE, ZY_SIZE, True)
    ro, rd = ro.double(), rd.double()
    true = params_of(scene)
    mtype = scene.materials.mtype
    pinned = torch.zeros_like(true.color[:, :1], dtype=torch.bool)
    pinned[scene.materials.tex[mtype == MAT_DIFFUSE_LIGHT].long()] = True
    fit = true._replace(color=torch.where(pinned, true.color, 0.5))

    def loss(p):
        rad = trace_compacted(_with_all(scene, p), ro, rd, key, ZY_DEPTH)
        return float(torch.mean((rad - target) ** 2))

    target = trace_compacted(scene, ro, rd, key, ZY_DEPTH)
    rad = trace_compacted(_with_all(scene, fit), ro, rd, key, ZY_DEPTH)
    touched = torch.full((n,), 3, dtype=torch.uint8)
    gfuzz, gir = scalar_tangent_pass(fit, scene, ro, rd, key, ZY_DEPTH,
                                     2.0 * (rad - target) / (3 * n), touched, tile_size=n)
    return scene, fit, loss, {"fuzz": gfuzz, "ir": gir}


@pytest.mark.parametrize("leaf", ["fuzz", "ir"])
def test_zy_scalar_gradient_is_the_loss_derivative(zy_float64, leaf):
    """A witness of the fuzz and IR gradients of a matched-key fit at
    depth 20: in float64, where no path flips within +-1e-8, the tangent
    pass equals the central difference of the loss (rtol 1e-5).  Yet the
    SGD step on that leaf alone raises the loss: the derivative holds
    over far less than lr |g| (PERF.md §6)."""
    scene, fit, loss, grads = zy_float64
    metal, glass = _active_rows(scene)
    row = int((metal if leaf == "fuzz" else glass)[0])
    g = float(grads[leaf][row])

    def moved(h):
        value = getattr(fit, leaf).clone()
        value[row] += h
        return fit._replace(**{leaf: value})

    h = 1e-8
    fd = (loss(moved(h)) - loss(moved(-h))) / (2 * h)
    assert abs(g) > 1e-3, "no gradient signal"
    np.testing.assert_allclose(g, fd, rtol=1e-5)
    assert loss(moved(-ZY_LR * g)) > loss(fit)
