"""The port's data-parallel path at world 4 (parallel/mesh.py over four
gloo processes) on the CPU: every case of tests/test_parallel.py against
one process, at widths whose ray counts need padding at world 4; the
direct and autograd steps at world 4 against the JAX package's steps on
``make_mesh(4)`` at depth 1; examples/fit_albedo.py as two processes
under torch.distributed.run's variables; multicard_torch.py on four
gloo ranks, with its refusals; and each rank's own card."""

import inspect
import os
import socket
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
from ray_tracing_tpu_torch.models.camera import Camera
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.parallel import mesh
from ray_tracing_tpu_torch.render.integrator import trace
from ray_tracing_tpu_torch.render.prb_scalar import AllParams, params_of

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
W = H = 18  # 324 rays: 352 at world 4 (a multiple of 4 * 8), 328 at world 1
ENV1 = (0.3, 0.4, 0.5)  # the depth-1 cases' environment: the albedos are live
COLOR_LINEAR = ("color", "images", "metal_albedo")


def _sphere(builder):
    """tests/test_parallel.py:_scene."""
    b = builder(background=(0.2, 0.3, 0.4))
    red = b.add_lambertian(b.add_texture_solid((0.8, 0.2, 0.2)))
    light = b.add_diffuse_light(b.add_texture_solid((3.0, 3.0, 3.0)))
    b.add_sphere((0, 0, -3), 1.0, red)
    b.add_rect("zx", -2, 2, -4, -2, 2.0, light, positive=False, important=True)
    return b.build()


def _full(builder, environment=(0.0, 0.0, 0.0)):
    """tests/test_parallel.py:149-160: a wall, a metal and a glass sphere
    and a light, so every leaf moves at depth > 1."""
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


def _wall(builder):
    """tests/test_parallel.py:118: one green wall under a bright sky."""
    b = builder(background=(0.9, 0.9, 0.9))
    b.add_rect("xy", -5, 5, -5, 5, -3.0, b.add_lambertian(b.add_texture_solid((0.2, 0.8, 0.2))),
               positive=True)
    return b.build()


def _trace_rays():
    """160 rays from (0, 0, 1) in a cone down -z (numpy seed 0)."""
    r = np.random.RandomState(0)
    n = WORLD * 40
    d = np.stack([r.uniform(-.3, .3, n), r.uniform(-.3, .3, n), -np.ones(n)], -1)
    ro = torch.from_numpy(np.tile([[0.0, 0.0, 1.0]], (n, 1)).astype(np.float32))
    return ro, torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))


def _target(seed=0):
    return np.random.RandomState(seed).uniform(0.2, 0.8, (H, W, 3)).astype(np.float32)


def _cases(m):
    """Every case on mesh ``m``; returns numpy arrays by name."""
    cam90 = Camera.build(prt.CameraParam((0, 0, 1), (0, 0, -1), 90), 1.0)
    out = {"mesh": np.array([m.rank, m.world, m.device.type == "cpu"])}
    sphere = _sphere(prt.SceneBuilder)
    ro, rd = _trace_rays()
    out["trace"] = mesh.sharded_trace(sphere, ro, rd, rng.key(7), 4, m, tile_size=64).numpy()
    cam = Camera.build(prt.CameraParam((0, 0, 1), (0, 0, -1), 60), 20 / 12)
    out["render"] = mesh.sharded_render_pass(sphere, cam, rng.key(0), width=20, height=12,
                                             max_depth=3, antialias=True, mesh=m).numpy()

    full = _full(prt.SceneBuilder)
    step = mesh.make_prb_train_step_all(cam90, full, width=16, height=16, max_depth=4, mesh=m,
                                        lr=0.3)
    params, target, losses = params_of(full), torch.full((16, 16, 3), 0.5), []
    for it in range(6):
        params, loss = step(params, full, rng.key(it), target)
        losses.append(float(loss))
        if it == 0:
            out.update({f"full_first_{f}": x.numpy() for f, x in zip(AllParams._fields, params)})
    out["full_losses"] = np.array(losses)
    out.update({f"full_last_{f}": x.numpy() for f, x in zip(AllParams._fields, params)})

    wall = _wall(prt.SceneBuilder)
    step = mesh.make_train_step(cam90, width=16, height=16, max_depth=2, mesh=m, lr=0.8)
    target, losses = torch.full((16, 16, 3), 0.55), []
    for it in range(8):
        wall, loss = step(wall, rng.key(it), target)
        losses.append(float(loss))
    out["wall_losses"], out["wall_color"] = np.array(losses), wall.textures.color.numpy()

    for depth, env in ((4, (0.0, 0.0, 0.0)), (1, ENV1)):
        scene = _full(prt.SceneBuilder, env)
        kw = dict(width=W, height=H, max_depth=depth, mesh=m, lr=0.3)
        for name, make in (("direct", mesh.make_prb_train_step_all_direct),
                           ("ad", mesh.make_prb_train_step_all)):
            p, loss = make(cam90, scene, **kw)(params_of(scene), scene, rng.key(5),
                                               torch.from_numpy(_target()))
            out[f"d{depth}_{name}_loss"] = loss.numpy()
            out.update({f"d{depth}_{name}_{f}": x.numpy() for f, x in zip(AllParams._fields, p)})
    return out


_WORKER = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    import ray_tracing_tpu_torch as prt
    from ray_tracing_tpu_torch.models.camera import Camera
    from ray_tracing_tpu_torch.ops import rng
    from ray_tracing_tpu_torch.parallel import distributed, mesh
    from ray_tracing_tpu_torch.render.prb_scalar import AllParams, params_of

    torch.set_num_threads(1)
    # helpers
    rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    if world > 1:
        distributed.initialize("gloo", init_method=init, world_size=world, rank=rank)
    np.savez(f"{out}_rank{rank}.npz", **_cases(distributed.global_mesh("cpu")))
    if world > 1:
        torch.distributed.destroy_process_group()
    """
)


def _run_ranks(tmp_path, world: int) -> list:
    """The worker on ``world`` gloo ranks (a file:// rendezvous), each
    process with its own timeout; returns every rank's results."""
    worker = tmp_path / "worker.py"
    helpers = "".join(inspect.getsource(f) + "\n" for f in
                      (_sphere, _full, _wall, _trace_rays, _target, _cases))
    consts = f"W = H = {W}\nWORLD = {WORLD}\nENV1 = {ENV1!r}\n"
    worker.write_text(_WORKER.replace("# helpers\n", consts + helpers))
    out = tmp_path / f"world{world}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), str(world),
                               f"file://{tmp_path}/init{world}", str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    return [dict(np.load(f"{out}_rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multicard")
    return {"four": _run_ranks(tmp, WORLD), "one": _run_ranks(tmp, 1)[0]}


def _leaves(res, prefix):
    return [res[f"{prefix}_{f}"] for f in AllParams._fields]


def _within_one_card_bound(four, one, prefix, loss_key=None):
    """The one-card bound: loss rtol 1e-6, updated leaves rtol 1e-6 and
    atol 1e-9 (the ranks' partial sums are added in another order)."""
    if loss_key:
        np.testing.assert_allclose(four[loss_key], one[loss_key], rtol=1e-6)
    for name, a, b in zip(AllParams._fields, _leaves(four, prefix), _leaves(one, prefix)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9, err_msg=f"{prefix} {name}")


def test_mesh_rank_world_and_device(runs):
    """Each rank's mesh is (rank, 4) on the CPU; alone, (0, 1)."""
    for r, res in enumerate(runs["four"]):
        assert res["mesh"].tolist() == [r, WORLD, True]
    assert runs["one"]["mesh"].tolist() == [0, 1, True]


def test_sharded_trace_matches_each_shard_traced_alone(runs):
    """tests/test_parallel.py:32: every rank's shard equals the dense trace
    of its rays alone with ids from its offset; every rank gathers the
    same wavefront, equal to one process's."""
    ro, rd = _trace_rays()
    per = ro.shape[0] // WORLD
    got = runs["four"][0]["trace"]
    for r in range(WORLD):
        rows = slice(r * per, (r + 1) * per)
        alone = trace(_sphere(prt.SceneBuilder), ro[rows], rd[rows], rng.key(7), 4,
                      ids_base=rows.start)
        np.testing.assert_array_equal(got[rows], alone.numpy(), err_msg=f"shard {r}")
        np.testing.assert_array_equal(runs["four"][r]["trace"], got)
    np.testing.assert_array_equal(got, runs["one"]["trace"])


def test_sharded_render_pass_shape_and_world_one(runs):
    """tests/test_parallel.py:62 at 20x12 (240 rays, 256 at world 4): the
    image's shape, finite, and equal to one process's."""
    img = runs["four"][0]["render"]
    assert img.shape == (12, 20, 3) and np.isfinite(img).all() and img.sum() > 0
    np.testing.assert_array_equal(img, runs["one"]["render"])


def test_full_param_train_step_sharded(runs):
    """tests/test_parallel.py:75: six autograd-surface steps on the whole
    parameter set descend and move the colors and fuzz or IR; the first
    step within the one-card bound of one process's."""
    four, one = runs["four"][0], runs["one"]
    losses = four["full_losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses[0], one["full_losses"][0], rtol=1e-6)
    _within_one_card_bound(four, one, "full_first")
    start = jparams_of(_full(jrt.SceneBuilder))
    moved = {f: float(np.abs(four[f"full_last_{f}"] - np.asarray(getattr(start, f))).sum())
             for f in AllParams._fields}
    assert moved["color"] > 0 and (moved["fuzz"] > 0 or moved["ir"] > 0), moved


def test_train_step_reduces_loss(runs):
    """tests/test_parallel.py:118: the dense step more than halves the
    loss in 8 steps and pulls the wall's albedo toward gray; its first
    loss within rtol 1e-6 of one process's."""
    four, one = runs["four"][0], runs["one"]
    losses = four["wall_losses"]
    assert losses[-1] < losses[0] * 0.5, losses
    np.testing.assert_allclose(losses[0], one["wall_losses"][0], rtol=1e-6)
    c = four["wall_color"][0]
    assert abs(c[0] - c[1]) < 0.45


def test_direct_step_matches_ad_step(runs):
    """tests/test_parallel.py:140 at 18x18 depth 4: the direct step equals
    the autograd step (loss rtol 1e-6, leaves rtol 1e-4 and atol 1e-7;
    the color-linear leaves bit for bit), and each is within the
    one-card bound of one process's."""
    four, one = runs["four"][0], runs["one"]
    np.testing.assert_allclose(four["d4_direct_loss"], four["d4_ad_loss"], rtol=1e-6)
    for name, a, b in zip(AllParams._fields, _leaves(four, "d4_direct"), _leaves(four, "d4_ad")):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7, err_msg=name)
        if name in COLOR_LINEAR:
            np.testing.assert_array_equal(a, b, err_msg=name)
    for which in ("direct", "ad"):
        _within_one_card_bound(four, one, f"d4_{which}", f"d4_{which}_loss")
    start = jparams_of(_full(jrt.SceneBuilder))
    for name in ("color", "metal_albedo", "fuzz", "ir"):
        assert not np.array_equal(four[f"d4_direct_{name}"], np.asarray(getattr(start, name)))


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's direct and autograd steps on make_mesh(4) of the
    8 virtual CPU devices at depth 1, one compile each."""
    scene = _full(jrt.SceneBuilder, ENV1)
    cam = jrt.Camera.build(jrt.CameraParam((0, 0, 1), (0, 0, -1), 90), 1.0)
    mesh4 = jmesh.make_mesh(WORLD)
    assert mesh4.devices.size == WORLD
    kw = dict(width=W, height=H, max_depth=1, mesh=mesh4, lr=0.3)
    steps = {"direct": jmesh.make_prb_train_step_all_direct(cam, scene, **kw),
             "ad": jmesh.make_prb_train_step_all(cam, scene, **kw)}

    def run(which):
        p, loss = steps[which](jparams_of(scene), scene,
                               jax.random.wrap_key_data(jnp.asarray(rng.key(5), jnp.uint32)),
                               jnp.asarray(_target()))
        return float(loss), [np.asarray(x) for x in p]

    return run


@pytest.mark.parametrize("which", ["direct", "ad"])
def test_step_at_world_four_matches_jax_make_mesh_four(runs, jax_steps, which):
    """Depth 1, 18x18 (padded to 352 on both sides): the port's step over
    four gloo ranks against the JAX package's on make_mesh(4), loss rtol
    1e-5, leaves rtol 1e-5 and atol 1e-6; colors and metal albedo move."""
    four = runs["four"][0]
    l_ref, p_ref = jax_steps(which)
    np.testing.assert_allclose(float(four[f"d1_{which}_loss"]), l_ref, rtol=1e-5)
    for name, a, b in zip(AllParams._fields, _leaves(four, f"d1_{which}"), p_ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)
    start = jparams_of(_full(jrt.SceneBuilder, ENV1))
    for name in ("color", "metal_albedo"):
        assert not np.array_equal(four[f"d1_{which}_{name}"], np.asarray(getattr(start, name)))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _fit_albedo(tmp_path, world: int):
    """examples/fit_albedo.py on ``world`` CPU processes, under
    torch.distributed.run's variables when ``world`` > 1; returns each
    process's stdout."""
    args = [sys.executable, "-m", "ray_tracing_tpu_torch.examples.fit_albedo", "--device", "cpu",
            "--steps", "2", "--size", "16", "--depth", "2",
            "--checkpoint", str(tmp_path / f"fit{world}.ckpt")]
    base = {k: v for k, v in os.environ.items()
            if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    base.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = str(_free_port())
    envs = [base] if world == 1 else [
        dict(base, MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(world),
             RANK=str(r), LOCAL_RANK=str(r)) for r in range(world)]
    procs = [subprocess.Popen(args, env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for env in envs]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    return [o[0] for o in outs]


def _first_loss(stdout: str) -> float:
    line = next(x for x in stdout.splitlines() if x.startswith("step    0 "))
    return float(line.split()[3])


def test_fit_albedo_joins_the_group(tmp_path):
    """Two gloo processes under torch.distributed.run's variables join
    world 2; rank 0 alone prints and writes the checkpoint; the first
    step's loss equals one process's within rtol 1e-6."""
    two = _fit_albedo(tmp_path, 2)
    assert "fit_albedo: 2 rank(s)" in two[0] and "final per-texture error" in two[0]
    assert two[1] == "", two[1]
    assert (tmp_path / "fit2.ckpt").exists()
    one = _fit_albedo(tmp_path, 1)
    assert "fit_albedo: 1 rank(s)" in one[0]
    np.testing.assert_allclose(_first_loss(two[0]), _first_loss(one[0]), rtol=1e-6)


def _multicard(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "multicard_torch.py", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_multicard_on_four_gloo_ranks():
    """multicard_torch.py --cpu --ranks 4 at 16^2 depth 2 exits 0: every
    step of every rank checked, one record per rank on the last line."""
    import json

    run = _multicard("--cpu", "--ranks", "4", "--depth", "2", "--size", "16")
    assert run.returncode == 0, run.stderr[-3000:]
    rec = json.loads(run.stdout.splitlines()[-1])
    assert rec["ranks"] == 4 and rec["backend"] == "gloo"
    assert [r["rank"] for r in rec["per_rank"]] == [0, 1, 2, 3]
    summed = rec["per_rank"][0]["summed"]
    assert summed["segments"] == rec["per_rank"][0]["world1_counts"]["segments"] > 256


def test_multicard_refuses_without_a_gpu_or_with_more_ranks_than_cards(monkeypatch):
    """No GPU and no --cpu, and more ranks than cards: exit 1, no rank
    started."""
    import multicard_torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert multicard_torch.main(["--ranks", "1"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multicard_torch.main(["--ranks", "2"]) == 1


def test_multicard_exits_1_when_a_rank_fails():
    """At depth 0 the ranks' steps raise (a pass of no bounce): the script
    reports the failed rank and exits 1."""
    run = _multicard("--cpu", "--ranks", "2", "--depth", "0", "--size", "16")
    assert run.returncode == 1
    assert "a rank failed" in run.stderr


def test_each_rank_takes_a_card_of_its_own(monkeypatch):
    """mesh.local_card: the card the caller gives, else the launcher's
    LOCAL_RANK where it is set, else the rank; a rank with no card of
    that index raises (no two ranks
    share a card, no rank falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert [mesh.local_card(r) for r in range(4)] == [0, 1, 2, 3]
    with pytest.raises(RuntimeError, match="no card of its own"):
        mesh.local_card(4)
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert mesh.local_card(6) == 2  # a second host's rank 6
    assert mesh.local_card(3, local=3) == 3  # the caller knows the rank's card
    with pytest.raises(RuntimeError, match="no card of its own"):
        mesh.local_card(5, local=5)
    monkeypatch.setenv("LOCAL_RANK", "4")
    with pytest.raises(RuntimeError, match="no card of its own"):
        mesh.local_card(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.local_card(0)


def test_an_explicit_rank_takes_its_own_card_whatever_local_rank_says(monkeypatch):
    """A launcher that spawns its ranks itself under an inherited
    LOCAL_RANK: distributed.initialize binds each NCCL rank to the card of
    its own rank (made current and given as the group's device_id), and
    make_mesh takes the card the group was bound to, not LOCAL_RANK's."""
    import types

    import torch.distributed as dist

    from ray_tracing_tpu_torch.parallel import distributed

    current, joined = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(joined))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, init_method=None, **kw: joined.append((backend, kw)))
    monkeypatch.setenv("LOCAL_RANK", "0")
    distributed.initialize("nccl", init_method="file:///unused", world_size=4, rank=2)
    assert current == [torch.device("cuda", 2)]
    assert joined == [("nccl", {"world_size": 4, "rank": 2,
                                "device_id": torch.device("cuda", 2)})]

    group = types.SimpleNamespace(bound_device_id=torch.device("cuda", 2))
    monkeypatch.setattr(dist, "get_rank", lambda g=None: 2)
    monkeypatch.setattr(dist, "get_world_size", lambda g=None: 4)
    m = mesh.make_mesh("cuda", group=group)
    assert (m.rank, m.world, m.device) == (2, 4, torch.device("cuda", 2))
    # a group bound to no card: LOCAL_RANK's, as torch.distributed.run sets it
    m = mesh.make_mesh("cuda", group=types.SimpleNamespace(bound_device_id=None))
    assert m.device == torch.device("cuda", 0)


def test_file_rendezvous_is_fresh_and_removed(tmp_path):
    """distributed.file_rendezvous: a file:// init_method in the directory
    that no earlier run left behind, removed when the block ends."""
    from ray_tracing_tpu_torch.parallel.distributed import file_rendezvous

    with file_rendezvous(str(tmp_path / "build")) as a, file_rendezvous(str(tmp_path / "build")) as b:
        assert a.startswith(f"file://{tmp_path / 'build'}/") and a != b
        open(a[len("file://"):], "w").close()  # as the ranks' store makes it
    assert os.listdir(tmp_path / "build") == []
