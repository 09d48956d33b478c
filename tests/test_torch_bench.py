"""The port's headline bench (bench_torch.py), its perf ladder and its
pass profile (tools/perf/ladder_torch.py, profile_pass_torch.py) on the
CPU, at 32^2-64^2 and depth <= 3: the bench's record carries bench.py's
keys, its pass is the library's (parallel/mesh.py:tiled_loss_and_grad)
bit for bit, its loss and gradients match the JAX package's bench
protocol (bench.py:171-231: per-tile prb_loss_and_grad_all with
defer_scalars under one key, one scalar_tangent_pass) and it counts the
segments bench.py counts; the ladder's colors stage is the full stage's
color-linear half; the profile's aggregation and launch-count check on
synthetic kernel names.  The card runs them in chip_smoke.py phases
39-41."""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from ray_tracing_tpu import load_scene_json as jload_scene_json
from ray_tracing_tpu.models.camera import Camera as JCamera
from ray_tracing_tpu.models.camera import camera_rays as jcamera_rays
from ray_tracing_tpu.render.integrator import trace_compacted as jtrace_compacted
from ray_tracing_tpu.render.prb_scalar import params_of as jparams_of
from ray_tracing_tpu.render.prb_scalar import prb_loss_and_grad_all as jloss_and_grad
from ray_tracing_tpu.render.prb_scalar import scalar_tangent_pass as jscalar_tangent_pass
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.parallel.mesh import tiled_loss_and_grad
from ray_tracing_tpu_torch.render.prb_scalar import AllParams, params_of

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, TILE = 32, 512  # two tiles under one key
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "mode", "spread"]  # bench.py:305-317
COLOR_LINEAR = ("color", "images", "metal_albedo")


def _tool(name):
    """tools/perf/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", "perf", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def bench_runs():
    """bench_torch.main on the CPU at 32^2 with tiles of 512, at depth 1
    and 3 (one pass, one block), with its details."""
    runs = {}
    for depth in (1, 3):
        details = {}
        rec = bench_torch.main(device="cpu", width=SIZE, height=SIZE, depth=depth, passes=1,
                               reps=1, tile=TILE, details=details)
        runs[depth] = (rec, details)
    return runs


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX package's bench pass (bench.py:171-231 without the planar
    atlas): per tile prb_loss_and_grad_all(jnp.sum, ..., ids_base,
    defer_scalars=True) under one key, the summed losses and gradients
    over n * 3, one scalar_tangent_pass.  It runs under
    jax.disable_jit(): jitted XLA-CPU fuses products and sums into FMAs,
    which moves hit points by an ulp and sends ~1 % of the rays down
    other paths by depth 3 (the port's own rounding, unfused, sends one
    ray of 1,024 at 32^2); the eager package compiles no program, only
    its primitives.  Returns get(depth, key words) -> (loss, AllParams of
    numpy)."""
    bundle = jload_scene_json(os.path.join(ROOT, "data", "zy_scene.json"))
    scene = bundle.scene
    camera = JCamera.build(bundle.camera, 1.0)
    n = SIZE * SIZE

    def get(depth, key_words):
        params = jparams_of(scene)
        with jax.disable_jit():
            key = jax.random.wrap_key_data(jnp.asarray(key_words, jnp.uint32))
            ro, rd, _, k_trace = jcamera_rays(camera, key, SIZE, SIZE, True)
            loss, g, rads, gcs, touches = 0.0, None, [], [], []
            for base in range(0, n, TILE):
                loss_i, g_i, (rad, gc, touched) = jloss_and_grad(
                    jnp.sum, params, scene, ro[base:base + TILE], rd[base:base + TILE], k_trace,
                    depth, ids_base=base, defer_scalars=True)
                loss = loss + loss_i
                g = g_i if g is None else jax.tree.map(jnp.add, g, g_i)
                rads.append(rad)
                gcs.append(gc)
                touches.append(touched)
            g = jax.tree.map(lambda a: a / (n * 3), g)
            gfuzz, gir = jscalar_tangent_pass(
                params, scene, ro, rd, k_trace, depth, jnp.concatenate(rads),
                jnp.concatenate(gcs) / (n * 3), jnp.concatenate(touches), tangent_cap=TILE)
            loss = loss / (n * 3)
        return float(loss), AllParams(*(np.asarray(x) for x in g._replace(fuzz=gfuzz, ir=gir)))

    return get


def _port_pass(key, depth):
    """(loss, AllParams as numpy) of bench_torch.fwd_bwd at ``key`` on the
    CPU at SIZE^2."""
    scene, camera, _ = bench_torch.load("cpu", SIZE, SIZE)
    loss, g = bench_torch.fwd_bwd(params_of(scene), scene,
                                  *bench_torch.wavefront(camera, key, SIZE, SIZE), depth, TILE)
    return float(loss), AllParams(*(x.numpy() for x in g))


def test_record_has_bench_py_keys(bench_runs):
    rec, details = bench_runs[3]
    assert list(rec) == BENCH_KEYS
    assert list(rec["spread"]) == ["blocks", "passes_per_block", "min", "max"]
    assert rec["metric"] == "zy_scene 32^2 fwd+bwd rays/s/chip (CPU)" and rec["mode"] == "cpu"
    assert rec["unit"] == "rays/s" and np.isfinite(rec["value"]) and rec["value"] > 0
    assert rec["vs_baseline"] == rec["value"] / bench_torch.REFERENCE_RAYS_PER_S
    assert rec["spread"]["blocks"] == 1 and rec["spread"]["passes_per_block"] == 1
    assert rec["spread"]["min"] == rec["value"] == rec["spread"]["max"]
    assert details["depth"] == 3 and details["tile"] == TILE
    assert bench_torch.METRIC.format(size="1024^2") == "zy_scene 1024^2 fwd+bwd rays/s/chip"


@pytest.mark.parametrize("depth", [1, 3])
def test_pass_is_the_library_pass(bench_runs, depth):
    """The bench's last timed pass (key 1) equals tiled_loss_and_grad
    called here with the loss sum(rad) / (n * 3), torch.equal; its
    segments equal trace_compacted's over the same tiles and ids."""
    from ray_tracing_tpu_torch.models.camera import camera_rays
    from ray_tracing_tpu_torch.render.integrator import trace_compacted

    _, details = bench_runs[depth]
    scene, camera, _ = bench_torch.load("cpu", SIZE, SIZE)
    ro, rd, _, k_trace = camera_rays(camera, rng.key(1), SIZE, SIZE, True)
    scale = 1.0 / (SIZE * SIZE * 3)
    loss, grads = tiled_loss_and_grad(lambda rad, rows: torch.sum(rad) * scale,
                                      params_of(scene), scene, ro, rd, k_trace, depth,
                                      tile_size=TILE)
    assert torch.equal(loss, details["loss"])
    for f in AllParams._fields:
        assert torch.equal(getattr(grads, f), getattr(details["grads"], f)), f
    segments = sum(int(trace_compacted(scene, ro[s:s + TILE], rd[s:s + TILE], k_trace, depth,
                                       with_stats=True, ids_base=s)[1])
                   for s in range(0, SIZE * SIZE, TILE))
    assert details["segments"] == [segments]


def test_depth_one_matches_jax(bench_runs, jax_bench):
    """Depth 1: the loss and all five leaves allclose to JAX's bench pass
    at the same key, rtol 1e-5 (atol 1e-8: at depth 1 only the emitters'
    colors have a gradient, every other leaf is 0 in both)."""
    _, details = bench_runs[1]
    loss, g = jax_bench(1, rng.key(1))
    np.testing.assert_allclose(float(details["loss"]), loss, rtol=1e-5)
    for f in AllParams._fields:
        np.testing.assert_allclose(getattr(details["grads"], f).numpy(), getattr(g, f),
                                   rtol=1e-5, atol=1e-8, err_msg=f)
    assert np.abs(g.color).sum() > 0


def test_depth_three_inside_noise_floor(bench_runs, jax_bench):
    """Depth 3: the loss and every leaf of the bench's pass differ from
    JAX's at the same key by at most 0.6x the port's own difference
    between two keys (the noise-floor rule); the loss, the color-linear
    leaves and fuzz carry a signal at this depth (IR may be 0 in both:
    few of 1,024 paths refract into a light by depth 3)."""
    _, details = bench_runs[3]
    mine_loss, mine = float(details["loss"]), AllParams(*(x.numpy() for x in details["grads"]))
    other_loss, other = _port_pass(rng.key(2), 3)
    their_loss, theirs = jax_bench(3, rng.key(1))
    assert abs(mine_loss - their_loss) <= 0.6 * abs(mine_loss - other_loss)
    for name, a, b, c in zip(AllParams._fields, mine, theirs, other):
        matched, floor = np.abs(a - b).sum(), np.abs(a - c).sum()
        assert floor > 0 or name == "ir", (name, floor)
        assert matched <= 0.6 * floor, (name, matched, floor)


def test_segments_match_jax(bench_runs):
    """Depth 1: the bench's segments equal JAX's trace_compacted(...,
    with_stats=True) over the same tiles, ids and key (bench.py's
    count_fn)."""
    _, details = bench_runs[1]
    bundle = jload_scene_json(os.path.join(ROOT, "data", "zy_scene.json"))
    camera = JCamera.build(bundle.camera, 1.0)
    key = jax.random.wrap_key_data(jnp.asarray(rng.key(1), jnp.uint32))
    ro, rd, _, k_trace = jcamera_rays(camera, key, SIZE, SIZE, True)
    count = jax.jit(lambda ro, rd, base: jtrace_compacted(
        bundle.scene, ro, rd, k_trace, 1, with_stats=True, ids_base=base)[1])
    want = sum(int(count(ro[s:s + TILE], rd[s:s + TILE], s)) for s in range(0, SIZE * SIZE, TILE))
    assert details["segments"] == [want]


@pytest.mark.parametrize("script", ["bench_torch.py", "tools/perf/ladder_torch.py",
                                    "tools/perf/profile_pass_torch.py"])
def test_entry_points_exit_one_without_a_gpu(script):
    """Without a GPU each entry point exits 1 with a message and never
    falls back to the CPU."""
    run = subprocess.run([sys.executable, os.path.join(ROOT, script)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert run.returncode == 1 and run.stdout == ""
    assert "needs an NVIDIA GPU" in run.stderr


def test_ladder_colors_is_the_full_stage_without_tangents():
    """The ladder's colors stage at 32^2 depth 3 (two tiles): its loss
    and color-linear leaves equal the full stage's (the bench's pass),
    torch.equal, and its fuzz and IR gradients are zero; fwd sums the
    radiance the passes trace (the loss times n * 3, rtol 1e-6)."""
    ladder = _tool("ladder_torch")
    setup = ladder.Setup(device="cpu", width=SIZE, height=SIZE, depth=3, tile=TILE)
    c_loss, colors = ladder.STAGES["colors"](setup, rng.key(1))
    f_loss, full = ladder.STAGES["full"](setup, rng.key(1))
    (total,) = ladder.STAGES["fwd"](setup, rng.key(1))
    assert torch.equal(c_loss, f_loss)
    for f in COLOR_LINEAR:
        assert torch.equal(getattr(colors, f), getattr(full, f)), f
    assert not colors.fuzz.any() and not colors.ir.any() and full.fuzz.any()
    np.testing.assert_allclose(float(total), float(f_loss) * SIZE * SIZE * 3, rtol=1e-6)
    part = ladder.Setup(device="cpu", width=SIZE, height=SIZE, depth=3, tile=TILE, tiles=2)
    ro, _, _ = part.rays(rng.key(1))
    assert ro.shape[0] == 2 * TILE


def test_ladder_main_times_every_stage(capsys):
    ladder = _tool("ladder_torch")
    results = ladder.main(["fwd", "colors", "--reps=2"], device="cpu", width=16, height=16,
                          depth=1, tile=128)
    assert list(results) == ["fwd", "colors"] and all(len(v) == 2 for v in results.values())
    out = capsys.readouterr().out
    assert "fwd      median" in out and "colors   median" in out
    with pytest.raises(SystemExit, match="unknown stage"):
        ladder.main(["nope"], device="cpu")


# demangled and mangled names of the kernels of csrc/*.cu
_NAMES = {
    "void (anonymous namespace)::phase_a_kernel<false, false, false, 4, false>(Args, int)": "K1",
    "void (anonymous namespace)::phase_a_kernel<true, false, false, 1, true>(Args, int)": "K3",
    "void (anonymous namespace)::phase_a_kernel<false, true, false, 2, false>(Args, int)": "K3",
    "void (anonymous namespace)::phase_a_kernel<false, false, true, 4, false>(Args, int)": "K4",
    "_ZN12_GLOBAL__N_114phase_a_kernelILb0ELb0ELb0ELi4ELb0EEEvNS_4ArgsEi": "K1",
    "_ZN12_GLOBAL__N_114phase_a_kernelILb0ELb0ELb1ELi4ELb0EEEvNS_4ArgsEi": "K4",
    "(anonymous namespace)::scatter_add_place_kernel(int, Segments, Scratch, unsigned int)": "K2",
    "(anonymous namespace)::scatter_add_sum_kernel(float*, Scratch, unsigned int)": "K2",
    "(anonymous namespace)::triangle_sweep_kernel(float const*, int)": "K5",
    "(anonymous namespace)::cluster_sweep_kernel(float const*, int)": "K6",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>": None,
    "(anonymous namespace)::empty_kernel()": None,
}


def test_profile_families_and_launch_check():
    """The profile's kernel families, aggregation and launch-count check
    on a synthetic event list: equal counts pass; a missing K1 launch, or
    a family the profiler never saw, is reported."""
    prof = _tool("profile_pass_torch")
    for name, fam in _NAMES.items():
        assert prof.family(name) == fam, name
    k1, place, total = list(_NAMES)[0], list(_NAMES)[6], list(_NAMES)[-2]
    events = [(k1, 0.005)] * 3 + [(place, 0.2), (list(_NAMES)[7], 0.1)] * 2 + [(total, 0.01)] * 7
    kernels = prof.aggregate(events)
    assert kernels[k1] == (3, pytest.approx(0.015)) and kernels[total][0] == 7
    counts = {"K1": 3, "K3": 0, "K4": 0, "K2": 4, "K5": 0, "K6": 0}
    assert prof.family_totals(kernels)["K2"] == (4, pytest.approx(0.6))
    assert prof.family_totals(kernels)["K5"] == (0, 0.0)
    assert prof.launch_check(kernels, counts) == []
    missed = prof.launch_check(prof.aggregate(events[1:]), counts)
    assert missed == ["K1: the profiler saw 2 launches, its wrapper counted 3"]
    assert prof.launch_check(kernels, dict(counts, K5=2)) == [
        "K5: the profiler saw 0 launches, its wrapper counted 2"]


def test_profile_counters_follow_the_wrappers():
    """counted_launches reads each wrapper's counter (K2 two launches a
    call); reset_counters sets them to 0."""
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_scatter as cs
    from ray_tracing_tpu_torch.ops import cuda_triangles as ct

    prof = _tool("profile_pass_torch")
    saved = (ci.LAUNCHES, ci.TF_LAUNCHES, ci.MOTION_LAUNCHES, cs.LAUNCHES, ct.LAUNCHES,
             ct.CL_LAUNCHES)
    try:
        ci.LAUNCHES, ci.TF_LAUNCHES, ci.MOTION_LAUNCHES = 5, 1, 2
        cs.LAUNCHES, ct.LAUNCHES, ct.CL_LAUNCHES = 3, 4, 6
        assert prof.counted_launches() == {"K1": 5, "K3": 1, "K4": 2, "K2": 6, "K5": 4, "K6": 6}
        prof.reset_counters()
        assert set(prof.counted_launches().values()) == {0}
    finally:
        (ci.LAUNCHES, ci.TF_LAUNCHES, ci.MOTION_LAUNCHES, cs.LAUNCHES, ct.LAUNCHES,
         ct.CL_LAUNCHES) = saved
