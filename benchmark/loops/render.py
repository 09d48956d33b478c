"""The ``render`` loop: the CLI's progressive loop (cli.py's loop body).
Pass i at ``fold_in(key(seed), i)`` through ``Renderer.render``, its
image copied to the host and added to a ``RenderResult``, closed loop,
no saves.  The set-up's warm-up passes are the render's first passes.

The comparison: ``sample_pixels`` pixels drawn from the seed, their sums
over every pass of the run (the set-up's included) against the
reference's, which traces the same pixels at the same keys;
``pixel_l1_gap`` = sum|S_port - S_ref| / sum|S_ref|.

Faults this loop can have, planted underneath the timed path:
``altered``, each pass's image with a quarter of its rows raised by
0.05 where it is produced; ``half_rays``, each pass leaving the second
half of its pixels untraced (0).
"""

from __future__ import annotations

import numpy as np

from harness import seeds
from harness.driving import Run, free, peak, window
from harness.profile import counted_launches, profile, reset_counters


def drive(cell, seed: int, seconds: float, traced: bool, env) -> Run:
    from ray_tracing_tpu_torch import Renderer, RenderResult, build_scene

    tr = cell.traffic
    bundle = build_scene(cell.scene, base_dir=cell.data_dir)
    renderer = Renderer(bundle.renderer, bundle.camera, bundle.scene, device=env.device)
    width, height = bundle.renderer.width, bundle.renderer.height
    result = RenderResult(width, height)

    def one(i):
        return result.add(renderer.render(seeds.pass_key(seed, i)))

    warm = int(tr["warmup_passes"])
    for i in range(warm):
        one(i)
    env.sync()
    run = Run(metrics={"setup_s": env.age()}, attempted=0, failed=0, memory_peak_bytes=0,
              outputs={})
    if traced:
        _, run.trace = profile(lambda: one(warm), env.sync)
        passes, window_s = 1, run.trace.window_s
        # untimed: the rays phase A tested in the profiled pass, counted on
        # the same code path at the same key, and its tile-bounces
        reset_counters()
        _, segments = renderer.render_with_stats(seeds.pass_key(seed, warm))
        run.readings.update(segments=segments, k1_launches=counted_launches()["K1"])
    else:
        passes, window_s = window(seconds, lambda j: one(warm + j), "pass", run.notes)
        run.metrics[tr["metric"]] = window_s * 1e3 / passes
    env.sync()
    run.memory_peak_bytes = peak(env)
    total = warm + passes
    run.attempted = total
    finite = bool(np.isfinite(result.sum).all())
    run.failed = 0 if finite else total
    pixels = seeds.sample_pixels(seed, width * height, int(tr["sample_pixels"]))
    run.outputs = dict(sum=result.sum.reshape(-1, 3)[pixels.numpy()].astype(np.float64),
                       pixels=pixels, keys=[seeds.pass_key(seed, i) for i in range(total)])
    run.notes.append(f"passes: {warm} in set-up, {passes} in the window of {window_s:.4f} s; "
                     f"{width}x{height} depth {renderer.max_depth}, tile {renderer.tile_size}; "
                     f"all finite: {finite}")
    del renderer, bundle, result
    free()
    return run


def reference(cell, outputs: dict, seed: int, env, state_dtype=None) -> dict:
    """The reference's sums of the sampled pixels over the run's keys."""
    from reference import render as ref_render

    total = ref_render.sampled_sum(cell.scene, cell.data_dir, outputs["keys"],
                                   outputs["pixels"], env.device, state_dtype)
    return dict(sum=total.cpu().numpy())


def numbers(port: dict, ref: dict) -> dict:
    return {"pixel_l1_gap": float(np.abs(port["sum"] - ref["sum"]).sum()
                                  / np.abs(ref["sum"]).sum())}


def notes(port: dict, ref: dict) -> list:
    return []


def _planted(change):
    from ray_tracing_tpu_torch.render import renderer

    original = renderer.render_pass

    def broken(*args, **kw):
        img = original(*args, **kw).clone()
        change(img)
        return img

    return renderer, "render_pass", broken


def _altered(img):
    img[: img.shape[0] // 4] += 0.05


def _half_rays(img):
    img.reshape(-1, 3)[img.shape[0] * img.shape[1] // 2:] = 0.0


# fault -> () -> (module, attribute, its broken stand-in)
FAULTS = {
    "altered": lambda: _planted(_altered),
    "half_rays": lambda: _planted(_half_rays),
}
