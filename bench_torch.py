#!/usr/bin/env python
"""Headline benchmark of the PyTorch port, the counterpart of
``bench.py``: the differentiable render of data/zy_scene.json.

Metric: traced segments per second of one 1-spp differentiable pass at
1024^2, the forward radiance and the gradient of the image-mean loss in
every differentiable scene parameter (solid colors, image texels, metal
albedo, metal fuzz, dielectric IR), at the scene's own max_depth (20),
on the card.  One pass is ``bench.py``'s protocol, run by the library's
own call (``render/prb_scalar.py:tiled_loss_and_grad``): tiles of 65,536
rays (``render/prb.py:TILE_SIZE``) under one trace key with ``ids_base``,
per tile the taped forward and its sweep, one global
``scalar_tangent_pass`` in batches of the tile; the loss is the summed
tile losses over n * 3, every gradient scaled by the same factor.  On
the card phase A runs K1 and each tile's sweep one K2 call.

Counting, as ``bench.py`` counts: the numerator is the segments traced
for each pass's key, counted untimed by ``trace_compacted(...,
with_stats=True)`` over the same tiles, ray ids and keys.  It is not
1024^2 per second.  Timing: one warm-up pass at key 0, then ``REPS``
blocks of ``PASSES`` passes at keys 1..PASSES; a block is the wall time
between two ``torch.cuda.synchronize()`` calls, what a user waits for,
with CUDA events beside it.  The value is the median block rate.

``REFERENCE_RAYS_PER_S`` is ``bench.py``'s documented estimate of the
reference CPU tracer (it publishes no numbers and cannot be built here,
BASELINE.md); it only fills ``vs_baseline``.

Run on the card:  python bench_torch.py   (no flags; exits 1 without a GPU)

Prints one JSON line on stdout, with bench.py's keys:
  {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N,
   "mode": "prb", "spread": {"blocks", "passes_per_block", "min", "max"}}
and one "#" diagnostics line on stderr: block rates, CUDA-event ms per
block, segments per block, depth, tile, loss, gradient norm and
torch.cuda.max_memory_allocated.  ``main(...)`` runs the same at other
sizes, in process, and returns the record.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REFERENCE_RAYS_PER_S = 5e6  # bench.py's documented estimate of the reference CPU tracer
WIDTH = HEIGHT = 1024
PASSES = 3
REPS = 5  # timed blocks; the value is the median block rate
METRIC = "zy_scene {size} fwd+bwd rays/s/chip"  # bench.py's metric at 1024^2


def load(device, width: int = WIDTH, height: int = HEIGHT):
    """(scene, camera, the scene's own max_depth) of data/zy_scene.json on
    ``device``, the camera built for width / height."""
    from ray_tracing_tpu_torch import load_scene_json
    from ray_tracing_tpu_torch.models.camera import Camera

    bundle = load_scene_json(os.path.join(ROOT, "data", "zy_scene.json"))
    camera = Camera.build(bundle.camera, width / height).to(device)
    return bundle.scene.to(device), camera, bundle.renderer.max_depth or 20


def wavefront(camera, key, width: int, height: int):
    """(ro, rd, trace key) of the pass at ``key``: the antialiased camera
    rays of the whole image, as bench.py draws them."""
    from ray_tracing_tpu_torch.models.camera import camera_rays

    ro, rd, _, k_trace = camera_rays(camera, key, width, height, True)
    return ro, rd, k_trace


def fwd_bwd(params, scene, ro, rd, k_trace, depth: int, tile: int, scalar_rows=None):
    """One pass of the bench over the rays (ro, rd): the library's tiled
    protocol with the loss sum(radiance) / (n * 3).  ``scalar_rows``
    ``((), ())`` skips the fuzz/IR tangent pass (the ladder's colors
    stage).  Returns (loss, AllParams)."""
    import torch

    from ray_tracing_tpu_torch.render.prb_scalar import tiled_loss_and_grad

    scale = 1.0 / (ro.shape[0] * 3)
    return tiled_loss_and_grad(lambda rad, rows: torch.sum(rad) * scale, params, scene, ro, rd,
                               k_trace, depth, tile_size=tile, scalar_rows=scalar_rows)


def traced_segments(scene, ro, rd, k_trace, depth: int, tile: int) -> int:
    """The segments traced for (ro, rd) with the tiles and ray ids of
    :func:`fwd_bwd`, forward only (bench.py:235-273).  At a fixed key the
    paths do not depend on the parameters, so they are the pass's."""
    from ray_tracing_tpu_torch.render.integrator import trace_compacted

    return sum(int(trace_compacted(scene, ro[s:s + tile], rd[s:s + tile], k_trace, depth,
                                   with_stats=True, ids_base=s)[1])
               for s in range(0, ro.shape[0], tile))


def main(*, width: int = WIDTH, height: int = HEIGHT, depth: int | None = None,
         passes: int = PASSES, reps: int = REPS, tile: int | None = None, device: str = "cuda",
         details: dict | None = None) -> dict:
    """Run the bench and return its record (bench.py's keys).  ``depth``
    None is the scene's own (20), ``tile`` None is ``TILE_SIZE`` (65,536).
    ``device="cuda"`` needs a GPU (SystemExit without one); ``"cpu"`` runs
    the kernels' plain versions and marks the record's metric and mode
    so.  The metric names the image size.  ``details``, when given,
    receives the segments per key, the block rates and event times, and
    the loss and gradients of the last timed pass (key ``passes``)."""
    import torch

    from ray_tracing_tpu_torch.ops import rng
    from ray_tracing_tpu_torch.render.prb import TILE_SIZE
    from ray_tracing_tpu_torch.render.prb_scalar import params_of

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("bench_torch.py needs an NVIDIA GPU: torch.cuda.is_available() is "
                         "False (main(device='cpu') runs the plain versions)")
    tile = tile or TILE_SIZE

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    scene, camera, own_depth = load(dev, width, height)
    depth = depth or own_depth
    params = params_of(scene)

    def one_pass(i):
        return fwd_bwd(params, scene, *wavefront(camera, rng.key(i), width, height), depth, tile)

    # untimed: the traced segments of the timed passes' keys
    seg_counts = [traced_segments(scene, *wavefront(camera, rng.key(i), width, height), depth,
                                  tile)
                  for i in range(1, passes + 1)]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    one_pass(0)  # warm-up
    sync()

    block_rates, block_event_ms = [], []
    for _ in range(reps):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        sync()
        t0 = time.perf_counter()
        if cuda:
            start.record()
        outs = [one_pass(i) for i in range(1, passes + 1)]
        if cuda:
            end.record()
        sync()
        dt = time.perf_counter() - t0
        block_rates.append(sum(seg_counts) / dt)
        block_event_ms.append(start.elapsed_time(end) if cuda else "not measured")
    loss, grads = outs[-1]

    rates = sorted(block_rates)
    value = rates[len(rates) // 2]
    size = f"{width}^2" if width == height else f"{width}x{height}"
    rec = {
        "metric": METRIC.format(size=size) + ("" if cuda else " (CPU)"),
        "value": value,
        "unit": "rays/s",
        "vs_baseline": value / REFERENCE_RAYS_PER_S,
        "mode": "prb" if cuda else "cpu",
        "spread": {"blocks": len(rates), "passes_per_block": passes, "min": rates[0],
                   "max": rates[-1]},
    }
    grad_norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else "not measured"
    print(f"# mode={rec['mode']} blocks={len(rates)}x{passes} "
          f"rates(segments/s, in run order)={block_rates} "
          f"event_ms={block_event_ms} segments/block={sum(seg_counts)} depth={depth} "
          f"tile={tile} size={width}x{height} loss={float(loss):.6f} grad_norm={grad_norm:.4e} "
          f"max_memory_allocated={peak}", file=sys.stderr, flush=True)
    if details is not None:
        details.update(segments=seg_counts, block_rates=block_rates,
                       block_event_ms=block_event_ms, loss=loss, grads=grads, depth=depth,
                       tile=tile, max_memory_allocated=peak)
    return rec


if __name__ == "__main__":
    import torch

    if not torch.cuda.is_available():
        print("bench_torch.py needs an NVIDIA GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(1)
    print(json.dumps(main()), flush=True)
