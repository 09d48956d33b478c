#!/usr/bin/env python
"""The tile ladder: both benchmark cells' paths on the card at a ladder
of tiles (rays per dispatch of the bounce's kernel sequence), in turns,
which sets the card's cap in ``render/renderer.py:tile_rule``.

    python tools/perf/tile_ladder_torch.py [--rounds N] [--passes P] [--steps S]
                                           [--tiles 65536,131072,...,0]

The paths are the cells' (``benchmark/``, ``BENCHMARK.json``):
``bunny_grid_c6.render`` (C6 at 512x512 depth 20: ``Renderer.render``,
the image's host copy, ``RenderResult.add``) and ``zy_scene.train`` (zy
at 800x800 depth 20: ``make_prb_train_step_all_direct``, from the
cell's perturbed start towards its target), built from the cells' own
files and seed.  A tile of 0 is the program's own (``tile_rule``: on the
card the whole wavefront).  The render takes its tile as
``Renderer(tile_size=)``; the step's ``tiled_loss_and_grad`` is given
``tile_size`` for the length of the run.

Each rung is warmed up once (a pass, a step); then each of ``--rounds``
rounds runs every rung in turn: ``--passes`` passes and ``--steps``
steps, timed on the host clock between two ``torch.cuda.synchronize()``,
then one pass and one step under torch.profiler (benchmark/harness/
profile.py), read for the device kernels launched, the device's idle
share (1 - busy / the region's wall) and the ``rtt.tile`` spans.  The
peak is ``torch.cuda.max_memory_allocated`` over the rung's runs.
Prints one JSON line per rung and cell, the medians over the rounds.
Exits 1 without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TILES = (65536, 131072, 262144, 524288, 0)
SEED = 1700000017


@contextlib.contextmanager
def gradient_tile(tile: int):
    """The direct train step with ``tile_size=tile`` in its call of
    ``parallel/mesh.py:tiled_loss_and_grad`` (0: its own default)."""
    from ray_tracing_tpu_torch.parallel import mesh

    real = mesh.tiled_loss_and_grad
    if tile:
        mesh.tiled_loss_and_grad = functools.partial(real, tile_size=tile)
    try:
        yield
    finally:
        mesh.tiled_loss_and_grad = real


def render_path(device):
    """(tile -> one pass of C6 at that tile; the cell's name)."""
    from harness import seeds
    from harness.cells import load_cell

    from ray_tracing_tpu_torch import Renderer, RenderResult, build_scene

    cell = load_cell("bunny_grid_c6.render")
    bundle = build_scene(cell.scene, base_dir=cell.data_dir)
    param = bundle.renderer
    renderers, results, count = {}, {}, [0]

    def one(tile):
        if tile not in renderers:
            renderers[tile] = Renderer(param, bundle.camera, bundle.scene, device=device,
                                       tile_size=tile or None)
            results[tile] = RenderResult(param.width, param.height)
        count[0] += 1
        return results[tile].add(renderers[tile].render(seeds.pass_key(SEED, count[0])))

    return one, cell.name


def train_path(device):
    """(tile -> one step of zy's train cell at that tile; the cell's name)."""
    from harness import seeds
    from harness.cells import load_cell

    from ray_tracing_tpu_torch import build_scene
    from ray_tracing_tpu_torch.models.camera import Camera
    from ray_tracing_tpu_torch.parallel.mesh import make_mesh, make_prb_train_step_all_direct
    from ray_tracing_tpu_torch.render.prb_scalar import AllParams, params_of

    cell = load_cell("zy_scene.train")
    tr = cell.traffic
    bundle = build_scene(cell.scene, base_dir=cell.data_dir)
    rp = bundle.renderer
    width, height, depth = rp.width, rp.height, rp.max_depth or 20
    scene = bundle.scene.to(device)
    camera = Camera.build(bundle.camera, width / height).to(device)
    step = make_prb_train_step_all_direct(camera, scene, width=width, height=height,
                                          max_depth=depth, mesh=make_mesh(device),
                                          lr=float(tr["lr"]))
    start = AllParams(**seeds.perturb(params_of(scene)._asdict(), SEED, float(tr["perturb"])))
    target = seeds.target_image(SEED, width, height, int(tr["target_grid"]),
                                *tr["target_range"], device)
    count = [0]

    def one(tile):
        count[0] += 1
        with gradient_tile(tile):
            return step(start, scene, seeds.pass_key(SEED, count[0]), target)

    return one, cell.name


def ladder(tiles=TILES, rounds: int = 2, passes: int = 3, steps: int = 2) -> list:
    """The ladder's records on the card: one per tile and cell (see the
    module's docstring)."""
    import torch
    from harness.driving import Env
    from harness.profile import profile
    from harness.spans import count

    device = torch.device("cuda")
    env = Env(device=device, age=time.perf_counter)
    paths = [(render_path(device), passes), (train_path(device), steps)]
    runs = {(cell, t): {"ms": [], "launches": [], "idle_pct": [], "tiles": [], "peak": 0}
            for (_, cell), _ in paths for t in tiles}

    def peak_after(key, fn):
        torch.cuda.reset_peak_memory_stats(device)
        out = fn()
        env.sync()
        runs[key]["peak"] = max(runs[key]["peak"], torch.cuda.max_memory_allocated(device))
        return out

    for (one, cell), _ in paths:  # warm-up: every rung's shapes once
        for t in tiles:
            peak_after((cell, t), lambda: one(t))
    for _ in range(rounds):
        for t in tiles:
            for (one, cell), reps in paths:
                rec = runs[(cell, t)]
                env.sync()
                t0 = time.perf_counter()
                peak_after((cell, t), lambda: [one(t) for _ in range(reps)])
                rec["ms"].append((time.perf_counter() - t0) * 1e3 / reps)
                _, trace = profile(lambda: peak_after((cell, t), lambda: one(t)), env.sync)
                rec["launches"].append(trace.kernel_launches())
                rec["idle_pct"].append(100.0 * (1.0 - trace.busy_s / trace.window_s))
                rec["tiles"].append(count(trace, "rtt.tile"))
    out = []
    for (cell, t), rec in runs.items():
        out.append({"cell": cell, "tile": t or "whole", "ms": statistics.median(rec["ms"]),
                    "ms_runs": rec["ms"], "launches": statistics.median(rec["launches"]),
                    "idle_pct": statistics.median(rec["idle_pct"]), "tiles": rec["tiles"],
                    "max_memory_allocated": rec["peak"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--tiles", default=",".join(str(t) for t in TILES))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the tile ladder needs an NVIDIA GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    tiles = tuple(int(t) for t in args.tiles.split(","))
    for rec in ladder(tiles, args.rounds, args.passes, args.steps):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
