#!/usr/bin/env python
"""Perf ladder of the PyTorch port, the counterpart of
``tools/perf/ladder.py``: the stages of the headline bench
(``bench_torch.py``: zy at 1024^2, its own depth 20, tiles of 65,536
rays under one trace key) timed interleaved in one process, on the card.

Stages:
  fwd     trace_compacted per tile, the radiance summed
  colors  taped forward + tape sweep per tile: the bench's pass with no
          tangent pass, the color, texel and metal-albedo gradients
  full    bench_torch.fwd_bwd, the bench's pass (colors + the fuzz/IR
          tangent pass)

Usage: python tools/perf/ladder_torch.py [stages ...] [--reps=N]

Each stage is warmed up once at key 0; then each of ``--reps`` (default
5) rounds runs every stage for ``PASSES`` passes at keys 1..PASSES, and
a stage's time per pass is the wall time between two
``torch.cuda.synchronize()`` calls over its passes.  Prints, per stage,
the median ms per pass with min..max.  Exits 1 without a GPU.

``Setup`` and ``STAGES`` are what ``profile_pass_torch.py`` profiles:
``STAGES[name](setup, key)`` runs one pass of the stage and returns its
outputs (a loss tensor first).
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402  (the bench's scene, rays and pass)

PASSES = bench_torch.PASSES


class Setup:
    """The bench's scene, camera and parameters on ``device`` at a size,
    depth (None: the scene's own) and tile (None: ``TILE_SIZE``); each
    pass runs over the first ``tiles`` tiles of its camera rays (None:
    the whole image)."""

    def __init__(self, device="cuda", width: int = bench_torch.WIDTH,
                 height: int = bench_torch.HEIGHT, depth: int | None = None,
                 tile: int | None = None, tiles: int | None = None):
        import torch

        from ray_tracing_tpu_torch.render.prb import TILE_SIZE
        from ray_tracing_tpu_torch.render.prb_scalar import params_of

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("the perf ladder needs an NVIDIA GPU: torch.cuda.is_available() is "
                             "False")
        self.width, self.height = width, height
        self.scene, self.camera, own_depth = bench_torch.load(self.device, width, height)
        self.depth = depth or own_depth
        self.tile = tile or TILE_SIZE
        self.rays_per_pass = width * height if tiles is None else tiles * self.tile
        self.params = params_of(self.scene)

    def rays(self, key):
        """(ro, rd, trace key) of the pass at ``key``, cut to the pass's
        rays."""
        ro, rd, k_trace = bench_torch.wavefront(self.camera, key, self.width, self.height)
        return ro[:self.rays_per_pass], rd[:self.rays_per_pass], k_trace

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run_fwd(setup: Setup, key):
    """The forward: trace_compacted per tile, the radiance summed."""
    import torch

    from ray_tracing_tpu_torch.render.integrator import trace_compacted

    ro, rd, k_trace = setup.rays(key)
    total = torch.zeros((), dtype=torch.float32, device=setup.device)
    for s in range(0, ro.shape[0], setup.tile):
        rad = trace_compacted(setup.scene, ro[s:s + setup.tile], rd[s:s + setup.tile], k_trace,
                              setup.depth, ids_base=s)
        total = total + torch.sum(rad)
    return (total,)


def run_colors(setup: Setup, key):
    """The bench's pass without its tangent pass, i.e. the taped forward
    and its sweep: (loss, AllParams with zero fuzz and IR gradients)."""
    ro, rd, k_trace = setup.rays(key)
    return bench_torch.fwd_bwd(setup.params, setup.scene, ro, rd, k_trace, setup.depth,
                               setup.tile, scalar_rows=((), ()))


def run_full(setup: Setup, key):
    """The bench's pass (bench_torch.fwd_bwd): (loss, AllParams)."""
    ro, rd, k_trace = setup.rays(key)
    return bench_torch.fwd_bwd(setup.params, setup.scene, ro, rd, k_trace, setup.depth,
                               setup.tile)


STAGES = {"fwd": run_fwd, "colors": run_colors, "full": run_full}


def main(argv=None, **setup_kw) -> dict:
    """Time the stages named in ``argv`` (all by default) with
    ``--reps=N``; ``setup_kw`` go to :class:`Setup`.  Prints and returns
    {stage: [ms per pass of each round]}."""
    from ray_tracing_tpu_torch.ops import rng

    argv = sys.argv[1:] if argv is None else argv
    names = [a for a in argv if not a.startswith("--")] or list(STAGES)
    unknown = [a for a in names if a not in STAGES]
    if unknown:
        raise SystemExit(f"unknown stage(s) {unknown}; the stages are {list(STAGES)}")
    reps = 5
    for a in argv:
        if a.startswith("--reps="):
            reps = int(a.split("=", 1)[1])
        elif a.startswith("--"):
            raise SystemExit(f"unknown option {a}; usage: [stages ...] [--reps=N]")
    setup = Setup(**setup_kw)
    for name in names:
        t0 = time.perf_counter()
        STAGES[name](setup, rng.key(0))
        setup.sync()
        print(f"warm-up {name} in {time.perf_counter() - t0:.1f} s", flush=True)
    results = {name: [] for name in names}
    for _ in range(reps):
        for name in names:
            setup.sync()
            t0 = time.perf_counter()
            for i in range(1, PASSES + 1):
                STAGES[name](setup, rng.key(i))
            setup.sync()
            results[name].append((time.perf_counter() - t0) / PASSES * 1e3)
    for name in names:
        r = sorted(results[name])
        print(f"{name:8s} median {r[len(r) // 2]:9.1f} ms/pass  [{r[0]:.1f} .. {r[-1]:.1f}]  "
              f"reps={reps} ({setup.width}x{setup.height}, depth {setup.depth}, "
              f"{setup.rays_per_pass} rays, tile {setup.tile})", flush=True)
    return results


if __name__ == "__main__":
    import torch

    if not torch.cuda.is_available():
        print("ladder_torch.py needs an NVIDIA GPU: torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(1)
    main()
