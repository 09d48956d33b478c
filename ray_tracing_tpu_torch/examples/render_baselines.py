"""Render the BASELINE.md configurations (C1-C6) and record their
throughput, the port's counterpart of ``examples/render_baselines.py``
with the same flags, defaults and outputs, plus ``--device`` (default
``cuda``; without a GPU it exits 1 and never falls back).

  C1  data/scene.json            256^2 /  16 spp
  C2  data/zy_scene.json         512^2 /  64 spp
  C3  textured earth sphere      512^2 /  64 spp   (scenes.earth_sphere)
  C4  data/bunny.obj mesh        512^2 / 128 spp   (scenes.bunny)
  C5  data/zy_scene.json        1024^2 / 256 spp
  C6  4x4 bunny grid (79k tris)  512^2 /  32 spp   (scenes.bunny_grid)

Each configuration renders at the renderer's default depth; pass ``i``
draws ``rng.fold_in(rng.key(0), i)`` and accumulates on the device, which
is read back after the first pass, every 16 passes for the progress
line, and at the end.  The mean is tone-mapped to an 8-bit PNG
(utils/image.py, no Pillow) and ``stats.json`` in ``--out`` gains each
configuration's size, spp, seconds_per_pass, total_seconds,
mean_radiance and image, merged into what a partial ``--configs`` run
left there.

Run: python -m ray_tracing_tpu_torch.examples.render_baselines [--out dir]
     [--configs C1,C2] [--spp-scale 0.25] [--res-scale 0.5] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ray_tracing_tpu_torch import Renderer, RendererParam, load_scene_json, scenes
from ray_tracing_tpu_torch.examples import device_of
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.utils.image import save_image

CONFIGS = ("C1", "C2", "C3", "C4", "C5", "C6")


def build(name: str):
    """(scene, camera param, size, spp) of configuration ``name`` at its
    own settings."""
    if name == "C1":
        bd = load_scene_json(os.path.join(scenes.DATA, "scene.json"))
        return bd.scene, bd.camera, 256, 16
    if name in ("C2", "C5"):
        bd = load_scene_json(os.path.join(scenes.DATA, "zy_scene.json"))
        return (bd.scene, bd.camera) + ((512, 64) if name == "C2" else (1024, 256))
    if name in ("C3", "C4", "C6"):
        make, spp = {"C3": (scenes.earth_sphere, 64), "C4": (scenes.bunny, 128),
                     "C6": (scenes.bunny_grid, 32)}[name]
        scene, cam, _ = make()
        return scene, cam, 512, spp
    raise KeyError(name)


def tone_map(img: np.ndarray) -> np.ndarray:
    """Linear radiance -> u8 (sqrt gamma, NaN to 0), the JAX script's."""
    return np.where(
        np.isnan(img), 0.0, np.clip(np.sqrt(np.maximum(img, 0.0)) * 256.0, 0.5, 255.5)
    ).astype(np.uint8)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="baseline_renders")
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--spp-scale", type=float, default=1.0)
    ap.add_argument("--res-scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    os.makedirs(args.out, exist_ok=True)
    wanted = set(args.configs.split(","))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    results = {}
    for name in CONFIGS:
        if name not in wanted:
            continue
        scene, cam, size, spp = build(name)
        size = max(int(size * args.res_scale), 16)
        spp = max(int(spp * args.spp_scale), 1)
        r = Renderer(RendererParam(size, size, max_depth=None), cam, scene, device=device)
        acc = r.accumulate(rng.fold_in(rng.key(0), 0))
        sync()  # the first pass
        t0 = time.perf_counter()
        for i in range(1, spp):
            acc = r.accumulate(rng.fold_in(rng.key(0), i), acc)
            if i % 16 == 0:
                sync()  # so that the progress line is honest
                print(f"  {name}: {i}/{spp} passes "
                      f"({(time.perf_counter() - t0) / i:.2f}s/pass)", flush=True)
        img = acc.cpu().numpy() / spp
        dt = time.perf_counter() - t0
        per_pass = dt / max(spp - 1, 1)

        path = os.path.join(args.out, f"{name}_{size}x{size}_{spp}spp.png")
        save_image(path, tone_map(img))
        results[name] = {
            "size": size, "spp": spp, "seconds_per_pass": per_pass,
            "total_seconds": dt, "mean_radiance": float(img.mean()),
            "image": path,
        }
        print(f"{name}: {size}^2 x {spp}spp  {per_pass:.3f}s/pass  -> {path}", flush=True)

    # merge into any existing stats, so that a partial --configs run keeps
    # the other configurations' entries
    stats_path = os.path.join(args.out, "stats.json")
    merged = {}
    if os.path.exists(stats_path):
        try:
            with open(stats_path) as fh:
                merged = json.load(fh)
        except (OSError, ValueError):
            merged = {}
    merged.update(results)
    with open(stats_path, "w") as fh:
        json.dump(merged, fh, indent=1)
    print("stats ->", stats_path)
    return merged


if __name__ == "__main__":
    main()
