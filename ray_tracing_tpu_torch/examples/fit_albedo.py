"""Inverse rendering: recover wall and sphere albedos from target images
by gradient descent through the path tracer, the port's counterpart of
``examples/fit_albedo.py``.

A Cornell box is rendered with its true colors under four known keys to
make the targets; the colors restart at gray (the emitter stays pinned)
and are fitted by dense reverse-mode autograd through the ray-sharded
render pass (parallel/mesh.py: one rank here, or every rank of an
initialised process group) with ``torch.optim.Adam``.  Each step
replays one target's key, so the Monte-Carlo noise is common to the
prediction and its target.

Run:  python -m ray_tracing_tpu_torch.examples.fit_albedo --device cpu --steps 60 --size 48
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ray_tracing_tpu_torch import CameraParam, SceneBuilder
from ray_tracing_tpu_torch.examples import device_of
from ray_tracing_tpu_torch.models.camera import Camera
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.parallel.mesh import all_reduce_sum, make_mesh, sharded_render_pass
from ray_tracing_tpu_torch.render.prb import check_fit_init
from ray_tracing_tpu_torch.utils.checkpoint import load_fit, save_fit

EMITTER = 3  # the light's texture row, pinned at its true value


def cornell():
    b = SceneBuilder(background=(0, 0, 0))
    white = b.add_lambertian(b.add_texture_solid((0.73, 0.73, 0.73)))
    red = b.add_lambertian(b.add_texture_solid((0.65, 0.05, 0.05)))
    green = b.add_lambertian(b.add_texture_solid((0.12, 0.45, 0.15)))
    light = b.add_diffuse_light(b.add_texture_solid((8.0, 8.0, 8.0)))
    blue = b.add_lambertian(b.add_texture_solid((0.2, 0.3, 0.7)))
    b.add_rect("xy", 0, 555, 0, 555, 555, white, positive=False)
    b.add_rect("zx", 0, 555, 0, 555, 0, white, positive=True)
    b.add_rect("zx", 0, 555, 0, 555, 555, white, positive=False)
    b.add_rect("yz", 0, 555, 0, 555, 555, red, positive=False)
    b.add_rect("yz", 0, 555, 0, 555, 0, green, positive=True)
    b.add_rect("zx", 187, 372, 187, 372, 554.9, light, positive=False, important=True)
    b.add_sphere((277, 140, 277), 120, blue)
    return b.build()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mesh = make_mesh(device_of(args.device))
    device = mesh.device  # this rank's card under a process group

    w = h = args.size
    scene = cornell().to(device)
    camera = Camera.build(CameraParam((278, 278, -800), (278, 278, 0), 40), 1.0).to(device)
    true_colors = scene.textures.color

    def render(colors, key):
        s = dataclasses.replace(scene, textures=dataclasses.replace(scene.textures, color=colors))
        return sharded_render_pass(s, camera, key, width=w, height=h, max_depth=args.depth,
                                   antialias=True, mesh=mesh)

    # targets: ground-truth passes under known keys, each replayed by the
    # fit (matched seeds), so the loss reaches ~0 at the true colors
    key = rng.key(args.seed)
    n_targets = 4
    target_keys = [rng.fold_in(key, 1000 + i) for i in range(n_targets)]
    with torch.no_grad():
        targets = [render(true_colors, k) for k in target_keys]

    # start from gray; the nudge keeps PRB-style fits off exact zeros and
    # the emitter is re-pinned after it
    colors = check_fit_init(torch.full_like(true_colors, 0.5), nudge=1e-3)
    colors[EMITTER] = true_colors[EMITTER]
    start_step = 0
    if args.checkpoint:
        try:
            start_step, restored, _ = load_fit(args.checkpoint)
            colors = torch.as_tensor(restored, device=device)
            print(f"resumed at step {start_step}")
        except FileNotFoundError:
            pass
    colors = colors.clone().requires_grad_(True)
    opt = torch.optim.Adam([colors], lr=args.lr)
    fit_mask = torch.ones((true_colors.shape[0], 1), device=device)
    fit_mask[EMITTER] = 0.0

    for i in range(start_step, args.steps):
        which = i % n_targets
        opt.zero_grad()
        loss = torch.mean((render(colors, target_keys[which]) - targets[which]) ** 2)
        loss.backward()
        (grad,) = all_reduce_sum(mesh, [colors.grad])
        colors.grad = grad * fit_mask
        opt.step()
        with torch.no_grad():
            colors.copy_(torch.where(fit_mask > 0, colors.clamp(0.0, 1.0), colors))
        if i % 10 == 0 or i == args.steps - 1:
            keep = torch.arange(true_colors.shape[0], device=device) != EMITTER
            err = float((colors.detach()[keep] - true_colors[keep]).abs().max())
            print(f"step {i:4d} loss {float(loss.detach()):.6f} max|c-c*| {err:.4f}")
            if args.checkpoint:
                save_fit(args.checkpoint, step=i + 1, color_table=colors.detach().cpu().numpy())

    err = (colors.detach() - true_colors).abs().cpu().numpy()
    err[EMITTER] = 0.0  # pinned emitter
    print("final per-texture error:", err.max(axis=1).round(3))
    return float(err.max())


if __name__ == "__main__":
    main()
