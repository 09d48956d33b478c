"""Inverse rendering over the whole parameter set: recover metal fuzz,
dielectric refraction index, metal albedo and wall colors from target
images, the port's counterpart of ``examples/fit_materials.py``.

The targets come from the autograd surface
(``prb_scalar.prb_radiance_all``) at the true parameters under four
known keys; each step replays one target's key through the direct
backward (``prb_loss_and_grad_all``: one taped traversal for the forward
and the color-linear gradients, a reverse-mode replay for fuzz and IR)
and takes a ``torch.optim.Adam`` step, the parameters then clipped to
their physical boxes.  The emitter's color row stays pinned.

Run:  python -m ray_tracing_tpu_torch.examples.fit_materials --device cpu --steps 80 --size 32
"""

from __future__ import annotations

import argparse

import torch

from ray_tracing_tpu_torch import CameraParam, SceneBuilder
from ray_tracing_tpu_torch.examples import device_of
from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.render.prb_scalar import (
    AllParams,
    params_of,
    prb_loss_and_grad_all,
    prb_radiance_all,
)

EMITTER = 3  # the light's texture row, pinned at its true value


def cornell():
    """Cornell box with a fuzzy metal and a glass sphere (the two
    scalar-parameter carriers) plus colored walls."""
    b = SceneBuilder(background=(0, 0, 0))
    white = b.add_lambertian(b.add_texture_solid((0.73, 0.73, 0.73)))
    red = b.add_lambertian(b.add_texture_solid((0.65, 0.05, 0.05)))
    green = b.add_lambertian(b.add_texture_solid((0.12, 0.45, 0.15)))
    light = b.add_diffuse_light(b.add_texture_solid((8.0, 8.0, 8.0)))
    metal = b.add_metal((0.85, 0.75, 0.55), 0.25)  # fuzz 0.25 = truth
    glass = b.add_dielectric(1.5)  # IR 1.5 = truth
    b.add_rect("xy", 0, 555, 0, 555, 555, white, positive=False)
    b.add_rect("zx", 0, 555, 0, 555, 0, white, positive=True)
    b.add_rect("zx", 0, 555, 0, 555, 555, white, positive=False)
    b.add_rect("yz", 0, 555, 0, 555, 555, red, positive=False)
    b.add_rect("yz", 0, 555, 0, 555, 0, green, positive=True)
    b.add_rect("zx", 187, 372, 187, 372, 554.9, light, positive=False, important=True)
    b.add_sphere((180, 130, 300), 110, metal)
    b.add_sphere((390, 110, 200), 90, glass)
    return b.build()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    w = h = args.size
    scene = cornell().to(device)
    camera = Camera.build(CameraParam((278, 278, -800), (278, 278, 0), 40), 1.0).to(device)
    true_params = params_of(scene)

    key = rng.key(args.seed)
    n_targets = 4
    target_keys = [rng.fold_in(key, 1000 + i) for i in range(n_targets)]
    with torch.no_grad():
        targets = []
        for k in target_keys:
            ro, rd, _, k_trace = camera_rays(camera, k, w, h, True)
            rad = prb_radiance_all(true_params, scene, ro, rd, k_trace, args.depth)
            targets.append(rad.reshape(h, w, 3))

    # perturbed start: wrong fuzz, wrong IR, wrong metal albedo, gray
    # walls; the emitter stays pinned at truth
    color = torch.full_like(true_params.color, 0.5)
    color[EMITTER] = true_params.color[EMITTER]
    params = AllParams(
        color=color,
        images=true_params.images.clone(),
        metal_albedo=torch.full_like(true_params.metal_albedo, 0.5),
        fuzz=torch.where(true_params.fuzz > 0, 0.05, true_params.fuzz),
        ir=torch.where(true_params.ir > 1.0, 1.2, true_params.ir),
    )
    leaves = [p.clone().requires_grad_(True) for p in params]
    opt = torch.optim.Adam(leaves, lr=args.lr)
    color_mask = torch.ones((true_params.color.shape[0], 1), device=device)
    color_mask[EMITTER] = 0.0

    mrow = int(torch.nonzero(true_params.fuzz > 0)[0])
    drow = int(torch.nonzero(true_params.ir > 1.0)[0])
    for i in range(args.steps):
        which = i % n_targets
        ro, rd, _, k_trace = camera_rays(camera, target_keys[which], w, h, True)

        def loss_fn(rad, _t=targets[which]):
            return torch.mean((rad.reshape(h, w, 3) - _t) ** 2)

        # the L2 loss is a cheap function of the radiance, so the renderer
        # needs no autograd graph: the direct backward
        loss, g = prb_loss_and_grad_all(loss_fn, AllParams(*(x.detach() for x in leaves)),
                                        scene, ro, rd, k_trace, args.depth)
        g = g._replace(color=g.color * color_mask)
        for leaf, grad in zip(leaves, g):
            leaf.grad = grad
        opt.step()
        with torch.no_grad():  # physical boxes: colors, fuzz in [0, 1], IR in [1, 3]
            c, _, met, fuzz, ir = leaves
            c.copy_(torch.where(color_mask > 0, c.clamp(0.0, 1.0), c))
            met.clamp_(0.0, 1.0)
            fuzz.clamp_(0.0, 1.0)
            ir.clamp_(1.0, 3.0)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {float(loss):.6f} "
                  f"fuzz {float(leaves[3].detach()[mrow]):.3f} (true 0.250) "
                  f"ir {float(leaves[4].detach()[drow]):.3f} (true 1.500)")

    fitted = AllParams(*(x.detach() for x in leaves))
    err_fuzz = abs(float(fitted.fuzz[mrow]) - 0.25)
    err_ir = abs(float(fitted.ir[drow]) - 1.5)
    keep = torch.arange(fitted.color.shape[0], device=device) != EMITTER
    err_col = float((fitted.color[keep] - true_params.color[keep]).abs().max())
    print(f"final |fuzz err| {err_fuzz:.4f}  |ir err| {err_ir:.4f}  "
          f"max wall-color err {err_col:.4f}")
    return err_fuzz, err_ir


if __name__ == "__main__":
    main()
