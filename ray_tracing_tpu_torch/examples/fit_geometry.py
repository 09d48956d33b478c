"""Inverse geometry: recover a sphere's depth and radius from target
images by gradient descent through the path tracer, the port's
counterpart of ``examples/fit_geometry.py``.

Phase A (which primitive a ray hits) is selection only and runs on
detached tables; phase B re-solves the winning sphere's roots from its
center and radius rows, so hit points, normals, shading, light pdfs and
the secondary rays are differentiable in the geometry.  Two
forward-mode tangents (``torch.autograd.forward_ad``), one per fitted
scalar, go through the compacted trace, and the script's own Adam
steps on them.

The gradient is the reparameterized interior term: silhouette terms
are not estimated.  So the sphere is Perlin-textured under an important
area light (shading continuous in the hit point), and only the view
depth and the radius are fitted: a lateral offset changes the image
mostly at the silhouette, where the interior gradient does not see it.

Run:  python -m ray_tracing_tpu_torch.examples.fit_geometry --device cpu --steps 60 --size 32
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch
import torch.autograd.forward_ad as fwAD

from ray_tracing_tpu_torch import CameraParam, SceneBuilder
from ray_tracing_tpu_torch.examples import device_of
from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
from ray_tracing_tpu_torch.models.scene import with_phase_a_tables
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.render.integrator import trace_compacted


def scene_with(center, radius):
    """Noise-textured sphere over a gray ground, lit by an overhead rect
    light (important) under a dim sky."""
    b = SceneBuilder(background=(0.25, 0.28, 0.32))
    marble = b.add_lambertian(b.add_texture_noise(4.0, 5))
    gray = b.add_lambertian(b.add_texture_solid((0.5, 0.5, 0.5)))
    light = b.add_diffuse_light(b.add_texture_solid((6.0, 6.0, 6.0)))
    b.add_sphere(tuple(float(c) for c in center), float(radius), marble)
    b.add_sphere((0.0, -100.6, -1.0), 100.0, gray)
    b.add_rect("zx", -1.2, 0.2, -0.8, 0.8, 1.6, light, positive=False, important=True)
    return b.build()


def with_geometry(scene, theta):
    """Sphere row 0 at (cx, cy, cz) = theta[:3] with radius theta[3]; its
    phase-A tables packed from the detached values (selection carries no
    derivative)."""
    sp = scene.spheres
    center = torch.cat([theta[None, :3], sp.center[1:]])
    radius = torch.cat([theta[3:4], sp.radius[1:]])
    detached = dataclasses.replace(
        scene, spheres=dataclasses.replace(sp, center=center.detach(), radius=radius.detach()))
    return dataclasses.replace(with_phase_a_tables(detached),
                               spheres=dataclasses.replace(sp, center=center, radius=radius))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--size", type=int, default=24)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    w = h = args.size

    f32 = dict(dtype=torch.float32, device=device)
    true_theta = torch.tensor([0.25, 0.05, -1.1, 0.5], **f32)
    true2 = torch.tensor([-1.1, 0.5], **f32)  # (depth cz, radius)
    init2 = torch.tensor([-1.25, 0.38], **f32)

    scene = scene_with(true_theta[:3].tolist(), float(true_theta[3])).to(device)
    camera = Camera.build(CameraParam((0.0, 0.2, 1.2), (0.0, 0.0, -1.1), 55.0), w / h).to(device)

    def radiance(theta, key):
        ro, rd, _, k_trace = camera_rays(camera, key, w, h, True)
        return trace_compacted(with_geometry(scene, theta), ro, rd, k_trace, args.depth)

    def loss_and_grad(t2, key, target):
        """The loss and its gradient in t2 = (cz, r): one forward-mode
        tangent per entry through the compacted trace."""
        grads = []
        for tangent in torch.eye(2, **f32):
            with fwAD.dual_level():
                t2_dual = fwAD.make_dual(t2, tangent)
                theta = torch.cat([true_theta[:2], t2_dual])
                loss = torch.mean((radiance(theta, key) - target.reshape(-1, 3)) ** 2)
                value, d = fwAD.unpack_dual(loss)
            grads.append(d if d is not None else torch.zeros((), **f32))
        return value, torch.stack(grads)

    t2 = init2.clone()
    mu = torch.zeros_like(t2)
    v = torch.zeros_like(t2)
    with torch.no_grad():
        for i in range(args.steps):
            key = rng.key(1000 + i)
            target = radiance(true_theta, key).reshape(h, w, 3)
            val, g = loss_and_grad(t2, key, target)
            mu = 0.9 * mu + 0.1 * g
            v = 0.99 * v + 0.01 * g * g
            t2 = t2 - args.lr * mu / (torch.sqrt(v) + 1e-8)
            if i % 25 == 0 or i == args.steps - 1:
                err = (t2 - true2).abs().cpu().numpy()
                print(f"step {i:3d}  loss {float(val):.6f}  "
                      f"(depth, radius) {t2.cpu().numpy().round(4)}  max err {err.max():.4f}")

    err = float((t2 - true2).abs().max())
    err0 = float((init2 - true2).abs().max())
    print(f"final geometry error: {err:.4f} (initial {err0:.4f}; "
          f"recovered to {'<' if err < 0.06 else '>='} 0.06)")
    # short runs must still descend; the 0.06 bound needs the full default run
    return 0 if err < err0 else 1


if __name__ == "__main__":
    sys.exit(main())
