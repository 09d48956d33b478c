"""Reference of the full-parameter SGD fit: the masked L2 loss of one
1-spp pass against a target image and its gradient in the five scene
parameter sets (solid colors, the image atlas, metal albedo, metal fuzz,
dielectric IR), by reverse-mode autograd of the dense loop, a tile of
rays at a time."""

from __future__ import annotations

import dataclasses

import torch

from .camera import camera_rays
from .integrator import trace
from .render import compile_scene

LEAVES = ("color", "images", "metal_albedo", "fuzz", "ir")


def params_of(scene) -> dict:
    return dict(color=scene.textures.color, images=scene.textures.images,
                metal_albedo=scene.materials.albedo, fuzz=scene.materials.fuzz,
                ir=scene.materials.ir)


def with_params(scene, p: dict):
    return dataclasses.replace(
        scene,
        textures=dataclasses.replace(scene.textures, color=p["color"], images=p["images"]),
        materials=dataclasses.replace(scene.materials, albedo=p["metal_albedo"],
                                      fuzz=p["fuzz"], ir=p["ir"]),
    )


def loss_and_grad(scene, camera, width: int, height: int, depth: int, params: dict, key,
                  target, tile: int, state_dtype=None):
    """(loss float, {leaf: gradient}) of ``sum((rad - target)^2) / (3 n)``
    over the antialiased camera rays at ``key``, ``tile`` rays at a time
    with their image indices as ray ids."""
    n = width * height
    ro, rd, _, k_trace = camera_rays(camera, key, width, height, True)
    flat_target = target.reshape(n, 3)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    s = with_params(scene, leaves)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    loss = 0.0
    for start in range(0, n, tile):
        stop = min(start + tile, n)
        ids = torch.arange(start, stop, device=ro.device)
        rad = trace(s, ro[start:stop], rd[start:stop], k_trace, depth, ids, state_dtype)
        part = torch.sum((rad - flat_target[start:stop]) ** 2) / (n * 3)
        got = torch.autograd.grad(part, list(leaves.values()), allow_unused=True)
        for name, g in zip(leaves, got):
            if g is not None:
                grads[name] += g
        loss += float(part.detach())
    return loss, grads


def follow(scene_json: dict, data_dir: str, device, *, perturb, states, target, keys,
           tile: int, lr: float, state_dtype=None):
    """The fit's start and its steps: the scene's parameters scaled by
    ``perturb`` (``perturb(params) -> params``), the first step's loss
    and gradient there under ``keys[0]``, and step i's at ``states[i]``
    (dicts of the five leaves) under ``keys[i]``.  Returns ``(start,
    losses, gradients, moves)``: ``moves[i][leaf]`` is whether the
    float32 update ``p - lr * g`` changes the leaf at all."""
    scene, camera, width, height, depth, _ = compile_scene(scene_json, data_dir, device)
    start = perturb(params_of(scene))
    losses, grads, moves = [], [], []
    for state, key in zip([start, *states[1:]], keys):
        p = {k: torch.as_tensor(v).to(device) for k, v in state.items()}
        loss, g = loss_and_grad(scene, camera, width, height, depth, p, key, target, tile,
                                state_dtype)
        losses.append(loss)
        grads.append(g)
        moves.append({k: bool((p[k] - lr * g[k] != p[k]).any()) for k in p})
    return start, losses, grads, moves
