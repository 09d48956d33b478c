"""Reference of a progressive render: the sum over passes of the 1-spp
radiance of a sample of pixels, traced densely at each pass's key."""

from __future__ import annotations

import torch

from .camera import Camera, camera_rays
from .compiler import build_scene
from .integrator import trace


def compile_scene(scene_json: dict, data_dir: str, device):
    """(scene, camera, width, height, max_depth, antialias) of a
    reference-schema scene, compiled by the reference on ``device``."""
    bundle = build_scene(scene_json, base_dir=data_dir)
    rp = bundle.renderer
    camera = Camera.build(bundle.camera, rp.width / rp.height).to(device)
    depth = rp.max_depth if rp.max_depth is not None else 20
    antialias = rp.antialias if rp.antialias is not None else True
    return bundle.scene.to(device), camera, rp.width, rp.height, depth, antialias


BATCH_RAYS = 1 << 16  # rays traced at once: whole passes of the sample


@torch.no_grad()
def sampled_sum(scene_json: dict, data_dir: str, keys, pixels, device, state_dtype=None):
    """(len(pixels), 3) float64: each pixel's radiance summed over the
    passes drawn at ``keys``.  ``pixels`` are flat row-major indices of
    the image; each is traced with its own index as its ray id, as a
    whole-image pass traces it, under its pass's trace key, several
    passes in one wavefront."""
    scene, camera, width, height, depth, antialias = compile_scene(scene_json, data_dir, device)
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    k = pixels.shape[0]
    total = torch.zeros((k, 3), dtype=torch.float64, device=device)
    per_batch = max(1, BATCH_RAYS // max(k, 1))
    for first in range(0, len(keys), per_batch):
        ro, rd, trace_keys = [], [], []
        for key in keys[first:first + per_batch]:
            o, d, _, k_trace = camera_rays(camera, key, width, height, antialias)
            ro.append(o[pixels])
            rd.append(d[pixels])
            trace_keys.append((k_trace, k))
        ids = pixels.repeat(len(trace_keys))
        rad = trace(scene, torch.cat(ro), torch.cat(rd), trace_keys, depth, ids, state_dtype)
        total += rad.double().reshape(len(trace_keys), k, 3).sum(dim=0)
    return total
