"""The bounce-loop path integrator, the PyTorch counterpart of
``ray_tracing_tpu/render/integrator.py`` (reference
src/renderer.rs:123-320) in radiance/throughput form::

    radiance  += throughput * (emitted at hits | background at misses)
    throughput *= coef
    ... after max_depth bounces: radiance += throughput * environment

Per-bounce uniforms are keyed by (ray id, global bounce index), never
by a ray's position in the wavefront.  The benchmark's reference keeps
the dense loop only: every ray is bounced ``max_depth`` times, with no
compaction and no tape, and every operation takes reverse-mode
autograd.
"""

from __future__ import annotations

import torch

from .scene import SceneData
from .geometry import EPSILON, INF
from .intersect import intersect_scene
from .materials import N_SCATTER_U, shade
from .rng import ray_uniforms

STAGE_BOUNCES = 4  # bounces per lead compaction stage


def _uniforms(keys, ids, bounce: int, n_cols: int):
    """The bounce's uniforms of a wavefront whose rows run under several
    keys: ``keys`` is a list of (key, rows), the rows consecutive."""
    return torch.cat([ray_uniforms(key, ids[start:start + count], bounce, n_cols)
                      for key, start, count in keys])


def _bounce(scene: SceneData, keys, bounce: int, carry, state_dtype=None):
    """One wavefront bounce: intersect, emit/background, scatter.
    carry = (rad, thr, ro, rd, alive, ids).  With ``state_dtype`` the
    float state leaving the bounce is rounded to that type (the
    benchmark's lower-precision control)."""
    rad, thr, ro, rd, alive, ids = carry
    # the scatter block, then one free-flight column per constant medium
    u = _uniforms(keys, ids, bounce, N_SCATTER_U + scene.n_medium)
    med_u = u[:, N_SCATTER_U:] if scene.n_medium else None
    u = u[:, :N_SCATTER_U]
    hit = intersect_scene(scene, ro, rd, EPSILON, INF, med_u)
    found = alive & hit.mask
    miss = alive & ~hit.mask

    rad = rad + torch.where(miss[:, None], thr * scene.background[None, :], 0.0)
    em, sc = shade(scene, hit, rd, u)
    rad = rad + torch.where(found[:, None], thr * em, 0.0)
    new_alive = found & sc.scattered
    thr = torch.where(new_alive[:, None], thr * sc.coef, thr)
    ro = torch.where(found[:, None], hit.p, ro)
    rd = torch.where(new_alive[:, None], sc.direction, rd)
    if state_dtype is not None:
        rad, thr, ro, rd = (x.to(state_dtype).to(torch.float32) for x in (rad, thr, ro, rd))
    return rad, thr, ro, rd, new_alive, ids


def trace(scene: SceneData, ro, rd, key, max_depth: int, ids, state_dtype=None):
    """Trace a wavefront densely to ``max_depth``: (N, 3) linear radiance
    of the rays ``ro``, ``rd`` whose RNG ids are ``ids`` (N,), the
    environment added to the rays still alive after the last bounce
    (reference renderer.rs:128-130).  ``key`` is one trace key, or a list
    of (key, count): the first count rows under the first key, and so
    on."""
    n = ro.shape[0]
    if isinstance(key, list):
        starts = [0]
        for _, count in key[:-1]:
            starts.append(starts[-1] + count)
        keys = [(k, s, c) for (k, c), s in zip(key, starts)]
    else:
        keys = [(key, 0, n)]
    carry = (torch.zeros((n, 3), dtype=torch.float32, device=ro.device),
             torch.ones((n, 3), dtype=torch.float32, device=ro.device),
             ro, rd, torch.ones((n,), dtype=torch.bool, device=ro.device),
             ids.to(torch.int64))
    for bounce in range(max_depth):
        carry = _bounce(scene, keys, bounce, carry, state_dtype)
    rad, thr, _, _, alive, _ = carry
    return rad + torch.where(alive[:, None], thr * scene.environment[None, :], 0.0)
