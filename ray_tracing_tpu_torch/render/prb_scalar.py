"""Full-parameter gradients: reverse-mode replays for the scalar
material parameters, the PyTorch counterpart of
``ray_tracing_tpu/render/prb_scalar.py``.

The color-linear parameters (solid colors, atlas texels, metal albedo)
get exact gradients from the PRB tape sweep (render/prb_tape.py).  Metal
fuzz and dielectric refraction index (reference metal.rs:31-46,
dielectric.rs:39-50) bend the scattered direction instead of scaling
the throughput, so their derivative flows through every later
intersection and no linearity trick applies.  Their gradient is that of
one scalar, ``vdot(g, rad)``, in a few active material rows: the rays
whose paths reach a metal or a dielectric (exactly zero derivative
otherwise) are gathered in batches, and each batch takes one compacted
replay under reverse-mode autograd with the active fuzz and IR rows as
leaves, and one backward.  (The JAX package takes forward-mode tangents,
one per row, since reverse mode cannot pass its ``while_loop`` of
dynamic trip count; eager PyTorch has no such limit.)  Uniforms are
keyed by (ray id, bounce), so a gathered subset replays its paths
bit-exactly.  The dielectric's stochastic reflect/refract branch is held
fixed under differentiation, as reverse-mode AD of the dense loop does.

``prb_loss_and_grad_all`` is the direct entry point: the loss value and
all five gradients from one taped traversal plus the replay batches,
with a ``defer_scalars`` protocol so that a caller tracing tiles runs
one global :func:`scalar_tangent_pass`.  ``prb_radiance_all`` is the
autograd surface: a ``torch.autograd.Function`` whose forward traces
(saving only its inputs and the radiance) and whose backward replays
the paths with the tape writer, sweeps the tapes and runs the fuzz / IR
pass, so any loss of the radiance takes ``loss.backward()``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ray_tracing_tpu_torch.models.scene import MAT_DIELECTRIC, MAT_METAL, SceneData
from ray_tracing_tpu_torch.render.integrator import trace, trace_compacted, trace_subset_dot
from ray_tracing_tpu_torch.render.prb import prb_grad_dense
from ray_tracing_tpu_torch.render.prb_tape import tape_sweep, trace_taped
from ray_tracing_tpu_torch.render.renderer import tile_rule
from ray_tracing_tpu_torch.utils.profiling import span, sync


class ScalarParams(NamedTuple):
    """The direction-bending scalar parameter set."""

    fuzz: torch.Tensor  # (M,) = scene.materials.fuzz
    ir: torch.Tensor  # (M,) = scene.materials.ir


class AllParams(NamedTuple):
    """Every differentiable scene parameter."""

    color: torch.Tensor  # (T, 3) solid-color table
    images: torch.Tensor  # (I, Hmax, Wmax, 3) texture atlas
    metal_albedo: torch.Tensor  # (M, 3)
    fuzz: torch.Tensor  # (M,)
    ir: torch.Tensor  # (M,)


def params_of(scene: SceneData) -> AllParams:
    """The current parameter values of a compiled scene."""
    return AllParams(
        color=scene.textures.color,
        images=scene.textures.images,
        metal_albedo=scene.materials.albedo,
        fuzz=scene.materials.fuzz,
        ir=scene.materials.ir,
    )


def _with_all(scene: SceneData, p: AllParams) -> SceneData:
    return dataclasses.replace(
        scene,
        textures=dataclasses.replace(scene.textures, color=p.color, images=p.images),
        materials=dataclasses.replace(
            scene.materials, albedo=p.metal_albedo, fuzz=p.fuzz, ir=p.ir
        ),
    )


def _active_rows(scene: SceneData, scalar_rows=None):
    """Material rows whose fuzz / IR matter: (metal rows, dielectric
    rows), read from the scene's material types unless ``scalar_rows``
    gives them (``((), ())`` disables the tangent pass)."""
    if scalar_rows is not None:
        return tuple(np.asarray(rows, np.int64) for rows in scalar_rows)
    mtype = scene.materials.mtype.cpu().numpy()
    return np.nonzero(mtype == MAT_METAL)[0], np.nonzero(mtype == MAT_DIELECTRIC)[0]


def _tangent_batches(scene_of, thetas, mask, ro, rd, key, max_depth: int, g, *,
                     tangent_cap, ids_base, compaction: bool = True):
    """d(vdot(g, rad)) / d(theta) for each tensor of ``thetas``, over the
    rays where ``mask`` is set; ``scene_of(*thetas)`` builds the scene.

    The masked rays are gathered in input order into batches of at most
    ``tangent_cap`` rays (default max(256, n/8)).  Each batch takes one
    replay under reverse-mode autograd, one ``rtt.tangent_replay`` span,
    with every theta a leaf that requires grad: the compacted subset
    trace, or with ``compaction=False`` the dense replay of the subset;
    one backward gives every leaf's gradient, and the batch's graph is
    freed before the next.  Rays outside the mask have an exactly-zero
    derivative and are never traced.  Returns one gradient per theta."""
    n = ro.shape[0]
    cap = min(n, tangent_cap or max(256, n // 8))
    with sync("prb_scalar.touched"):
        touched = torch.nonzero(mask).squeeze(1)
    rog = torch.cat([ro, rd, g], dim=1)  # one gather per batch
    grads = [torch.zeros_like(theta) for theta in thetas]
    for start in range(0, touched.shape[0], cap):
        with span("rtt.tangent_replay"), torch.enable_grad():
            sub = touched[start:start + cap]
            row = rog[sub]
            ro_s, rd_s, g_s = row[:, 0:3], row[:, 3:6], row[:, 6:9]
            alive_s = torch.ones_like(sub, dtype=torch.bool)
            leaves = [theta.detach().requires_grad_(True) for theta in thetas]
            s = scene_of(*leaves)
            if compaction:
                val = trace_subset_dot(s, ro_s, rd_s, key, max_depth, g_s, alive_s,
                                       ids_base + sub)
            else:
                rad = prb_grad_dense(s, ro_s, rd_s, key, max_depth, None, g_s, alive0=alive_s,
                                     ids0=ids_base + sub, accumulate=False)[1]
                val = (g_s * rad).sum(dtype=torch.float64)
            if val.requires_grad:  # not at depth 1: no scattered direction is traced
                for acc, part in zip(grads, torch.autograd.grad(val, leaves)):
                    acc += part
    return grads


@torch.no_grad()
def _scalar_tangent_pass(p: AllParams, sc: SceneData, ro, rd, key, max_depth: int, g,
                         touched, *, tangent_cap=None, ids_base=0, compaction: bool = True,
                         scalar_rows=None):
    """Fuzz and IR gradients of the scene's active material rows on the
    touched subset only.  ``touched`` is the tape's bitmask (1: the path
    reached a metal, 2: a dielectric); the rays that reached an active
    family are batched once, and each batch's one replay carries both
    families' rows as leaves.  Returns (gfuzz (M,), gir (M,))."""
    with span("rtt.tangent_pass"):
        p = AllParams(*(x.detach() for x in p))
        gfuzz, gir = torch.zeros_like(p.fuzz), torch.zeros_like(p.ir)
        active, bits = [], 0  # (name, rows on the device, its gradient)
        for name, rows_j, bit, grad in zip(("fuzz", "ir"), _active_rows(sc, scalar_rows), (1, 2),
                                           (gfuzz, gir)):
            if len(rows_j):
                with sync("prb_scalar.rows"):  # a copy to the device that waits on it
                    active.append((name, torch.as_tensor(rows_j, device=grad.device), grad))
                bits |= bit
        if active:

            def scene_of(*thetas):
                return _with_all(sc, p._replace(**{
                    name: getattr(p, name).index_copy(0, rows, theta)
                    for (name, rows, _), theta in zip(active, thetas)}))

            parts = _tangent_batches(
                scene_of, [getattr(p, name)[rows] for name, rows, _ in active],
                (touched & bits) != 0, ro, rd, key, max_depth, g, tangent_cap=tangent_cap,
                ids_base=ids_base, compaction=compaction)
            for (_, rows, grad), part in zip(active, parts):
                grad[rows] = part
        return gfuzz, gir


def _assemble_grads(p: AllParams, gacc, gfuzz, gir) -> AllParams:
    """(gcol, gimg (P, 3), gmet) + scalars -> AllParams, images in atlas
    shape."""
    gcol, gimg, gmet = gacc
    if p.images.numel():
        gimg_out = gimg[: p.images[..., 0].numel()].reshape(p.images.shape)
    else:
        gimg_out = torch.zeros_like(p.images)
    return AllParams(color=gcol, images=gimg_out, metal_albedo=gmet, fuzz=gfuzz, ir=gir)


def _tiles(n: int, tile_size: int | None):
    """Row slices of at most ``tile_size`` rays (all rows in one with
    None)."""
    step = tile_size or max(n, 1)
    return [slice(start, min(start + step, n)) for start in range(0, n, step)]


@torch.no_grad()
def _color_replay(s: SceneData, ro, rd, key, max_depth: int, rad, g, *, compaction: bool,
                  ids_base: int, tile_size: int | None):
    """The color-linear half of the backward by re-tracing: per tile, the
    taped compacted forward and its sweep (the tape path's own forward,
    bit-equal to trace_compacted), or with ``compaction=False`` the dense
    replay.  Returns ``((gcol, gimg, gmet) summed over the tiles in
    order, touched (N,))``."""
    gacc, touched = None, []
    for rows in _tiles(ro.shape[0], tile_size):
        base = ids_base + rows.start
        if compaction:
            _, touched_t, tape = trace_taped(s, ro[rows], rd[rows], key, max_depth,
                                             ids_base=base)
            gacc_t = tape_sweep(s, tape, rad[rows], g[rows])
            del tape
        else:
            ids0 = base + torch.arange(rows.stop - rows.start, device=ro.device)
            gacc_t, _, touched_t = prb_grad_dense(s, ro[rows], rd[rows], key, max_depth,
                                                  rad[rows], g[rows], ids0=ids0)
        gacc = gacc_t if gacc is None else tuple(a + b for a, b in zip(gacc, gacc_t))
        touched.append(touched_t)
    return gacc, torch.cat(touched)


class _PrbRadianceAll(torch.autograd.Function):
    """Radiance of the rays, with the PRB backward over the five
    :class:`AllParams` leaves (prb_radiance_all)."""

    @staticmethod
    def forward(ctx, scene, ro, rd, key, max_depth, opts, *leaves):
        s = _with_all(scene, AllParams(*leaves))
        fn = trace_compacted if opts["compaction"] else trace
        rad = torch.cat([fn(s, ro[rows], rd[rows], key, max_depth,
                            ids_base=opts["ids_base"] + rows.start)
                         for rows in _tiles(ro.shape[0], opts["tile_size"])])
        ctx.save_for_backward(ro, rd, rad, *leaves)
        ctx.scene, ctx.key, ctx.max_depth, ctx.opts = scene, key, max_depth, opts
        return rad

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ro, rd, rad, *leaves = ctx.saved_tensors
        p, opts = AllParams(*leaves), ctx.opts
        g = g.contiguous()
        gacc, touched = _color_replay(_with_all(ctx.scene, p), ro, rd, ctx.key, ctx.max_depth,
                                      rad, g, compaction=opts["compaction"],
                                      ids_base=opts["ids_base"], tile_size=opts["tile_size"])
        gfuzz, gir = _scalar_tangent_pass(
            p, ctx.scene, ro, rd, ctx.key, ctx.max_depth, g, touched,
            tangent_cap=opts["tangent_cap"], ids_base=opts["ids_base"],
            compaction=opts["compaction"], scalar_rows=opts["scalar_rows"])
        return (None,) * 6 + tuple(_assemble_grads(p, gacc, gfuzz, gir))


def prb_radiance_all(params: AllParams, scene: SceneData, ro, rd, key, max_depth: int, *,
                     compaction: bool = True, scalar_rows=None, tangent_cap: int | None = None,
                     ids_base: int = 0, tile_size: int | None = None):
    """Per-ray radiance (N, 3), differentiable by autograd in the whole
    parameter set (``params``' five leaves; any that require grad).

    The forward traces ``tile_size`` rays at a time (None: the device's
    tile, renderer.tile_rule) under the one key
    with ids ``ids_base + row`` (compacted, or dense with
    ``compaction=False``) and keeps only its inputs and the radiance.
    The backward replays the same paths (the taped forward and its sweep
    per tile, or the dense replay), which gives the color, texel and
    metal-albedo gradients, then runs one fuzz / IR tangent pass over
    all the rays: one traversal more than :func:`prb_loss_and_grad_all`,
    and no tape lives between forward and backward.  ``scalar_rows``
    selects the tangent rows as (fuzz rows, IR rows); ``((), ())``
    disables the tangent pass."""
    opts = dict(compaction=compaction, scalar_rows=scalar_rows, tangent_cap=tangent_cap,
                ids_base=ids_base, tile_size=tile_size or tile_rule(ro.shape[0], ro.device))
    return _PrbRadianceAll.apply(scene, ro, rd, key, max_depth, opts, *params)


def scalar_radiance(params: ScalarParams, scene: SceneData, ro, rd, key, max_depth: int, *,
                    compaction: bool = True, tile_size: int | None = None):
    """Scalars-only :func:`prb_radiance_all`: the color-linear leaves are
    the scene's own."""
    full = params_of(scene)._replace(fuzz=params.fuzz, ir=params.ir)
    return prb_radiance_all(full, scene, ro, rd, key, max_depth, compaction=compaction,
                            tile_size=tile_size)


def _loss_cotangent(loss_fn, rad):
    """``loss_fn(rad)`` detached, and its gradient in the radiance (zeros
    where the loss does not read it)."""
    r = rad.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(r)
    (g,) = torch.autograd.grad(loss, r, allow_unused=True)
    return loss.detach(), torch.zeros_like(rad) if g is None else g


def prb_loss_and_grad_all(loss_fn, params: AllParams, scene: SceneData, ro, rd, key,
                          max_depth: int, *, compaction: bool = True, scalar_rows=None,
                          tangent_cap: int | None = None, use_tape: bool = True,
                          ids_base: int = 0, defer_scalars: bool = False):
    """Loss value and full-parameter gradient with no autograd graph over
    the renderer, for a loss that is a function of the per-ray radiance.

    ``loss_fn(rad) -> scalar tensor`` is differentiated on its own (one
    small autograd call over the (N, 3) radiance).  By default the taped
    compacted forward writes the PRB tape and the color-linear gradients
    come from its sweep; with ``use_tape=False`` the forward is
    trace_compacted and the backward half re-traces with the tape writer;
    with ``compaction=False`` the forward is the dense trace and the
    backward its dense replay (prb.prb_grad_dense).  Fuzz / IR come from
    the reverse-mode replay of the touched rays (:func:`scalar_tangent_pass`).
    Returns ``(loss, grads: AllParams)``;
    every branch equals ``loss_fn(prb_radiance_all(...)).backward()``.

    ``ids_base`` offsets the per-ray RNG ids, so tiles traced under one
    key with globally unique ids form one logical wavefront.  With
    ``defer_scalars`` the tangent pass is skipped (grads.fuzz and
    grads.ir are zero) and the return becomes ``(loss, grads, (rad, g,
    touched))``: a tiled caller concatenates those and runs
    :func:`scalar_tangent_pass` once over the whole wavefront."""
    s = _with_all(scene, params)
    taped = compaction and use_tape
    if taped:
        rad, touched, tape = trace_taped(s, ro, rd, key, max_depth, ids_base=ids_base)
    else:
        fn = trace_compacted if compaction else trace
        with torch.no_grad():
            rad = fn(s, ro, rd, key, max_depth, ids_base=ids_base)
    loss, g = _loss_cotangent(loss_fn, rad)
    if taped:
        gacc = tape_sweep(s, tape, rad, g)
        del tape
    else:
        gacc, touched = _color_replay(s, ro, rd, key, max_depth, rad, g, compaction=compaction,
                                      ids_base=ids_base, tile_size=None)
    if defer_scalars:
        grads = _assemble_grads(params, gacc, torch.zeros_like(params.fuzz),
                                torch.zeros_like(params.ir))
        return loss, grads, (rad, g, touched)
    gfuzz, gir = _scalar_tangent_pass(params, scene, ro, rd, key, max_depth, g, touched,
                                      tangent_cap=tangent_cap, ids_base=ids_base,
                                      compaction=compaction, scalar_rows=scalar_rows)
    return loss, _assemble_grads(params, gacc, gfuzz, gir)


def scalar_tangent_pass(params: AllParams, scene: SceneData, ro, rd, key, max_depth: int,
                        rad, g, touched, *, compaction: bool = True, scalar_rows=None,
                        tangent_cap: int | None = None, ids_base: int = 0):
    """The fuzz / IR tangent pass on its own: ``(gfuzz, gir)`` from the
    forward's (rad, g, touched), the second half of
    :func:`prb_loss_and_grad_all`'s ``defer_scalars`` protocol.  The ray
    tensors may be the concatenation of tiles traced under one key with
    ``ids_base`` offsets (pass the whole wavefront's base, normally 0).
    ``compaction=False`` differentiates the dense replay of each batch
    (the masked subset with its original ids) in place of the compacted
    subset trace."""
    return _scalar_tangent_pass(params, scene, ro, rd, key, max_depth, g, touched,
                                tangent_cap=tangent_cap, ids_base=ids_base,
                                compaction=compaction, scalar_rows=scalar_rows)
