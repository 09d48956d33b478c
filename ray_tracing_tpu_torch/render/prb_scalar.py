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

The port takes a gradient one way, :func:`tiled_loss_and_grad`: per
tile, the taped compacted forward, the loss cotangent and the tape
sweep (kernel K2 on the card), then one :func:`scalar_tangent_pass`
over the whole wavefront for fuzz and IR.  ``prb_loss_and_grad_all`` is
its one-tile call.  ``prb_radiance_all`` is the autograd face: a
``torch.autograd.Function`` whose forward traces (saving only its
inputs) and whose backward runs the same per-tile body and the same
tangent pass with the incoming cotangent, so any loss of the radiance
takes ``loss.backward()``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch

from ray_tracing_tpu_torch.models.scene import MAT_DIELECTRIC, MAT_METAL, SceneData
from ray_tracing_tpu_torch.ops.rng import TIME_STREAM, stream_key
from ray_tracing_tpu_torch.render.integrator import trace_compacted, trace_subset_dot
from ray_tracing_tpu_torch.render.prb_tape import tape_sweep, trace_taped
from ray_tracing_tpu_torch.render.renderer import tile_rule
from ray_tracing_tpu_torch.render.stage_graphs import replay_graphs
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
    rows), int64 tensors on the scene's device, read from the scene's
    material types unless ``scalar_rows`` gives them (``((), ())``
    disables the tangent pass).  A caller that fixes its rows once
    passes these tensors on, and the tangent pass takes them with no
    copy to the device."""
    device = scene.materials.mtype.device
    if scalar_rows is None:
        mtype = scene.materials.mtype
        with sync("prb_scalar.rows"):  # a read of the material types
            scalar_rows = (torch.nonzero(mtype == MAT_METAL)[:, 0],
                           torch.nonzero(mtype == MAT_DIELECTRIC)[:, 0])
    return tuple(torch.as_tensor(rows, dtype=torch.int64, device=device) for rows in scalar_rows)


@torch.no_grad()
def scalar_tangent_pass(params: AllParams, scene: SceneData, ro, rd, key, max_depth: int, g,
                        touched, *, tile_size: int | None = None, ids_base: int = 0,
                        scalar_rows=None):
    """Fuzz and IR gradients ``(gfuzz (M,), gir (M,))`` of ``vdot(g,
    rad)`` in the scene's active material rows (:func:`_active_rows`).

    ``touched`` is the tape's bitmask (1: the path reached a metal, 2: a
    dielectric) and ``g`` the loss cotangent, both over the whole
    wavefront of ``ro``, whose ray ids start at ``ids_base``.  The rays
    that reached an active family are gathered in input order into
    batches of at most ``tile_size`` rays (None: the device's tile,
    renderer.tile_rule).  Each batch takes one compacted replay under
    reverse-mode autograd (integrator.trace_subset_dot), one
    ``rtt.tangent_replay`` span, with every active row of both families
    a leaf; one backward gives every leaf's gradient, and the batch's
    graph is freed before the next.  The other rays have an exactly-zero
    derivative and are never traced.

    On the card the replay's stages run as CUDA graphs
    (render/stage_graphs.py): a batch is padded with dead rays to a width
    the graphs keep from step to step (``ReplayGraphs.width``) and the
    key goes to the device once as stream seeds (ops/rng.py:StreamKey).  On the CPU the
    replay runs eagerly at the batch's own widths."""
    with span("rtt.tangent_pass"):
        p = AllParams(*(x.detach() for x in params))
        gfuzz, gir = torch.zeros_like(p.fuzz), torch.zeros_like(p.ir)
        active, bits = [], 0  # (name, rows on the device, its gradient)
        for name, rows_j, bit, grad in zip(("fuzz", "ir"), _active_rows(scene, scalar_rows),
                                           (1, 2), (gfuzz, gir)):
            if len(rows_j):
                active.append((name, rows_j, grad))
                bits |= bit
        if not active:
            return gfuzz, gir
        n = ro.shape[0]
        cap = min(n, tile_size or tile_rule(n, ro.device))
        mask = (touched & bits) != 0
        with sync("prb_scalar.touched"):
            picked = torch.nonzero(mask).squeeze(1)
        rog = torch.cat([ro, rd, g], dim=1)  # one gather per batch
        thetas = [getattr(p, name)[rows] for name, rows, _ in active]
        parts = [torch.zeros_like(theta) for theta in thetas]
        graphs = replay_graphs(scene, ro.device)
        if graphs is not None:
            key = stream_key(key, [*range(max_depth), TIME_STREAM], ro.device)
        for start in range(0, picked.shape[0], cap):
            with span("rtt.tangent_replay"), torch.enable_grad(), \
                    (graphs.lock if graphs is not None else contextlib.nullcontext()):
                sub = picked[start:start + cap]
                count = sub.shape[0]
                width = count if graphs is None else graphs.width(("batch", max_depth), count)
                alive0 = torch.arange(width, device=ro.device) < count
                sub = torch.nn.functional.pad(sub, (0, width - count))  # dead rays: row 0
                row = rog[sub]
                leaves = [theta.detach().requires_grad_(True) for theta in thetas]
                s = _with_all(scene, p._replace(**{
                    name: getattr(p, name).index_copy(0, rows, leaf)
                    for (name, rows, _), leaf in zip(active, leaves)}))
                val = trace_subset_dot(s, row[:, 0:3], row[:, 3:6], key, max_depth,
                                       torch.where(alive0[:, None], row[:, 6:9], 0.0), alive0,
                                       ids_base + sub, stages=graphs)
                if val.requires_grad:  # not at depth 1: no scattered direction is traced
                    for acc, part in zip(parts, torch.autograd.grad(val, leaves)):
                        acc += part
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


def _loss_cotangent(loss_fn, rad):
    """``loss_fn(rad)`` detached, and its gradient in the radiance (zeros
    where the loss does not read it)."""
    r = rad.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(r)
    (g,) = torch.autograd.grad(loss, r, allow_unused=True)
    return loss.detach(), torch.zeros_like(rad) if g is None else g


def _tile_grads(s: SceneData, ro, rd, key, max_depth: int, ids_base: int, cotangent):
    """One tile of the gradient route: the taped compacted forward, the
    cotangent of its radiance (``cotangent(rad) -> (loss or None, g)``)
    and the tape sweep.  Returns ``(loss, (gcol, gimg, gmet), g,
    touched)``; the tape is freed on return."""
    rad, touched, tape = trace_taped(s, ro, rd, key, max_depth, ids_base=ids_base)
    loss, g = cotangent(rad)
    return loss, tape_sweep(s, tape, rad, g), g, touched


def _tiled_grads(s: SceneData, ro, rd, key, max_depth: int, ids_base: int, tile_size: int,
                 cotangent):
    """:func:`_tile_grads` over the wavefront's tiles, one ``rtt.tile``
    span each, under one key with ray ids ``ids_base + row``;
    ``cotangent(rad, rows)`` takes the tile's rows.  Returns the losses
    and color-linear gradients summed in tile order (loss None where the
    cotangents give none) and the whole wavefront's ``(g, touched)``."""
    loss, gacc, gs, touches = None, None, [], []
    for rows in _tiles(ro.shape[0], tile_size):
        with span("rtt.tile"):
            l_t, gacc_t, g_t, touched_t = _tile_grads(
                s, ro[rows], rd[rows], key, max_depth, ids_base + rows.start,
                lambda rad, _rows=rows: cotangent(rad, _rows))
            loss = l_t if loss is None else loss + l_t
            gacc = gacc_t if gacc is None else tuple(a + b for a, b in zip(gacc, gacc_t))
            gs.append(g_t)
            touches.append(touched_t)
    return loss, gacc, torch.cat(gs), torch.cat(touches)


def tiled_loss_and_grad(tile_loss, params: AllParams, scene: SceneData, ro, rd, key,
                        max_depth: int, *, ids_base: int = 0, tile_size: int | None = None,
                        scalar_rows=None):
    """Loss value and full-parameter gradient of a wavefront, with no
    autograd graph over the renderer: the port's one gradient route.

    The wavefront is traced ``tile_size`` rays at a time (None: the
    device's tile, renderer.tile_rule: on the card the whole wavefront)
    under one key with ray ids ``ids_base + row``.  Per tile, in one
    ``rtt.tile`` span: the taped compacted forward (prb_tape.trace_taped),
    the loss and its cotangent in the tile's radiance, and the tape
    sweep (K2 on the card), which gives the color, texel and
    metal-albedo gradients; the tiles' losses and gradients are summed
    in tile order.  Then one :func:`scalar_tangent_pass` over the whole
    wavefront, in batches of ``tile_size`` rays, gives fuzz and IR.

    ``tile_loss(rad, rows)`` is the loss of the tile's rays ``rows`` (a
    slice of ``ro``), differentiated on its own; the losses must add up
    to the wavefront's.  ``scalar_rows`` as :func:`_active_rows`.
    Returns ``(loss tensor, AllParams)``."""
    tile_size = tile_size or tile_rule(ro.shape[0], ro.device)
    loss, gacc, g, touched = _tiled_grads(
        _with_all(scene, params), ro, rd, key, max_depth, ids_base, tile_size,
        lambda rad, rows: _loss_cotangent(lambda r: tile_loss(r, rows), rad))
    gfuzz, gir = scalar_tangent_pass(params, scene, ro, rd, key, max_depth, g, touched,
                                     tile_size=tile_size, ids_base=ids_base,
                                     scalar_rows=scalar_rows)
    return loss, _assemble_grads(params, gacc, gfuzz, gir)


def prb_loss_and_grad_all(loss_fn, params: AllParams, scene: SceneData, ro, rd, key,
                          max_depth: int, *, ids_base: int = 0, scalar_rows=None):
    """:func:`tiled_loss_and_grad` with the whole wavefront in one tile,
    for a loss ``loss_fn(rad) -> scalar tensor`` of the per-ray radiance.
    Returns ``(loss, grads: AllParams)``, which equal
    ``loss_fn(prb_radiance_all(...)).backward()``'s."""
    return tiled_loss_and_grad(lambda rad, rows: loss_fn(rad), params, scene, ro, rd, key,
                               max_depth, ids_base=ids_base, tile_size=max(ro.shape[0], 1),
                               scalar_rows=scalar_rows)


class _PrbRadianceAll(torch.autograd.Function):
    """Radiance of the rays, with the PRB backward over the five
    :class:`AllParams` leaves (prb_radiance_all)."""

    @staticmethod
    def forward(ctx, scene, ro, rd, key, max_depth, opts, *leaves):
        s = _with_all(scene, AllParams(*leaves))
        rad = torch.cat([trace_compacted(s, ro[rows], rd[rows], key, max_depth,
                                         ids_base=opts["ids_base"] + rows.start)
                         for rows in _tiles(ro.shape[0], opts["tile_size"])])
        ctx.save_for_backward(ro, rd, *leaves)
        ctx.scene, ctx.key, ctx.max_depth, ctx.opts = scene, key, max_depth, opts
        return rad

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ro, rd, *leaves = ctx.saved_tensors
        p, opts = AllParams(*leaves), ctx.opts
        g = g.contiguous()
        _, gacc, g, touched = _tiled_grads(
            _with_all(ctx.scene, p), ro, rd, ctx.key, ctx.max_depth, opts["ids_base"],
            opts["tile_size"], lambda rad, rows: (None, g[rows]))
        gfuzz, gir = scalar_tangent_pass(p, ctx.scene, ro, rd, ctx.key, ctx.max_depth, g,
                                         touched, tile_size=opts["tile_size"],
                                         ids_base=opts["ids_base"],
                                         scalar_rows=opts["scalar_rows"])
        return (None,) * 6 + tuple(_assemble_grads(p, gacc, gfuzz, gir))


def prb_radiance_all(params: AllParams, scene: SceneData, ro, rd, key, max_depth: int, *,
                     scalar_rows=None, ids_base: int = 0, tile_size: int | None = None):
    """Per-ray radiance (N, 3), differentiable by autograd in the whole
    parameter set (``params``' five leaves; any that require grad).

    The forward traces ``tile_size`` rays at a time (None: the device's
    tile, renderer.tile_rule) compacted, under the one key with ids
    ``ids_base + row``, and keeps only its inputs.  The backward takes
    :func:`tiled_loss_and_grad`'s route with the incoming cotangent in
    place of a loss's: per tile the taped forward and its sweep, then
    one fuzz / IR tangent pass over all the rays; one traversal more
    than :func:`prb_loss_and_grad_all`, and no tape lives between
    forward and backward.  ``scalar_rows`` selects the tangent rows as
    (fuzz rows, IR rows); ``((), ())`` disables the tangent pass."""
    opts = dict(scalar_rows=scalar_rows, ids_base=ids_base,
                tile_size=tile_size or tile_rule(ro.shape[0], ro.device))
    return _PrbRadianceAll.apply(scene, ro, rd, key, max_depth, opts, *params)


def scalar_radiance(params: ScalarParams, scene: SceneData, ro, rd, key, max_depth: int, *,
                    tile_size: int | None = None):
    """Scalars-only :func:`prb_radiance_all`: the color-linear leaves are
    the scene's own."""
    full = params_of(scene)._replace(fuzz=params.fuzz, ir=params.ir)
    return prb_radiance_all(full, scene, ro, rd, key, max_depth, tile_size=tile_size)
