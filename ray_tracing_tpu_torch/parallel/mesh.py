"""Ray-axis data parallelism over a ``torch.distributed`` process group,
the PyTorch counterpart of ``ray_tracing_tpu/parallel/mesh.py``.

The scene is small and every rank holds all of it; the rays of an image
are split into one contiguous shard per rank.  Every rank traces its
shard under the one trace key with ids ``ids_base = rank * shard +
row``, so an image does not depend on the world size (sharding is an
execution strategy, like tiling or compaction).  The ray axis is padded
to a multiple of ``world * 8`` with rays at the origin looking along +z,
cropped from images and weighted 0 in losses.  The only communication
is explicit: an ``all_gather`` of the image rows, and one ``all_reduce``
of the loss and the gradients, the counterpart of the JAX package's
``psum``.

Without an initialised process group (parallel/distributed.py) a mesh
is one process of world size 1 and nothing is communicated.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ray_tracing_tpu_torch.models.camera import Camera, camera_rays, stamp_shutter
from ray_tracing_tpu_torch.models.scene import SceneData
from ray_tracing_tpu_torch.render.integrator import trace
from ray_tracing_tpu_torch.render.prb import prb_radiance
from ray_tracing_tpu_torch.render.prb_scalar import (
    TILE_SIZE,
    AllParams,
    _active_rows,
    _tiles,
    prb_loss_and_grad_all,
    prb_radiance_all,
    scalar_tangent_pass,
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks the ray axis is split over, and this process's place."""

    group: object  # the process group (None: the default group)
    rank: int
    world: int
    device: torch.device
    collective: bool  # False: one process, no process group

    def shard(self, n_pad: int) -> slice:
        """This rank's rows of a padded ray axis of ``n_pad`` rays."""
        per = n_pad // self.world
        return slice(self.rank * per, (self.rank + 1) * per)


def make_mesh(device="cuda", group=None) -> Mesh:
    """The mesh of the initialised process group (``group`` or the
    default one), or a single process when none is initialised.  Ranks
    on ``cuda`` take the card ``rank % device_count`` unless ``device``
    names one."""
    collective = dist.is_available() and dist.is_initialized()
    if collective:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
    elif group is not None:
        raise ValueError("make_mesh: a group was given, but no process group is initialised")
    else:
        rank, world = 0, 1
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(group, rank, world, device, collective)


def _shard_pad(n: int, world: int) -> int:
    """The ray axis padded so that every shard holds a multiple of 8."""
    mult = world * 8
    return -(-n // mult) * mult


def _pad_rays(ro, rd, n_pad: int):
    """Rays at the origin looking along +z appended up to ``n_pad``."""
    pad = n_pad - ro.shape[0]
    if pad == 0:
        return ro, rd
    zeros = torch.zeros((pad, 3), dtype=ro.dtype, device=ro.device)
    ahead = zeros.clone()
    ahead[:, 2] = 1.0
    return torch.cat([ro, zeros]), torch.cat([rd, ahead])


def _gather_rows(mesh: Mesh, local):
    """Every rank's rows, in rank order.  This rank's part keeps its
    autograd graph; the others arrive detached, so a loss of the whole
    image differentiates, on each rank, into that rank's own rays only
    (the all_reduce of the gradients then sums the ranks)."""
    if not mesh.collective:
        return local
    parts = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(parts, local.detach().contiguous(), group=mesh.group)
    parts[mesh.rank] = local
    return torch.cat(parts)


def all_reduce_sum(mesh: Mesh, tensors):
    """The tensors summed over the ranks with one all_reduce of one flat
    buffer (unchanged without a process group)."""
    if not mesh.collective:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].reshape(t.shape))
        offset += t.numel()
    return out


def _rank_rays(camera: Camera, key, width: int, height: int, mesh: Mesh):
    """(ro, rd) of this rank's shard of the padded camera rays, the trace
    key, the shard's rows and the padded length."""
    n = width * height
    n_pad = _shard_pad(n, mesh.world)
    ro, rd, _, k_trace = camera_rays(camera, key, width, height, True)
    ro, rd = _pad_rays(ro, rd, n_pad)
    rows = mesh.shard(n_pad)
    return ro[rows], rd[rows], k_trace, rows, n_pad


def sharded_trace(scene: SceneData, ro, rd, key, max_depth: int, mesh: Mesh, *,
                  tile_size: int = TILE_SIZE):
    """Trace a wavefront (N, 3) with N a multiple of the world size: each
    rank traces its shard densely, ``tile_size`` rays at a time, with ids
    ``rank * shard + row``, and gathers the others'.  Returns (N, 3)
    radiance on every rank, differentiable in this rank's part."""
    rows = mesh.shard(ro.shape[0])
    ro_s, rd_s = ro[rows], rd[rows]
    rad = torch.cat([trace(scene, ro_s[t], rd_s[t], key, max_depth, ids_base=rows.start + t.start)
                     for t in _tiles(ro_s.shape[0], tile_size)])
    return _gather_rows(mesh, rad)


def sharded_render_pass(scene: SceneData, camera: Camera, key, *, width: int, height: int,
                        max_depth: int, antialias: bool, mesh: Mesh,
                        tile_size: int = TILE_SIZE):
    """One 1-spp pass with the ray axis split over ``mesh``: (H, W, 3)
    linear radiance on every rank, under autograd when the scene's
    tensors require grad (dense reverse mode: small images only)."""
    n = width * height
    scene = stamp_shutter(scene, camera)
    ro, rd, _, k_trace = camera_rays(camera, key, width, height, antialias)
    ro, rd = _pad_rays(ro, rd, _shard_pad(n, mesh.world))
    colors = sharded_trace(scene, ro, rd, k_trace, max_depth, mesh, tile_size=tile_size)
    return colors[:n].reshape(height, width, 3)


def sharded_prb_render(colors, scene: SceneData, camera: Camera, key, *, width: int,
                       height: int, max_depth: int, mesh: Mesh, compaction: bool = True):
    """One 1-spp pass, ray axis split over ``mesh``, differentiable in the
    color table through the PRB backward (prb.prb_radiance): (H, W, 3)
    on every rank."""
    n = width * height
    scene = stamp_shutter(scene, camera)
    ro_s, rd_s, k_trace, rows, _ = _rank_rays(camera, key, width, height, mesh)
    rad = prb_radiance(colors, scene, ro_s, rd_s, k_trace, max_depth, compaction=compaction,
                       ids_base=rows.start)
    return _gather_rows(mesh, rad)[:n].reshape(height, width, 3)


def sharded_prb_render_all(params: AllParams, scene: SceneData, camera: Camera, key, *,
                           width: int, height: int, max_depth: int, mesh: Mesh,
                           compaction: bool = True, scalar_rows=None):
    """One 1-spp pass, ray axis split over ``mesh``, differentiable in the
    whole parameter set through prb_scalar.prb_radiance_all: (H, W, 3) on
    every rank.  ``scalar_rows`` as there."""
    n = width * height
    scene = stamp_shutter(scene, camera)
    ro_s, rd_s, k_trace, rows, _ = _rank_rays(camera, key, width, height, mesh)
    rad = prb_radiance_all(params, scene, ro_s, rd_s, k_trace, max_depth,
                           compaction=compaction, scalar_rows=scalar_rows, ids_base=rows.start)
    return _gather_rows(mesh, rad)[:n].reshape(height, width, 3)


def tiled_loss_and_grad(tile_loss, params: AllParams, scene: SceneData, ro, rd, key,
                        max_depth: int, *, ids_base: int = 0, tile_size: int = TILE_SIZE,
                        compaction: bool = True, use_tape: bool = True, scalar_rows=None):
    """The loss and full-parameter gradient of a wavefront, traced
    ``tile_size`` rays at a time under one key (the bench protocol):
    per tile ``prb_loss_and_grad_all(..., ids_base=ids_base + start,
    defer_scalars=True)``, the tiles' losses and color-linear gradients
    summed in tile order, then one ``scalar_tangent_pass`` over the whole
    wavefront in batches of ``tile_size`` rays.

    ``tile_loss(rad, rows)`` is the loss of the tile's rays ``rows`` (a
    slice of ``ro``); the losses must add up to the wavefront's.  Returns
    ``(loss tensor, AllParams)``."""
    loss, grads, rads, cotangents, touches = None, None, [], [], []
    for rows in _tiles(ro.shape[0], tile_size):
        l_t, g_t, (rad, g_ray, touched) = prb_loss_and_grad_all(
            lambda r, _rows=rows: tile_loss(r, _rows), params, scene, ro[rows], rd[rows], key,
            max_depth, compaction=compaction, use_tape=use_tape, ids_base=ids_base + rows.start,
            defer_scalars=True,
        )
        loss = l_t if loss is None else loss + l_t
        grads = g_t if grads is None else AllParams(*(a + b for a, b in zip(grads, g_t)))
        rads.append(rad)
        cotangents.append(g_ray)
        touches.append(touched)
    gfuzz, gir = scalar_tangent_pass(
        params, scene, ro, rd, key, max_depth, torch.cat(rads), torch.cat(cotangents),
        torch.cat(touches), compaction=compaction, scalar_rows=scalar_rows,
        tangent_cap=tile_size, ids_base=ids_base,
    )
    return loss, grads._replace(fuzz=gfuzz, ir=gir)


def _sgd(params, grads, lr: float):
    return type(params)(*(p.detach() - lr * g for p, g in zip(params, grads)))


def _leaf_grads(leaves):
    return [torch.zeros_like(x) if x.grad is None else x.grad for x in leaves]


def make_prb_train_step_all_direct(camera: Camera, template_scene: SceneData, *, width: int,
                                   height: int, max_depth: int, mesh: Mesh, lr: float = 0.5,
                                   compaction: bool = True, use_tape: bool = True):
    """Full-parameter data-parallel SGD step on the direct backward: each
    rank runs :func:`tiled_loss_and_grad` over its shard with the masked
    L2 loss ``sum(w (rad - target)^2) / (3 n)`` (padded rays weight 0),
    then one all_reduce sums the loss and the gradients.
    ``template_scene``'s material types fix the fuzz / IR rows once.
    Returns ``step(params, scene, key, target) -> (params', loss)``."""
    n = width * height
    scalar_rows = _active_rows(template_scene)

    def step(params: AllParams, scene: SceneData, key, target):
        scene = stamp_shutter(scene, camera)
        ro_s, rd_s, k_trace, rows, n_pad = _rank_rays(camera, key, width, height, mesh)
        weight = torch.zeros((n_pad,), dtype=torch.float32, device=ro_s.device)
        weight[:n] = 1.0
        t_flat = torch.zeros((n_pad, 3), dtype=torch.float32, device=ro_s.device)
        t_flat[:n] = target.reshape(n, 3)
        w_s, t_s = weight[rows], t_flat[rows]

        def tile_loss(rad, tile):
            return torch.sum(w_s[tile, None] * (rad - t_s[tile]) ** 2) / (n * 3)

        loss, grads = tiled_loss_and_grad(
            tile_loss, params, scene, ro_s, rd_s, k_trace, max_depth, ids_base=rows.start,
            compaction=compaction, use_tape=use_tape, scalar_rows=scalar_rows,
        )
        loss, *grads = all_reduce_sum(mesh, [loss, *grads])
        return _sgd(params, grads, lr), loss

    return step


def make_prb_train_step_all(camera: Camera, template_scene: SceneData, *, width: int,
                            height: int, max_depth: int, mesh: Mesh, lr: float = 0.5,
                            compaction: bool = True):
    """Full-parameter data-parallel SGD step on the autograd surface: the
    mean squared error of :func:`sharded_prb_render_all`'s image,
    ``loss.backward()``, one all_reduce of the five ``.grad``.  Equals
    :func:`make_prb_train_step_all_direct`'s step.  Returns
    ``step(params, scene, key, target) -> (params', loss)``."""
    scalar_rows = _active_rows(template_scene)

    def step(params: AllParams, scene: SceneData, key, target):
        leaves = AllParams(*(p.detach().requires_grad_(True) for p in params))
        img = sharded_prb_render_all(leaves, scene, camera, key, width=width, height=height,
                                     max_depth=max_depth, mesh=mesh, compaction=compaction,
                                     scalar_rows=scalar_rows)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        return _sgd(params, all_reduce_sum(mesh, _leaf_grads(leaves)), lr), loss.detach()

    return step


def _with_colors(scene: SceneData, colors) -> SceneData:
    return dataclasses.replace(scene, textures=dataclasses.replace(scene.textures, color=colors))


def make_prb_train_step(camera: Camera, *, width: int, height: int, max_depth: int,
                        mesh: Mesh, lr: float = 0.5, compaction: bool = True):
    """Data-parallel SGD step on the color table through the PRB backward
    (:func:`sharded_prb_render`).  Returns ``step(scene, key, target) ->
    (scene', loss)``."""

    def step(scene: SceneData, key, target):
        colors = scene.textures.color.detach().requires_grad_(True)
        img = sharded_prb_render(colors, scene, camera, key, width=width, height=height,
                                 max_depth=max_depth, mesh=mesh, compaction=compaction)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        (g,) = all_reduce_sum(mesh, _leaf_grads([colors]))
        return _with_colors(scene, colors.detach() - lr * g), loss.detach()

    return step


def make_train_step(camera: Camera, *, width: int, height: int, max_depth: int, mesh: Mesh,
                    lr: float = 0.5):
    """Data-parallel SGD step on the color table by dense reverse-mode
    autograd through :func:`sharded_render_pass` (every bounce on the
    tape: small images only).  Returns ``step(scene, key, target) ->
    (scene', loss)``."""

    def step(scene: SceneData, key, target):
        colors = scene.textures.color.detach().requires_grad_(True)
        img = sharded_render_pass(_with_colors(scene, colors), camera, key, width=width,
                                  height=height, max_depth=max_depth, antialias=True, mesh=mesh)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        (g,) = all_reduce_sum(mesh, _leaf_grads([colors]))
        return _with_colors(scene, colors.detach() - lr * g), loss.detach()

    return step
