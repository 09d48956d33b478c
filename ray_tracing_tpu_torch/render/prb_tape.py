"""Taped path-replay backpropagation, the PyTorch counterpart of
``ray_tracing_tpu/render/prb_tape.py``: the forward writes a compact
per-(bounce, ray) tape and the color-linear gradients come from a sweep
over it, with no second traversal.

Tape semantics per bounce j (the estimator of reference
src/renderer.rs:231-263, derived in render/prb.py):

* emission (one-sided diffuse light): d rad / d e = thr_j
  -> flags F_SOLID/F_IMAGE, c = thr, no suffix scaling
* lambertian / isotropic albedo: d rad / d A = suffix_j / A
  -> flags F_SOLID/F_IMAGE + F_SUFFIX, c = 1/max(A, eps)
* metal albedo: the same suffix trick keyed by material row
  -> flags F_METAL + F_SUFFIX, c = 1/max(albedo, eps)

with suffix_j = rad_total - rad_after_j.  The three cases exclude each
other per ray, so one (leaf, texel, material, flags, c, rad_after) row
serves all three: 40 bytes per ray and bounce.

Layout: tape rows live in the stage-local sorted coordinates of
:func:`~ray_tracing_tpu_torch.render.integrator.trace_compacted`'s
schedule.  ``stage_ids`` maps each stage's positions back to the tile's
rays and ``alive_counts`` holds each stage's live prefix, so the sweep
gathers ``g`` and ``rad_total`` once per stage and reads only the rows
the forward wrote.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ray_tracing_tpu_torch.models.scene import (
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_ISOTROPIC,
    MAT_LAMBERTIAN,
    MAT_METAL,
    SceneData,
)
from ray_tracing_tpu_torch.ops.cuda_scatter import scatter_add
from ray_tracing_tpu_torch.render.integrator import stage_schedule, trace_compacted
from ray_tracing_tpu_torch.render.prb import _A_EPS, _grad_rows, _zero_grads

F_SOLID = 1   # leaf contribution reads textures.color
F_IMAGE = 2   # leaf contribution scatters into the atlas
F_METAL = 4   # material-row contribution
F_SUFFIX = 8  # scale by (rad_total - rad_after); else by 1 (emission)


class PrbTape(NamedTuple):
    """(D, n[, 3]) per-bounce rows in stage-local sorted coordinates, plus
    the per-stage layout needed to walk them back."""

    leaf: torch.Tensor       # (D, n) i32
    texel: torch.Tensor      # (D, n) i32
    mat: torch.Tensor        # (D, n) i32
    flags: torch.Tensor      # (D, n) i32
    c: torch.Tensor          # (D, n, 3) f32
    rad_after: torch.Tensor  # (D, n, 3) f32
    stage_ids: torch.Tensor  # (S, n) i64: stage position -> tile-local ray
    alive_counts: tuple      # (S,) host ints: live rays entering each stage


def _empty_rows(depth: int, n: int, device):
    i = lambda: torch.zeros((depth, n), dtype=torch.int32, device=device)
    f = lambda: torch.zeros((depth, n, 3), dtype=torch.float32, device=device)
    return i(), i(), i(), i(), f(), f()


class _TapeWriter:
    """The tape of one taped forward, filled while
    integrator.trace_compacted runs: its stage walker calls
    :meth:`start_stage` before each stage and every bounce calls
    :meth:`write`.  With ``dense`` the writer serves the dense loop
    (render/prb.py:prb_grad_dense), whose wavefront stays full width in
    input order whatever the rays' ids."""

    def __init__(self, scene: SceneData, max_depth: int, n: int, ids_base: int, device, *,
                 dense: bool = False):
        self.scene = scene
        self.ids_base = ids_base
        self.dense = dense
        self.rows = _empty_rows(max_depth, n, device)
        # bit 0: the path reached a metal, bit 1: a dielectric, in input
        # order; the scalar tangent pass batches each family over its rays
        self.touched = torch.zeros((n,), dtype=torch.int32, device=device)
        self.stage_ids, self.alive_counts = [], []

    def start_stage(self, pos, live: int):
        self.stage_ids.append(pos)
        self.alive_counts.append(live)

    def write(self, bounce: int, hit, aux, found, new_alive, thr, rad, ids):
        """Tape row ``bounce`` of the live prefix: what the JAX package's
        ``_taped_bounce`` adds to the plain bounce."""
        mat = self.scene.materials
        mtype = mat.mtype[hit.material]
        emit_mask = found & (mtype == MAT_DIFFUSE_LIGHT) & hit.front_face
        albedo_mask = new_alive & ((mtype == MAT_LAMBERTIAN) | (mtype == MAT_ISOTROPIC))
        metal_mask = new_alive & (mtype == MAT_METAL)
        a_safe = torch.clamp_min(aux.tex_value, _A_EPS)
        met_safe = torch.clamp_min(mat.albedo[hit.material], _A_EPS)
        leaf_mask = emit_mask | albedo_mask
        flags = (
            torch.where(leaf_mask & aux.leaf_is_solid, F_SOLID, 0)
            | torch.where(leaf_mask & aux.leaf_is_image, F_IMAGE, 0)
            | torch.where(metal_mask, F_METAL, 0)
            | torch.where(albedo_mask | metal_mask, F_SUFFIX, 0)
        )
        c = torch.where(
            emit_mask[:, None], thr,
            torch.where(metal_mask[:, None], 1.0 / met_safe, 1.0 / a_safe),
        )
        live = rad.shape[0]
        for table, value in zip(self.rows, (aux.leaf_tex, aux.texel, hit.material, flags, c, rad)):
            table[bounce, :live] = value
        bits = (found & (mtype == MAT_METAL)).to(torch.int32) | (
            (found & (mtype == MAT_DIELECTRIC)).to(torch.int32) << 1
        )
        if self.dense:
            self.touched |= bits
        else:
            pos = ids - self.ids_base  # the live prefix's rays are distinct
            self.touched[pos] = self.touched[pos] | bits

    def tape(self) -> PrbTape:
        return PrbTape(*self.rows, stage_ids=torch.stack(self.stage_ids),
                       alive_counts=tuple(self.alive_counts))


@torch.no_grad()
def trace_taped(scene: SceneData, ro, rd, key, max_depth: int, *, ids_base: int = 0):
    """Compacted forward trace that also writes the PRB tape.

    It is integrator.trace_compacted with a tape writer (same sorts, same
    live prefixes, same uniforms), so the radiance is bit-identical to it
    and to the dense loop.  Returns ``(rad (n, 3), touched (n,) i32
    bitmask -- 1: the path reached a metal, 2: a dielectric --, tape)``
    with rad and touched in input-row order.  ``ids_base`` offsets the
    RNG ids; ``tape.stage_ids`` stay tile-local."""
    writer = _TapeWriter(scene, max_depth, ro.shape[0], ids_base, ro.device)
    rad = trace_compacted(scene, ro, rd, key, max_depth, ids_base=ids_base, tape=writer)
    return rad, writer.touched, writer.tape()


def _flat_rows(leaf, texel, mat, flags, c, rad_after, g_s, tot_s):
    """One stage's (B, L) tape block -> B*L flat rows (leaf, texel, mat,
    flags, contrib (B*L, 3)), contrib = g * c * (suffix or 1); g_s and
    tot_s are (L, 3) and broadcast over the bounce axis."""
    suffix = tot_s - rad_after
    scale = torch.where((flags & F_SUFFIX)[..., None] != 0, suffix, 1.0)
    contrib = (g_s * c * scale).reshape(-1, 3)
    return leaf.reshape(-1), texel.reshape(-1), mat.reshape(-1), flags.reshape(-1), contrib


def _table_rows(p: int, t: int, leaf, texel, mat, flags, c, rad_after, g_s, tot_s):
    """One stage's tape block -> its segment of the (P + T + M, 3)
    gradient table ``[gimg | gcol | gmet]``: ``(row (B*L,) i32, contrib
    (B*L, 3), mask)`` with row = texel, P + leaf or P + T + material.  A
    tape row feeds at most one table (F_SOLID, F_IMAGE and F_METAL
    exclude each other), so the mask is their union."""
    leaf, texel, mat, flags, contrib = _flat_rows(leaf, texel, mat, flags, c, rad_after,
                                                  g_s, tot_s)
    row = torch.where((flags & F_IMAGE) != 0, texel,
                      torch.where((flags & F_SOLID) != 0, leaf + p, mat + (p + t)))
    return row, contrib, (flags & (F_SOLID | F_IMAGE | F_METAL)) != 0


def stage_blocks(tape: PrbTape, rad_total, g):
    """Yield each stage's tape block ``(leaf, texel, mat, flags, c,
    rad_after, g_s, tot_s)``: the rows of its live prefix, with the loss
    cotangent and total radiance gathered into stage coordinates.  The
    stages are those of the tape's own depth."""
    gt = torch.cat([g, rad_total], dim=1)  # one gather for both
    offset = 0
    for stage, bounces in enumerate(stage_schedule(tape.leaf.shape[0])):
        live = tape.alive_counts[stage]
        block = tuple(t[offset:offset + bounces, :live] for t in tape[:6])
        # stage 0 runs in input order: no gather needed
        gt_s = gt if stage == 0 else gt[tape.stage_ids[stage, :live]]
        yield block + (gt_s[:, :3], gt_s[:, 3:])
        offset += bounces


def sweep_segments(scene: SceneData, tape: PrbTape, rad_total, g) -> list:
    """The tape's rows of the gradient table, one ``(row, contrib, mask)``
    segment per stage (:func:`_table_rows`): what K2 takes per tile."""
    p, t, _ = _grad_rows(scene)
    return [_table_rows(p, t, *block) for block in stage_blocks(tape, rad_total, g)]


@torch.no_grad()
def tape_sweep(scene: SceneData, tape: PrbTape, rad_total, g):
    """Accumulate (gcol (T, 3), gimg (P, 3), gmet (M, 3)) from the tape:
    no traversal; one ordered scatter of every stage's rows into the one
    table ``[gimg | gcol | gmet]`` (kernel K2 on the card: one call per
    tile, bit-repeatable; the plain version on the CPU, the same sums in
    the same order).  ``rad_total`` and ``g`` are in input-row order."""
    table, gacc = _zero_grads(scene)
    scatter_add(table, sweep_segments(scene, tape, rad_total, g))
    return gacc
