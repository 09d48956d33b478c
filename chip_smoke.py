"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. build the kernels with nvcc for sm_90a, one nvcc per source, in
     parallel: K1 phase A (csrc/intersect.cu) and K2 scatter-add
     (csrc/scatter.cu);
  2. K1 against its plain PyTorch version on the card, for the 1024x1024
     zy camera rays and 65,536 random rays (numpy seed 0): hit/miss,
     kind and index equal, t to rtol 1e-5;
  3. the main path: load data/zy_scene.json, Renderer(1024x1024,
     max_depth=20, device="cuda"), render(k) for k = 0..3 -- finite,
     non-negative images with a mean in 0.1-0.4, render(0) deterministic,
     and K1 launched by those renders;
  4. at 256x256 depth 20, trace_compacted equals the dense trace, and a
     64x64 depth-1 image on the card equals the port's CPU render;
  5. timings with CUDA events: ms per 1024x1024 depth-20 pass, traced
     segments per second, K1 against its plain version on a 65,536-ray
     tile;
  6. K2 against its plain version on the card, into the 524,288-texel zy
     atlas-gradient table: 1,310,720 seeded rows (~5 % live, heavy
     duplicates) to rtol 1e-5 / atol 1e-6 (atomics reorder sums), the
     same rows without duplicates bit-equal, and the real rows of one zy
     tile's tape sweep;
  7. the gradient path: zy at 1024x1024 depth 20, params_of -> 16 tiles
     of 65,536 rays under one trace key with ids_base,
     prb_loss_and_grad_all(torch.sum, defer_scalars=True) per tile, one
     global scalar_tangent_pass; loss = image mean.  All five gradient
     leaves finite and nonzero, K1 and K2 launched, the color gradient
     against a central difference of the image mean on the card (eps
     1e-2, rtol 1e-2), a second pass at the same key equal in loss and
     close in gradients, and three SGD steps of an L2 fit to a target
     rendered under another key;
  8. timings with CUDA events: ms per 1024x1024 depth-20 fwd+bwd pass
     and rays/s, split into taped forward, sweep and tangent pass; the
     device's busy share over one tile's fwd+bwd; K2 against its plain
     version on one zy tile's sweep rows.
The last lines are a JSON kernel record (K1 once per path, with the
launches of the forward render of phase 3 and of the fwd+bwd of phase
7, and K2 with those of phase 7), the card's name and power limit, and
a JSON device record.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE, DEPTH, TILE = 1024, 20, 65536  # zy at full size, as bench.py measures it


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_device(fn):
    """Run ``fn()`` once under torch.profiler; returns (wall ms, {kernel
    name: (launches, device ms)}), the kernels empty when the profiler
    saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, ms = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return wall_ms, kernels


def interior_rays(n: int, seed: int):
    """Secondary-bounce-like rays for zy: origins inside the box,
    isotropic directions (numpy, seeded)."""
    import numpy as np
    import torch

    r = np.random.RandomState(seed)
    ro = r.uniform(1.0, 554.0, (n, 3)).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return torch.from_numpy(ro).cuda(), torch.from_numpy(rd).cuda()


def compare_k1(ci, sph, rect, ro, rd, what: str) -> float:
    """K1 against phase_a_plain on the same card tensors; returns the
    largest |dt| over hit rays."""
    import torch

    t, kind, idx = ci.phase_a_cuda(sph, rect, ro, rd, 1e-3, float("inf"))
    torch.cuda.synchronize()
    pt, pkind, pidx = ci.phase_a_plain(sph, rect, ro, rd, 1e-3, float("inf"))
    found, pfound = kind >= 0, pkind >= 0
    n_found = int((found != pfound).sum())
    n_kind = int((kind != pkind).sum())
    n_idx = int((idx != pidx).sum())
    both = found & pfound
    n_t = int((~torch.isclose(t[both], pt[both], rtol=1e-5, atol=0.0)).sum())
    err = float((t[both] - pt[both]).abs().max()) if bool(both.any()) else 0.0
    print(f"[2] K1 vs plain, {what}: {ro.shape[0]} rays, {int(found.sum())} hits; "
          f"mismatches found={n_found} kind={n_kind} idx={n_idx} t(rtol 1e-5)={n_t}; "
          f"max |dt| = {err!r}")
    check(n_found == n_kind == n_idx == n_t == 0, f"K1 disagrees with its plain version on {what}")
    return err


def compare_k2(cs, p: int, texel, contrib, mask, what: str, exact: bool = False) -> float:
    """K2 against scatter_add_plain into a zeroed (p, 3) table on the card;
    returns the largest |difference|.  Atomics add duplicates in a varying
    order, so the two agree to rtol 1e-5 / atol 1e-6, and bit for bit
    where no texel repeats (``exact``)."""
    import torch

    zeros = lambda: torch.zeros((p, 3), dtype=torch.float32, device=texel.device)
    got = cs.scatter_add_cuda(zeros(), texel, contrib, mask)
    torch.cuda.synchronize()
    want = cs.scatter_add_plain(zeros(), texel, contrib, mask)
    n_bad = int((~torch.isclose(got, want, rtol=1e-5, atol=1e-6)).sum())
    err = float((got - want).abs().max())
    live = mask & (texel >= 0)
    n_dup = int(live.sum()) - int(torch.unique(texel[live]).numel())
    print(f"[6] K2 vs plain, {what}: {texel.shape[0]} rows, {int(live.sum())} live, "
          f"{n_dup} duplicate live rows; mismatches (rtol 1e-5, atol 1e-6; atomics reorder "
          f"sums) {n_bad}; max |d| = {err!r}; torch.equal {torch.equal(got, want)}")
    check(n_bad == 0, f"K2 disagrees with its plain version on {what}")
    if exact:
        check(torch.equal(got, want), f"K2 equals its plain version bit for bit on {what}")
    return err


def grad_pass(params, scene, ro, rd, k_trace, tile_loss, tile: int = TILE):
    """One full-parameter fwd+bwd pass with the protocol of bench.py:172-231:
    tiles under one trace key with ids_base, prb_loss_and_grad_all(...,
    defer_scalars=True) per tile, one global scalar_tangent_pass.  The
    loss is the summed per-tile losses over n*3 and every gradient is
    scaled by 1/(n*3).  ``tile_loss(rad, rows)`` is the loss of the tile's
    rows.  Returns (loss tensor, AllParams)."""
    import torch
    from ray_tracing_tpu_torch.render.prb_scalar import (
        AllParams,
        prb_loss_and_grad_all,
        scalar_tangent_pass,
    )

    n = ro.shape[0]
    scale = 1.0 / (n * 3)
    loss, grads, rads, gcs, touches = 0.0, None, [], [], []
    for start in range(0, n, tile):
        rows = slice(start, min(start + tile, n))
        l_i, g_i, (rad, g_ray, touched) = prb_loss_and_grad_all(
            lambda r, _rows=rows: tile_loss(r, _rows), params, scene, ro[rows], rd[rows],
            k_trace, DEPTH, ids_base=start, defer_scalars=True,
        )
        loss = loss + l_i
        grads = g_i if grads is None else AllParams(*(a + b for a, b in zip(grads, g_i)))
        rads.append(rad)
        gcs.append(g_ray)
        touches.append(touched)
    gfuzz, gir = scalar_tangent_pass(
        params, scene, ro, rd, k_trace, DEPTH, torch.cat(rads), torch.cat(gcs) * scale,
        torch.cat(touches), tangent_cap=65536,
    )
    grads = AllParams(*(x * scale for x in grads))._replace(fuzz=gfuzz, ir=gir)
    return loss * scale, grads


def split_pass(params, scene, ro, rd, k_trace, tile: int = TILE):
    """The same pass as grad_pass with the loss torch.sum, built from its
    pieces so that CUDA events split it: (taped forward ms, sweep ms,
    tangent pass ms)."""
    import torch
    from ray_tracing_tpu_torch.render.prb_scalar import _with_all, scalar_tangent_pass
    from ray_tracing_tpu_torch.render.prb_tape import tape_sweep, trace_taped

    ev = lambda: torch.cuda.Event(enable_timing=True)
    s = _with_all(scene, params)
    n = ro.shape[0]
    fwd, sweep, rads, touches = [], [], [], []
    for start in range(0, n, tile):
        rows = slice(start, min(start + tile, n))
        e0, e1, e2 = ev(), ev(), ev()
        e0.record()
        rad, touched, tape = trace_taped(s, ro[rows], rd[rows], k_trace, DEPTH, ids_base=start)
        e1.record()
        tape_sweep(s, tape, rad, torch.ones_like(rad))
        e2.record()
        fwd.append((e0, e1))
        sweep.append((e1, e2))
        rads.append(rad)
        touches.append(touched)
    e3, e4 = ev(), ev()
    e3.record()
    rad = torch.cat(rads)
    scalar_tangent_pass(params, scene, ro, rd, k_trace, DEPTH, rad, torch.ones_like(rad),
                        torch.cat(touches), tangent_cap=65536)
    e4.record()
    torch.cuda.synchronize()
    total = lambda pairs: sum(a.elapsed_time(b) for a, b in pairs)
    return total(fwd), total(sweep), e3.elapsed_time(e4)


def image_mean(scene, camera, key) -> float:
    """Mean of the 1024x1024 depth-20 zy image at ``key`` (forward only,
    the tiles and ray ids of grad_pass), summed in float64."""
    from ray_tracing_tpu_torch.render.renderer import render_pass

    img = render_pass(scene, camera, key, width=SIZE, height=SIZE, max_depth=DEPTH,
                      antialias=True, tile_size=TILE)
    return float(img.double().sum()) / img.numel()


def gradient_phases(scene, bundle, smi: str) -> dict:
    """Phases 6-8 on the card: K2 against its plain version, the
    full-parameter fwd+bwd of zy at 1024^2 depth 20, and its timings.
    Returns the numbers the kernel record needs."""
    import numpy as np
    import torch
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.models.scene import MAT_DIFFUSE_LIGHT, MAT_METAL
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_scatter as cs
    from ray_tracing_tpu_torch.ops import rng
    from ray_tracing_tpu_torch.render.prb_scalar import AllParams, _with_all, params_of
    from ray_tracing_tpu_torch.render.prb_tape import F_IMAGE, _flat_rows, stage_blocks, trace_taped
    from ray_tracing_tpu_torch.render.renderer import render_pass

    dev = scene.device
    n = SIZE * SIZE
    p_texels = scene.textures.images[..., 0].numel()
    cam = Camera.build(bundle.camera, 1.0).to(dev)
    key = rng.key(0)
    ro, rd, _, k_trace = camera_rays(cam, key, SIZE, SIZE, True)

    # 6. K2 against its plain version
    r = np.random.RandomState(0)
    rows = 20 * TILE
    live = r.rand(rows) < 0.05
    texel = np.where(r.rand(rows) < 0.5, r.randint(0, 1024, rows), r.randint(0, p_texels, rows))
    # positive, as the rows of an image-mean gradient are
    contrib = torch.from_numpy(r.uniform(0.0, 1.0, (rows, 3)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(live).to(dev)
    k2_err = compare_k2(cs, p_texels, torch.from_numpy(texel.astype(np.int32)).to(dev), contrib,
                        mask, f"{rows:,} rows (seed 0), duplicates")
    unique = np.full(rows, -1, np.int64)
    unique[live] = r.permutation(p_texels)[: int(live.sum())]
    k2_err = max(k2_err, compare_k2(cs, p_texels, torch.from_numpy(unique.astype(np.int32)).to(dev),
                                    contrib, mask, "the same rows, no duplicates", exact=True))
    rad0, _, tape0 = trace_taped(scene, ro[:TILE], rd[:TILE], k_trace, DEPTH)
    g0 = torch.full_like(rad0, 1.0 / (n * 3))
    tile_rows = []
    for block in stage_blocks(tape0, rad0, g0):
        _, texel_s, _, flags, contrib_s = _flat_rows(*block)
        tile_rows.append((texel_s, contrib_s, (flags & F_IMAGE) != 0))
    del tape0
    for stage, (texel_s, contrib_s, mask_s) in enumerate(tile_rows):
        k2_err = max(k2_err, compare_k2(cs, p_texels, texel_s, contrib_s, mask_s,
                                        f"zy tile 0 sweep stage {stage}"))

    # 7. the gradient path at full size
    params = params_of(scene)
    ci.LAUNCHES = cs.LAUNCHES = 0
    t0 = time.perf_counter()
    loss, grads = grad_pass(params, scene, ro, rd, k_trace, lambda rad, rows: torch.sum(rad))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k1_launches": ci.LAUNCHES, "k2_launches": cs.LAUNCHES}
    norms = {f: float(torch.linalg.vector_norm(getattr(grads, f))) for f in AllParams._fields}
    print(f"[7] zy {SIZE}^2 depth {DEPTH} fwd+bwd ({n // TILE} tiles of {TILE}, one tangent pass): "
          f"loss {float(loss)!r} in {wall:.2f} s; K1 launches {ci.LAUNCHES}, "
          f"K2 launches {cs.LAUNCHES}; gradient norms {norms}")
    for f in AllParams._fields:
        g = getattr(grads, f)
        check(g.shape == getattr(params, f).shape, f"{f} gradient shape")
        check(bool(torch.isfinite(g).all()), f"{f} gradient finite")
        check(norms[f] > 0.0, f"{f} gradient nonzero")
    check(ci.LAUNCHES > 0 and cs.LAUNCHES > 0, "the gradient path launched K1 and K2")
    mean0 = image_mean(scene, cam, key)
    check(abs(mean0 - float(loss)) <= 1e-5 * mean0, "the gradient pass's loss is the image mean")

    # colors against a central difference: at a fixed key the paths do not
    # depend on colors, so the image mean is a polynomial in them
    d = grads.color / torch.linalg.vector_norm(grads.color)
    eps = 1e-2
    at = lambda c: image_mean(_with_all(scene, params._replace(color=c)), cam, key)
    fd = (at(params.color + eps * d) - at(params.color - eps * d)) / (2 * eps)
    gd = float((grads.color * d).sum())
    print(f"[7] color gradient along g/|g|: g.d {gd!r}, central difference (eps {eps}) {fd!r}, "
          f"rel err {abs(fd - gd) / abs(gd)!r}")
    check(abs(fd - gd) <= 1e-2 * abs(gd), "color gradient matches the central difference, rtol 1e-2")

    loss2, grads2 = grad_pass(params, scene, ro, rd, k_trace, lambda rad, rows: torch.sum(rad))
    rel = {f: float((getattr(grads2, f) - getattr(grads, f)).abs().max()
                    / getattr(grads, f).abs().max()) for f in AllParams._fields}
    print(f"[7] second pass, same key: loss equal {bool(torch.equal(loss, loss2))}; gradient "
          f"max |d| / max |g| per leaf {rel} (not bit-equal: index_add_ and K2 sum with atomics)")
    check(bool(torch.equal(loss, loss2)), "the loss repeats at the same key")
    for f in AllParams._fields:
        check(torch.allclose(getattr(grads2, f), getattr(grads, f), rtol=1e-4, atol=1e-8),
              f"{f} gradient repeats to rtol 1e-4")

    # three SGD steps of an L2 fit (examples/fit_materials.py:97-141): the
    # target is rendered under another key; colors (emitters pinned), metal
    # albedo, fuzz and IR start perturbed and are clipped to their boxes
    mat = scene.materials
    pinned = torch.zeros_like(params.color[:, :1], dtype=torch.bool)
    pinned[mat.tex[mat.mtype == MAT_DIFFUSE_LIGHT].long()] = True
    is_metal = mat.mtype == MAT_METAL
    fit = params._replace(
        color=torch.where(pinned, params.color, 0.5),
        metal_albedo=torch.where(is_metal[:, None], 0.5, params.metal_albedo),
        fuzz=torch.where(is_metal, 0.05, params.fuzz),
        ir=torch.where(params.ir > 1.0, 1.2, params.ir),
    )
    target = render_pass(scene, cam, rng.key(1), width=SIZE, height=SIZE, max_depth=DEPTH,
                         antialias=True, tile_size=TILE).reshape(n, 3)
    lr = 1.0
    for step in range(3):
        loss_s, g = grad_pass(fit, scene, ro, rd, k_trace,
                              lambda rad, rows: torch.sum((rad - target[rows]) ** 2))
        g = g._replace(color=torch.where(pinned, 0.0, g.color))
        step_norms = {f: float(torch.linalg.vector_norm(getattr(g, f))) for f in AllParams._fields}
        print(f"[7] SGD step {step}: L2 loss {float(loss_s)!r}, gradient norms {step_norms}")
        check(np.isfinite(float(loss_s)) and all(np.isfinite(v) for v in step_norms.values()),
              f"SGD step {step} finite")
        fit = AllParams(*(p - lr * gp for p, gp in zip(fit, g)))
        fit = fit._replace(
            color=torch.where(pinned, fit.color, fit.color.clamp(0.0, 1.0)),
            images=fit.images.clamp(0.0, 1.0),
            metal_albedo=fit.metal_albedo.clamp(0.0, 1.0),
            fuzz=fit.fuzz.clamp(0.0, 1.0),
            ir=fit.ir.clamp(1.0, 3.0),
        )
    print(f"[7] after 3 steps: fuzz {fit.fuzz[is_metal].tolist()} (true "
          f"{params.fuzz[is_metal].tolist()}), ir {fit.ir[params.ir > 1].tolist()} "
          f"(true {params.ir[params.ir > 1].tolist()})")

    # 8. timings, CUDA events after the warm-up above
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    pass_ms = []
    for _ in range(2):
        start.record()
        grad_pass(params, scene, ro, rd, k_trace, lambda rad, rows: torch.sum(rad))
        end.record()
        torch.cuda.synchronize()
        pass_ms.append(start.elapsed_time(end))
    fwd_ms, sweep_ms, tangent_ms = split_pass(params, scene, ro, rd, k_trace)
    gt = torch.zeros((p_texels, 3), dtype=torch.float32, device=dev)
    before = cs.LAUNCHES
    run_plain = lambda: [cs.scatter_add_plain(gt, *rows_s) for rows_s in tile_rows]
    run_kernel = lambda: [cs.scatter_add_cuda(gt, *rows_s) for rows_s in tile_rows]
    plain_ms = [cuda_ms(run_plain, 20)]
    kernel_ms = [cuda_ms(run_kernel, 50) for _ in range(2)]
    plain_ms.append(cuda_ms(run_plain, 20))
    _, k_dev = profile_device(lambda: [run_kernel() for _ in range(10)])
    _, p_dev = profile_device(lambda: [run_plain() for _ in range(10)])
    cs.LAUNCHES = before
    tile_wall, tile_dev = profile_device(
        lambda: grad_pass(params, scene, ro[:TILE], rd[:TILE], k_trace,
                          lambda rad, rows: torch.sum(rad)))
    mean_ms = sum(pass_ms) / len(pass_ms)
    print(f"[8] card: {smi}")
    print(f"[8] ms per {SIZE}^2 depth-{DEPTH} fwd+bwd pass: {pass_ms!r} (mean {mean_ms!r}); "
          f"{n / (mean_ms / 1e3)!r} rays/s")
    print(f"[8] split of one pass: taped forward {fwd_ms!r} ms, sweep {sweep_ms!r} ms, "
          f"tangent pass {tangent_ms!r} ms")
    n_rows = sum(t.shape[0] for t, _, _ in tile_rows)
    n_live = sum(int(m.sum()) for _, _, m in tile_rows)
    print(f"[8] K2 on one zy tile's sweep rows ({len(tile_rows)} calls, {n_rows} rows, "
          f"{n_live} live): kernel {kernel_ms!r} ms, plain {plain_ms!r} ms (plain, kernel, "
          f"kernel, plain)")
    if k_dev and p_dev and tile_dev:
        print(f"[8] device time per tile's rows (torch.profiler, 10 runs): kernel "
              f"{sum(ms for _, ms in k_dev.values()) / 10!r} ms, plain "
              f"{sum(ms for _, ms in p_dev.values()) / 10!r} ms")
        busy = sum(ms for _, ms in tile_dev.values())
        print(f"[8] profiled fwd+bwd of one {TILE}-ray tile: wall {tile_wall!r} ms, device busy "
              f"{busy!r} ms ({busy / tile_wall!r} of wall), "
              f"{sum(c for c, _ in tile_dev.values())} device kernels")
        for name, (c, ms) in sorted(tile_dev.items(), key=lambda kv: -kv[1][1])[:8]:
            print(f"[8]   {ms!r} ms in {c} launches: {name[:90]}")
    else:
        print("[8] torch.profiler saw no device time: device share not measured")
    return dict(launches, k2_err=k2_err, k2_ms=sum(kernel_ms) / 2, k2_plain_ms=sum(plain_ms) / 2)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ray_tracing_tpu_torch import Renderer, RendererParam, load_scene_json
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.ops import _build
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_scatter as cs
    from ray_tracing_tpu_torch.ops import rng

    dev = torch.device("cuda")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s) visible, this run uses cuda:0")
    bundle = load_scene_json(os.path.join(ROOT, "data", "zy_scene.json"))
    scene = bundle.scene.to(dev)

    # 1. build K1 and K2, one nvcc each, in parallel
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(_build.build, [ci.SOURCE, cs.SOURCE]))
    print(f"[1] built {', '.join(os.path.relpath(lib, ROOT) for lib in libs)} "
          f"in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())

    # 2. K1 against its plain version on the card
    sph, rect = ci.pack_primitive_tables(scene)
    cam = Camera.build(bundle.camera, 1.0).to(dev)
    ro, rd, _, _ = camera_rays(cam, rng.key(0), 1024, 1024)
    err = compare_k1(ci, sph, rect, ro.contiguous(), rd.contiguous(), "1024^2 zy camera rays")
    tile_ro, tile_rd = interior_rays(65536, 0)
    err = max(err, compare_k1(ci, sph, rect, tile_ro, tile_rd, "65536 random rays (seed 0)"))

    # 3. the main path
    param = RendererParam(1024, 1024, max_depth=20)
    renderer = Renderer(param, bundle.camera, bundle.scene, device="cuda")
    ci.LAUNCHES = 0
    t0 = time.perf_counter()
    images = [renderer.render(k) for k in range(4)]
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = ci.LAUNCHES
    print(f"[3] rendered 4 passes of zy at 1024^2 depth 20 (tile {renderer.tile_size}) "
          f"in {main_s:.2f} s; K1 launches {launches}")
    check(launches > 0, "the main path launched K1")
    for k, img in enumerate(images):
        mean = float(img.mean())
        print(f"[3] pass {k}: mean {mean:.6f} max {float(img.max()):.4f}")
        check(img.shape == (1024, 1024, 3) and img.device.type == "cuda", f"pass {k} shape/device")
        check(bool(torch.isfinite(img).all()) and bool((img >= 0).all()), f"pass {k} finite, >= 0")
        check(0.1 < mean < 0.4, f"pass {k} mean {mean} in 0.1-0.4")
    check(torch.equal(images[0], renderer.render(0)), "render(0) twice is equal")
    print("[3] render(0) repeated: torch.equal")

    # 4. compaction equals the dense loop; the card agrees with the CPU
    small = RendererParam(256, 256, max_depth=20)
    img_c, seg_c = Renderer(small, bundle.camera, bundle.scene, device="cuda").render_with_stats(7)
    img_d, seg_d = Renderer(small, bundle.camera, bundle.scene, device="cuda",
                            compaction=False).render_with_stats(7)
    check(torch.equal(img_c, img_d) and seg_c == seg_d, "trace_compacted equals trace at 256^2")
    print(f"[4] 256^2 depth 20: compacted == dense (torch.equal), {seg_c} segments each")
    tiny = RendererParam(64, 64, max_depth=1)
    on_card = Renderer(tiny, bundle.camera, bundle.scene, device="cuda").render(0).cpu()
    on_cpu = Renderer(tiny, bundle.camera, bundle.scene, device="cpu").render(0)
    share = float((on_card == on_cpu).all(dim=-1).float().mean())
    print(f"[4] 64^2 depth 1: {share:.6f} of pixels equal to the CPU render")
    check(share >= 0.999, "depth-1 image on the card equals the CPU render")

    # 5. timings
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    pass_ms = []
    for key in (10, 11, 12):  # warm: phase 3 ran the same path
        start.record()
        renderer.render(key)
        end.record()
        torch.cuda.synchronize()
        pass_ms.append(start.elapsed_time(end))
    start.record()
    _, segments = renderer.render_with_stats(20)
    end.record()
    torch.cuda.synchronize()
    stats_s = start.elapsed_time(end) / 1e3
    args = (sph, rect, tile_ro, tile_rd, 1e-3, float("inf"))
    before = ci.LAUNCHES
    plain_ms = [cuda_ms(lambda: ci.phase_a_plain(*args), 50)]
    kernel_ms = [cuda_ms(lambda: ci.phase_a_cuda(*args), 200) for _ in range(2)]
    plain_ms.append(cuda_ms(lambda: ci.phase_a_plain(*args), 50))
    _, k_dev = profile_device(lambda: [ci.phase_a_cuda(*args) for _ in range(20)])
    _, p_dev = profile_device(lambda: [ci.phase_a_plain(*args) for _ in range(20)])
    ci.LAUNCHES = before
    k_ms, p_ms = sum(kernel_ms) / 2, sum(plain_ms) / 2
    small_renderer = Renderer(small, bundle.camera, bundle.scene, device="cuda")
    small_renderer.render(30)
    pass_wall, pass_dev = profile_device(lambda: small_renderer.render(31))
    print(f"[5] card: {smi}")
    print(f"[5] ms per 1024^2 depth-20 pass: {pass_ms!r} (mean {sum(pass_ms) / 3!r})")
    print(f"[5] render_with_stats: {segments} segments in {stats_s!r} s = "
          f"{segments / stats_s!r} segments/s")
    print(f"[5] K1 on a 65536-ray tile: kernel {kernel_ms!r} ms, plain {plain_ms!r} ms "
          f"(plain, kernel, kernel, plain)")
    if k_dev and p_dev:
        print(f"[5] device time per call (torch.profiler, 20 calls): kernel "
              f"{sum(ms for _, ms in k_dev.values()) / 20!r} ms, plain "
              f"{sum(ms for _, ms in p_dev.values()) / 20!r} ms in "
              f"{sum(n for n, _ in p_dev.values()) / 20!r} device kernels")
        busy = sum(ms for _, ms in pass_dev.values())
        print(f"[5] profiled 256^2 depth-20 pass: wall {pass_wall!r} ms, device busy "
              f"{busy!r} ms ({busy / pass_wall!r} of wall), "
              f"{sum(n for n, _ in pass_dev.values())} device kernels")
        top = sorted(pass_dev.items(), key=lambda kv: -kv[1][1])[:8]
        for name, (n, ms) in top:
            print(f"[5]   {ms!r} ms in {n} launches: {name[:90]}")
    else:
        print("[5] torch.profiler saw no device time: device share not measured")

    grad = gradient_phases(scene, bundle, smi)

    # one K1 entry per path, each with the count of its own run
    k1 = {
        "route": "cuda",
        "source": "ray_tracing_tpu_torch/csrc/intersect.cu",
        "replaces": "ray_tracing_tpu/ops/pallas_intersect.py:116",
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }
    k2 = {
        "name": "scatter_add (K2), fwd+bwd",
        "route": "cuda",
        "source": "ray_tracing_tpu_torch/csrc/scatter.cu",
        "replaces": "ray_tracing_tpu/ops/pallas_scatter.py:82",
        "launches": grad["k2_launches"],
        "max_abs_err": grad["k2_err"],
        "ms": grad["k2_ms"],
        "plain_ms": grad["k2_plain_ms"],
    }
    record = {"kernels": [
        {"name": "phase_a (K1), forward render", **k1, "launches": launches},
        {"name": "phase_a (K1), fwd+bwd", **k1, "launches": grad["k1_launches"]},
        k2,
    ]}
    print(json.dumps(record))
    print(smi)
    # the run uses one device, cuda:0 (the count of visible devices is
    # printed on the first line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
