#!/usr/bin/env python
"""The port's data-parallel path over K ranks of one host, the
counterpart of ``__graft_entry__.py:dryrun_multichip`` at full width on
real cards: zy (``data/zy_scene.json``) at ``--size``^2 (1024) and depth
``--depth`` (20).

``python3 multicard_torch.py [--ranks K] [--depth D] [--size S] [--cpu]``
starts K processes (``torch.multiprocessing``, default K: every card).
Each is an NCCL rank bound to its own card (parallel/distributed.py), or
with ``--cpu`` a gloo rank on the CPU.  The script exits 1 with a
message when there is no GPU and no ``--cpu``, when K exceeds the cards,
or when a rank fails; it never puts two ranks on one card and never
turns to gloo or to the CPU when a card or NCCL fails.  The kernels are
built once, here, before any rank starts; every rank then only loads
them (its ``_build.COMPILES`` is 0, checked).

Every rank runs, under one key:

1. ``sharded_render_pass``: on rank 0 the gathered image is
   ``torch.equal`` to the same function at world 1 (a ``Mesh`` with
   ``collective=False`` on rank 0's card, in the same process);
2. ``make_prb_train_step_all_direct`` (the bench's fwd+bwd, sharded
   through ``tiled_loss_and_grad``): on rank 0 its loss and five updated
   leaves against the world-1 step within the one-card bound (loss rtol
   1e-6, leaves rtol 1e-6 and atol 1e-9: the ranks' partial sums are
   added in another order), each one's share of it printed.  The traced
   segments summed over the ranks equal the one-card step's; where each
   rank's shard is a run of whole tiles of the one-card pass
   (``renderer.tile_rule``: on the card that pass is one tile, so at one
   rank; with ``--cpu`` tiles of 65,536, so 1024^2 over 1, 2 or 4
   ranks), so do K2's calls, and the render pass's K1 launches (step 1:
   the forward's trace) equal world 1's.  The step's K1
   launches are printed beside world 1's: each rank runs its own tangent
   pass over its touched rays;
3. ``make_prb_train_step_all`` (the autograd surface): equal to the
   direct step to dryrun_multichip's tolerances (loss 1e-5 relative,
   leaves rtol 1e-4 and atol 1e-7), its color-linear leaves bit for bit;
4. ``make_prb_train_step`` (colors only) on zy and ``make_train_step``
   (dense autograd) on the flagship box at 16^2 and depth 3: finite, the
   colors moved, and on rank 0 within the one-card bound of world 1 (as
   in 2);
5. K1 and K2 on every rank's card against their plain versions on that
   rank's own first tile, by chip_smoke.py's own checks (path_kernels:
   winners and t bit-equal; compare_k2: twice, bit-equal to its plain
   version on the CPU), timed there in turns beside the plain versions
   (K2 also beside ``index_add_``, time_k2), each with its bound;
6. the rank's ms per sharded fwd+bwd step (the direct step once more,
   from a barrier), and the ms and bytes of the gradients' flat
   ``all_reduce`` and of the image ``all_gather``, each line stamped with
   the rank's card's ``nvidia-smi`` name and power limit.

The last line is one JSON object: the rank count, the backend and every
rank's record (its counts, checks and times); rank 0 checks that no two
ranks were on one card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
LR = 0.1  # dryrun_multichip's learning rate
FLAG_SIZE, FLAG_DEPTH = 16, 3  # the dense step's flagship box (dryrun_multichip)
LOSS_RTOL, LEAF_RTOL, LEAF_ATOL = 1e-6, 1e-6, 1e-9  # the one-card bound
DRY_LOSS_RTOL, DRY_RTOL, DRY_ATOL = 1e-5, 1e-4, 1e-7  # __graft_entry__.py:145-149
COLOR_LINEAR = ("color", "images", "metal_albedo")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def flagship_scene(builder_cls):
    """__graft_entry__.py:_flagship_scene: a Cornell box with every
    material family and an important light."""
    b = builder_cls(background=(0.0, 0.0, 0.0))
    white = b.add_lambertian(b.add_texture_solid((0.73, 0.73, 0.73)))
    red = b.add_lambertian(b.add_texture_solid((0.65, 0.05, 0.05)))
    green = b.add_lambertian(b.add_texture_solid((0.12, 0.45, 0.15)))
    checker = b.add_lambertian(b.add_texture_checker(
        b.add_texture_solid((1.0, 0.0, 0.0)), b.add_texture_solid((0.0, 1.0, 0.0)), 0.05))
    light = b.add_diffuse_light(b.add_texture_solid((10.86, 7.76, 6.2)))
    glass = b.add_dielectric(1.5)
    metal = b.add_metal((0.9, 0.9, 0.9), 0.05)
    b.add_rect("xy", 0, 555, 0, 555, 555, white, positive=False)
    b.add_rect("zx", 0, 555, 0, 555, 0, checker, positive=True)
    b.add_rect("zx", 0, 555, 0, 555, 555, white, positive=False)
    b.add_rect("yz", 0, 555, 0, 555, 555, red, positive=False)
    b.add_rect("yz", 0, 555, 0, 555, 0, green, positive=True)
    b.add_rect("zx", 187, 372, 187, 372, 554.999, light, positive=False, important=True)
    b.add_sphere((190, 120, 200), 90, glass)
    b.add_sphere((380, 120, 300), 90, metal)
    b.add_sphere((277, 350, 277), 70, white)
    return b.build()


def card_line(dev) -> str:
    """Card ``dev``'s line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``, found by the card's UUID: nvidia-smi lists
    every card of the host, whatever ``CUDA_VISIBLE_DEVICES`` hides."""
    import torch

    uuid = str(torch.cuda.get_device_properties(dev).uuid).lower().removeprefix("gpu-")
    out = subprocess.run(["nvidia-smi", "--query-gpu=uuid,name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout
    for line in out.strip().splitlines():
        card_uuid, name_limit = line.split(",", 1)
        if card_uuid.strip().lower().removeprefix("gpu-") == uuid:
            return name_limit.strip()
    raise RuntimeError(f"nvidia-smi lists no card of UUID {uuid}: {out!r}")


def gap(got, want, rtol: float, atol: float) -> float:
    """The largest |got - want| / (atol + rtol |want|): at most 1 within
    the bound."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max()) if got.numel() else 0.0


def _rank(rank: int, k: int, init: str, args, cpu: bool, queue) -> None:
    """One rank; rank 0 checks that no two ranks shared a card and puts
    every rank's record on ``queue``."""
    import torch
    import torch.distributed as dist

    from ray_tracing_tpu_torch.parallel import distributed

    if cpu:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // k))
    distributed.initialize("gloo" if cpu else "nccl", init_method=init, world_size=k, rank=rank)
    try:
        rec = run_rank(args, cpu)
        recs = [None] * k
        dist.all_gather_object(recs, rec)
        if rank == 0:
            cards = [r["device"] for r in recs]
            check(cpu or len(set(cards)) == k, f"every rank on a card of its own: {cards}")
            queue.put(recs)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_rank(args, cpu: bool) -> dict:
    """Steps 1-6 on this rank of the initialised group; returns its record."""
    import torch
    import torch.distributed as dist

    import ray_tracing_tpu_torch as prt
    from ray_tracing_tpu_torch.models.camera import Camera
    from ray_tracing_tpu_torch.ops import _build
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_scatter as cs
    from ray_tracing_tpu_torch.ops import rng
    from ray_tracing_tpu_torch.parallel import mesh as pm
    from ray_tracing_tpu_torch.render.integrator import trace
    from ray_tracing_tpu_torch.render.prb_scalar import AllParams, _tiles, params_of
    from ray_tracing_tpu_torch.render.renderer import tile_rule

    mesh = pm.make_mesh("cpu" if cpu else "cuda")
    rank, k, dev = mesh.rank, mesh.world, mesh.device
    one = pm.Mesh(None, 0, 1, dev, False)  # world 1 on this rank's card
    card = "cpu (gloo)" if cpu else card_line(dev)

    def say(msg: str) -> None:  # one write per line: the ranks share the stream
        sys.stdout.write(f"[rank {rank}] {msg}\n")
        sys.stdout.flush()

    def sync() -> None:
        if not cpu:
            torch.cuda.synchronize(dev)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def counted(fn):
        """``fn()`` timed, with K1's and K2's counts from 0."""
        ci.LAUNCHES = cs.LAUNCHES = 0
        out, ms = timed(fn)
        return out, ms, {"k1": ci.LAUNCHES, "k2": cs.LAUNCHES}

    if not cpu:
        check(torch.cuda.current_device() == dev.index,
              f"rank {rank}: the current card is {torch.cuda.current_device()}, not {dev}")
        check(_build.COMPILES == 0, f"rank {rank} built {_build.COMPILES} kernel(s) itself")
    say(f"of {k} on {dev} ({card}), backend {dist.get_backend()}; kernel builds in this "
        f"rank: {_build.COMPILES}")

    bundle = prt.load_scene_json(os.path.join(ROOT, "data", "zy_scene.json"))
    scene = bundle.scene.to(dev)
    cam = Camera.build(bundle.camera, 1.0).to(dev)
    size, depth = args.size, args.depth
    n = size * size
    key = rng.key(0)
    target = torch.full((size, size, 3), 0.5, device=dev)
    params = params_of(scene)
    kw = dict(width=size, height=size, max_depth=depth, lr=LR)
    ro_s, rd_s, k_trace, rows, n_pad = pm._rank_rays(cam, key, size, size, mesh)
    per = n_pad // k
    # the shards are runs of the one-card pass's tiles (tile_rule's, on the
    # card the whole wavefront up to its cap): the counts add up
    tile = tile_rule(n_pad, dev)
    aligned = n % (8 * k) == 0 and tile_rule(per, dev) == tile and per % tile == 0
    rec = {"rank": rank, "device": str(dev), "card": card, "compiles": _build.COMPILES}

    def reduced(values: dict) -> dict:
        (out,) = pm.all_reduce_sum(mesh, [torch.tensor(list(values.values()),
                                                       dtype=torch.float64, device=dev)])
        return dict(zip(values, (int(x) for x in out)))

    def real_segments(ro, rd, rows_m):
        """Traced segments of the real (unpadded) rays of a shard."""
        real = max(0, min(rows_m.stop, n) - rows_m.start)
        return sum(int(trace(scene, ro[t], rd[t], k_trace, depth, with_stats=True,
                             ids_base=rows_m.start + t.start)[1])
                   for t in _tiles(real, tile_rule(real, dev)))

    def within_one_card_bound(name, got, want, l_got, l_want) -> dict:
        """Checks the loss and each leaf against world 1's within the
        one-card bound; returns each one's largest share of it."""
        share = {"loss": abs(float(l_got) - float(l_want)) / (LOSS_RTOL * abs(float(l_want)))}
        share.update({f: gap(a, b, LEAF_RTOL, LEAF_ATOL) for f, a, b in zip(AllParams._fields,
                                                                           got, want)})
        say(f"{name} against world 1: share of the one-card bound {share}")
        check(all(g <= 1 for g in share.values()), f"{name}: within the one-card bound")
        return share

    # 1. the sharded render pass (the forward's trace), against world 1 on rank 0
    def render(m):
        return pm.sharded_render_pass(scene, cam, key, width=size, height=size,
                                      max_depth=depth, antialias=True, mesh=m)

    with torch.no_grad():
        img, render_ms, render_counts = counted(lambda: render(mesh))
        check(img.shape == (size, size, 3) and bool(torch.isfinite(img).all()),
              "the sharded image is finite, (H, W, 3)")
        render_total = reduced(render_counts)
        if rank == 0:
            img1, _, render_counts1 = counted(lambda: render(one))
            check(torch.equal(img, img1), "the sharded image equals world 1's")
            say(f"[1] sharded_render_pass {size}^2 depth {depth}: torch.equal to world 1; "
                f"mean {float(img.mean())!r}; {render_ms!r} ms at world {k}; K1 launches "
                f"summed over the ranks {render_total['k1']}, world 1 {render_counts1['k1']}")
            if aligned:
                check(render_total["k1"] == render_counts1["k1"],
                      "the render pass's K1 launches summed over the ranks equal world 1's")

    # 2. the direct step, counted
    def direct_step(m):
        step = pm.make_prb_train_step_all_direct(cam, scene, mesh=m, **kw)
        return step, step(params, scene, key, target)

    (step, (p_dir, l_dir)), first_ms, counts = counted(lambda: direct_step(mesh))
    rec["launches"] = dict(counts)
    counts["segments"] = real_segments(ro_s, rd_s, rows)
    total = reduced(counts)
    check(bool(torch.isfinite(l_dir)), "the direct step's loss is finite")
    say(f"[2] make_prb_train_step_all_direct: loss {float(l_dir)!r}; this rank's counts "
        f"{counts}; summed over the ranks {total}")
    rec["summed"] = total
    if rank == 0:
        (_, (p1, l1)), one_ms, counts1 = counted(lambda: direct_step(one))
        ro1, rd1, _, rows1, _ = pm._rank_rays(cam, key, size, size, one)
        counts1["segments"] = real_segments(ro1, rd1, rows1)
        del ro1, rd1
        say(f"[2] world 1: {one_ms!r} ms, loss {float(l1)!r}, counts {counts1}; K1 summed "
            f"over the ranks less world 1's: {total['k1'] - counts1['k1']} (each rank's own "
            f"tangent pass)")
        rec["bound_share"] = within_one_card_bound("[2] the direct step", p_dir, p1, l_dir, l1)
        check(total["segments"] == counts1["segments"],
              "the traced segments summed over the ranks equal world 1's")
        if aligned:
            check(total["k2"] == counts1["k2"], "K2's calls summed over the ranks equal world 1's")
        else:
            say("[2] the shards are not runs of whole tiles: launches not compared")
        rec["world1_counts"] = counts1

    # 3. the autograd surface against the direct step
    step_ad = pm.make_prb_train_step_all(cam, scene, mesh=mesh, **kw)
    p_ad, l_ad = step_ad(params, scene, key, target)
    same = {f: bool(torch.equal(getattr(p_ad, f), getattr(p_dir, f))) for f in COLOR_LINEAR}
    ad_gap = {f: gap(a, b, DRY_RTOL, DRY_ATOL) for f, a, b in zip(AllParams._fields, p_ad, p_dir)}
    say(f"[3] make_prb_train_step_all: loss {float(l_ad)!r} (direct {float(l_dir)!r}); "
        f"color-linear leaves torch.equal {same}; gap of dryrun_multichip's bound {ad_gap}")
    check(abs(float(l_ad) - float(l_dir)) <= DRY_LOSS_RTOL * max(1.0, abs(float(l_dir))),
          "the autograd step's loss equals the direct step's")
    check(all(g <= 1 for g in ad_gap.values()) and all(same.values()),
          "the autograd step equals the direct step")

    # 4. the colour-only PRB step on zy, the dense step on the flagship box
    flag = flagship_scene(prt.SceneBuilder).to(dev)
    flag_cam = Camera.build(prt.CameraParam((278, 278, -800), (278, 278, 0), 40), 1.0).to(dev)
    flag_target = torch.full((FLAG_SIZE, FLAG_SIZE, 3), 0.5, device=dev)
    colour_steps = {
        "make_prb_train_step (zy)": (
            lambda m: pm.make_prb_train_step(cam, mesh=m, **kw), scene, target),
        f"make_train_step (flagship {FLAG_SIZE}^2 depth {FLAG_DEPTH})": (
            lambda m: pm.make_train_step(flag_cam, width=FLAG_SIZE, height=FLAG_SIZE,
                                         max_depth=FLAG_DEPTH, mesh=m, lr=LR), flag, flag_target),
    }
    for name, (make, sc, tg) in colour_steps.items():
        (moved, loss), ms = timed(lambda: make(mesh)(sc, key, tg))
        colors = moved.textures.color
        check(bool(torch.isfinite(loss)) and bool(torch.isfinite(colors).all()),
              f"{name}: finite")
        check(not torch.equal(colors, sc.textures.color), f"{name}: the colors moved")
        say(f"[4] {name}: loss {float(loss)!r}, {ms!r} ms")
        if rank == 0:
            moved1, loss1 = make(one)(sc, key, tg)
            within_one_card_bound(f"[4] {name}", [colors], [moved1.textures.color], loss, loss1)

    # 5. K1 and K2 on this rank's card, on its own first tile
    if not cpu:
        rec.update(kernels_on_card(scene, ro_s, rd_s, k_trace, depth, rows.start, dev,
                                   f"rank {rank}'s first tile ({card})", f"5 rank {rank}"))

    # 6. timings: the step once more, the gradients' all_reduce, the image all_gather
    dist.barrier()
    _, step_ms = timed(lambda: step(params, scene, key, target))
    grads = list(p_dir)
    reps = 10
    pm.all_reduce_sum(mesh, grads)
    _, ar_ms = timed(lambda: [pm.all_reduce_sum(mesh, grads) for _ in range(reps)])
    rows_img = torch.rand((per, 3), device=dev)
    pm._gather_rows(mesh, rows_img)
    _, ag_ms = timed(lambda: [pm._gather_rows(mesh, rows_img) for _ in range(reps)])
    rec.update(
        step_ms=step_ms, first_step_ms=first_ms, render_ms=render_ms,
        all_reduce_ms=ar_ms / reps, all_reduce_bytes=4 * sum(g.numel() for g in grads),
        all_gather_ms=ag_ms / reps, all_gather_bytes=4 * 3 * n_pad)
    say(f"[6] {card}: sharded fwd+bwd step {step_ms!r} ms (the first, counted: "
        f"{first_ms!r} ms); all_reduce of the gradients {rec['all_reduce_ms']!r} ms for "
        f"{rec['all_reduce_bytes']} B; image all_gather {rec['all_gather_ms']!r} ms for "
        f"{rec['all_gather_bytes']} B")
    return rec


def kernels_on_card(scene, ro, rd, k_trace, depth: int, ids_base: int, dev, what: str,
                    tag: str) -> dict:
    """K1 on the first tile of these rays and K2 on that tile's tape
    sweep rows, by chip_smoke.py's checks and timings (path_kernels;
    tile_segments, compare_k2 and time_k2), each with its bound.  The
    launches made here do not count: every count is put back.  Returns
    {"k1": ..., "k2": ...}, as the JSON record holds them."""
    import chip_smoke as smoke
    from ray_tracing_tpu_torch.ops import cuda_scatter as cs

    saved = cs.LAUNCHES
    k1 = smoke.path_kernels(("k1",), scene, ro[:smoke.TILE], rd[:smoke.TILE], what, tag)["k1"]
    segments, p = smoke.tile_segments(scene, ro, rd, k_trace, depth, ids_base=ids_base)
    err = smoke.compare_k2(cs, p, segments, what, tag)
    k2 = smoke.time_k2(cs, p, segments, dev, tag, "zy")
    cs.LAUNCHES = saved
    return {"k1": k1, "k2": {"err": err, "ms": k2["kernel"][0], "plain_ms": k2["plain"][0],
                             "library_ms": k2["index_add_"][0], "bound": k2["bound"]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to start (default: every card; 4 with --cpu)")
    ap.add_argument("--depth", type=int, default=20)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    args = ap.parse_args(argv)

    import torch
    import torch.multiprocessing as mp

    from ray_tracing_tpu_torch.parallel.distributed import file_rendezvous

    if args.cpu:
        k = args.ranks or 4
    elif not torch.cuda.is_available():
        print("multicard_torch.py: no CUDA device is available (torch.cuda.is_available() is "
              "False); pass --cpu for gloo ranks on the CPU", file=sys.stderr)
        return 1
    else:
        count = torch.cuda.device_count()
        k = args.ranks or count
        if k > count:
            print(f"multicard_torch.py: --ranks {k}, but only {count} card(s): two ranks would "
                  "share a card", file=sys.stderr)
            return 1
        from ray_tracing_tpu_torch.ops import _build
        from ray_tracing_tpu_torch.ops import cuda_intersect as ci
        from ray_tracing_tpu_torch.ops import cuda_scatter as cs

        t0 = time.perf_counter()
        _build.build_all([ci.SOURCE, cs.SOURCE])  # the ranks only load
        print(f"built the kernels in {time.perf_counter() - t0:.2f} s "
              f"({_build.COMPILES} nvcc runs)", flush=True)
    if k < 1:
        print(f"multicard_torch.py: --ranks {k}", file=sys.stderr)
        return 1
    backend = "gloo" if args.cpu else "nccl"
    print(f"multicard_torch.py: {k} {backend} rank(s), zy {args.size}^2 depth {args.depth}",
          flush=True)
    queue = mp.get_context("spawn").SimpleQueue()
    t0 = time.perf_counter()
    try:
        with file_rendezvous(os.path.join(ROOT, "build")) as init:
            mp.spawn(_rank, args=(k, init, args, args.cpu, queue), nprocs=k, join=True)
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
        print(f"multicard_torch.py: a rank failed:\n{exc}", file=sys.stderr)
        return 1
    recs = queue.get()
    print(json.dumps({"ranks": k, "backend": backend, "size": args.size, "depth": args.depth,
                      "seconds": time.perf_counter() - t0, "per_rank": recs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
