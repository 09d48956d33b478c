#!/usr/bin/env python
"""Weak-scaling harness of the PyTorch port, the counterpart of
``bench_scaling.py``: the production fwd+bwd (compacted forward and PRB
backward of the color table, ``render/prb.py:prb_radiance``) over k
ranks of a ``torch.distributed`` process group, each rank holding the
same ray load, so that

    efficiency(k) = rays/s/rank (k ranks) / rays/s/rank (1 rank)

is the per-rank throughput retained.  For each k, k processes are
started (``torch.multiprocessing``) and join one group through
``parallel/distributed.py`` (``file_rendezvous`` under ``build/``):
NCCL with each rank bound to its own card, or gloo on the CPU with
``--force-cpu``, where the ranks share the host's cores (the efficiency
then measures the code path, not the interconnect).  Without
``--force-cpu`` and without a GPU the script exits 1; it never falls
back.  The kernels are built once, in this process, before any rank
starts; each rank prints its own count of builds (0: it only loaded).

Each rank draws its own ``--rays-per-device`` zy camera rays from the
key folded with its rank and traces them under the pass's one trace key
with ray ids offset by ``rank * rays_per_device`` (the port's uniforms
are keyed by ray id, parallel/mesh.py), then the loss (the radiance sum
over all rays, divided by their count) and the color gradient are summed
over the ranks by one ``all_reduce`` (parallel/mesh.py:all_reduce_sum).
So the sharded pass equals the unsharded pass of the same rays up to
the order of the sums.  Traced segments are counted untimed on the same
keys (``trace(..., with_stats=True)``, as bench_scaling.py counts them);
the passes are timed with one synchronize after the last.  Rank 0's
launches of K1 (phase A) and K2 (the gradient scatter) in the timed
passes go into its line (``launches``; 0 on the CPU, where the plain
versions run).

With the unsharded baseline (default on) rank 0 then runs the same
total ray load alone, on one device (with every core on the CPU), and
``sharding_overhead`` = sharded time / unsharded time; its loss, color
gradient and segment count are printed beside the sharded ones.

Prints one JSON line per k with bench_scaling.py's keys, and a final
efficiency line when more than one k ran.

Run: python bench_scaling_torch.py [--devices 1,2] [--rays-per-device 16384]
     [--depth 10] [--passes 3] [--force-cpu] [--no-unsharded-baseline]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _rays(camera, per: int, rank: int):
    """Rank ``rank``'s camera rays: uniform viewport points and lens and
    time uniforms from the id-keyed hash under key(7) folded with the
    rank."""
    import torch

    from ray_tracing_tpu_torch.ops import rng

    ids = torch.arange(per, device=camera.origin.device)
    u = rng.ray_uniforms(rng.fold_in(rng.key(7), rank), ids, 0, 5)
    ro, rd, _ = camera.get_rays(u[:, 0:2], u[:, 2], u[:, 3], u[:, 4])
    return ro, rd


def _fwd_bwd(scene, ro, rd, key, depth: int, ids_base: int, n: int):
    """(loss part, color gradient part) of one pass over these rays."""
    from ray_tracing_tpu_torch.render.prb import prb_radiance

    colors = scene.textures.color.detach().clone().requires_grad_(True)
    rad = prb_radiance(colors, scene, ro, rd, key, depth, ids_base=ids_base)
    loss = rad.sum() / n
    loss.backward()
    return loss.detach().reshape(1), colors.grad


def _segments(scene, ro, rd, key, depth: int, ids_base: int, tile: int = 65536):
    """Traced segments of these rays under ``key`` (the dense trace)."""
    from ray_tracing_tpu_torch.render.integrator import trace

    total = 0
    for s in range(0, ro.shape[0], tile):
        _, seg = trace(scene, ro[s:s + tile], rd[s:s + tile], key, depth, with_stats=True,
                       ids_base=ids_base + s)
        total += int(seg)
    return total


def _rank(rank: int, k: int, init: str, args, cpu: bool, queue) -> None:
    """One rank of the k-rank run; rank 0 puts the JSON record on ``queue``."""
    import torch
    import torch.distributed as dist

    from ray_tracing_tpu_torch import load_scene_json
    from ray_tracing_tpu_torch.models.camera import Camera
    from ray_tracing_tpu_torch.ops import _build
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_scatter as cs
    from ray_tracing_tpu_torch.ops import rng
    from ray_tracing_tpu_torch.parallel import distributed
    from ray_tracing_tpu_torch.parallel.mesh import all_reduce_sum, make_mesh

    cores = os.cpu_count() or 1
    if cpu:
        torch.set_num_threads(max(1, cores // k))
    distributed.initialize("gloo" if cpu else "nccl", init_method=init, world_size=k, rank=rank)
    mesh = make_mesh("cpu" if cpu else "cuda")
    dev = mesh.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    bundle = load_scene_json(os.path.join(ROOT, "data", "zy_scene.json"))
    scene = bundle.scene.to(dev)
    camera = Camera.build(bundle.camera, 1.0).to(dev)
    per, depth, passes = args.rays_per_device, args.depth, args.passes
    n = per * k
    ro, rd = _rays(camera, per, rank)
    base = rank * per

    def sharded(key):
        return all_reduce_sum(mesh, list(_fwd_bwd(scene, ro, rd, key, depth, base, n)))

    # untimed: the traced segments of the timed passes' keys, over the ranks
    counts = torch.tensor([_segments(scene, ro, rd, rng.key(i), depth, base)
                           for i in range(1, passes + 1)], dtype=torch.float64, device=dev)
    total_segments = float(all_reduce_sum(mesh, [counts])[0].sum())

    loss, grad = sharded(rng.key(0))  # warm-up, and the parity pass
    sync()
    if mesh.collective:
        dist.barrier()
    ci.LAUNCHES = cs.LAUNCHES = 0
    t0 = time.perf_counter()
    outs = [sharded(rng.key(i)) for i in range(1, passes + 1)]
    sync()
    dt = time.perf_counter() - t0
    launches = {"k1": ci.LAUNCHES, "k2": cs.LAUNCHES}
    del outs
    sys.stdout.write(f"rank {rank} of {k} on {dev}: {_build.COMPILES} kernel builds in this "
                     f"rank; launches in the timed passes {launches}\n")  # one write a line
    sys.stdout.flush()

    if rank == 0:
        rays_per_s = total_segments / dt
        rec = {
            "metric": f"sharded fwd+bwd rays/s ({k} devices)",
            "value": rays_per_s,
            "unit": "rays/s",
            "per_device": rays_per_s / k,
            "devices": k,
            "segments_per_pass": total_segments / passes,
            "primary_rays_per_pass": n,
            "backend": "gloo" if cpu else "nccl",
            "loss": float(loss[0]),
            "color_grad": grad.cpu().tolist(),
            "launches": launches,
        }
        if not args.no_unsharded_baseline:
            # the same total work, one process, no collective
            if cpu:
                torch.set_num_threads(cores)
            parts = [_rays(camera, per, r) for r in range(k)]
            all_ro = torch.cat([p[0] for p in parts])
            all_rd = torch.cat([p[1] for p in parts])
            u_segments = sum(_segments(scene, all_ro, all_rd, rng.key(i), depth, 0)
                             for i in range(1, passes + 1))
            u_loss, u_grad = _fwd_bwd(scene, all_ro, all_rd, rng.key(0), depth, 0, n)
            sync()
            t0 = time.perf_counter()
            outs = [_fwd_bwd(scene, all_ro, all_rd, rng.key(i), depth, 0, n)
                    for i in range(1, passes + 1)]
            sync()
            dt_u = time.perf_counter() - t0
            del outs
            rec.update({
                "unsharded_same_work_s": dt_u / passes,
                "sharded_s": dt / passes,
                "sharding_overhead": dt / dt_u,
                "unsharded_segments_per_pass": u_segments / passes,
                "unsharded_loss": float(u_loss[0]),
                "unsharded_color_grad": u_grad.cpu().tolist(),
            })
        queue.put(rec)
    if mesh.collective:
        dist.barrier()
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default=None,
                    help="comma list of rank counts (default: 1,2,4,... up to the devices)")
    ap.add_argument("--rays-per-device", type=int, default=16384)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--force-cpu", action="store_true",
                    help="gloo ranks on the CPU (up to 8), sharing the host's cores")
    ap.add_argument("--no-unsharded-baseline", action="store_true",
                    help="skip the same-total-work unsharded timing")
    args = ap.parse_args(argv)

    import torch
    import torch.multiprocessing as mp

    from ray_tracing_tpu_torch.parallel.distributed import file_rendezvous

    cpu = args.force_cpu
    if cpu:
        n_avail = min(8, os.cpu_count() or 1)
    elif torch.cuda.is_available():
        n_avail = torch.cuda.device_count()
    else:
        raise SystemExit("bench_scaling_torch.py: no CUDA device is available "
                         "(torch.cuda.is_available() is False); pass --force-cpu for gloo "
                         "ranks on the CPU")
    if args.devices:
        counts = [int(x) for x in args.devices.split(",")]
    else:
        counts = [k for k in (1, 2, 4, 8, 16, 32, 64) if k <= n_avail]
    if max(counts) > n_avail:
        raise SystemExit(f"--devices {args.devices}: only {n_avail} devices")

    if not cpu:
        from ray_tracing_tpu_torch.ops import _build
        from ray_tracing_tpu_torch.ops import cuda_intersect as ci
        from ray_tracing_tpu_torch.ops import cuda_scatter as cs

        _build.build_all([ci.SOURCE, cs.SOURCE])  # the ranks only load
    ctx = mp.get_context("spawn")
    results = {}
    for k in counts:
        queue = ctx.SimpleQueue()
        with file_rendezvous(os.path.join(ROOT, "build")) as init:
            mp.spawn(_rank, args=(k, init, args, cpu, queue), nprocs=k, join=True)
        rec = queue.get()
        results[k] = rec["per_device"]
        print(json.dumps(rec), flush=True)

    if len(results) > 1:
        k_max = max(results)
        print(json.dumps({
            "metric": f"scaling efficiency 1->{k_max} devices",
            "value": results[k_max] / results[min(results)],
            "unit": "fraction",
            "target": 0.85,
            "note": ("gloo ranks share the host's cores; the >=85% target applies on real "
                     "multi-card hardware" if cpu else "real multi-device measurement"),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
