"""Time two builds of the triangle sweeps K5 and K6 on the same card, in
turns, on chip_smoke.py's tiles: this checkout's csrc/triangles.cu and an
earlier one whose K5 takes no cluster boxes (the dense sweep) and whose
K6 takes (loads, sweeps, pairs) stats.

Run from the root of a checkout, on one NVIDIA GPU:

    git show <commit>:ray_tracing_tpu_torch/csrc/triangles.cu > scratch/triangles_old.cu
    python3 sweep_ab.py scratch/triangles_old.cu

For each tile (scene.json: the busiest 800^2 camera-ray tile, the
bunny-aimed tile, the secondary tile; C6: the busiest 512^2 camera-ray
tile, the secondary tile) every variant is first held against the plain
version (found and idx equal, t bit-equal on hits), then timed in turns
(old, new, any arms, then the same in reverse): torch.profiler device
ms per call and CUDA-event ms per call.  Where this checkout's library has another
build of its kernels as ``<kernel>_<arm>_launch`` (an arm of a design
measurement, ARMS), that arm is a variant too.  The ray order of
ray_order (direction octant, then Morton code of the origin) is timed
as well: the kernel on the sorted tile, and sort + gather + kernel +
scatter back.  Every time is printed beside the needed pairs,
chip_smoke.sweep_bound and the share; the new kernel's per-warp list
lengths and sweeps are printed too.  The last line of the output is
one JSON object with every number.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
INF = float("inf")
# the arms measured while K5 and K6 were redesigned (PERF.md, section 6):
# rows read through L1, every cluster one ray at a time, a test without
# early exits, one staging buffer, both, listing without group boxes,
# 256-cluster list pages, two rays per one-ray-at-a-time step, both; a
# library without such an entry point skips it
ARMS = ("direct", "narrow", "flat", "single", "single_flat", "ungrouped", "list256", "pair2",
        "list256_pair2")


def _spread10(x):
    """The low 10 bits of int64 ``x`` moved to every third bit."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def ray_order(aabb, origin, ro, rd):
    """(N,) int64 permutation of the rays: by direction octant, then by
    the 30-bit Morton code of the origin in the box of ``aabb`` (the
    frame of ``origin``), ties in ray order."""
    import torch

    lo, hi = aabb[:, 0:3].amin(dim=0), aabb[:, 3:6].amax(dim=0)
    cell = ((ro - origin - lo) / torch.clamp_min(hi - lo, 1e-30) * 1024.0).clamp(0.0, 1023.0)
    q = cell.to(torch.int64)
    code = _spread10(q[:, 0]) | (_spread10(q[:, 1]) << 1) | (_spread10(q[:, 2]) << 2)
    neg = (rd < 0).to(torch.int64)
    octant = neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2)
    return torch.argsort((octant << 30) | code, stable=True)


def main(old_source: str) -> int:
    import torch
    from ray_tracing_tpu_torch import load_scene_json, scenes
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.ops import _build
    from ray_tracing_tpu_torch.ops import cuda_triangles as ct
    from ray_tracing_tpu_torch.ops import rng

    if not torch.cuda.is_available():
        raise SystemExit("sweep_ab.py needs an NVIDIA GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        new_path, old_path = pool.map(_build.build, [ct.SOURCE, old_source])
    print(f"built {new_path.name} and {old_path.name} in {time.perf_counter() - t0:.2f} s")
    new = ct._library()
    old = ctypes.CDLL(str(old_path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old.triangle_sweep_launch.argtypes = [p, i, p, p, p, i, f, f, p, p, p, p]
    old.cluster_sweep_launch.argtypes = [p, i, p, i, p, p, p, i, f, f, p, p, p, p, p]
    arms = {}
    for name in ("triangle_sweep", "cluster_sweep"):
        for arm in ARMS:
            fn = getattr(new, f"{name}_{arm}_launch", None)
            if fn is not None:
                fn.argtypes = [p, i, p, i, p, p, p, i, f, f, p, p, p, p, p]
                arms[name, arm] = fn

    def outputs(n):
        return (torch.empty(n, dtype=torch.float32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.bool, device=dev))

    def call(fn, *args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    def variants(tr, ro, rd, kernel: str, stats=None):
        """{variant: fn() -> (t, idx, found)} for the table and tile;
        ``stats`` (int32 (3,)) gains the new variants' counts."""
        n, nt, kc = ro.shape[0], tr.v0.shape[0], tr.sw_aabb.shape[0]
        ptr = lambda x: x.data_ptr()
        common = (ptr(tr.sw_origin), ptr(ro), ptr(rd), n, 1e-3, INF)

        def old_fn():
            out = outputs(n)
            if kernel == "triangle_sweep":
                call(old.triangle_sweep_launch, ptr(tr.sw_table), nt, *common, *map(ptr, out))
            else:
                call(old.cluster_sweep_launch, ptr(tr.sw_table), nt, ptr(tr.sw_aabb), kc, *common,
                     *map(ptr, out), None)
            return out

        def new_fn(fn):
            def run():
                out = outputs(n)
                call(fn, ptr(tr.sw_table), nt, ptr(tr.sw_aabb), kc, *common, *map(ptr, out),
                     None if stats is None else ptr(stats))
                return out
            return run

        v = {"old": old_fn, "new": new_fn(getattr(new, f"{kernel}_launch"))}
        v.update({arm: new_fn(fn) for (name, arm), fn in arms.items() if name == kernel})
        return v

    def ordered(tr, ro, rd, run_on):
        """Sort the tile by ray_order, sweep, scatter the winners back."""
        perm = ray_order(tr.sw_aabb, tr.sw_origin, ro, rd)
        t, idx, found = run_on(ro[perm].contiguous(), rd[perm].contiguous())
        out = outputs(ro.shape[0])
        out[0][perm], out[1][perm], out[2][perm] = t, idx, found
        return out

    record = {"card": smi, "tiles": []}

    def measure(scene_name, tr, kernel, tiles, plain):
        for label, ro, rd in tiles:
            want = plain(ro, rd)
            for name in variants(tr, ro, rd, kernel):
                stats = torch.zeros(3, dtype=torch.int32, device=dev)
                got = variants(tr, ro, rd, kernel, stats)[name]()
                cs.agree("ab", f"{kernel} {name} vs plain, {scene_name} {label}", ro.shape[0],
                         got, want)
                if name != "old":
                    print(f"[ab]   {name}: "
                          f"{cs.sweep_stats(ct, stats, ro.shape[0], tr.sw_aabb.shape[0])}")
            v = variants(tr, ro, rd, kernel)
            pairs, tri_pairs = cs.needed_work(ct, tr, ro, rd, want[0], want[2])
            bnd = cs.sweep_bound(ro.shape[0], tr.v0.shape[0], tr.sw_aabb.shape[0], pairs,
                                 tri_pairs)
            turns = list(v) + list(reversed(v))
            dev_ms = {k: [] for k in v}
            ev_ms = {k: [] for k in v}
            for name in turns:
                dev_ms[name].append(cs.device_ms(v[name], 5, "sweep_kernel"))
                ev_ms[name].append(cs.cuda_ms(v[name], 10))
            # the ray order: the new kernel on the sorted tile, and the whole
            # sort + gather + kernel + scatter (not in the port: it did not pay)
            perm = ray_order(tr.sw_aabb, tr.sw_origin, ro, rd)
            s_ro, s_rd = ro[perm].contiguous(), rd[perm].contiguous()
            on_sorted = variants(tr, s_ro, s_rd, kernel)["new"]
            launch = getattr(ct, f"{kernel}_cuda")
            run_on = lambda a, b: launch(tr.sw_table, tr.sw_aabb, tr.sw_origin, a, b, 1e-3, INF)
            got = ordered(tr, ro, rd, run_on)
            cs.agree("ab", f"{kernel} new on the sorted tile, scattered back, vs unsorted, "
                     f"{scene_name} {label}", ro.shape[0], got, v["new"]())
            sorted_dev = cs.device_ms(on_sorted, 5, "sweep_kernel")
            whole = lambda: ordered(tr, ro, rd, run_on)
            whole_ev = [cs.cuda_ms(whole, 10), cs.cuda_ms(v["new"], 10), cs.cuda_ms(whole, 10)]
            _, trace = cs.profile_device(lambda: [whole() for _ in range(5)])
            whole_dev = sum(ms for _, ms in trace.values()) / 5 if trace else "not measured"
            row = {"scene": scene_name, "kernel": kernel, "tile": label, "rays": ro.shape[0],
                   "hits": int(want[2].sum()), "needed_pairs": pairs, "bound_ms": bnd[0],
                   "bound_by": bnd[1], "device_ms": dev_ms, "events_ms": ev_ms,
                   "sorted_device_ms": sorted_dev,
                   "sort_sweep_scatter_events_ms (whole, unsorted, whole)": whole_ev,
                   "sort_sweep_scatter_device_ms": whole_dev}
            record["tiles"].append(row)
            print(f"[ab] {scene_name} {label}: {json.dumps(row)}")
            for name in v:
                d = [x for x in dev_ms[name] if isinstance(x, float)]
                if d:
                    print(f"[ab]   {kernel} {name}: device {min(d)!r}-{max(d)!r} ms, share "
                          f"{bnd[0] / max(d):.4f}-{bnd[0] / min(d):.4f} of the bound "
                          f"{bnd[0]!r} ms ({bnd[1]})")

    # scene.json: K5
    bundle = load_scene_json(os.path.join(ROOT, "data", "scene.json"))
    tr = bundle.scene.triangles.to(dev)
    ro, rd, _, _ = camera_rays(Camera.build(bundle.camera, 1.0).to(dev), rng.key(0), cs.SJ_SIZE,
                               cs.SJ_SIZE)
    ro, rd = ro.contiguous(), rd.contiguous()
    dense = lambda a, b: [torch.cat(x) for x in zip(*[
        ct.triangle_sweep_plain(tr.sw_table, tr.sw_origin, a[s:s + cs.TILE], b[s:s + cs.TILE],
                                1e-3, INF) for s in range(0, a.shape[0], cs.TILE)])]
    cam = dense(ro, rd)
    whole = cs.TILE * (ro.shape[0] // cs.TILE)
    busiest = int(cam[2][:whole].reshape(-1, cs.TILE).sum(dim=1).argmax())
    tile = slice(busiest * cs.TILE, (busiest + 1) * cs.TILE)
    tiles = [(f"camera-ray tile {busiest}", ro[tile].contiguous(), rd[tile].contiguous()),
             ("bunny-aimed tile", *cs.bunny_rays(cs.TILE, 0)),
             ("secondary tile", *cs.secondary_rays(tr, ro, rd, *cam, cs.TILE, 0))]
    measure("scene.json", tr, "triangle_sweep", tiles, dense)

    # C6: K6
    host_scene, cam_param, _ = scenes.bunny_grid()
    tr = host_scene.triangles.to(dev)
    ro, rd, _, _ = camera_rays(Camera.build(cam_param, 1.0).to(dev), rng.key(0), cs.C6_SIZE,
                               cs.C6_SIZE)
    ro, rd = ro.contiguous(), rd.contiguous()
    clustered = lambda a, b: [torch.cat(x) for x in zip(*[
        ct.cluster_sweep_plain(tr, a[s:s + cs.TILE], b[s:s + cs.TILE], 1e-3, INF)
        for s in range(0, a.shape[0], cs.TILE)])]
    cam = clustered(ro, rd)
    busiest = int(cam[2].reshape(-1, cs.TILE).sum(dim=1).argmax())
    tile = slice(busiest * cs.TILE, (busiest + 1) * cs.TILE)
    tiles = [(f"camera-ray tile {busiest}", ro[tile].contiguous(), rd[tile].contiguous()),
             ("secondary tile", *cs.secondary_rays(tr, ro, rd, *cam, cs.TILE, 0))]
    measure("C6", tr, "cluster_sweep", tiles, clustered)

    print(smi)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1]))
