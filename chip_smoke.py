"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. build the K1 phase-A kernel (csrc/intersect.cu) with nvcc for sm_90a;
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
     tile.
The last lines are a JSON kernel record, the card's name and power
limit, and a JSON device record.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ray_tracing_tpu_torch import Renderer, RendererParam, load_scene_json
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import rng

    dev = torch.device("cuda")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    bundle = load_scene_json(os.path.join(ROOT, "data", "zy_scene.json"))
    scene = bundle.scene.to(dev)

    # 1. build K1
    t0 = time.perf_counter()
    lib = ci.build()
    print(f"[1] built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.2f} s")
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

    record = {"kernels": [{
        "name": "phase_a (K1)",
        "route": "cuda",
        "source": "ray_tracing_tpu_torch/csrc/intersect.cu",
        "replaces": "ray_tracing_tpu/ops/pallas_intersect.py:116",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
