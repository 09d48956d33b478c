"""Time an earlier build of the phase-A kernels K1, K3 and K4
(csrc/intersect.cu, per-row tables) and of the atlas scatter-add K2
(csrc/scatter.cu, through its own wrapper) against this checkout's, in
turns, on chip_smoke.py's tiles.

Run from the root of a checkout, on one NVIDIA GPU:

    mkdir -p scratch/old
    for f in csrc/intersect.cu csrc/scatter.cu ops/cuda_scatter.py; do
        git show <commit>:ray_tracing_tpu_torch/$f > scratch/old/$(basename $f)
    done
    python3 kernels_ab.py scratch/old [scratch/arm ...]

Each further directory is an arm: a variant of this checkout's
intersect.cu or scatter.cu (either or both, with this checkout's entry
points), timed beside the others under the directory's name.

Phase A: K1 on zy's 65,536 random rays (chip_smoke phase 5), K3 on
scene.json's (phase 13), K4 on the motion scene's 65,536 rays at seeded
times (phase 19).  Every variant is first held against phase_a_plain
(found, kind and idx equal, t bit-equal), then timed in turns (old, new,
the arms, then the same in reverse): torch.profiler device ms per launch
and CUDA-event ms per call.

K2: one zy tile's sweep rows into the gradient table [gimg | gcol | gmet]
(chip_smoke phase 8): the old build (one call per stage where its
wrapper takes one stage, else one call), the new (one call over the
three stages) and the arms,
index_add_ and the deterministic index_put_ on the live rows selected
beforehand, and an empty kernel launched through ctypes.  The new kernel
and every arm are held bit for bit against the plain version on the CPU.
Device ms are per tile (every launch of a call).  Every time is printed
beside chip_smoke's bound (phase_a_bound, k2_bound) and the card's name
and power limit.  The last line of the output is one JSON object with
every number.
"""

from __future__ import annotations

import ctypes
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
INF = float("inf")


def main(old_dir: str, arm_dirs) -> int:
    import torch
    from ray_tracing_tpu_torch import load_scene_json, scenes
    from ray_tracing_tpu_torch.models.camera import Camera, camera_rays
    from ray_tracing_tpu_torch.ops import _build
    from ray_tracing_tpu_torch.ops import cuda_intersect as ci
    from ray_tracing_tpu_torch.ops import cuda_scatter as csc
    from ray_tracing_tpu_torch.ops import rng

    if not torch.cuda.is_available():
        raise SystemExit("kernels_ab.py needs an NVIDIA GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    sources = {("new", "pa"): ci.SOURCE, ("new", "k2"): csc.SOURCE,
               ("old", "pa"): os.path.join(old_dir, "intersect.cu"),
               ("old", "k2"): os.path.join(old_dir, "scatter.cu")}
    for d in arm_dirs:
        for kind, name in (("pa", "intersect.cu"), ("k2", "scatter.cu")):
            if os.path.exists(os.path.join(d, name)):
                sources[os.path.basename(os.path.normpath(d)), kind] = os.path.join(d, name)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(_build.build, sources.values())))
    print(f"built {', '.join(p.name for p in paths.values())} in {time.perf_counter() - t0:.2f} s")
    libs = {key: ctypes.CDLL(str(path)) for key, path in paths.items() if key[0] != "new"}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs["old", "pa"].phase_a_launch.argtypes = [p, i, i, i, p, i, i, p, p, p, i, f, f, p, p, p, p]
    for (name, kind), lib in libs.items():
        if name != "old" and kind == "pa":
            lib.phase_a_launch.argtypes = [p, i, p, i, p, i, i, i, p, p, p, i, f, f, p, p, p, p]
        if name != "old" and kind == "k2":
            csc.bind(lib)
    # the old build's own wrapper, loaded from its file and pointed at its
    # source (built above), which it loads and binds itself
    spec = importlib.util.spec_from_file_location("old_scatter", os.path.join(old_dir,
                                                                             "cuda_scatter.py"))
    old_wrapper = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old_wrapper)
    old_wrapper.SOURCE = Path(old_dir, "scatter.cu")
    old_wrapper._library()
    # a wrapper of one stage a call, (gimg, texel, contrib, mask), or of
    # every stage in one call, (gimg, segments)
    per_stage = len(inspect.signature(old_wrapper.scatter_add_cuda).parameters) == 4
    arms = sorted({name for name, _ in libs} - {"old"})
    stream = lambda: torch.cuda.current_stream().cuda_stream
    record = {"card": smi, "phase_a": [], "k2": None}

    def check(err):
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")

    def outputs(n):
        return (torch.empty(n, dtype=torch.float32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev))

    def phase_a_variants(scene, ro, rd, t_ray):
        """{variant: fn() -> (t, kind, idx)}: the old build on the per-row
        tables, the new one and the arms on the cached tables."""
        sph, rect = (x.contiguous() for x in ci.pack_primitive_tables(scene))
        tb = scene.phase_a
        n, tr = ro.shape[0], None if t_ray is None else t_ray.data_ptr()
        ptr = lambda x: x.data_ptr()

        def old():
            out = outputs(n)
            check(libs["old", "pa"].phase_a_launch(
                ptr(sph), sph.shape[0], int(sph.shape[1] == 16), int(sph.shape[1] == 7),
                ptr(rect), rect.shape[0], int(rect.shape[1] == 26), ptr(ro), ptr(rd), tr, n,
                1e-3, INF, *map(ptr, out), stream()))
            return out

        def arm(lib):
            def run():
                out = outputs(n)
                check(lib.phase_a_launch(
                    ptr(tb.sph), tb.sph.shape[0], ptr(tb.rect), tb.rect.shape[0], ptr(tb.slots),
                    int(tb.sph_tf), int(tb.rect_tf), int(tb.sph_motion), ptr(ro), ptr(rd), tr, n,
                    1e-3, INF, *map(ptr, out), stream()))
                return out
            return run

        v = {"old": old, "new": lambda: ci.phase_a_cuda(tb, ro, rd, 1e-3, INF, t_ray)}
        v.update({name: arm(libs[name, "pa"]) for name in arms if (name, "pa") in libs})
        return v

    def measure_phase_a(kernel, scene, ro, rd, t_ray=None):
        scene = scene.to(dev)
        want = ci.phase_a_plain(scene.phase_a, ro, rd, 1e-3, INF, t_ray)
        v = phase_a_variants(scene, ro, rd, t_ray)
        for name, fn in v.items():
            ok = all(torch.equal(a, b) for a, b in zip(fn(), want))
            print(f"[ab] {kernel} {name} vs plain: found, kind, idx equal and t bit-equal {ok}")
            if not ok:
                raise RuntimeError(f"{kernel} {name} disagrees with phase_a_plain")
        bnd = cs.phase_a_bound(ci, scene.phase_a, ro.shape[0])
        dev_ms = {k: [] for k in v}
        ev_ms = {k: [] for k in v}
        for name in list(v) + list(reversed(v)):
            dev_ms[name].append(cs.device_ms(v[name], 10, "phase_a_kernel"))
            ev_ms[name].append(cs.cuda_ms(v[name], 50))
        record["phase_a"].append({"kernel": kernel, "rays": ro.shape[0],
                                  "hits": int((want[1] >= 0).sum()), "bound_ms": bnd[0],
                                  "bound_by": bnd[1], "device_ms": dev_ms, "events_ms": ev_ms})
        for name in v:
            report(kernel, name, dev_ms[name], ev_ms[name], bnd, "")

    def report(kernel, name, dev_ms, ev_ms, bnd, unit):
        d = [x for x in dev_ms if isinstance(x, float)]
        share = (f", share {bnd[0] / max(d):.4f}-{bnd[0] / min(d):.4f} of the bound "
                 f"{bnd[0]!r} ms ({bnd[1]})" if d else "")
        print(f"[ab] {kernel} {name}: device {dev_ms!r} ms{unit}, events {ev_ms!r} ms{share}")

    # phase A: K1 (zy), K3 (scene.json), K4 (motion)
    zy = load_scene_json(os.path.join(ROOT, "data", "zy_scene.json"))
    box_ro, box_rd = cs.interior_rays(cs.TILE, 0)
    measure_phase_a("K1", zy.scene, box_ro, box_rd)
    sj = load_scene_json(os.path.join(ROOT, "data", "scene.json"))
    measure_phase_a("K3", sj.scene, box_ro, box_rd)
    m_ro, m_rd, m_t = cs.motion_rays(cs.TILE, 0)
    measure_phase_a("K4", scenes.motion_blur()[0], m_ro, m_rd, m_t)

    # K2: one zy tile's sweep rows into the table [gimg | gcol | gmet]
    scene = zy.scene.to(dev)
    ro, rd, _, k_trace = camera_rays(Camera.build(zy.camera, 1.0).to(dev), rng.key(0), cs.SIZE,
                                     cs.SIZE, True)
    rows, p_table = cs.tile_segments(scene, ro, rd, k_trace, cs.DEPTH)
    gt = torch.zeros((p_table, 3), dtype=torch.float32, device=dev)
    idx = torch.cat([t[m & (t >= 0)] for t, _, m in rows]).long()
    vals = torch.cat([c[m & (t >= 0)] for t, c, m in rows])
    n_rows = sum(t.shape[0] for t, _, _ in rows)

    def old_tile(g):
        if not per_stage:
            return old_wrapper.scatter_add_cuda(g, rows)
        for t, c, m in rows:
            old_wrapper.scatter_add_cuda(g, t, c, m)
        return g

    def k2_arm(lib):
        """The arm's build through this checkout's wrapper, with a scratch
        of its own."""
        consts = (lib, lib.scatter_add_max_segments(), lib.scatter_add_max_blocks(),
                  lib.scatter_add_block_rows(), {})

        def run(g=None):
            g = gt if g is None else g
            names = ("_lib", "_max_segments", "_max_blocks", "_block_rows", "_scratch")
            csc._library()
            saved = [getattr(csc, n) for n in names]
            for n, v in zip(names, consts):
                setattr(csc, n, v)
            try:
                return csc.scatter_add_cuda(g, rows)
            finally:
                for n, v in zip(names, saved):
                    setattr(csc, n, v)
        return run

    want = csc.scatter_add_plain(torch.zeros((p_table, 3)),
                                 [tuple(x.cpu() for x in r) for r in rows])
    k2 = {"old": old_tile, "new": lambda g=gt: csc.scatter_add_cuda(g, rows)}
    k2.update({name: k2_arm(libs[name, "k2"]) for name in arms if (name, "k2") in libs})
    for name, fn in k2.items():
        got = fn(torch.zeros_like(gt)).cpu()
        again = fn(torch.zeros_like(gt)).cpu()
        equal = torch.equal(got, want)
        print(f"[ab] K2 {name} vs plain on the CPU: torch.equal {equal}, max |d| "
              f"{float((got - want).abs().max())!r}; two runs torch.equal "
              f"{torch.equal(got, again)}")
        if name != "old" and not (equal and torch.equal(got, again)):
            raise RuntimeError(f"K2 {name} disagrees with its plain version on the CPU")

    def put():
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            gt.index_put_((idx,), vals, accumulate=True)
        finally:
            torch.use_deterministic_algorithms(was)

    empty = csc._library().empty_launch
    v = {**{name: (lambda fn=fn: fn(gt)) for name, fn in k2.items()},
         "index_add_": lambda: gt.index_add_(0, idx, vals),
         "index_put_ (deterministic)": put, "empty kernel": lambda: empty(stream())}
    bnd = cs.k2_bound(csc, rows)
    x = torch.zeros(1 << 20, device=dev)

    def k2_device(name):
        """Device ms per tile of a K2 variant, from one torch.profiler
        session of 10 tiles paired with a small PyTorch op: each kernel's
        ms per launch seen (a session can miss the first ctypes launch),
        summed over the kernels of a call, times the calls per tile."""
        _, trace = cs.profile_device(lambda: [(v[name](), x.add_(1.0)) for _ in range(10)])
        per = {k: ms / n for k, (n, ms) in trace.items() if "scatter_add" in k}
        split[name].append(per)
        calls = len(rows) if name == "old" and per_stage else 1
        return sum(per.values()) * calls if per else "not measured"

    split = {name: [] for name in k2}  # device ms per launch of each kernel of a call
    dev_ms = {k: [] for k in v}
    ev_ms = {k: [] for k in v}
    for name in list(v) + list(reversed(v)):
        if name in k2:
            dev_ms[name].append(k2_device(name))
        elif name == "empty kernel":  # a ctypes launch, paired with a PyTorch op
            dev_ms[name].append(cs.device_ms(v[name], 10, "empty_kernel"))
        else:
            _, trace = cs.profile_device(lambda: [v[name]() for _ in range(10)])
            dev_ms[name].append(sum(ms for _, ms in trace.values()) / 10 if trace
                                else "not measured")
        ev_ms[name].append(cs.cuda_ms(v[name], 50))
    for name in k2:
        print(f"[ab] K2 {name}, device ms per launch of each kernel: {split[name]!r}")
    record["k2"] = {"rows": n_rows, "live": idx.numel(), "split": split,
                    "texels": int(torch.unique(idx).numel()), "bound_ms": bnd[0],
                    "bound_by": bnd[1], "device_ms": dev_ms, "events_ms": ev_ms}
    print(f"[ab] K2 on one zy tile's sweep rows: {n_rows} rows, {idx.numel()} live, "
          f"{record['k2']['texels']} texels")
    for name in v:
        report("K2", name, dev_ms[name], ev_ms[name], bnd, " per tile")
    print(smi)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2:]))
