"""CLI frontend of the port: progressive render of a JSON scene to an
image file, the counterpart of ``ray_tracing_tpu/cli.py`` (reference
src/main.rs).

One 1-spp full-image pass per iteration with a log line each
(``Iter N +Ts``), a save every ``--save-interval`` seconds when new
passes landed (``Iter N saved``), and exit on Enter when run on a
terminal without ``--iterations``.  Pass ``i`` draws
``rng.fold_in(rng.key(seed), i)``, so a render resumed from
``--checkpoint`` continues the key sequence of one uninterrupted run.
It runs on the GPU unless ``--device cpu`` is given, and exits with a
message when the device asked for is missing.

Run: ``python -m ray_tracing_tpu_torch.cli -i data/zy_scene.json -o out.bmp``
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ray-tracing-tpu-torch",
        description="progressive Monte Carlo path tracer on an NVIDIA GPU (PyTorch / CUDA)",
    )
    p.add_argument("-i", "--input", required=True, help="input scene JSON")
    p.add_argument("-o", "--output", required=True,
                   help="output image (.bmp/.png; other formats need Pillow; "
                        ".hdr = linear Radiance RGBE)")
    p.add_argument("--iterations", type=int, default=0,
                   help="stop after N 1-spp passes (0 = run until Enter)")
    p.add_argument("--seed", type=int, default=0, help="base RNG seed")
    p.add_argument("--save-interval", type=float, default=5.0,
                   help="seconds between progressive saves (reference: 5 s)")
    p.add_argument("--max-depth", type=int, default=None,
                   help="override the scene's max ray depth")
    p.add_argument("--width", type=int, default=None, help="override render width")
    p.add_argument("--height", type=int, default=None, help="override render height")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file: resume from it if present, save to it on "
                        "every progressive save")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace into this directory")
    p.add_argument("--stats", default=None,
                   help="write per-pass timing/throughput JSON here on exit")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; cpu runs the "
                        "kernels' plain versions)")
    return p


def _save(args, result, img) -> None:
    from ray_tracing_tpu_torch.utils.checkpoint import save_render
    from ray_tracing_tpu_torch.utils.image import save_hdr, save_image

    if args.output.lower().endswith(".hdr"):
        save_hdr(args.output, result.mean())  # linear radiance out
    else:
        save_image(args.output, img)
    if args.checkpoint:
        save_render(args.checkpoint, result, args.seed)


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         "(torch.cuda.is_available() is False); pass --device cpu to "
                         "render on the CPU")

    from ray_tracing_tpu_torch import Renderer, RenderResult, load_scene_json
    from ray_tracing_tpu_torch.ops import rng
    from ray_tracing_tpu_torch.utils.checkpoint import load_render
    from ray_tracing_tpu_torch.utils.profiling import RenderStats, torch_trace

    bundle = load_scene_json(args.input, noise_seed=args.seed)
    rparam = bundle.renderer
    if args.width:
        rparam.width = args.width
    if args.height:
        rparam.height = args.height
    if args.max_depth:
        rparam.max_depth = args.max_depth

    renderer = Renderer(rparam, bundle.camera, bundle.scene, device=device)
    result = RenderResult(rparam.width, rparam.height)
    stats = RenderStats(verbose=False)
    if args.checkpoint and os.path.exists(args.checkpoint):
        result, ckpt_seed = load_render(args.checkpoint)
        if ckpt_seed != args.seed:
            print(f"warning: checkpoint seed {ckpt_seed} != --seed {args.seed}; "
                  "using checkpoint seed", flush=True)
            args.seed = ckpt_seed
        if (result.width, result.height) != (rparam.width, rparam.height):
            raise SystemExit("checkpoint resolution does not match the render")
        print(f"resumed at iteration {result.count}", flush=True)

    stop = threading.Event()
    if args.iterations == 0 and sys.stdin is not None and sys.stdin.isatty():
        def wait_enter():
            try:
                sys.stdin.readline()
            except (OSError, ValueError):
                pass
            stop.set()

        threading.Thread(target=wait_enter, daemon=True).start()
        print("rendering; press Enter to stop", flush=True)

    key = rng.key(args.seed)
    last_saved = 0
    last_save_time = time.perf_counter()
    iteration = result.count  # continues a resumed render's key sequence
    try:
        with torch_trace(args.profile, device):
            while not stop.is_set():
                if args.iterations and iteration >= args.iterations:
                    break
                stats.start_pass()
                pass_key = rng.fold_in(key, iteration)
                if args.stats:
                    colors, segments = renderer.render_with_stats(pass_key)  # int(): synced
                else:
                    colors, segments = renderer.render(pass_key), 0.0
                # add() copies the image to the host, so the pass ends after
                # its device work
                iteration = result.add(colors)
                rec = stats.end_pass(segments)
                print(f"Iter {iteration} +{rec.seconds:.3f}s", flush=True)
                now = time.perf_counter()
                if now - last_save_time >= args.save_interval:
                    raw = result.get_raw(last_saved)
                    if raw is not None:
                        img, last_saved = raw
                        _save(args, result, img)
                        print(f"Iter {last_saved} saved", flush=True)
                    last_save_time = now
    except KeyboardInterrupt:
        pass

    raw = result.get_raw(0)
    if raw is not None:
        img, n = raw
        _save(args, result, img)
        print(f"Iter {n} saved", flush=True)
    if args.stats:
        stats.dump(args.stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
