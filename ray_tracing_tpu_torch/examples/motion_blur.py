"""True motion blur demo, the port's counterpart of
``examples/motion_blur.py`` with the same flags, defaults and outputs,
plus ``--device`` (default ``cuda``; without a GPU it exits 1).

Three spheres, static red, slow green and fast blue, over a checker
floor under a sky (scenes.motion_blur).  Each primary ray samples one
shutter time from the camera's [0, 1] window, keyed by its id
(ops/rng.py:ray_time), so the image is reproducible; on the card the
moving spheres take K4.  Pass ``i`` draws ``rng.fold_in(rng.key(0), i)``.

Run: python -m ray_tracing_tpu_torch.examples.motion_blur
     [--out renders/motion_blur.png] [--size 384] [--spp 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

from ray_tracing_tpu_torch import Renderer, RendererParam, scenes
from ray_tracing_tpu_torch.examples import device_of
from ray_tracing_tpu_torch.examples.render_baselines import tone_map
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.utils.image import save_image


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="renders/motion_blur.png")
    ap.add_argument("--size", type=int, default=384)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    scene, cam, _ = scenes.motion_blur()
    r = Renderer(RendererParam(args.size, args.size, max_depth=8), cam, scene, device=device)
    acc = None
    for i in range(args.spp):
        acc = r.accumulate(rng.fold_in(rng.key(0), i), acc)
    img = acc.cpu().numpy() / args.spp

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_image(args.out, tone_map(img))
    print(f"motion blur demo -> {args.out}  mean={img.mean():.4f}")
    return float(img.mean())


if __name__ == "__main__":
    main()
