"""Renderer frontend: progressive one-sample-per-pixel passes, the
PyTorch counterpart of ``ray_tracing_tpu/render/renderer.py`` (reference
src/renderer.rs:72-332, 335-406).

``Renderer.render(key)`` produces one full-image 1-spp pass of linear
radiance on the renderer's device, ``render_to_noise`` repeats passes
until a noise target; ``RenderResult`` accumulates passes
and tone-maps.  Rays are traced in fixed-size tiles, so the
(rays x primitives) candidate grids of the plain phase A stay bounded.
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Optional

import numpy as np
import torch

from ray_tracing_tpu_torch.models.camera import Camera, CameraParam, camera_rays, stamp_shutter
from ray_tracing_tpu_torch.models.scene import SceneData
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.render.integrator import trace, trace_compacted


@dataclasses.dataclass
class RendererParam:
    """reference renderer.rs:42-51 (max_depth default 20: renderer.rs:331;
    antialias default true: renderer.rs:49-50)."""

    width: int
    height: int
    max_depth: Optional[int] = None
    antialias: Optional[bool] = None

    @classmethod
    def from_json(cls, d: dict) -> "RendererParam":
        return cls(
            width=d["width"],
            height=d["height"],
            max_depth=d.get("max_depth"),
            antialias=d.get("antialias"),
        )


def _pick_tile_size(n_rays: int, n_prims: int, grid_budget: int = 4_194_304) -> int:
    """Bound the (tile x primitives) candidate grid to ``grid_budget``
    entries, with tiles of 512 to 65536 rays.  The grid is the plain
    phase A's; on the card K1 loops over the table inside the kernel, so
    a CUDA renderer passes ``n_prims=0`` and its tile is bounded by the
    ray count and 65536 alone."""
    budget = grid_budget // max(n_prims, 1)
    tile = 512
    while tile * 2 <= min(budget, n_rays, 65536):
        tile *= 2
    return tile


def render_pass(scene: SceneData, camera: Camera, key, *, width: int, height: int,
                max_depth: int, antialias: bool, tile_size: int,
                with_stats: bool = False, compaction: bool = True):
    """One full-image 1-spp pass -> (H, W, 3) linear radiance on the
    scene's device; with ``with_stats`` also the traced segment count.

    Every tile is traced under the one trace key with globally unique
    ray ids (``ids_base``), so the image does not depend on the tile
    size."""
    n = width * height
    scene = stamp_shutter(scene, camera)
    ro, rd, _time, k_trace = camera_rays(camera, key, width, height, antialias)
    colors = torch.empty((n, 3), dtype=torch.float32, device=ro.device)
    segments = torch.zeros((), dtype=torch.int64, device=ro.device)
    fn = trace_compacted if compaction else trace
    for start in range(0, n, tile_size):
        stop = min(start + tile_size, n)
        out = fn(scene, ro[start:stop], rd[start:stop], k_trace, max_depth,
                 with_stats=with_stats, ids_base=start)
        if with_stats:
            out, seg = out
            segments = segments + seg
        colors[start:stop] = out
    img = colors.reshape(height, width, 3)
    return (img, segments) if with_stats else img


class Renderer:
    """A compiled scene and camera on one device (reference
    Renderer::new, renderer.rs:84-93).  ``device`` is required: the
    renderer never guesses where to run."""

    def __init__(self, param: RendererParam, camera: CameraParam, scene: SceneData, *,
                 device, tile_size: Optional[int] = None, compaction: bool = True):
        self.param = param
        self.device = torch.device(device)
        self.scene = scene.to(self.device)
        self.camera = Camera.build(camera, param.width / param.height).to(self.device)
        self.tile_size = tile_size or _pick_tile_size(
            param.width * param.height,
            scene.n_spheres + scene.n_rects if self.device.type == "cpu" else 0,
        )
        self.max_depth = param.max_depth if param.max_depth is not None else 20
        self.antialias = param.antialias if param.antialias is not None else True
        self._pass_opts = dict(
            width=param.width,
            height=param.height,
            max_depth=self.max_depth,
            antialias=self.antialias,
            tile_size=self.tile_size,
            compaction=compaction,
        )

    @staticmethod
    def _as_key(key):
        """An int seed becomes ``rng.key(seed)``; a 2-word key passes."""
        if isinstance(key, (int, np.integer)):
            return rng.key(int(key))
        key = np.asarray(key, np.uint32)
        if key.shape != (2,):
            raise ValueError(f"a key is 2 uint32 words, got shape {key.shape}")
        return key

    @torch.no_grad()
    def render(self, key) -> torch.Tensor:
        """One 1-spp pass; ``key`` is an int seed or a 2-word key.
        Returns (H, W, 3) float32 linear radiance on the device."""
        return render_pass(self.scene, self.camera, self._as_key(key), **self._pass_opts)

    @torch.no_grad()
    def render_with_stats(self, key):
        """(image, traced segment count), on the same code path as
        :meth:`render`."""
        img, segments = render_pass(self.scene, self.camera, self._as_key(key),
                                    with_stats=True, **self._pass_opts)
        return img, int(segments)

    def accumulate(self, key, acc=None) -> torch.Tensor:
        """Fold one pass into a device-resident sum image and return it."""
        img = self.render(key)
        return img if acc is None else acc + img

    @torch.no_grad()
    def render_to_noise(self, key, *, target_rel_err: float = 0.02, max_passes: int = 4096,
                        min_passes: int = 8, check_every: int = 16):
        """Render passes until the Monte-Carlo error estimate drops below
        ``target_rel_err``.  Pass ``n`` draws ``rng.fold_in(key, n)``; the
        per-pixel sum and sum of squares stay on the device, and every
        ``check_every`` passes (from ``min_passes`` on) one scalar, the
        mean over pixels of the luminance standard error over
        (luminance + 1e-3), is read on the host.  Returns
        ``(mean image (H, W, 3) np.float32, passes, rel_err)``."""
        key = self._as_key(key)
        shape = (self.param.height, self.param.width, 3)
        s = torch.zeros(shape, dtype=torch.float32, device=self.device)
        s2 = torch.zeros_like(s)
        n = 0
        rel = float("inf")
        while n < max_passes:
            img = self.render(rng.fold_in(key, n))
            s = s + img
            s2 = s2 + img * img
            n += 1
            if n >= min_passes and (n % check_every == 0 or n == max_passes):
                rel = float(_noise_criterion(s, s2, n))
                if rel <= target_rel_err:
                    break
        return s.cpu().numpy() / n, n, rel

    async def render_async(self, key) -> np.ndarray:
        """Awaitable :meth:`render` (reference renderer.rs:449-476), run in
        the event loop's default executor; returns the (H, W, 3) numpy
        array of linear radiance."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, lambda: self.render(key).cpu().numpy())


_LUMA = (0.2126, 0.7152, 0.0722)


def _noise_criterion(s: torch.Tensor, s2: torch.Tensor, n: int) -> torch.Tensor:
    """Mean over pixels of the luminance standard error over (luminance +
    1e-3), from the float32 per-pixel sum ``s`` and sum of squares ``s2``
    of ``n`` passes (Bessel-corrected variance), as a 0-d float32 tensor."""
    nf = torch.tensor(float(n), dtype=torch.float32, device=s.device)
    w = torch.tensor(_LUMA, dtype=torch.float32, device=s.device)
    mean = s / nf
    var = torch.clamp(s2 / nf - mean * mean, min=0.0) * nf / torch.clamp(nf - 1, min=1.0)
    lum = (mean * w).sum(-1)
    lvar = (var * w ** 2).sum(-1)
    stderr = torch.sqrt(lvar / nf)
    return (stderr / (lum + 1e-3)).mean()


class RenderResult:
    """Progressive accumulator (reference renderer.rs:335-406): ``add``
    folds in one 1-spp pass, ``get_raw`` tone-maps to u8 bytes."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.sum = np.zeros((height, width, 3), dtype=np.float32)
        self.count = 0

    def add(self, colors) -> int:
        """colors: (H, W, 3) linear radiance of one pass (tensor or array)."""
        if isinstance(colors, torch.Tensor):
            colors = colors.detach().cpu().numpy()
        self.sum += np.asarray(colors, dtype=np.float32)
        self.count += 1
        return self.count

    def get_raw(self, last: int = 0):
        """u8 RGB bytes after mean + sqrt gamma (renderer.rs:369-406);
        returns (bytes_array (H, W, 3) u8, count) or None when no new
        passes landed since ``last``."""
        if self.count <= last:
            return None
        vals = np.sqrt(self.sum / self.count) * 256.0
        vals = np.where(np.isnan(vals), 0.0, np.clip(vals, 0.5, 255.5))
        return vals.astype(np.uint8), self.count

    def mean(self) -> np.ndarray:
        """Linear mean image."""
        return self.sum / max(self.count, 1)
