"""Renderer frontend: progressive one-sample-per-pixel passes, the
PyTorch counterpart of ``ray_tracing_tpu/render/renderer.py`` (reference
src/renderer.rs:72-332, 335-406).

``Renderer.render(key)`` produces one full-image 1-spp pass of linear
radiance on the renderer's device; ``RenderResult`` accumulates passes
and tone-maps.  Rays are traced in fixed-size tiles, so the
(rays x primitives) candidate grids of the plain phase A stay bounded.
"""

from __future__ import annotations

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
    entries, with tiles of 512 to 65536 rays."""
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
            param.width * param.height, scene.n_spheres + scene.n_rects
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
