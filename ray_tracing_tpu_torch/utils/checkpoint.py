"""Checkpoint and resume, the counterpart of
``ray_tracing_tpu/utils/checkpoint.py``, in the same npz container
with the same keys and magic strings, so either package reads the
other's files.

A progressive render is a monotone ``(sum, count)`` accumulator and its
pass keys are ``fold_in(key(seed), i)``, so ``(sum, count, seed)``
captures a render in flight: pass ``i`` of a resumed render draws the
key it would have drawn in one run.  Differentiable-fit state (a color
table, the optimizer step and extras) uses the same container.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ray_tracing_tpu_torch.render.renderer import RenderResult

_MAGIC = "ray_tracing_tpu.render.v1"
_FIT_MAGIC = "ray_tracing_tpu.fit.v1"


def _check_magic(data, magic: str, path: str) -> None:
    if str(data["magic"]) != magic:
        raise ValueError(f"{path!r} is not a {magic} checkpoint")


def save_render(path: str, result: RenderResult, seed: int) -> None:
    """Write (sum, count, seed, width, height) to ``path`` atomically
    (a ``.tmp`` file, then ``os.replace``)."""
    tmp = path + ".tmp"
    tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"  # savez appends .npz
    np.savez_compressed(tmp, magic=_MAGIC, sum=result.sum, count=result.count, seed=seed,
                        width=result.width, height=result.height)
    os.replace(tmp, path)


def load_render(path: str) -> Tuple[RenderResult, int]:
    """-> (RenderResult with the accumulated passes, seed)."""
    with np.load(path, allow_pickle=False) as data:
        _check_magic(data, _MAGIC, path)
        result = RenderResult(int(data["width"]), int(data["height"]))
        result.sum = np.asarray(data["sum"], np.float32)
        result.count = int(data["count"])
        return result, int(data["seed"])


def save_fit(path: str, *, step: int, color_table: np.ndarray,
             extra: Optional[dict] = None) -> None:
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp, magic=_FIT_MAGIC, step=step, color=np.asarray(color_table),
        **{f"extra_{k}": np.asarray(v) for k, v in (extra or {}).items()},
    )
    os.replace(tmp, path)


def load_fit(path: str) -> Tuple[int, np.ndarray, dict]:
    """-> (step, color table, extras)."""
    with np.load(path, allow_pickle=False) as data:
        _check_magic(data, _FIT_MAGIC, path)
        extra = {k[len("extra_"):]: np.asarray(v) for k, v in data.items()
                 if k.startswith("extra_")}
        return int(data["step"]), np.asarray(data["color"]), extra
