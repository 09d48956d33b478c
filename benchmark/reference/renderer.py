"""The renderer's settings as the scene JSON gives them (reference
renderer.rs:42-51), which the reference's compiler returns."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class RendererParam:
    width: int
    height: int
    max_depth: Optional[int] = None
    antialias: Optional[bool] = None

    @classmethod
    def from_json(cls, d: dict) -> "RendererParam":
        return cls(width=d["width"], height=d["height"], max_depth=d.get("max_depth"),
                   antialias=d.get("antialias"))
