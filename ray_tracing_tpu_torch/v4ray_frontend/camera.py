"""Camera plugin, as a declarative field table (see plugin.py).

Role parity: reference `v4ray_frontend/camera.py` (PerspectiveCamera
with its 14 scalar fields and the pinhole-aperture preview).  The
project-JSON layout (``look_from``/``look_at``/``up`` packed triples
plus scalar keys) is fixed by the document format; the packing is
expressed through field slots instead of hand-written dict code.

A copy of ``v4ray_frontend_tpu/camera.py`` whose only change is its
imports; it builds the port's façade objects."""

from __future__ import annotations

import ray_tracing_tpu_torch.v4ray as v4ray
from ray_tracing_tpu_torch.v4ray_frontend.plugin import CameraType
from ray_tracing_tpu_torch.v4ray_frontend.properties import FloatProperty

__all__ = ["CameraType", "PerspectiveCamera"]


def _triple(label, key, defaults=(0.0, 0.0, 0.0)):
    return tuple(
        FloatProperty(f"{label} {axis}", default=d, slot=(key,))
        for axis, d in zip("xyz", defaults)
    )


class PerspectiveCamera(CameraType):
    KIND = "perspective"
    FIELDS = (
        *_triple("position", "look_from", (0.0, 0.0, -10.0)),   # 0-2
        *_triple("look at", "look_at"),                          # 3-5
        FloatProperty("vertical fov (deg)", default=20, slot="vfov",
                      check=lambda v: 0 < float(v) < 180),       # 6
        *_triple("up", "up", (0.0, 1.0, 0.0)),                   # 7-9
        FloatProperty("aperture", default=0.0, slot="aperture",
                      check=lambda v: float(v) >= 0),            # 10
        FloatProperty("focus distance", default=10.0, slot="focus_dist",
                      check=lambda v: float(v) > 0),             # 11
        FloatProperty("shutter time 0", default=0.0, slot="time0"),  # 12
        FloatProperty("shutter time 1", default=0.0, slot="time1"),  # 13
    )

    @classmethod
    def rule(cls, data):
        return float(data[12]) <= float(data[13])

    @classmethod
    def _build(cls, data, aperture):
        return v4ray.PerspectiveCameraParam(
            look_from=tuple(data[0:3]),
            look_at=tuple(data[3:6]),
            vfov=data[6],
            up=tuple(data[7:10]),
            aperture=aperture,
            focus_dist=data[11],
            time0=data[12],
            time1=data[13],
        )

    @classmethod
    def apply(cls, data):
        return cls._build(data, data[10])

    @classmethod
    def apply_preview(cls, data):
        # the live preview is single-sample; defocus blur would be pure
        # noise there, so force a pinhole
        return cls._build(data, 0.0)
