"""Reference of the web editor's live preview (the ``preview`` loop): the
preview's semantics applied to a reference-schema scene, the edits of
the loop's mix applied to such a scene by object index, and a whole
preview image, tone-mapped as the editor's PNG.

Written from the upstream editor's semantics (``State.generate``,
main.py:1515-1561; ``Dielectric``, ``Metal`` and
``PerspectiveCamera.apply_preview`` of v4ray_frontend), not from the
port's editor.  A preview renders at depth 1, without antialias,
through a pinhole, under a white environment, each glass as a gray
(0.9, 0.9, 0.9) lambertian and each metal as a lambertian of its
albedo.

Departures, each the benchmark's choice:

* object *i* is the *i*-th object of the configuration's scene for the
  whole run, whatever the edits do to it (the loop names the editor's
  objects by the same index: the *i*-th of the opened project's
  ``analyze(doc).rendered_objects``, the order the scene was exported
  in); a hidden object keeps its place and carries ``"visible": false``
  (the upstream schema's flag, json.rs:685-699);
* the image is rendered at key 0 (``rng.key(0)``), as the editor's
  preview renders its first pass;
* the lower-precision control (``state_dtype``) also rounds the camera
  rays it traces: at depth 1 the state leaving the one bounce only
  carries the environment's term, so the rays entering it are the
  wavefront state the rounding has to reach.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .camera import camera_rays
from .integrator import trace
from .render import BATCH_RAYS, compile_scene
from .rng import key

GLASS_GRAY = [0.9, 0.9, 0.9]  # Dielectric.apply_preview's body
WHITE = [1.0, 1.0, 1.0]  # the preview's environment


def preview(scene: dict) -> dict:
    """The scene as the editor's preview renders it: each glass and metal
    a lambertian of a solid texture of its own (the configuration's
    other materials are lambertian, which the preview keeps)."""
    out = copy.deepcopy(scene)
    out["renderer"] = {**scene["renderer"], "max_depth": 1, "antialias": False}
    out["camera"] = {**scene["camera"], "aperture": 0.0}
    out["environment"] = list(WHITE)
    for i, m in enumerate(out["materials"]):
        if m["type"] not in ("dielectric", "metal"):
            continue
        color = GLASS_GRAY if m["type"] == "dielectric" else m["albedo"]
        texture = m["name"] + " (preview)"
        out["textures"].append({"type": "solid-color", "color": list(color), "name": texture})
        out["materials"][i] = {"type": "lambertian", "texture": texture, "name": m["name"]}
    return out


def _material(scene: dict, obj: dict) -> dict:
    return next(m for m in scene["materials"] if m["name"] == obj["material"])


def _texture(scene: dict, name: str) -> dict:
    return next(t for t in scene["textures"] if t["name"] == name)


class Edits:
    """A scene under the loop's edits, by object index, with undo as a
    stack of the scenes before each edit.

    An edit is a dict: ``{"kind": "set_shape", "index", "center"}`` (a
    sphere's new center), ``{"kind": "set_texture", "index", "color"}``
    (the object's lambertian's solid texture takes the u8 RGB
    ``color``), ``{"kind": "set_material", "index", "albedo", "fuzz"}``
    (the object's metal, albedo in u8 RGB), ``{"kind": "set_object",
    "index", "visible"}``, ``{"kind": "set_camera", "look_from"}`` or
    ``{"kind": "undo"}``."""

    def __init__(self, scene: dict):
        self.scene = copy.deepcopy(scene)
        self._before = []

    def apply(self, edit: dict) -> None:
        kind = edit["kind"]
        if kind == "undo":
            self.scene = self._before.pop()
            return
        self._before.append(copy.deepcopy(self.scene))
        obj = self.scene["objects"][edit["index"]] if "index" in edit else None
        if kind == "set_shape":
            obj["shape"]["center"] = [float(c) for c in edit["center"]]
        elif kind == "set_texture":
            tex = _texture(self.scene, _material(self.scene, obj)["texture"])
            tex["color"] = [c / 255 for c in edit["color"]]
        elif kind == "set_material":
            mat = _material(self.scene, obj)
            mat["albedo"] = [c / 255 for c in edit["albedo"]]
            mat["fuzz"] = float(edit["fuzz"])
        elif kind == "set_object":
            obj["visible"] = bool(edit["visible"])
        elif kind == "set_camera":
            self.scene["camera"]["look_from"] = [float(c) for c in edit["look_from"]]
        else:
            raise ValueError(f"unknown edit {kind!r}")


def tone_map(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) linear float32 -> u8, as the editor's PNG maps it."""
    return (np.sqrt(np.clip(img, 0.0, 1.0)) * 255).astype(np.uint8)


@torch.no_grad()
def image(scene: dict, data_dir: str, device, state_dtype=None) -> np.ndarray:
    """(H, W, 3) u8: the preview of ``scene``, one pass at key 0, every
    pixel traced densely with its index as its ray id.  With
    ``state_dtype`` the camera rays and the state leaving each bounce are
    rounded to it."""
    scene_t, camera, width, height, depth, antialias = compile_scene(preview(scene), data_dir,
                                                                   device)
    ro, rd, _, k_trace = camera_rays(camera, key(0), width, height, antialias)
    if state_dtype is not None:
        ro, rd = (x.to(state_dtype).to(torch.float32) for x in (ro, rd))
    n = width * height
    ids = torch.arange(n, device=ro.device)
    rad = torch.empty((n, 3), dtype=torch.float32, device=ro.device)
    for s in range(0, n, BATCH_RAYS):
        e = min(n, s + BATCH_RAYS)
        rad[s:e] = trace(scene_t, ro[s:e], rd[s:e], k_trace, depth, ids[s:e], state_dtype)
    return tone_map(rad.reshape(height, width, 3).cpu().numpy())
