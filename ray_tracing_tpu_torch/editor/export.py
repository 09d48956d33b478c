"""Editor project -> CLI scene schema.

The reference keeps two unrelated JSON formats: the GUI's UUID-keyed
project files (main.py:584-720) and the CLI's serde schema
(src/json.rs) — with no converter between them.  This closes that gap:
an editor Document exports to a scene-param dict loadable by
``ray_tracing_tpu_torch.build_scene`` (and by the reference CLI, for the
shape/material/texture kinds it knows).

Emissive objects export with ``important: true`` so the CLI path gets
light importance sampling (the GUI never had the flag).

A copy of ``ray_tracing_tpu/editor/export.py`` whose only change is
its imports; its output feeds the port's
``models/compiler.py:build_scene``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional
from uuid import UUID

from ray_tracing_tpu_torch.editor.model import (
    Analysis,
    Document,
    ObjectData,
    analyze,
)


def _texture_def(doc: Document, names: Dict[UUID, str], key: UUID) -> Dict[str, Any]:
    kind, values = doc.textures[key].texture
    if kind == "solid color":
        c = values[0]
        return {"type": "solid-color", "color": [c[0] / 255, c[1] / 255, c[2] / 255]}
    if kind == "checker":
        return {
            "type": "checker",
            "odd": names[values[0]],
            "even": names[values[1]],
            "density": values[2],
        }
    if kind == "noise":
        return {"type": "noise", "scale": float(values[0]), "depth": int(values[1])}
    if kind == "image":
        return {"type": "image", "file": str(values[0])}
    raise ValueError(f"texture kind {kind!r} has no CLI-schema equivalent")


def _material_def(doc: Document, names: Dict[UUID, str], key: UUID) -> Dict[str, Any]:
    kind, values = doc.materials[key].material
    if kind == "lambertian":
        return {"type": "lambertian", "texture": names[values[0]]}
    if kind == "metal":
        c = values[0]
        return {
            "type": "metal",
            "albedo": [c[0] / 255, c[1] / 255, c[2] / 255],
            "fuzz": float(values[1]),
        }
    if kind == "dielectric":
        return {"type": "dielectric", "ir": float(values[0])}
    if kind == "diffuse light":
        c, k = values[0], float(values[1])
        return {
            "type": "diffuse-light",
            "emit": {
                "type": "solid-color",
                "color": [c[0] / 255 * k, c[1] / 255 * k, c[2] / 255 * k],
            },
        }
    if kind == "isotropic":
        return {"type": "isotropic", "albedo": names[values[0]]}
    raise ValueError(f"material kind {kind!r} has no CLI-schema equivalent")


def _shape_def(shape) -> Dict[str, Any]:
    kind, values = shape
    if kind == "sphere":
        return {"type": "sphere", "center": list(map(float, values[:3])),
                "radius": float(values[3])}
    if kind in ("xy-rect", "yz-rect", "zx-rect"):
        axes = {"xy-rect": ("x", "y", "z"), "yz-rect": ("y", "z", "x"),
                "zx-rect": ("z", "x", "y")}[kind]
        a, b, k = axes
        return {
            "type": kind,
            f"{a}0": float(values[0]), f"{a}1": float(values[1]),
            f"{b}0": float(values[2]), f"{b}1": float(values[3]),
            k: float(values[4]),
            "positive": float(values[5]) > 0,
        }
    if kind == "cuboid":
        return {"type": "cuboid", "p0": list(map(float, values[:3])),
                "p1": list(map(float, values[3:6]))}
    if kind == "triangle":
        v = list(map(float, values))
        return {"type": "triangle",
                "vertices": [v[0:3], v[3:6], v[6:9]]}
    if kind == "moving-sphere":
        return {
            "type": "moving-sphere",
            "center0": list(map(float, values[0:3])),
            "center1": list(map(float, values[3:6])),
            "radius": float(values[6]),
            "time0": float(values[7]), "time1": float(values[8]),
        }
    if kind == "mesh":
        d: Dict[str, Any] = {"type": "mesh", "file": str(values[0])}
        if values[1]:
            d["model"] = str(values[1])
        return d
    if kind == "constant-medium-sphere":
        return {
            "type": "constant-medium",
            "shape": {"type": "sphere",
                      "center": list(map(float, values[0:3])),
                      "radius": float(values[3])},
            "density": float(values[4]),
        }
    if kind == "constant-medium-cuboid":
        return {
            "type": "constant-medium",
            "shape": {"type": "cuboid",
                      "p0": list(map(float, values[0:3])),
                      "p1": list(map(float, values[3:6]))},
            "density": float(values[6]),
        }
    raise ValueError(f"shape kind {kind!r} has no CLI-schema equivalent")


def document_to_scene_param(
    doc: Document, analysis: Optional[Analysis] = None
) -> Dict[str, Any]:
    """Export the renderable part of a Document as a CLI scene dict."""
    a = analysis or analyze(doc)
    if not a.camera_valid:
        raise ValueError("camera is missing or invalid")

    cam_kind, cv = doc.camera
    assert cam_kind == "perspective"
    camera = {
        "look_from": list(map(float, cv[0:3])),
        "look_at": list(map(float, cv[3:6])),
        "vfov": float(cv[6]),
        "up": list(map(float, cv[7:10])),
        "aperture": float(cv[10]),
        "focus_dist": float(cv[11]),
        "time0": float(cv[12]),
        "time1": float(cv[13]),
    }

    # unique names for referenced defs
    names: Dict[UUID, str] = {}
    for key in list(a.rendered_textures) + list(a.rendered_materials):
        base = a.display_names.get(key) or str(key)[:8]
        names[key] = base

    textures: List[Dict[str, Any]] = []
    for key in a.rendered_textures:
        d = _texture_def(doc, names, key)
        d["name"] = names[key]
        textures.append(d)
    materials: List[Dict[str, Any]] = []
    for key in a.rendered_materials:
        d = _material_def(doc, names, key)
        d["name"] = names[key]
        materials.append(d)

    objects = []
    for key in a.rendered_objects:
        node = doc.objects[key]
        assert isinstance(node, ObjectData)
        mat_key = a.effective_materials[key]
        entry: Dict[str, Any] = {
            "shape": _shape_def(node.shape),
            "material": names[mat_key],
        }
        if doc.materials[mat_key].material[0] == "diffuse light":
            entry["important"] = True
        objects.append(entry)

    bg = doc.renderer.background
    return {
        "renderer": {
            "width": doc.renderer.width,
            "height": doc.renderer.height,
            "max_depth": doc.renderer.max_depth,
        },
        "camera": camera,
        "background": [bg[0] / 255, bg[1] / 255, bg[2] / 255],
        "objects": objects,
        "materials": materials,
        "textures": textures,
    }
