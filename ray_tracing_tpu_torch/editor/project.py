"""Project (de)serialization in the reference editor's JSON format
(reference main.py:584-720): UUID-keyed objects/materials/textures
dicts, hex colors, ``root_objects`` ordering, per-type payloads produced
by the plugin ``to_json``/``from_json`` hooks.  Files written by the
reference GUI load here and vice versa (for the plugin kinds both
support).

A copy of ``ray_tracing_tpu/editor/project.py`` whose only change is
its imports; the project JSON stays bit-compatible both ways."""

from __future__ import annotations

from typing import Any, Dict
from uuid import UUID

from ray_tracing_tpu_torch.editor.model import (
    CAMERA_TYPES,
    Document,
    GroupData,
    MATERIAL_TYPES,
    MaterialData,
    ObjectData,
    RendererData,
    SHAPE_TYPES,
    TEXTURE_TYPES,
    TextureData,
)


def document_to_json(doc: Document) -> Dict[str, Any]:
    data: Dict[str, Any] = {}
    data["render"] = {
        "width": doc.renderer.width,
        "height": doc.renderer.height,
        "max_depth": doc.renderer.max_depth,
        "background": "#%02x%02x%02x" % tuple(doc.renderer.background),
    }
    if doc.camera is not None:
        kind, values = doc.camera
        camera = {"type": kind}
        camera.update(CAMERA_TYPES[kind].to_json(values))
        data["camera"] = camera
    data["root_objects"] = [str(k) for k in doc.root_objects]
    objects: Dict[str, Any] = {}
    for key, node in doc.objects.items():
        obj: Dict[str, Any] = {"name": node.name, "visible": node.visible}
        if node.material is not None:
            obj["material"] = str(node.material)
        if isinstance(node, ObjectData):
            if node.shape is not None:
                kind, values = node.shape
                shape = {"type": kind}
                shape.update(SHAPE_TYPES[kind].to_json(values))
                obj["shape"] = shape
        else:
            obj["children"] = [str(c) for c in node.children]
        objects[str(key)] = obj
    data["objects"] = objects
    materials: Dict[str, Any] = {}
    for key in doc.root_materials:
        m = doc.materials[key]
        material: Dict[str, Any] = {"name": m.name}
        if m.material is not None:
            kind, values = m.material
            material["type"] = kind
            material.update(MATERIAL_TYPES[kind].to_json(values))
        materials[str(key)] = material
    data["materials"] = materials
    textures: Dict[str, Any] = {}
    for key in doc.root_textures:
        t = doc.textures[key]
        texture: Dict[str, Any] = {"name": t.name}
        if t.texture is not None:
            kind, values = t.texture
            texture["type"] = kind
            texture.update(TEXTURE_TYPES[kind].to_json(values))
        textures[str(key)] = texture
    data["textures"] = textures
    return data


def document_from_json(data: Dict[str, Any]) -> Document:
    render = data.get("render", {})
    bg = render.get("background", "#000000")
    renderer = RendererData(
        width=render.get("width", 800),
        height=render.get("height", 600),
        max_depth=render.get("max_depth", 20),
        background=(int(bg[1:3], 16), int(bg[3:5], 16), int(bg[5:7], 16)),
    )
    camera = None
    if "camera" in data:
        cam = dict(data["camera"])
        kind = cam.pop("type")
        camera = (kind, CAMERA_TYPES[kind].from_json(cam))

    objects: Dict[UUID, Any] = {}
    for key_str, obj in data.get("objects", {}).items():
        key = UUID(key_str)
        material = UUID(obj["material"]) if obj.get("material") else None
        if "children" in obj:
            objects[key] = GroupData(
                key=key, name=obj["name"], material=material,
                children=tuple(UUID(c) for c in obj["children"]),
                visible=obj.get("visible", False),
            )
        else:
            shape = None
            if obj.get("shape"):
                s = dict(obj["shape"])
                kind = s.pop("type")
                shape = (kind, SHAPE_TYPES[kind].from_json(s))
            objects[key] = ObjectData(
                key=key, name=obj["name"], shape=shape, material=material,
                visible=obj.get("visible", False),
            )

    materials: Dict[UUID, MaterialData] = {}
    for key_str, m in data.get("materials", {}).items():
        key = UUID(key_str)
        material = None
        if "type" in m:
            mm = dict(m)
            name = mm.pop("name")
            kind = mm.pop("type")
            material = (kind, MATERIAL_TYPES[kind].from_json(mm))
        else:
            name = m["name"]
        materials[key] = MaterialData(key=key, name=name, material=material)

    textures: Dict[UUID, TextureData] = {}
    for key_str, t in data.get("textures", {}).items():
        key = UUID(key_str)
        texture = None
        if "type" in t:
            tt = dict(t)
            name = tt.pop("name")
            kind = tt.pop("type")
            texture = (kind, TEXTURE_TYPES[kind].from_json(tt))
        else:
            name = t["name"]
        textures[key] = TextureData(key=key, name=name, texture=texture)

    return Document(
        renderer=renderer,
        camera=camera,
        objects=objects,
        root_objects=tuple(UUID(k) for k in data.get("root_objects", [])),
        materials=materials,
        root_materials=tuple(materials.keys()),
        textures=textures,
        root_textures=tuple(textures.keys()),
    )
