"""Document -> renderable scene (reference State.generate,
main.py:1515-1561) with the reference's preview semantics: preview
renders use depth 1, no antialias, pinhole aperture, a white
environment, and each material's ``apply_preview`` stand-in.

A copy of ``ray_tracing_tpu/editor/generate.py`` whose only changes are
its imports and the ``rtt.generate`` span (``utils/profiling.py``); it
builds the port's façade scene."""

from __future__ import annotations

from typing import Dict, Optional
from uuid import UUID

import ray_tracing_tpu_torch.v4ray as v4ray
from ray_tracing_tpu_torch.utils.profiling import span
from ray_tracing_tpu_torch.v4ray_frontend.properties import TextureProperty

from ray_tracing_tpu_torch.editor.model import (
    Analysis,
    CAMERA_TYPES,
    Document,
    MATERIAL_TYPES,
    ObjectData,
    SHAPE_TYPES,
    TEXTURE_TYPES,
    analyze,
)


def generate(
    doc: Document,
    analysis: Optional[Analysis] = None,
    *,
    preview: bool = False,
):
    """Build (scene, camera_param, renderer_param) from a document.

    Raises ValueError when the camera is missing/invalid (the reference
    disables the render button in that case)."""
    with span("rtt.generate"):
        return _generate(doc, analysis, preview)


def _generate(doc: Document, analysis: Optional[Analysis], preview: bool):
    a = analysis or analyze(doc)
    if not a.camera_valid:
        raise ValueError("camera is missing or invalid")

    # textures: DFS over TextureProperty refs (main.py:1519-1531)
    built_textures: Dict[UUID, object] = {}

    def build_texture(key: UUID):
        if key in built_textures:
            return built_textures[key]
        t = doc.textures[key]
        kind, values = t.texture
        for prop, value in zip(TEXTURE_TYPES[kind].properties(), values):
            if isinstance(prop, TextureProperty) and value is not None:
                build_texture(value)  # populate built_textures for apply
        built_textures[key] = TEXTURE_TYPES[kind].apply(values, built_textures)
        return built_textures[key]

    for key in a.rendered_textures:
        build_texture(key)

    # materials: preview stand-ins vs real (main.py:1532-1541)
    built_materials: Dict[UUID, object] = {}
    for key in a.rendered_materials:
        kind, values = doc.materials[key].material
        plugin = MATERIAL_TYPES[kind]
        built_materials[key] = (
            plugin.apply_preview(values, built_textures)
            if preview
            else plugin.apply(values, built_textures)
        )

    # scene: background from renderer data; environment white in preview
    # (main.py:1542-1544)
    bg = tuple(c / 255.0 for c in doc.renderer.background)
    scene = v4ray.Scene(
        background=bg,
        environment=(1.0, 1.0, 1.0) if preview else (0.0, 0.0, 0.0),
    )
    for key in a.rendered_objects:
        node = doc.objects[key]
        assert isinstance(node, ObjectData)
        kind, values = node.shape
        for shape in SHAPE_TYPES[kind].apply(values):
            scene.add(shape, built_materials[a.effective_materials[key]])

    cam_kind, cam_values = doc.camera
    camera = (
        CAMERA_TYPES[cam_kind].apply_preview(cam_values)
        if preview
        else CAMERA_TYPES[cam_kind].apply(cam_values)
    )

    renderer_param = v4ray.RendererParam(
        doc.renderer.width,
        doc.renderer.height,
        1 if preview else doc.renderer.max_depth,
        not preview,  # antialias off in preview (main.py:1552-1561)
    )
    return scene, camera, renderer_param
