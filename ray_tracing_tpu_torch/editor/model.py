"""Immutable scene document + derived analysis.

The reference keeps one big ``State`` class mixing scene data, UI
selection, and memoized derived fields (reference main.py:245-582).
Here the scene description is a frozen :class:`Document` with
copy-on-write mutators, and everything derivable is computed by
:func:`analyze` into an :class:`Analysis` — the same quantities the
reference derives (unique display names, texture/material validity with
cycle guards, material inheritance down the object tree, visible ∩
valid = rendered sets, transitive rendered materials/textures,
camera validity; main.py:340-581) but as a pure function, so any
frontend can diff two analyses instead of patching widgets in place.

A copy of ``ray_tracing_tpu/editor/model.py`` whose only change is its
imports.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Mapping, Optional, Set, Tuple
from uuid import UUID, uuid4

import ray_tracing_tpu_torch.v4ray_frontend as plugins
from ray_tracing_tpu_torch.v4ray_frontend.properties import TextureProperty

ShapeSpec = Tuple[str, List[Any]]  # (plugin kind, property values)


@dataclass(frozen=True)
class ObjectData:
    """A leaf scene object (reference main.py:42-49)."""

    key: UUID
    name: str
    shape: Optional[ShapeSpec] = None
    material: Optional[UUID] = None
    visible: bool = False


@dataclass(frozen=True)
class GroupData:
    """An object group; children inherit its material when they have
    none (reference main.py:52-58 ObjectListData)."""

    key: UUID
    name: str
    material: Optional[UUID] = None
    children: Tuple[UUID, ...] = ()
    visible: bool = False


@dataclass(frozen=True)
class TextureData:
    key: UUID
    name: str
    texture: Optional[ShapeSpec] = None


@dataclass(frozen=True)
class MaterialData:
    key: UUID
    name: str
    material: Optional[ShapeSpec] = None


@dataclass(frozen=True)
class RendererData:
    """reference main.py:74-80."""

    width: int = 800
    height: int = 600
    max_depth: int = 20
    background: Tuple[int, int, int] = (0, 0, 0)  # 0-255 ints


def _registry(types):
    return {t.kind(): t for t in types}


SHAPE_TYPES = _registry(plugins.shapes)
TEXTURE_TYPES = _registry(plugins.textures)
MATERIAL_TYPES = _registry(plugins.materials)
CAMERA_TYPES = _registry(plugins.cameras)


@dataclass(frozen=True)
class Document:
    """The whole editable scene, immutable.  Mutators return new docs."""

    renderer: RendererData = RendererData()
    camera: Optional[ShapeSpec] = None
    objects: Mapping[UUID, Any] = field(default_factory=dict)
    root_objects: Tuple[UUID, ...] = ()
    materials: Mapping[UUID, MaterialData] = field(default_factory=dict)
    root_materials: Tuple[UUID, ...] = ()
    textures: Mapping[UUID, TextureData] = field(default_factory=dict)
    root_textures: Tuple[UUID, ...] = ()

    # -- texture / material mutators ----------------------------------
    def add_texture(self, name: str, texture: Optional[ShapeSpec] = None,
                    key: Optional[UUID] = None) -> Tuple["Document", UUID]:
        key = key or uuid4()
        textures = dict(self.textures)
        textures[key] = TextureData(key=key, name=name, texture=texture)
        return (
            replace(self, textures=textures,
                    root_textures=self.root_textures + (key,)),
            key,
        )

    def modify_texture(self, key: UUID, **changes) -> "Document":
        textures = dict(self.textures)
        textures[key] = replace(textures[key], **changes)
        return replace(self, textures=textures)

    def remove_texture(self, key: UUID) -> "Document":
        textures = {k: v for k, v in self.textures.items() if k != key}
        return replace(
            self, textures=textures,
            root_textures=tuple(k for k in self.root_textures if k != key),
        )

    def add_material(self, name: str, material: Optional[ShapeSpec] = None,
                     key: Optional[UUID] = None) -> Tuple["Document", UUID]:
        key = key or uuid4()
        materials = dict(self.materials)
        materials[key] = MaterialData(key=key, name=name, material=material)
        return (
            replace(self, materials=materials,
                    root_materials=self.root_materials + (key,)),
            key,
        )

    def modify_material(self, key: UUID, **changes) -> "Document":
        materials = dict(self.materials)
        materials[key] = replace(materials[key], **changes)
        return replace(self, materials=materials)

    def remove_material(self, key: UUID) -> "Document":
        materials = {k: v for k, v in self.materials.items() if k != key}
        return replace(
            self, materials=materials,
            root_materials=tuple(k for k in self.root_materials if k != key),
        )

    # -- object tree mutators -----------------------------------------
    def add_object(self, name: str, *, parent: Optional[UUID] = None,
                   shape: Optional[ShapeSpec] = None,
                   material: Optional[UUID] = None, visible: bool = False,
                   key: Optional[UUID] = None) -> Tuple["Document", UUID]:
        key = key or uuid4()
        objects = dict(self.objects)
        objects[key] = ObjectData(
            key=key, name=name, shape=shape, material=material, visible=visible
        )
        doc = replace(self, objects=objects)
        return doc._attach(key, parent), key

    def add_group(self, name: str, *, parent: Optional[UUID] = None,
                  material: Optional[UUID] = None, visible: bool = False,
                  key: Optional[UUID] = None) -> Tuple["Document", UUID]:
        key = key or uuid4()
        objects = dict(self.objects)
        objects[key] = GroupData(
            key=key, name=name, material=material, visible=visible
        )
        doc = replace(self, objects=objects)
        return doc._attach(key, parent), key

    def _attach(self, key: UUID, parent: Optional[UUID]) -> "Document":
        if parent is None:
            return replace(self, root_objects=self.root_objects + (key,))
        objects = dict(self.objects)
        group = objects[parent]
        objects[parent] = replace(group, children=group.children + (key,))
        return replace(self, objects=objects)

    def modify_object(self, key: UUID, **changes) -> "Document":
        objects = dict(self.objects)
        objects[key] = replace(objects[key], **changes)
        return replace(self, objects=objects)

    def remove_object(self, key: UUID) -> "Document":
        """Remove an object/group and its whole subtree."""
        doomed: Set[UUID] = set()

        def collect(k: UUID):
            doomed.add(k)
            node = self.objects[k]
            if isinstance(node, GroupData):
                for c in node.children:
                    collect(c)

        collect(key)
        objects = {}
        for k, v in self.objects.items():
            if k in doomed:
                continue
            if isinstance(v, GroupData):
                v = replace(
                    v, children=tuple(c for c in v.children if c not in doomed)
                )
            objects[k] = v
        return replace(
            self, objects=objects,
            root_objects=tuple(k for k in self.root_objects if k not in doomed),
        )

    def set_camera(self, camera: Optional[ShapeSpec]) -> "Document":
        return replace(self, camera=camera)

    def set_renderer(self, renderer: RendererData) -> "Document":
        return replace(self, renderer=renderer)


@dataclass(frozen=True)
class Analysis:
    """Everything derivable from a Document (reference State.recalculate,
    main.py:340-582)."""

    parents: Mapping[UUID, Optional[UUID]]
    display_names: Mapping[UUID, str]  # unique-suffixed per kind
    valid_textures: frozenset
    valid_materials: frozenset
    effective_materials: Mapping[UUID, Optional[UUID]]  # after inheritance
    visible_objects: frozenset  # self and all ancestors visible
    valid_objects: frozenset  # shape present+valid, material resolves
    rendered_objects: frozenset  # visible ∩ valid leaf objects
    rendered_materials: frozenset
    rendered_textures: frozenset
    camera_valid: bool


def _unique_names(items) -> Dict[UUID, str]:
    """Disambiguate duplicate names with (n) suffixes
    (reference main.py:352-374)."""
    seen: Dict[str, int] = {}
    out: Dict[UUID, str] = {}
    for key, name in items:
        count = seen.get(name, 0)
        seen[name] = count + 1
        out[key] = name if count == 0 else f"{name} ({count})"
    return out


def analyze(doc: Document) -> Analysis:
    # parent map
    parents: Dict[UUID, Optional[UUID]] = {k: None for k in doc.root_objects}
    order: List[UUID] = list(doc.root_objects)
    i = 0
    while i < len(order):
        node = doc.objects[order[i]]
        if isinstance(node, GroupData):
            for c in node.children:
                parents[c] = node.key
                order.append(c)
        i += 1

    # texture validity: monotone fixpoint from a pessimistic start — a
    # texture is valid once its plugin validates it against the current
    # valid set.  Cycles never become valid, matching the reference's
    # cycle guard (main.py:432-459).
    valid: Set[UUID] = set()
    changed = True
    while changed:
        changed = False
        for key, t in doc.textures.items():
            if key in valid or t.texture is None:
                continue
            kind_values = t.texture
            if kind_values[0] not in TEXTURE_TYPES:
                continue
            if TEXTURE_TYPES[kind_values[0]].validate(
                kind_values[1], frozenset(valid)
            ):
                valid.add(key)
                changed = True
    valid_texture_set = frozenset(valid)

    # material validity (main.py:460-471)
    valid_materials = set()
    for key, m in doc.materials.items():
        if m.material is None or m.material[0] not in MATERIAL_TYPES:
            continue
        kind, values = m.material
        if MATERIAL_TYPES[kind].validate(values, valid_texture_set):
            valid_materials.add(key)

    # material inheritance down the tree (main.py:472-507)
    effective: Dict[UUID, Optional[UUID]] = {}

    def inherit(key: UUID, inherited: Optional[UUID]):
        node = doc.objects[key]
        mat = node.material if node.material is not None else inherited
        effective[key] = mat
        if isinstance(node, GroupData):
            for c in node.children:
                inherit(c, mat)

    for key in doc.root_objects:
        inherit(key, None)

    # visibility: node and all ancestors visible (main.py:517-534)
    visible: Set[UUID] = set()

    def walk_visible(key: UUID, ancestors_visible: bool):
        node = doc.objects[key]
        vis = ancestors_visible and node.visible
        if vis:
            visible.add(key)
        if isinstance(node, GroupData):
            for c in node.children:
                walk_visible(c, vis)

    for key in doc.root_objects:
        walk_visible(key, True)

    # object validity: leaf with valid shape + resolvable valid material
    valid_objects = set()
    for key, node in doc.objects.items():
        if not isinstance(node, ObjectData):
            continue
        if node.shape is None or node.shape[0] not in SHAPE_TYPES:
            continue
        kind, values = node.shape
        if not SHAPE_TYPES[kind].validate(values):
            continue
        mat = effective.get(key)
        if mat is None or mat not in valid_materials:
            continue
        valid_objects.add(key)

    rendered = frozenset(valid_objects & visible)

    # transitive rendered materials/textures (main.py:541-581)
    rendered_materials = frozenset(
        effective[k] for k in rendered if effective.get(k) is not None
    )
    rendered_textures: Set[UUID] = set()

    def collect_textures(tex_key: UUID):
        if tex_key in rendered_textures or tex_key not in doc.textures:
            return
        rendered_textures.add(tex_key)
        t = doc.textures[tex_key]
        if t.texture is None:
            return
        kind, values = t.texture
        for prop, value in zip(TEXTURE_TYPES[kind].properties(), values):
            if isinstance(prop, TextureProperty) and value is not None:
                collect_textures(value)

    for mkey in rendered_materials:
        m = doc.materials[mkey]
        if m.material is None:
            continue
        kind, values = m.material
        for prop, value in zip(MATERIAL_TYPES[kind].properties(), values):
            if isinstance(prop, TextureProperty) and value is not None:
                collect_textures(value)

    camera_valid = (
        doc.camera is not None
        and doc.camera[0] in CAMERA_TYPES
        and CAMERA_TYPES[doc.camera[0]].validate(doc.camera[1])
    )

    names = _unique_names(
        [(k, doc.objects[k].name) for k in order]
    )
    names.update(_unique_names(
        [(k, doc.materials[k].name) for k in doc.root_materials]
    ))
    names.update(_unique_names(
        [(k, doc.textures[k].name) for k in doc.root_textures]
    ))

    return Analysis(
        parents=parents,
        display_names=names,
        valid_textures=valid_texture_set,
        valid_materials=frozenset(valid_materials),
        effective_materials=effective,
        visible_objects=frozenset(visible),
        valid_objects=frozenset(valid_objects),
        rendered_objects=rendered,
        rendered_materials=rendered_materials,
        rendered_textures=frozenset(rendered_textures),
        camera_valid=camera_valid,
    )


def need_rerender(
    old: Document, old_a: Analysis, new: Document, new_a: Analysis
) -> bool:
    """Deep comparison of everything that feeds the renderer
    (reference main.py:1475-1513)."""
    if old.renderer != new.renderer or old.camera != new.camera:
        return True
    if old_a.rendered_objects != new_a.rendered_objects:
        return True
    for key in new_a.rendered_objects:
        o_old = old.objects.get(key)
        o_new = new.objects[key]
        if o_old is None or o_old.shape != o_new.shape:
            return True
        if old_a.effective_materials.get(key) != new_a.effective_materials.get(key):
            return True
    if old_a.rendered_materials != new_a.rendered_materials:
        return True
    for key in new_a.rendered_materials:
        if old.materials.get(key) != new.materials.get(key):
            return True
    if old_a.rendered_textures != new_a.rendered_textures:
        return True
    for key in new_a.rendered_textures:
        if old.textures.get(key) != new.textures.get(key):
            return True
    return False
