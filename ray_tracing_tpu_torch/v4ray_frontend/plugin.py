"""Generic machinery behind every editor plugin type.

Role parity: the abstract halves of reference `v4ray_frontend/
{shape,texture,material,camera}.py` — but instead of four parallel
all-abstract interfaces whose concrete classes each hand-write
``validate``/``to_json``/``from_json``, a plugin here is a declarative
table: a ``KIND`` tag plus a ``FIELDS`` tuple of self-serializing
descriptors (see properties.py).  The bases below derive the whole
form/JSON/validation surface from ``FIELDS``; concrete types add only a
backend builder (and, rarely, a cross-field ``rule`` or a cheap preview
stand-in).

All entry points are classmethods so the registries can store the
classes themselves and callers keep the ``Plugin.validate(values)``
call shape the editor core uses.

A copy of ``v4ray_frontend_tpu/plugin.py`` whose only change is its
imports.
"""

from __future__ import annotations

from abc import abstractmethod
from typing import Any, Dict, List, Set
from uuid import UUID

from ray_tracing_tpu_torch.v4ray_frontend.properties import (
    AnyProperty,
    fields_valid,
    pack,
    texture_refs,
    unpack,
)


class _DeclaredPlugin:
    KIND: str = ""
    FIELDS: tuple = ()

    @classmethod
    def kind(cls) -> str:
        return cls.KIND

    @classmethod
    def properties(cls) -> List[AnyProperty]:
        return list(cls.FIELDS)

    @classmethod
    def to_json(cls, data: List[Any]) -> Dict[str, Any]:
        return pack(cls.FIELDS, data)

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> List[Any]:
        return unpack(cls.FIELDS, data)

    @classmethod
    def rule(cls, data: List[Any]) -> bool:
        """Cross-field constraint hook; per-field checks live on FIELDS."""
        return True


class ShapeType(_DeclaredPlugin):
    """A shape plugin; ``apply`` may expand to several backend shapes."""

    @classmethod
    def validate(cls, data: List[Any]) -> bool:
        return fields_valid(cls.FIELDS, data) and cls.rule(data)

    @classmethod
    @abstractmethod
    def apply(cls, data: List[Any]) -> List[Any]: ...


class _TextureConsumer(_DeclaredPlugin):
    """Shared by textures and materials: anything whose fields may
    reference other texture nodes, validated against the live set."""

    @classmethod
    def validate(cls, data: List[Any], valid_textures: Set[UUID]) -> bool:
        refs_ok = all(
            r is not None and r in valid_textures
            for r in texture_refs(cls.FIELDS, data)
        )
        return refs_ok and fields_valid(cls.FIELDS, data) and cls.rule(data)

    @classmethod
    @abstractmethod
    def apply(cls, data: List[Any], textures: Dict[UUID, Any]) -> Any: ...


class TextureType(_TextureConsumer):
    pass


class MaterialType(_TextureConsumer):
    @classmethod
    def apply_preview(cls, data: List[Any], textures: Dict[UUID, Any]) -> Any:
        """Stand-in for the live preview; defaults to the real material."""
        return cls.apply(data, textures)


class CameraType(_DeclaredPlugin):
    @classmethod
    def validate(cls, data: List[Any]) -> bool:
        return fields_valid(cls.FIELDS, data) and cls.rule(data)

    @classmethod
    @abstractmethod
    def apply(cls, data: List[Any]) -> Any: ...

    @classmethod
    def apply_preview(cls, data: List[Any]) -> Any:
        return cls.apply(data)
