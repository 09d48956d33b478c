"""Self-serializing form-field descriptors for the editor plugin system.

Role parity: reference `v4ray_frontend/properties.py` (widget hints the
GUI turns into Qt forms).  Architecture is different by design: here a
descriptor owns not just its widget hints but also its slice of the
project-file JSON — ``slot`` names where the value lives in the plugin's
JSON object and ``codec`` names how the editor value maps to the JSON
value.  Generic :func:`pack` / :func:`unpack` / :func:`fields_valid`
walk a field tuple, so concrete plugin types (shape/texture/material/
camera modules) never hand-write their JSON round-trip or their
per-field validation — they are declarative tables.

Slot forms:

* ``"radius"``            — scalar key in the JSON object
* ``("center",)``         — next component of the flat list at ``center``
* ``("vertices", i)``     — next component of row ``i`` of a nested list

Codecs (editor value -> JSON value):

* ``number``  float kept as-is
* ``int``     float in the editor, integer in the JSON
* ``sign``    float in the editor, ``value > 0`` boolean in the JSON
              (absent key reads as ``True``)
* ``hex``     ``(r, g, b)`` 0-255 ints, ``"#rrggbb"`` string in the JSON
* ``uuid``    :class:`uuid.UUID` reference or None; None omits the key
* ``string``  text kept as-is (absent key reads as ``""``)

A copy of ``v4ray_frontend_tpu/properties.py`` whose only change is
its imports.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union
from uuid import UUID

Slot = Union[str, Tuple[str], Tuple[str, int], None]

_OMIT = object()      # encoder result: leave the key out of the JSON
_REQUIRED = object()  # decoder default: key must be present


def _rgb_to_hex(rgb: Sequence[int]) -> str:
    return "#%02x%02x%02x" % tuple(int(c) for c in rgb)


def _hex_to_rgb(s: str) -> Tuple[int, int, int]:
    return int(s[1:3], 16), int(s[3:5], 16), int(s[5:7], 16)


def rgb01(rgb: Sequence[int]) -> Tuple[float, float, float]:
    """0-255 int channels -> 0-1 floats (what backend textures expect)."""
    return rgb[0] / 255.0, rgb[1] / 255.0, rgb[2] / 255.0


# codec name -> (encode, decode, JSON default when the key is absent)
_CODECS: Dict[str, Tuple[Callable, Callable, Any]] = {
    "number": (lambda v: v, lambda j: j, _REQUIRED),
    "int": (lambda v: int(v), lambda j: float(j), _REQUIRED),
    "sign": (lambda v: float(v) > 0, lambda j: 1.0 if j else -1.0, True),
    "hex": (_rgb_to_hex, _hex_to_rgb, _REQUIRED),
    "uuid": (
        lambda v: _OMIT if v is None else str(v),
        lambda j: None if j is None else UUID(j),
        None,
    ),
    "string": (lambda v: str(v), lambda j: str(j), ""),
}


@dataclass(frozen=True)
class FloatProperty:
    """Numeric form field.  ``min``/``max``/``decimals`` are widget hints;
    ``check`` is the validation predicate (wired into generic validate)."""

    name: str
    default: float = 0.0
    min: Optional[float] = None
    max: Optional[float] = None
    decimals: Optional[int] = None
    slot: Slot = None
    codec: str = "number"
    check: Optional[Callable[[Any], bool]] = None


@dataclass(frozen=True)
class ColorProperty:
    """RGB swatch field; editor value is a 0-255 int triple."""

    name: str
    default: Tuple[int, int, int] = (255, 255, 255)
    slot: Slot = None
    codec: str = "hex"
    check: Optional[Callable[[Any], bool]] = None


@dataclass(frozen=True)
class TextureProperty:
    """Reference to another texture node, by document UUID."""

    name: str
    default: Optional[UUID] = None
    slot: Slot = None
    codec: str = "uuid"
    check: Optional[Callable[[Any], bool]] = None


@dataclass(frozen=True)
class StringProperty:
    """Free-text form field (file paths, model names)."""

    name: str
    default: str = ""
    slot: Slot = None
    codec: str = "string"
    check: Optional[Callable[[Any], bool]] = None


AnyProperty = Union[
    FloatProperty, ColorProperty, TextureProperty, StringProperty
]


def pack(fields: Sequence[AnyProperty], values: Sequence[Any]) -> Dict[str, Any]:
    """Encode a value list into the plugin's project-JSON object."""
    if len(values) != len(fields):
        raise ValueError(
            f"expected {len(fields)} values, got {len(values)}"
        )
    out: Dict[str, Any] = {}
    for f, v in zip(fields, values):
        encode = _CODECS[f.codec][0]
        j = encode(v)
        if j is _OMIT:
            continue
        slot = f.slot if f.slot is not None else f.name
        if isinstance(slot, str):
            out[slot] = j
        elif len(slot) == 1:
            out.setdefault(slot[0], []).append(j)
        else:
            key, row = slot
            rows = out.setdefault(key, [])
            while len(rows) <= row:
                rows.append([])
            rows[row].append(j)
    return out


def unpack(fields: Sequence[AnyProperty], data: Dict[str, Any]) -> List[Any]:
    """Decode a project-JSON object back into the ordered value list."""
    cursor: Dict[Any, int] = {}
    values: List[Any] = []
    for f in fields:
        _, decode, absent = _CODECS[f.codec]
        slot = f.slot if f.slot is not None else f.name
        if isinstance(slot, str):
            j = data.get(slot, absent)
            if j is _REQUIRED:
                raise KeyError(slot)
        elif len(slot) == 1:
            i = cursor.get(slot, 0)
            cursor[slot] = i + 1
            j = data[slot[0]][i]
        else:
            key, row = slot
            i = cursor.get(slot, 0)
            cursor[slot] = i + 1
            j = data[key][row][i]
        values.append(decode(j))
    return values


def fields_valid(fields: Sequence[AnyProperty], values: Sequence[Any]) -> bool:
    """Every per-field ``check`` predicate passes (missing check = pass).
    A malformed value list (wrong length — e.g. a truncated editor POST)
    is invalid, never silently zip-truncated."""
    if len(values) != len(fields):
        return False

    import numbers

    def typed_ok(f, v):
        # per-type gate BEFORE any custom check: client data is
        # unvalidated (a cleared web-form number arrives as None).
        # numbers.Real admits numpy scalars (scene generators use them)
        if isinstance(f, FloatProperty):
            return (
                isinstance(v, numbers.Real)
                and not isinstance(v, bool)
                and float(v) == float(v)  # NaN-reject
            )
        if isinstance(f, ColorProperty):
            return (
                isinstance(v, (tuple, list)) and len(v) == 3
                and all(
                    isinstance(c, numbers.Integral)
                    and not isinstance(c, bool) and 0 <= c <= 255
                    for c in v
                )
            )
        if isinstance(f, TextureProperty):
            return v is None or isinstance(v, UUID)
        if isinstance(f, StringProperty):
            return isinstance(v, str)
        return True

    def ok(f, v):
        if not typed_ok(f, v):
            return False
        if f.check is None:
            return True
        try:
            return bool(f.check(v))
        except (TypeError, ValueError):
            # malformed means invalid, never an exception out of
            # analyze()
            return False

    return all(ok(f, v) for f, v in zip(fields, values))


def texture_refs(fields: Sequence[AnyProperty],
                 values: Sequence[Any]) -> List[Optional[UUID]]:
    """The values of every texture-reference field, in declaration order."""
    return [v for f, v in zip(fields, values) if f.codec == "uuid"]
