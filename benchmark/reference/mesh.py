"""Wavefront OBJ loading with the reference's mesh semantics, the numpy
counterpart of ``ray_tracing_tpu/models/mesh.py`` (reference
src/hittables/obj.rs:30-104 + tobj triangulate).

Produces numpy triangle soups: per-face vertex positions, shading
normals and UVs.  Polygons triangulate as fans.  When the file has no
normals, smooth per-vertex normals are accumulated from face normals
``(p2-p1) x (p3-p2)``, normalized per face, summed per vertex and
re-normalized (obj.rs:66-70, 86-97).  That accumulation runs in float64
in face-then-corner order, as the JAX package's native loader
(native/src/v4ray_native.cpp:rt_obj_fill) does, so the arrays equal
what the JAX package loads.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np


@dataclasses.dataclass
class ObjModel:
    name: str
    indices: np.ndarray  # (F, 3) position indices
    normal_indices: Optional[np.ndarray]  # (F, 3), None when absent
    texcoord_indices: Optional[np.ndarray]  # (F, 3), -1 = corner without vt


@dataclasses.dataclass
class ObjFile:
    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray  # (VN, 3) f32
    texcoords: np.ndarray  # (VT, 2) f32
    models: List[ObjModel]


def _resolve(idx: int, count: int) -> int:
    """OBJ 1-based, negative = relative to the end."""
    return idx - 1 if idx > 0 else count + idx


def parse_obj(path: str) -> ObjFile:
    positions, normals, texcoords = [], [], []
    models = []

    def new_model(name: str):
        models.append({"name": name, "f": [], "fn": [], "ft": [], "has_n": False,
                       "has_t": False})

    new_model("")
    with open(path, "r") as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                texcoords.append([float(x) for x in parts[1:3]])
            elif tag in ("o", "g"):
                name = parts[1] if len(parts) > 1 else ""
                if models[-1]["f"]:
                    new_model(name)
                else:
                    models[-1]["name"] = name
            elif tag == "f":
                corners = []
                for spec in parts[1:]:
                    fields = spec.split("/")
                    vi = _resolve(int(fields[0]), len(positions))
                    ti = (_resolve(int(fields[1]), len(texcoords))
                          if len(fields) > 1 and fields[1] else None)
                    ni = (_resolve(int(fields[2]), len(normals))
                          if len(fields) > 2 and fields[2] else None)
                    corners.append((vi, ti, ni))
                m = models[-1]
                # fan triangulation; normal and texcoord rows stay aligned
                # with the face rows through -1 sentinels
                for a in range(1, len(corners) - 1):
                    tri = (corners[0], corners[a], corners[a + 1])
                    m["f"].append([c[0] for c in tri])
                    m["fn"].append([c[2] if c[2] is not None else -1 for c in tri])
                    m["ft"].append([c[1] if c[1] is not None else -1 for c in tri])
                    if all(c[2] is not None for c in tri):
                        m["has_n"] = True
                    if all(c[1] is not None for c in tri):
                        m["has_t"] = True

    out_models = []
    for m in models:
        if not m["f"]:
            continue
        fn = np.asarray(m["fn"], np.int64)
        out_models.append(ObjModel(
            name=m["name"],
            indices=np.asarray(m["f"], np.int64),
            # all or nothing per model (obj.rs:64-70): any corner without
            # a vn gives smooth vertex normals for the whole model
            normal_indices=fn if m["has_n"] and (fn >= 0).all() else None,
            texcoord_indices=np.asarray(m["ft"], np.int64) if m["has_t"] else None,
        ))
    return ObjFile(
        positions=np.asarray(positions, np.float32).reshape(-1, 3),
        normals=np.asarray(normals, np.float32).reshape(-1, 3),
        texcoords=np.asarray(texcoords, np.float32).reshape(-1, 2),
        models=out_models,
    )


def _smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """(F, 3, 3) smooth vertex normals in float64, rounded to float32 once
    at the end: edges are float32 differences, each face normal is
    divided by its length ((x*x + y*y) + z*z summed in that order), and
    the per-vertex sums run in face-then-corner order."""
    pts = positions[indices]  # (F, 3, 3) f32
    e1 = (pts[:, 1] - pts[:, 0]).astype(np.float64)
    e2 = (pts[:, 2] - pts[:, 1]).astype(np.float64)
    n = np.stack([
        e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
        e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
        e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0],
    ], axis=-1)

    def unit(x):
        length = np.sqrt((x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2])
        return x / np.maximum(length, 1e-30)[:, None]

    vsum = np.zeros((positions.shape[0], 3), np.float64)
    # ufunc.at adds unbuffered, in the order of the flattened (face, corner) rows
    np.add.at(vsum, indices.reshape(-1), np.repeat(unit(n), 3, axis=0))
    return unit(vsum)[indices].astype(np.float32)


def mesh_triangles(obj: ObjFile, model: Union[int, str, None] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One model as (points (F,3,3), normals (F,3,3), uvs (F,3,2)), all
    float32.  Model selection as reference json.rs:627-637: None -> the
    first, int -> by index, str -> by name."""
    if model is None:
        m = obj.models[0]
    elif isinstance(model, int):
        m = obj.models[model]
    else:
        matches = [mm for mm in obj.models if mm.name == model]
        if not matches:
            raise KeyError(f"cannot find the model {model!r}")
        m = matches[0]

    pts = obj.positions[m.indices]
    if m.normal_indices is not None:
        nrm = obj.normals[m.normal_indices]
    else:
        nrm = _smooth_normals(obj.positions, m.indices)
    if m.texcoord_indices is not None:
        # corners without a vt read uv (0, 0)
        safe = np.maximum(m.texcoord_indices, 0)
        uvs = np.where((m.texcoord_indices >= 0)[..., None], obj.texcoords[safe], 0.0)
    else:
        uvs = np.zeros((pts.shape[0], 3, 2), np.float32)
    return pts.astype(np.float32), nrm.astype(np.float32), uvs.astype(np.float32)


def load_triangles(path: str, model: Union[int, str, None] = None):
    """OBJ file -> (points, normals, uvs) of one model."""
    return mesh_triangles(parse_obj(path), model)
