"""The port's editor plugins for the Image texture and the Mesh and
ConstantMedium shapes (ray_tracing_tpu_torch/v4ray_frontend/): every
case of tests/test_editor_plugins.py on the port (JSON round trip,
validation, document -> scene generation, CLI-schema export into the
port's build_scene), rendering with device="cpu", and the export held
against the JAX package's."""

import os

import numpy as np
import pytest
import torch

from ray_tracing_tpu_torch.editor import (
    Document,
    RendererData,
    analyze,
    document_from_json,
    document_to_json,
    generate,
)
from ray_tracing_tpu_torch.editor.export import document_to_scene_param
from ray_tracing_tpu_torch.v4ray_frontend import shapes, textures
from ray_tracing_tpu_torch.v4ray_frontend.shape import (
    ConstantMediumCuboid,
    ConstantMediumSphere,
    Mesh,
)
from ray_tracing_tpu_torch.v4ray_frontend.texture import Image

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
EARTH = os.path.join(DATA, "earthmap.jpg")


def tiny_obj(tmp_path):
    """Two-triangle square facing +z at z=-3."""
    p = tmp_path / "square.obj"
    p.write_text(
        "o square\n"
        "v -1 -1 -3\nv 1 -1 -3\nv 1 1 -3\nv -1 1 -3\n"
        "f 1 2 3\nf 1 3 4\n"
    )
    return str(p)


def test_new_plugins_registered():
    kinds = {s.kind() for s in shapes}
    assert {"mesh", "constant-medium-sphere",
            "constant-medium-cuboid"} <= kinds
    assert "image" in {t.kind() for t in textures}


def test_plugin_json_roundtrips(tmp_path):
    obj = tiny_obj(tmp_path)
    cases = [
        (Image, [EARTH]),
        (Mesh, [obj, ""]),
        (Mesh, [obj, "square"]),
        (ConstantMediumSphere, [0.0, 1.0, -3.0, 2.0, 0.5]),
        (ConstantMediumCuboid, [0.0, 0.0, 0.0, 1.0, 2.0, 3.0, 0.25]),
    ]
    for plugin, values in cases:
        j = plugin.to_json(values)
        assert plugin.from_json(j) == values, plugin.KIND


def test_plugin_validation(tmp_path):
    obj = tiny_obj(tmp_path)
    assert Image.validate([EARTH], set())
    assert not Image.validate([""], set())
    assert not Image.validate(["/nonexistent/file.png"], set())
    assert Mesh.validate([obj, ""])
    assert not Mesh.validate(["/nonexistent.obj", ""])
    assert ConstantMediumSphere.validate([0.0, 0.0, 0.0, 1.0, 0.5])
    assert not ConstantMediumSphere.validate([0.0, 0.0, 0.0, -1.0, 0.5])
    assert not ConstantMediumSphere.validate([0.0, 0.0, 0.0, 1.0, 0.0])
    assert not ConstantMediumCuboid.validate(
        [1.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.5]
    )


def _doc_with(shape_kind, shape_values, tex_kind="solid color",
              tex_values=((204, 51, 51),), mat_kind="lambertian"):
    doc = Document(renderer=RendererData(24, 24, 4, (30, 30, 60)))
    doc = doc.set_camera(
        ("perspective",
         [0.0, 0.0, 1.0, 0.0, 0.0, -1.0, 60.0,
          0.0, 1.0, 0.0, 0.0, 2.0, 0.0, 0.0])
    )
    doc, tex = doc.add_texture("t", (tex_kind, list(tex_values)))
    doc, mat = doc.add_material("m", (mat_kind, [tex]))
    doc, obj = doc.add_object(
        "node", shape=(shape_kind, list(shape_values)), material=mat,
        visible=True,
    )
    return doc, obj


def test_earthmap_sphere_in_editor():
    """zy_scene's earthmap sphere is now expressible in the editor:
    image texture -> lambertian -> sphere, generated and rendered."""
    doc = Document(renderer=RendererData(24, 24, 3, (20, 20, 20)))
    doc = doc.set_camera(
        ("perspective",
         [0.0, 0.0, 1.0, 0.0, 0.0, -1.0, 60.0,
          0.0, 1.0, 0.0, 0.0, 2.0, 0.0, 0.0])
    )
    doc, tex = doc.add_texture("earth", ("image", [EARTH]))
    doc, mat = doc.add_material("m", ("lambertian", [tex]))
    doc, obj = doc.add_object(
        "globe", shape=("sphere", [0.0, 0.0, -3.0, 1.5]), material=mat,
        visible=True,
    )
    a = analyze(doc)
    assert tex in a.valid_textures and obj in a.rendered_objects

    # project-JSON round trip preserves the image node
    doc2 = document_from_json(document_to_json(doc))
    assert doc2.textures[tex].texture == ("image", [EARTH])

    scene, cam, rp = generate(doc2)
    assert scene.compile().textures.images.shape[0] == 1

    # preview render: the globe shows the atlas, not a flat color
    import asyncio

    scene_p, cam_p, rp_p = generate(doc2, preview=True)
    import ray_tracing_tpu_torch.v4ray as v4ray

    r = v4ray.Renderer(rp_p, cam_p, scene_p, device="cpu")
    img = np.asarray(asyncio.run(r.render()))
    h, w = img.shape[:2]
    center = img[h // 3: 2 * h // 3, w // 3: 2 * w // 3]
    assert center.std() > 0.01  # textured, not uniform


def test_mesh_and_medium_generate_and_export(tmp_path):
    obj_file = tiny_obj(tmp_path)
    doc, obj = _doc_with("mesh", [obj_file, ""])
    scene, cam, rp = generate(doc)
    assert scene.compile().n_triangles == 2

    # isotropic smoke ball generates a medium
    doc2, obj2 = _doc_with(
        "constant-medium-sphere", [0.0, 0.0, -3.0, 1.0, 0.7],
        mat_kind="isotropic",
    )
    scene2, _, _ = generate(doc2)
    assert scene2.compile().n_medium == 1

    # CLI-schema export of all new kinds builds a scene
    from ray_tracing_tpu_torch import build_scene

    for doc_i, tris, med in ((doc, 2, 0), (doc2, 0, 1)):
        param = document_to_scene_param(doc_i)
        bundle = build_scene(param)
        assert bundle.scene.n_triangles == tris
        assert bundle.scene.n_medium == med

    doc3, _ = _doc_with(
        "constant-medium-cuboid",
        [-1.0, -1.0, -4.0, 1.0, 1.0, -2.0, 0.4], mat_kind="isotropic",
    )
    param3 = document_to_scene_param(doc3)
    assert param3["objects"][0]["shape"]["type"] == "constant-medium"
    assert build_scene(param3).scene.n_medium == 1


def test_image_texture_exports_to_cli_schema():
    doc = Document(renderer=RendererData(16, 16, 2, (0, 0, 0)))
    doc = doc.set_camera(
        ("perspective",
         [0.0, 0.0, 1.0, 0.0, 0.0, -1.0, 60.0,
          0.0, 1.0, 0.0, 0.0, 2.0, 0.0, 0.0])
    )
    doc, tex = doc.add_texture("earth", ("image", [EARTH]))
    doc, mat = doc.add_material("m", ("lambertian", [tex]))
    doc, _ = doc.add_object(
        "globe", shape=("sphere", [0.0, 0.0, -3.0, 1.0]), material=mat,
        visible=True,
    )
    param = document_to_scene_param(doc)
    tdef = next(t for t in param["textures"] if t["type"] == "image")
    assert tdef["file"] == EARTH
    from ray_tracing_tpu_torch import build_scene

    assert build_scene(param).scene.textures.images.shape[0] == 1


def test_moving_sphere_exports_to_cli_schema():
    doc, _ = _doc_with(
        "moving-sphere",
        [0.0, 0.0, -3.0, 1.0, 0.0, -3.0, 0.5, 0.0, 1.0],
    )
    param = document_to_scene_param(doc)
    sdef = param["objects"][0]["shape"]
    assert sdef["type"] == "moving-sphere"
    from ray_tracing_tpu_torch import build_scene

    assert build_scene(param).scene.has_motion


def test_export_equals_jax_for_every_plugin_kind(tmp_path):
    """document_to_scene_param of one project holding every shape,
    texture and material kind equals the JAX package's dict for the same
    project JSON, and the port's build_scene of it equals JAX's tables."""
    import json

    import ray_tracing_tpu as jrt
    from ray_tracing_tpu.editor import document_from_json as jfrom_json
    from ray_tracing_tpu.editor.export import document_to_scene_param as jexport

    from test_torch_scene import _assert_tables_equal

    doc = Document(renderer=RendererData(24, 24, 4, (30, 30, 60)))
    doc = doc.set_camera(
        ("perspective",
         [0.0, 0.0, 1.0, 0.0, 0.0, -1.0, 60.0, 0.0, 1.0, 0.0, 0.1, 2.0, 0.0, 1.0])
    )
    doc, red = doc.add_texture("red", ("solid color", [(204, 51, 51)]))
    doc, white = doc.add_texture("white", ("solid color", [(240, 240, 240)]))
    doc, chk = doc.add_texture("chk", ("checker", [red, white, 4.0]))
    doc, noise = doc.add_texture("noise", ("noise", [2.0, 5.0]))
    doc, earth = doc.add_texture("earth", ("image", [EARTH]))
    mats = {}
    for name, spec in (("lam", ("lambertian", [chk])), ("metal", ("metal", [(200, 180, 160), 0.3])),
                       ("glass", ("dielectric", [1.5])), ("lamp", ("diffuse light", [(255, 240, 200), 4.0])),
                       ("fog", ("isotropic", [white])), ("globe", ("lambertian", [earth])),
                       ("marble", ("lambertian", [noise]))):
        doc, mats[name] = doc.add_material(name, spec)
    obj = tiny_obj(tmp_path)
    for name, shape, mat in (
            ("ball", ("sphere", [0.0, 0.0, -3.0, 1.0]), "globe"),
            ("mover", ("moving-sphere", [1.0, 0.0, -3.0, 1.5, 0.0, -3.0, 0.3, 0.0, 1.0]), "metal"),
            ("xy", ("xy-rect", [-3.0, 3.0, -3.0, 3.0, -6.0, 1.0]), "lam"),
            ("yz", ("yz-rect", [-1.0, 1.0, -5.0, -2.0, 3.0, -1.0]), "marble"),
            ("zx", ("zx-rect", [-1.0, 1.0, -4.0, -2.0, 3.0, -1.0]), "lamp"),
            ("box", ("cuboid", [-1.0, -2.0, -5.0, 1.0, -1.0, -4.0]), "lam"),
            ("tri", ("triangle", [0.0, 1.0, -2.0, 1.0, 1.0, -2.0, 0.0, 2.0, -2.0]), "glass"),
            ("mesh", ("mesh", [obj, "square"]), "lam"),
            ("smoke", ("constant-medium-sphere", [0.0, 2.0, -3.0, 0.5, 0.7]), "fog"),
            ("haze", ("constant-medium-cuboid", [2.0, 2.0, -5.0, 3.0, 3.0, -4.0, 0.2]), "fog")):
        doc, _ = doc.add_object(name, shape=shape, material=mats[mat], visible=True)
    blob = json.loads(json.dumps(document_to_json(doc)))
    ours = document_to_scene_param(document_from_json(blob))
    ref = jexport(jfrom_json(blob))
    assert ours == ref
    assert len(ours["objects"]) == 10
    from ray_tracing_tpu_torch import build_scene

    _assert_tables_equal(build_scene(ours).scene, jrt.build_scene(ref).scene)
