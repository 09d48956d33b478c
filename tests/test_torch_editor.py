"""The port's editor core (ray_tracing_tpu_torch/editor/): every case of
tests/test_editor.py on the port (Document mutators, Analysis, the
rerender predicate, the undo tree, the project JSON round trip,
preview-vs-final generation, the progressive render controller, the
CLI-schema export), rendering with device="cpu"; then the weekend scene
(examples/weekend_scene.py, 485 spheres) held against the JAX editor on
the same project JSON: the JSON, the compiled tables (final and
preview), the preview image and the final image's noise floor, and the
controller's accumulated mean against passes rendered one after another.

The JAX package compiles the weekend twice here (the preview and the
final render at 48x32), ~20-35 s each on the CPU."""

import asyncio
import json

import numpy as np
import pytest
import torch

import ray_tracing_tpu_torch.v4ray as v4ray
from ray_tracing_tpu_torch.editor import (
    Document,
    RendererData,
    UndoTree,
    analyze,
    document_from_json,
    document_to_json,
    generate,
    need_rerender,
)
from ray_tracing_tpu_torch.ops import rng

torch.set_num_threads(2)


def simple_doc():
    doc = Document(renderer=RendererData(32, 24, 4, (128, 128, 255)))
    doc = doc.set_camera(
        ("perspective",
         [0.0, 0.0, 1.0, 0.0, 0.0, -1.0, 60.0, 0.0, 1.0, 0.0, 0.0, 2.0, 0.0, 0.0])
    )
    doc, tex = doc.add_texture("red", ("solid color", [(204, 51, 51)]))
    doc, mat = doc.add_material("red mat", ("lambertian", [tex]))
    doc, obj = doc.add_object(
        "ball", shape=("sphere", [0.0, 0.0, -3.0, 1.0]), material=mat,
        visible=True,
    )
    return doc, tex, mat, obj


def test_mutators_are_immutable():
    doc, tex, mat, obj = simple_doc()
    doc2 = doc.modify_object(obj, visible=False)
    assert doc.objects[obj].visible is True
    assert doc2.objects[obj].visible is False


def test_analysis_validity_and_rendered():
    doc, tex, mat, obj = simple_doc()
    a = analyze(doc)
    assert tex in a.valid_textures
    assert mat in a.valid_materials
    assert obj in a.rendered_objects
    assert a.camera_valid
    assert a.rendered_materials == frozenset({mat})
    assert a.rendered_textures == frozenset({tex})

    # invalid radius -> object drops out of the rendered set
    doc_bad = doc.modify_object(obj, shape=("sphere", [0.0, 0.0, -3.0, -1.0]))
    a_bad = analyze(doc_bad)
    assert obj not in a_bad.valid_objects
    assert obj not in a_bad.rendered_objects


def test_texture_cycle_invalid():
    doc = Document()
    doc, t1 = doc.add_texture("a")
    doc, t2 = doc.add_texture("b")
    doc = doc.modify_texture(t1, texture=("checker", [t2, t2, 1.0]))
    doc = doc.modify_texture(t2, texture=("checker", [t1, t1, 1.0]))
    a = analyze(doc)
    assert t1 not in a.valid_textures
    assert t2 not in a.valid_textures
    # breaking the cycle makes both valid
    doc, solid = doc.add_texture("solid", ("solid color", [(255, 255, 255)]))
    doc = doc.modify_texture(t2, texture=("checker", [solid, solid, 1.0]))
    a = analyze(doc)
    assert a.valid_textures >= {t1, t2, solid}


def test_material_inheritance_through_groups():
    doc = Document()
    doc, tex = doc.add_texture("white", ("solid color", [(255, 255, 255)]))
    doc, mat_g = doc.add_material("group mat", ("lambertian", [tex]))
    doc, mat_o = doc.add_material("own mat", ("dielectric", [1.5]))
    doc, group = doc.add_group("g", material=mat_g, visible=True)
    doc, child1 = doc.add_object(
        "inherits", parent=group,
        shape=("sphere", [0.0, 0.0, 0.0, 1.0]), visible=True,
    )
    doc, child2 = doc.add_object(
        "own", parent=group, shape=("sphere", [2.0, 0.0, 0.0, 1.0]),
        material=mat_o, visible=True,
    )
    a = analyze(doc)
    assert a.effective_materials[child1] == mat_g
    assert a.effective_materials[child2] == mat_o
    assert a.parents[child1] == group
    assert child1 in a.rendered_objects and child2 in a.rendered_objects


def test_visibility_requires_all_ancestors():
    doc = Document()
    doc, tex = doc.add_texture("w", ("solid color", [(255, 255, 255)]))
    doc, mat = doc.add_material("m", ("lambertian", [tex]))
    doc, group = doc.add_group("g", material=mat, visible=False)
    doc, child = doc.add_object(
        "c", parent=group, shape=("sphere", [0.0, 0.0, 0.0, 1.0]), visible=True
    )
    a = analyze(doc)
    assert child not in a.visible_objects  # hidden group hides children
    doc2 = doc.modify_object(group, visible=True)
    assert child in analyze(doc2).visible_objects


def test_need_rerender_predicate():
    doc, tex, mat, obj = simple_doc()
    a = analyze(doc)
    # renaming an object does not rerender (reference main.py:1475-1513)
    doc2 = doc.modify_object(obj, name="renamed")
    assert not need_rerender(doc, a, doc2, analyze(doc2))
    # changing a rendered texture payload does
    doc3 = doc.modify_texture(tex, texture=("solid color", [(0, 255, 0)]))
    assert need_rerender(doc, a, doc3, analyze(doc3))
    # changing the camera does
    doc4 = doc.set_camera(
        ("perspective",
         [0.0, 0.0, 2.0, 0.0, 0.0, -1.0, 60.0, 0.0, 1.0, 0.0, 0.0, 2.0, 0.0, 0.0])
    )
    assert need_rerender(doc, a, doc4, analyze(doc4))
    # editing an UNRENDERED material does not
    doc5, mat2 = doc.add_material("unused", ("dielectric", [1.5]))
    assert not need_rerender(doc, a, doc5, analyze(doc5))


def test_undo_tree_branches_and_prune():
    doc, *_ = simple_doc()
    tree = UndoTree(doc, "new")
    d1 = doc.set_renderer(RendererData(64, 48, 4, (0, 0, 0)))
    tree.push(d1, "resize")
    d2 = d1.set_renderer(RendererData(128, 96, 4, (0, 0, 0)))
    tree.push(d2, "resize again")
    assert tree.document.renderer.width == 128
    assert tree.undo().renderer.width == 64
    assert tree.redo().renderer.width == 128
    # undo then a new edit -> branch
    tree.undo()
    d3 = d1.set_renderer(RendererData(256, 192, 4, (0, 0, 0)))
    tree.push(d3, "branch")
    assert tree.document.renderer.width == 256
    assert tree.undo().renderer.width == 64
    assert tree.redo().renderer.width == 256  # redo follows newest branch
    tree.prune_others()
    assert len(tree.nodes) == 3  # root -> d1 -> d3


def test_undo_tree_workspace_roundtrip(tmp_path):
    doc, *_ = simple_doc()
    tree = UndoTree(doc, "new")
    tree.push(doc.set_renderer(RendererData(64, 48, 4, (0, 0, 0))), "resize")
    path = str(tmp_path / "workspace.json")
    tree.save(path)
    tree2 = UndoTree.load(path)
    assert tree2.document.renderer.width == 64
    assert tree2.can_undo()
    assert tree2.undo().renderer.width == 32


def test_project_json_roundtrip():
    doc, tex, mat, obj = simple_doc()
    doc, group = doc.add_group("grp", material=mat, visible=True)
    doc, child = doc.add_object(
        "child", parent=group, shape=("sphere", [1.0, 0.0, -3.0, 0.5]),
        visible=True,
    )
    blob = json.dumps(document_to_json(doc))
    doc2 = document_from_json(json.loads(blob))
    assert doc2.renderer == doc.renderer
    assert doc2.camera == doc.camera
    assert set(doc2.objects) == set(doc.objects)
    assert doc2.objects[child].shape == doc.objects[child].shape
    assert doc2.objects[group].children == doc.objects[group].children
    assert doc2.materials[mat].material == doc.materials[mat].material
    assert doc2.textures[tex].texture == doc.textures[tex].texture
    a2 = analyze(doc2)
    assert child in a2.rendered_objects


def test_generate_final_and_preview():
    import asyncio

    import ray_tracing_tpu_torch.v4ray as v4ray

    doc, tex, mat, obj = simple_doc()
    scene, camera, param = generate(doc)
    assert param.max_depth == 4 and param.antialias
    assert np.allclose(scene.background, (128 / 255, 128 / 255, 1.0))
    assert scene.environment == (0.0, 0.0, 0.0)

    scene_p, camera_p, param_p = generate(doc, preview=True)
    assert param_p.max_depth == 1 and not param_p.antialias
    assert scene_p.environment == (1.0, 1.0, 1.0)
    assert camera_p.aperture == 0.0

    # the generated scene actually renders
    r = v4ray.Renderer(param_p, camera_p, scene_p, device="cpu")
    img = asyncio.run(r.render())
    assert img.shape == (24, 32, 3)
    assert np.isfinite(img).all()


def test_generate_without_camera_raises():
    doc = Document()
    with pytest.raises(ValueError):
        generate(doc)


def test_weekend_scene_example():
    from ray_tracing_tpu_torch.examples.weekend_scene import build

    doc = build(seed=1)
    a = analyze(doc)
    assert len(a.rendered_objects) > 400  # ground + ~480 small + 3 big
    assert a.camera_valid
    blob = document_to_json(doc)
    doc2 = document_from_json(blob)
    assert len(analyze(doc2).rendered_objects) == len(a.rendered_objects)
    scene, camera, param = generate(doc2, preview=True)
    assert len(scene.objects) == len(a.rendered_objects)


def test_progressive_render_controller():
    import asyncio

    import ray_tracing_tpu_torch.v4ray as v4ray
    from ray_tracing_tpu_torch.editor.render import ProgressiveRenderController

    doc, *_ = simple_doc()
    scene, camera, param = generate(doc, preview=True)
    renderer = v4ray.Renderer(param, camera, scene, device="cpu")
    updates = []

    async def run():
        ctl = ProgressiveRenderController(
            renderer, param.width, param.height,
            on_update=lambda img, n: updates.append(n), in_flight=2,
        )
        ctl.start()
        while ctl.iterations < 4:
            await asyncio.sleep(0.01)
        ctl.stop()
        await ctl.drain()
        return ctl

    ctl = asyncio.run(run())
    assert ctl.iterations >= 4
    assert updates == sorted(updates)
    img = ctl.result.mean()
    assert img.shape == (24, 32, 3)
    assert np.isfinite(img).all()


def test_export_to_cli_schema_and_render():
    """Editor Document -> CLI scene schema -> compiled scene renders the
    same picture class as the editor path."""
    from ray_tracing_tpu_torch.examples.weekend_scene import build

    from ray_tracing_tpu_torch import Renderer, RendererParam, build_scene
    from ray_tracing_tpu_torch.editor.export import document_to_scene_param

    doc = build(seed=2)
    param = document_to_scene_param(doc)
    assert param["renderer"]["width"] == 1200
    assert len(param["objects"]) == len(analyze(doc).rendered_objects)
    bundle = build_scene(param)
    assert bundle.scene.n_spheres == len(param["objects"])
    r = Renderer(RendererParam(48, 32, max_depth=3), bundle.camera, bundle.scene, device="cpu")
    img = r.render(0).numpy()
    assert img.shape == (32, 48, 3)
    assert np.isfinite(img).all()
    assert img.mean() > 0.05  # sky + spheres actually render


def test_export_marks_lights_important():
    doc = Document(renderer=RendererData(8, 8, 2, (0, 0, 0)))
    doc = doc.set_camera(
        ("perspective",
         [0.0, 0.0, 1.0, 0.0, 0.0, -1.0, 60.0, 0.0, 1.0, 0.0, 0.0, 2.0, 0.0, 0.0])
    )
    doc, mat = doc.add_material("lamp", ("diffuse light", [(255, 255, 255), 5.0]))
    doc, _ = doc.add_object(
        "light", shape=("zx-rect", [-1.0, 1.0, -1.0, 1.0, 2.0, -1.0]),
        material=mat, visible=True,
    )
    from ray_tracing_tpu_torch.editor.export import document_to_scene_param

    param = document_to_scene_param(doc)
    assert param["objects"][0]["important"] is True
    from ray_tracing_tpu_torch import build_scene

    assert build_scene(param).scene.n_lights == 1


# -- the weekend scene against the JAX editor, on one project JSON ------

WEEKEND_SIZE = (48, 32)


def _strip_keys(blob):
    """A project JSON with its UUIDs replaced by their order of first
    appearance: two builds of one scene differ only in their keys."""
    import re

    names = {}

    def rename(m):
        return names.setdefault(m.group(0), f"key{len(names)}")

    text = json.dumps(blob, sort_keys=False)
    return json.loads(re.sub(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}",
                             rename, text))


@pytest.fixture(scope="module")
def weekend():
    """The seed-1 weekend project written by the JAX editor
    (examples/weekend_scene.py), as JSON text, opened by both editors."""
    import sys

    from ray_tracing_tpu.editor import document_from_json as jfrom_json
    from ray_tracing_tpu.editor import document_to_json as jto_json

    sys.path.insert(0, "examples")
    try:
        from weekend_scene import build as jbuild
    finally:
        sys.path.pop(0)
    text = json.dumps(jto_json(jbuild(seed=1)))
    return text, document_from_json(json.loads(text)), jfrom_json(json.loads(text))


def _sized(doc, size=WEEKEND_SIZE, depth=None):
    r = doc.renderer
    return doc.set_renderer(type(r)(size[0], size[1], depth or r.max_depth, r.background))


def test_weekend_project_opens_in_the_port(weekend):
    """The JAX editor's file opens in the port and writes back equal as
    JSON; the port's own weekend_scene.build(seed=1) is the same scene
    under other keys."""
    from ray_tracing_tpu.editor import analyze as janalyze
    from ray_tracing_tpu.editor import document_to_json as jto_json
    from ray_tracing_tpu_torch.examples.weekend_scene import build

    text, ours, ref = weekend
    assert document_to_json(ours) == jto_json(ref) == json.loads(text)
    assert json.loads(json.dumps(document_to_json(ours))) == json.loads(text)
    assert _strip_keys(document_to_json(build(seed=1))) == _strip_keys(json.loads(text))
    a = analyze(ours)
    assert a.rendered_objects == janalyze(ref).rendered_objects
    assert len(a.rendered_objects) == 486  # seed 1; seed 0 (chip_smoke.py) has 485


@pytest.mark.parametrize("preview", [False, True], ids=["final", "preview"])
def test_weekend_tables_equal_jax(weekend, preview):
    """generate(doc) -> Scene.compile: the port's tables equal the JAX
    compiler's exactly, and the camera and renderer parameters match."""
    from ray_tracing_tpu.editor import generate as jgenerate

    from test_torch_scene import _assert_tables_equal

    _, ours, ref = weekend
    scene, camera, param = generate(ours, preview=preview)
    jscene, jcamera, jparam = jgenerate(ref, preview=preview)
    data = scene.compile()
    assert (data.n_spheres, data.n_rects, data.n_lights) == (486, 0, 0)
    _assert_tables_equal(data, jscene.compile())
    for f in ("look_from", "look_at", "vfov", "up", "aperture", "focus_dist", "time0", "time1"):
        assert getattr(camera, f) == getattr(jcamera, f), f
    assert (param.width, param.height, param.max_depth, param.antialias) == (
        jparam.width, jparam.height, jparam.max_depth, jparam.antialias)


def _renderers(weekend, preview, depth=None):
    """The port's and the JAX façade's renderer of the weekend at 48x32."""
    import v4ray_tpu as jv4ray
    from ray_tracing_tpu.editor import generate as jgenerate

    _, ours, ref = weekend
    mine = v4ray.Renderer(*_reorder(generate(_sized(ours, depth=depth), preview=preview)),
                          device="cpu")
    theirs = jv4ray.Renderer(*_reorder(jgenerate(_sized(ref, depth=depth), preview=preview)))
    return mine, theirs


def _reorder(generated):
    scene, camera, param = generated
    return param, camera, scene


def test_weekend_preview_equals_jax(weekend):
    """The preview (depth 1, pinhole, no antialias, white environment) at
    48x32 equals JAX's: at depth 1 a pixel does not depend on the key,
    and the ROADMAP's depth-1 rule holds 0.999 of the pixels equal (one
    pixel of 1,536 may differ, PR 1's widening for a grazing winner)."""
    mine, theirs = _renderers(weekend, preview=True)
    a = asyncio.run(mine.render())
    b = asyncio.run(theirs.render())
    assert a.shape == b.shape == (WEEKEND_SIZE[1], WEEKEND_SIZE[0], 3)
    assert np.all(a == b, axis=-1).mean() >= 0.999
    assert np.array_equal(a, asyncio.run(mine.render()))  # key-independent


def test_weekend_final_inside_noise_floor(weekend):
    """The final render (aperture 0.1, antialias) at 48x32 depth 4, 8 spp
    under the façade's keys (iterations 1-8): the mean absolute
    difference to JAX's is at most 0.6x the port's own different-key
    noise floor (8 other keys), as tests/test_torch_render.py holds zy."""
    mine, theirs = _renderers(weekend, preview=False, depth=4)
    ours = np.mean([asyncio.run(mine.render()) for _ in range(8)], axis=0)
    ref = np.mean([asyncio.run(theirs.render()) for _ in range(8)], axis=0)
    other = np.mean([mine._inner.render(rng.fold_in(rng.key(1), i)).numpy() for i in range(8)],
                    axis=0)
    assert np.isfinite(ours).all() and (ours >= 0).all()
    matched = np.abs(ours - ref).mean()
    floor = np.abs(ours - other).mean()
    assert matched <= 0.6 * floor, (matched, floor)


def test_weekend_export_equals_jax(weekend):
    """document_to_scene_param equals the JAX package's dict, and the
    port's build_scene of it equals the façade's compiled tables."""
    import ray_tracing_tpu as jrt
    from ray_tracing_tpu.editor.export import document_to_scene_param as jexport
    from ray_tracing_tpu_torch import build_scene
    from ray_tracing_tpu_torch.editor.export import document_to_scene_param

    from test_torch_scene import _assert_tables_equal

    _, ours, ref = weekend
    param = document_to_scene_param(ours)
    assert param == jexport(ref)
    scene = build_scene(param).scene
    assert (scene.n_spheres, scene.n_rects, scene.n_lights) == (486, 0, 0)
    _assert_tables_equal(scene, jrt.build_scene(param).scene)


def test_progressive_controller_in_flight_equals_passes_in_turn(weekend):
    """ProgressiveRenderController with two passes in flight (two
    executor threads) stops at exactly 4 passes, which draw iterations
    1-4; its mean equals the mean of the same four keys rendered one
    after another, to float32 summation order (rtol 1e-6, atol 1e-7)."""
    from ray_tracing_tpu_torch.editor.render import ProgressiveRenderController

    _, ours, _ = weekend
    scene, camera, param = generate(_sized(ours, (24, 16), depth=3))
    renderer = v4ray.Renderer(param, camera, scene, device="cpu")
    passes, in_flight = 4, 2

    async def run():
        ctl = ProgressiveRenderController(renderer, param.width, param.height,
                                          in_flight=in_flight)
        # stop once the passes landed and in flight make `passes`
        ctl.on_update = lambda img, n: ctl.stop() if n + in_flight - 1 >= passes else None
        ctl.start()
        while ctl._tasks:
            await ctl.drain()
        return ctl

    ctl = asyncio.run(run())
    assert ctl.result.count == passes and renderer._iteration == passes
    want = np.mean([renderer._inner.render(rng.fold_in(rng.key(0), i)).numpy()
                    for i in range(1, passes + 1)], axis=0)
    np.testing.assert_allclose(ctl.result.mean(), want, rtol=1e-6, atol=1e-7)


def test_weekend_jax_means_inside_the_card_range():
    """JAX's passes of the seed-0 weekend, the document chip_smoke.py
    renders on the card (the port's weekend_scene.build written to its
    project JSON and opened by the JAX editor), at 48x32 and the
    document's own depth 50: every per-pass mean (iterations 1-8) lies
    inside chip_smoke.WEEKEND_MEAN, which the card's 1200x800 passes are
    held to."""
    import v4ray_tpu as jv4ray
    from chip_smoke import WEEKEND_MEAN, WEEKEND_SEED
    from ray_tracing_tpu.editor import document_from_json as jfrom_json
    from ray_tracing_tpu.editor import generate as jgenerate
    from ray_tracing_tpu_torch.examples.weekend_scene import build

    doc = _sized(jfrom_json(json.loads(json.dumps(document_to_json(build(seed=WEEKEND_SEED))))))
    scene, camera, param = jgenerate(doc)
    assert (param.max_depth, param.antialias, camera.aperture) == (50, True, 0.1)
    renderer = jv4ray.Renderer(param, camera, scene)
    means = [float(np.asarray(asyncio.run(renderer.render()), np.float64).mean())
             for _ in range(8)]
    assert all(WEEKEND_MEAN[0] < m < WEEKEND_MEAN[1] for m in means), means


def test_weekend_scene_module_writes_the_project(tmp_path):
    """``python -m ray_tracing_tpu_torch.examples.weekend_scene out.json``
    writes the seed-0 project, the JAX example's scene under other keys."""
    import subprocess
    import sys

    from ray_tracing_tpu.editor import document_to_json as jto_json

    sys.path.insert(0, "examples")
    try:
        from weekend_scene import build as jbuild
    finally:
        sys.path.pop(0)
    out = tmp_path / "weekend.json"
    proc = subprocess.run([sys.executable, "-m", "ray_tracing_tpu_torch.examples.weekend_scene",
                           str(out)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"wrote {out}"
    written = json.loads(out.read_text())
    assert _strip_keys(written) == _strip_keys(jto_json(jbuild(seed=0)))
    assert len(analyze(document_from_json(written)).rendered_objects) == 485
