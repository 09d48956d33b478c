"""The web editor's live preview of the One Weekend scene, held against
the benchmark's plain reference (benchmark/reference/preview.py) on the
CPU at 48x32: the configuration of the ``weekend.preview`` cell
(benchmark/configs/weekend.json) opened as a project, a seeded run of
rounds that holds every edit kind of the cell's mix, undo included, and
each round's PNG against the reference's image of the same edits; and
each planted fault of the cell's loop above the cell's limit."""

import dataclasses
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from harness.cells import load_cell  # noqa: E402
from harness.driving import Env  # noqa: E402
from harness.faults import planted  # noqa: E402

torch.set_num_threads(2)

SIZE = {"width": 48, "height": 32}
SEED = 3918000007
# every kind of the mix; the camera's orbit second, so that a preview one
# edit behind shows at 48x32
KINDS = ["set_shape", "set_camera", "set_texture", "set_material", "set_object", "undo",
         "set_shape", "undo"]


@pytest.fixture(scope="module")
def cell():
    """weekend.preview with its scene and its project at 48x32."""
    c = load_cell("weekend.preview")
    scene = {**c.scene, "renderer": {**c.scene["renderer"], **SIZE}}
    project = {**c.config["project"], "render": {**c.config["project"]["render"], **SIZE}}
    return dataclasses.replace(c, config={**c.config, "scene": scene, "project": project})


def _rounds(cell, kinds=KINDS):
    """Drive the loop's rounds on the CPU, the edit kinds in the order
    ``kinds`` (the rest drawn from the seed): (edit log, {round: the
    render reply})."""
    from ray_tracing_tpu_torch.editor.web import EditorSession

    loop = cell.loop
    session = EditorSession(device="cpu")
    loop._post(session, loop.EDIT_PATH, {"action": "load_project",
                                         "project": cell.config["project"]})
    draw = loop._Draw(cell.traffic, session.tree.document, SEED)
    order = iter(kinds)
    draw._kind = lambda: next(order)
    log, replies = [], {}
    for r in range(len(kinds)):
        path, body, edit = draw(session.tree.document)
        log.append(edit)
        with session.lock:
            state = json.loads(loop._post(session, path, body))
        assert state["can_undo"]  # the opened project stays on the tree
        with session.lock:
            replies[r] = loop._render(session)
    return dict(edits=log, replies=replies)


def _gaps(cell, outputs):
    env = Env(device=torch.device("cpu"), age=lambda: 0.0)
    return cell.loop._gaps(outputs, cell.loop.reference(cell, outputs, SEED, env))


def test_every_round_follows_the_reference(cell):
    """Each round's preview, the project's edits and undos applied by the
    editor, equals the reference's image of the same edits inside the
    cell's limit."""
    outputs = _rounds(cell)
    assert [e["kind"] for e in outputs["edits"]] == KINDS
    limit = cell.limits["preview_px_gap"]
    gaps = _gaps(cell, outputs)
    assert len(gaps) == len(KINDS)
    assert all(g <= limit for g in gaps.values()), gaps


@pytest.mark.parametrize("fault", ["stale", "altered"])
def test_faults_pass_the_limit(cell, fault):
    with planted("preview", fault):
        outputs = _rounds(cell)
    assert max(_gaps(cell, outputs).values()) > cell.limits["preview_px_gap"]


def test_project_exports_to_the_scene(cell):
    """The configuration's project, opened by the editor and exported to
    the reference schema, is the configuration's scene, object for
    object in the same order; and it is weekend_scene.build(seed=0)
    (whose keys are fresh uuids) up to that order."""
    from ray_tracing_tpu_torch.editor.export import document_to_scene_param
    from ray_tracing_tpu_torch.editor.project import document_from_json
    from ray_tracing_tpu_torch.examples.weekend_scene import build

    full = load_cell("weekend.preview").config
    assert document_to_scene_param(document_from_json(full["project"])) == full["scene"]
    fresh = document_to_scene_param(build(0))

    def key(scene):
        mats = {m["name"]: m for m in scene["materials"]}
        return sorted(json.dumps([o["shape"], mats[o["material"]]], sort_keys=True)
                      for o in scene["objects"])

    assert key(fresh) == key(full["scene"])
    assert {k: v for k, v in fresh.items() if k not in ("objects", "materials", "textures")} \
        == {k: v for k, v in full["scene"].items()
            if k not in ("objects", "materials", "textures")}
    assert len(full["scene"]["objects"]) == 485
