"""BENCHMARK.json and the files the harness finds by name agree, and each
configuration is the scene its source names."""

import dataclasses
import json
import os
import re
from pathlib import Path

import pytest
import torch

from conftest import BENCH, CHECKOUT
from harness.cells import load_cell, metric_readers

with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as fh:
    BENCHMARK = json.load(fh)
CHECKOUT_PATH = Path(CHECKOUT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("w", BENCHMARK["workloads"], ids=lambda w: w["name"])
def test_cell_files_agree(w):
    cell = load_cell(w["name"])
    assert (cell.config_name, cell.traffic_name, cell.chips) == (w["config"], w["traffic"],
                                                                 w["chips"])
    with open(os.path.join(BENCH, "workloads", w["name"] + ".json")) as fh:
        assert json.load(fh)["why"] == w["why"]
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    reported = {m["name"] for m in BENCHMARK["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])}
    assert reported == {"setup_s", cell.traffic["metric"]}


@pytest.mark.parametrize("c", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_config_files_agree(c):
    with open(os.path.join(CHECKOUT, c["file"])) as fh:
        cfg = json.load(fh)
    assert (cfg["source"], cfg["reduced"], cfg["why"]) == (c["source"], c["reduced"], c["why"])


@pytest.mark.parametrize("mix", sorted(p.stem for p in (CHECKOUT_PATH / "benchmark" / "traffic").glob("*.json")))
def test_every_mix_names_a_loop_found_by_name(mix):
    """A mix is data naming a loop; the loop is a module of its own
    (loops/<loop>.py) with what the harness calls, and no file of the
    harness names a loop."""
    from harness.cells import _load, load_loop

    name = _load("traffic", mix)["loop"]
    loop = load_loop(name)
    for part in ("drive", "reference", "numbers", "notes"):
        assert callable(getattr(loop, part)), (name, part)
    assert loop.FAULTS, name
    for path in sorted((CHECKOUT_PATH / "benchmark" / "harness").glob("*.py")) + [
            CHECKOUT_PATH / "benchmark" / "run.py"]:
        assert f'"{name}"' not in path.read_text(), (path, name)


def test_metric_readers_exist_with_their_units():
    readers = metric_readers()
    for m in BENCHMARK["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"], m["name"]
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in BENCHMARK["end_to_end"]
                                  if cell in e.get("workloads", [cell])}


def test_names_keep_to_the_rules():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCHMARK[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(len(w["why"]) <= 200 for w in BENCHMARK["workloads"] + BENCHMARK["configs"])


def test_zy_scene_is_the_upstream_file():
    with open(os.path.join(CHECKOUT, "data", "zy_scene.json")) as fh:
        assert load_cell("zy_scene.render").scene == json.load(fh)


def test_bunny_grid_is_the_gallery_c6():
    """The configuration's scene compiles to the tables of
    scenes.bunny_grid(), the gallery's C6, field for field."""
    from ray_tracing_tpu_torch import build_scene, scenes

    cell = load_cell("bunny_grid_c6.render")
    ours = build_scene(cell.scene, base_dir=cell.data_dir)
    theirs, camera, rp = scenes.bunny_grid()

    def same(a, b, path):
        if dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b), path
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}[{i}]")
        else:
            assert a == b, path

    same(ours.scene, theirs, "scene")
    assert (ours.renderer.width, ours.renderer.height) == (rp.width, rp.height)
    assert ours.renderer.max_depth == 20 and rp.max_depth is None  # the renderer's default
    assert list(ours.camera.look_from) == list(camera.look_from)
    assert list(ours.camera.look_at) == list(camera.look_at)
    assert ours.camera.vfov == camera.vfov
