"""harness/spans.py and the readers of the program's spans, on a
synthetic trace: known device activities and host spans (nested ones,
sync spans, an idle gap inside spans and one outside), and a trace of a
program without spans."""

import types

import numpy as np
import pytest

from harness.cells import metric_readers
from harness.profile import Trace
from harness.spans import OUTSIDE, count, idle_by_span, innermost, wall_s

MS = 1_000_000  # ns


def _trace(cpu, device):
    """A :class:`Trace` of host events ``cpu`` [(start, end, name)] and
    device activities ``device`` [(start, end)], in ms."""
    tr = Trace.__new__(Trace)
    tr.cpu = [(s * MS, e * MS, n) for s, e, n in cpu]
    tr.names = ["kernel"] * len(device)
    tr.start = np.asarray([s * MS for s, _ in device], np.int64)
    tr.dur = np.asarray([(e - s) * MS for s, e in device], np.int64)
    tr.busy_s, tr._gaps = tr._union()
    return tr


# a step: two tiles of taped forward (an intersect and a shade each, the
# second shade holding a sync) and sweep, then the tangent pass with one
# sync; an aten op (not a span) and a sync outside the phases
STEP = [
    (0, 10, "rtt.taped_forward"), (1, 4, "rtt.intersect"), (4, 9, "rtt.shade"),
    (2, 3, "aten::mul"),
    (10, 12, "rtt.tape_sweep"),
    (12, 20, "rtt.taped_forward"), (12, 15, "rtt.intersect"), (15, 19, "rtt.shade"),
    (16, 17, "rtt.sync.textures.image_sel"),
    (20, 21, "rtt.tape_sweep"),
    (22, 30, "rtt.tangent_pass"), (23, 24, "rtt.sync.prb_scalar.touched"),
    (31, 32, "rtt.sync.renderer.to_host"),
]
# device busy 0-2, 5-16.5, 18-40: idle 2-5 and 16.5-18
DEVICE = [(0, 2), (5, 16.5), (18, 25), (24, 40)]


def test_walls_are_unions():
    tr = _trace(STEP, DEVICE)
    assert wall_s(tr, "rtt.taped_forward") == pytest.approx(18e-3)
    assert wall_s(tr, "rtt.tape_sweep") == pytest.approx(3e-3)
    assert wall_s(tr, "rtt.tangent_pass") == pytest.approx(8e-3)
    assert wall_s(tr, "rtt.sync.") == pytest.approx(3e-3)
    assert wall_s(tr, "rtt.shade") == pytest.approx(9e-3)
    # overlapping intervals of one name count once
    over = _trace([(0, 4, "rtt.a"), (2, 6, "rtt.a"), (8, 9, "rtt.a"), (8.5, 8.7, "rtt.a")], [])
    assert wall_s(over, "rtt.a") == pytest.approx(7e-3)
    assert wall_s(over, "rtt.b") == 0.0


def test_counts_by_name_and_prefix():
    tr = _trace(STEP, DEVICE)
    assert count(tr, "rtt.sync.") == 3
    assert count(tr, "rtt.taped_forward") == 2
    assert count(tr, "rtt.tape") == 0  # a name without the dot is exact
    assert count(tr, "rtt.") == len(STEP) - 1


def test_idle_by_innermost_span():
    tr = _trace(STEP + [(33, 50, "aten::add")], DEVICE + [(42, 45)])
    # gaps: 2-5 (mid 3.5, inside intersect 1-4), 16.5-18 (mid 17.25, shade
    # 15-19), 40-42 (mid 41, outside every span: the aten op is no span)
    got = dict(idle_by_span(tr))
    assert got == pytest.approx({"rtt.intersect": 3e-3, "rtt.shade": 1.5e-3, OUTSIDE: 2e-3})
    assert [n for n, _ in idle_by_span(tr)] == ["rtt.intersect", OUTSIDE, "rtt.shade"]


def test_innermost_timeline():
    bounds, labels = innermost([(0, 10, "a"), (1, 4, "b"), (2, 3, "c"), (4, 9, "d"),
                                (12, 13, "e")])
    assert bounds.tolist() == [0, 1, 2, 3, 4, 4, 9, 10, 12, 13]
    assert labels == ["a", "b", "c", "b", "a", "d", "a", OUTSIDE, "e", OUTSIDE]


def test_no_spans_reads_nothing():
    tr = _trace([(0, 10, "aten::mul")], DEVICE)
    assert wall_s(tr, "rtt.shade") is None
    assert count(tr, "rtt.sync.") is None
    assert idle_by_span(tr) is None


NEW = {
    "taped_forward_ms.train": ("train", 18.0), "tape_sweep_ms.train": ("train", 3.0),
    "tangent_ms.train": ("train", 8.0), "host_syncs_per_step.train": ("train", 3),
    "host_sync_ms.train": ("train", 3.0), "intersect_ms.render": ("render", 6.0),
    "shade_ms.render": ("render", 9.0), "compact_ms.render": ("render", 0.0),
    "host_syncs_per_pass.render": ("render", 3), "host_sync_ms.render": ("render", 3.0),
}


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader(name):
    """Each reader reads its span in its own loop's trace, nothing in the
    other loop's, nor in a trace without spans."""
    loop, want = NEW[name]
    other = "render" if loop == "train" else "train"
    mod = metric_readers()[name]
    read = lambda lp, tr: mod.read(types.SimpleNamespace(loop=lp, trace=tr))  # noqa: E731
    assert read(loop, _trace(STEP, DEVICE)) == pytest.approx(want)
    assert read(other, _trace(STEP, DEVICE)) is None
    assert read(loop, _trace([(0, 1, "aten::mul")], DEVICE)) is None
    assert read(loop, None) is None


@pytest.mark.parametrize("cell", ["bunny_grid_c6.render", "zy_scene.train"])
def test_traced_cpu_run_reads_every_span_metric(cell_run, cell):
    """A tiny traced CPU run of each cell (depth 6: a compaction stage)
    reports every span metric its cell lists in BENCHMARK.json."""
    import json
    import os

    from conftest import CHECKOUT

    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as fh:
        listed = {m["name"] for m in json.load(fh)["per_layer"]
                  if m["name"] in NEW and cell in m["workloads"]}
    assert len(listed) == 5
    got = cell_run(cell, 3600000002, sizes={"width": 12, "height": 12, "max_depth": 6},
                   traced=True)["metrics"]
    assert all(got.get(name, {}).get("value") is not None for name in listed), got
