"""The readers of the program's tile spans (``rtt.tile``: one per tile of
render/renderer.py:render_pass and of parallel/mesh.py:tiled_loss_and_grad)
on synthetic traces: a pass of four tiles and a step of ten, a program
with spans but without the tile span (nothing to read), a program
without spans, and a tiny traced CPU run of each cell."""

import types

import pytest
from test_bench_spans import DEVICE, _trace

from harness.cells import metric_readers

READERS = {"tiles_per_pass.render": ("render", 4), "tiles_per_step.train": ("train", 10)}


def _tiles(n):
    """Host events of ``n`` tiles, each holding an intersect and a shade,
    and a sync span after them."""
    cpu = []
    for i in range(n):
        cpu += [(3 * i, 3 * i + 3, "rtt.tile"), (3 * i, 3 * i + 1, "rtt.intersect"),
                (3 * i + 1, 3 * i + 3, "rtt.shade")]
    return cpu + [(3 * n, 3 * n + 1, "rtt.sync.renderer.to_host")]


@pytest.mark.parametrize("name", sorted(READERS))
def test_tile_reader(name):
    """Each reader counts the tile spans of its own loop's trace, and
    reads nothing in the other loop's, in a trace whose program records
    spans but no tile span, in one without spans, or without a trace."""
    loop, n = READERS[name]
    other = "render" if loop == "train" else "train"
    mod = metric_readers()[name]
    read = lambda lp, tr: mod.read(types.SimpleNamespace(loop=lp, trace=tr))  # noqa: E731
    assert mod.UNIT == "tiles"
    assert read(loop, _trace(_tiles(n), DEVICE)) == n
    assert read(other, _trace(_tiles(n), DEVICE)) is None
    untiled = [ev for ev in _tiles(n) if ev[2] != "rtt.tile"]
    assert read(loop, _trace(untiled, DEVICE)) is None
    assert read(loop, _trace([(0, 1, "aten::mul")], DEVICE)) is None
    assert read(loop, None) is None


@pytest.mark.parametrize("cell,name", [("bunny_grid_c6.render", "tiles_per_pass.render"),
                                       ("zy_scene.train", "tiles_per_step.train")])
def test_traced_cpu_run_reads_one_tile(cell_run, cell, name):
    """A tiny traced CPU run of each cell (12x12, one tile on the CPU
    too) reports its tile reader at 1."""
    got = cell_run(cell, 3600000003, sizes={"width": 12, "height": 12, "max_depth": 3},
                   traced=True)["metrics"]
    assert got[name]["value"] == 1, got
