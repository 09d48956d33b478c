"""The roofline arithmetic copied from chip_smoke.py."""

import pytest

from harness.cells import load_cell
from harness.roofline import bound, phase_a_bound, phase_a_work
from reference.render import compile_scene


def test_zy_phase_a_tile_is_bound_by_bytes():
    """A 65,536-ray phase-A launch on zy's tables (9 spheres, 6 rects) is
    bound by its bytes at 0.000704 ms (PERF.md's K1 row)."""
    cell = load_cell("zy_scene.render")
    tables = compile_scene(cell.scene, cell.data_dir, "cpu")[0].phase_a
    assert (tables.sph.shape[0], tables.rect.shape[0]) == (9, 6)
    ms, by = phase_a_bound(tables, 65536)
    assert by == "bytes"
    assert ms == pytest.approx(0.000704, abs=5e-7)
    flops, nbytes = phase_a_work(tables, 65536)
    assert flops == 65536 * (9 * 20 + 6 * 36)
    assert nbytes == 65536 * 36 + 4 * (tables.sph.numel() + tables.rect.numel())


def test_launches_add_the_tables_once_each():
    cell = load_cell("bunny_grid_c6.render")
    tables = compile_scene(cell.scene, cell.data_dir, "cpu")[0].phase_a
    one = phase_a_work(tables, 1000, 1)[1]
    assert phase_a_work(tables, 1000, 3)[1] - one == 2 * 4 * tables.rect.numel()


def test_bound_takes_the_larger_side():
    assert bound(67e9, 0) == (pytest.approx(1.0), "operations")
    assert bound(0, 3.35e9) == (pytest.approx(1.0), "bytes")
