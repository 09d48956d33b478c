"""The control on the CPU at tiny sizes: the reference with its
wavefront state rounded to bfloat16 after every bounce, put in the
program's place, fails the cell's limits.  On the card the same
readings (readings.py) are taken at each cell's own size; PERF.md has
them."""

import time

import pytest
import torch

from conftest import c6_train, resized
from harness import verdict
from harness.cells import load_cell
from harness.driving import Env
from readings import readings


@pytest.mark.parametrize("cell", ["zy_scene.render", "bunny_grid_c6.render", "zy_scene.train",
                                  "bunny_grid_c6.train"])
def test_control_is_not_correct(cell):
    c = resized(c6_train() if cell == "bunny_grid_c6.train" else load_cell(cell))
    t0 = time.perf_counter()
    env = Env(device=torch.device("cpu"), age=lambda: time.perf_counter() - t0)
    out = readings(c, 2**34 + 3, 0.0, env)
    assert not verdict.judge(c, out["control"]), out["control"]
