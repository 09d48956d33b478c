"""The benchmark's own tests: the harness's pieces on the CPU at tiny
sizes (every kernel's plain version), the reference against the port,
the control and the planted faults against the cells' limits.  Run
with ``python -m pytest benchmark/tests``; tests that need a card carry
the ``cuda`` marker and skip without one."""

import contextlib
import io
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH)
for _p in (BENCH, CHECKOUT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import pytest  # noqa: E402

# the tiny sizes every CPU run of a cell takes
TINY = {"width": 16, "height": 16, "max_depth": 3}


def resized(cell, sizes=TINY):
    """The cell with its scene's renderer set to ``sizes``."""
    import dataclasses

    scene = {**cell.scene, "renderer": {**cell.scene["renderer"], **sizes}}
    return dataclasses.replace(cell, config={**cell.config, "scene": scene})


def c6_train():
    """zy_scene.train's traffic and limits on the C6 configuration (solid
    colors only): a train cell whose sound runs read sound at CPU sizes,
    where zy's image leaf shows the port's zero-texel fault
    (test_bench_zero_texel.py) in grad_gap."""
    import dataclasses

    from harness.cells import _load, load_cell

    return dataclasses.replace(load_cell("zy_scene.train"), name="bunny_grid_c6.train",
                               config_name="bunny_grid_c6",
                               config=_load("configs", "bunny_grid_c6"))


def run_cell(name, seed: int, *, sizes=TINY, traced: bool = False, seconds: float = 0.0):
    """Drive a cell (a name, or a Cell) on the CPU as run.py drives it on
    the card, from its loop to its report, and return the result line as
    a dict."""
    import torch

    from harness import report
    from harness.cells import load_cell
    from harness.driving import Env

    cell = resized(load_cell(name) if isinstance(name, str) else name, sizes)
    t0 = time.perf_counter()
    env = Env(device=torch.device("cpu"), age=lambda: time.perf_counter() - t0)
    run = cell.loop.drive(cell, seed, seconds, traced, env)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = report.finish(cell, run, seed, traced, env)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture
def cell_run():
    return run_cell
