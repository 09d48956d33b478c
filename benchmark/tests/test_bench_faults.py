"""The harness's verdict on the CPU at tiny sizes: a sound run of a cell
is correct, and a run with the timed path broken underneath is not, once
for each fault the cell can have (its loop's FAULTS): a render pass whose
answer is altered where it is produced, or that leaves half of its rays
out; a train step that returns its state unchanged, or that leaves half
of its rays out and takes the mean over the rest.  Where the sound run
of the same seed is correct, each fault fails a number that it passes."""

import functools

import pytest

from conftest import c6_train, run_cell
from harness.faults import faults_of, planted

RENDER_CELLS = ("zy_scene.render", "bunny_grid_c6.render")
# bunny_grid_c6.train is zy_scene.train's loop and limits on C6
# (conftest.c6_train): at these sizes zy's sound run itself fails grad_gap
# on the port's zero-texel fault (test_bench_zero_texel.py)
TRAIN_CELLS = ("zy_scene.train", "bunny_grid_c6.train")
SEED = 2**33 + 5


@functools.lru_cache(maxsize=None)
def sound(cell):
    return run_cell(_cell(cell), SEED)


def _cell(name):
    return c6_train() if name == "bunny_grid_c6.train" else name


@pytest.mark.parametrize("cell", RENDER_CELLS + ("bunny_grid_c6.train",))
def test_sound_run_is_correct(cell):
    out = sound(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 2


@pytest.mark.parametrize("cell,fault", [(c, f) for c in RENDER_CELLS for f in faults_of("render")]
                         + [(c, f) for c in TRAIN_CELLS for f in faults_of("train")])
def test_broken_run_is_not_correct(cell, fault):
    with planted("render" if cell in RENDER_CELLS else "train", fault):
        out = run_cell(_cell(cell), SEED)
    assert not out["correct"]
    if sound(cell)["correct"]:
        failed = [k for k, c in out["checks"].items() if not c["value"] <= c["limit"]]
        assert any(sound(cell)["checks"][k]["value"] <= out["checks"][k]["limit"]
                   for k in failed), (failed, out["checks"])
