"""The port's fit examples (ray_tracing_tpu_torch/examples/) run as
``python -m`` on the CPU at the sizes tests/test_examples.py gives the
JAX package's scripts, and reach their final report line; without a GPU
the default ``--device cuda`` exits 1 with a message."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", f"ray_tracing_tpu_torch.examples.{module}", *args],
                          capture_output=True, text=True, timeout=300, env=env, cwd=REPO)


@pytest.mark.parametrize("module,args,expect", [
    ("fit_albedo", ["--steps", "6", "--size", "16"], "final per-texture error"),
    ("fit_materials", ["--steps", "12", "--size", "16", "--depth", "4"], "final |fuzz err|"),
    ("fit_geometry", ["--steps", "8", "--size", "16"], "final geometry error"),
])
def test_example_runs_on_the_cpu(module, args, expect):
    proc = _run(module, *args, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert expect in proc.stdout, proc.stdout[-2000:]


def test_example_without_a_gpu_exits_with_a_message():
    """The default device is the card; with none it exits 1 and says so
    (torch here has no CUDA), never falling back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    proc = _run("fit_albedo", "--steps", "1", "--size", "8")
    assert proc.returncode == 1
    assert "no CUDA device" in proc.stderr and "final" not in proc.stdout
