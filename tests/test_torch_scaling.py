"""bench_scaling_torch.py (the weak-scaling harness of the port) on the
CPU: one and two gloo ranks at 256 rays per rank, depth 2, one pass.
Every line carries bench_scaling.py's keys, and the two-rank loss, color
gradient and segment count equal those of the same rays traced by one
process (the unsharded baseline): the loss and gradient to rtol 1e-6,
the order of the sums, the segments exactly."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_KEYS = ("metric", "value", "unit", "per_device", "devices", "segments_per_pass",
            "primary_rays_per_pass", "unsharded_same_work_s", "sharded_s", "sharding_overhead")
FINAL_KEYS = ("metric", "value", "unit", "target", "note")


@pytest.fixture(scope="module")
def lines():
    run = subprocess.run(
        [sys.executable, "bench_scaling_torch.py", "--force-cpu", "--devices", "1,2",
         "--rays-per-device", "256", "--depth", "2", "--passes", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return [json.loads(x) for x in run.stdout.splitlines() if x.startswith("{")]


def test_every_line_carries_the_jax_keys(lines):
    assert len(lines) == 3
    for k, rec in zip((1, 2), lines):
        assert all(key in rec for key in JAX_KEYS), rec.keys()
        assert rec["devices"] == k and rec["primary_rays_per_pass"] == 256 * k
        assert rec["metric"] == f"sharded fwd+bwd rays/s ({k} devices)"
        for key in ("value", "per_device", "sharded_s", "unsharded_same_work_s",
                    "sharding_overhead"):
            assert np.isfinite(rec[key]) and rec[key] > 0, key
    assert tuple(lines[2]) == FINAL_KEYS
    assert lines[2]["metric"] == "scaling efficiency 1->2 devices"
    assert lines[2]["value"] == pytest.approx(lines[1]["per_device"] / lines[0]["per_device"])


@pytest.mark.parametrize("k", [1, 2])
def test_sharded_equals_unsharded(lines, k):
    """The ranks' all-reduced loss and color gradient against one process
    tracing all their rays; the segment counts equal; the rays differ
    per rank (rank 1's gradient is not rank 0's)."""
    rec = lines[k - 1]
    assert rec["segments_per_pass"] == rec["unsharded_segments_per_pass"] > 256 * k
    np.testing.assert_allclose(rec["loss"], rec["unsharded_loss"], rtol=1e-6)
    g, gu = np.asarray(rec["color_grad"]), np.asarray(rec["unsharded_color_grad"])
    np.testing.assert_allclose(g, gu, rtol=1e-6, atol=0)
    assert np.abs(g).sum() > 0
    if k == 2:
        assert not np.allclose(g, lines[0]["color_grad"])
