"""The ``preview`` loop (loops/preview.py) and its readers: a sound CPU
run of ``weekend.preview`` at 48x32 is correct and each of its loop's
faults is not, by its limit; its six per-layer readers on a synthetic
trace read their spans and kernels in the preview loop only, and read
nothing from a program without the editor's spans; and the PNG decoder
reads what the editor writes."""

import dataclasses
import types

import numpy as np
import pytest

from conftest import run_cell
from harness.cells import load_cell, load_loop, metric_readers
from harness.faults import faults_of, planted
from harness.profile import Trace

SIZE = {"width": 48, "height": 32}
SEED = 2**33 + 33  # its second round orbits the camera: a preview one edit behind shows
MS = 1_000_000  # ns


def _small():
    c = load_cell("weekend.preview")
    project = {**c.config["project"], "render": {**c.config["project"]["render"], **SIZE}}
    return dataclasses.replace(c, config={**c.config, "project": project})


def test_sound_run_is_correct():
    out = run_cell(_small(), SEED, sizes=SIZE)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == 3
    assert out["checks"]["preview_px_gap"]["value"] == 0.0


@pytest.mark.parametrize("fault", faults_of("preview"))
def test_broken_run_is_not_correct(fault):
    with planted("preview", fault):
        out = run_cell(_small(), SEED, sizes=SIZE)
    assert not out["correct"]
    check = out["checks"]["preview_px_gap"]
    assert check["value"] > check["limit"]


def test_png_decodes_as_written():
    from ray_tracing_tpu_torch.utils.image import encode_png

    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    assert np.array_equal(load_loop("preview").decode_png(encode_png(img)), img)


def _trace(cpu, device, counted=None, names=None):
    """A :class:`Trace` of host events ``cpu`` [(start, end, name)] and
    device activities ``device`` [(start, end)], in ms."""
    tr = Trace.__new__(Trace)
    tr.cpu = [(s * MS, e * MS, n) for s, e, n in cpu]
    tr.names = names or ["kernel"] * len(device)
    tr.start = np.asarray([s * MS for s, _ in device], np.int64)
    tr.dur = np.asarray([(e - s) * MS for s, e in device], np.int64)
    tr.kernels = {}
    for name, s, e in zip(tr.names, tr.start, tr.start + tr.dur):
        n, total = tr.kernels.get(name, (0, 0.0))
        tr.kernels[name] = (n + 1, total + (e - s) * 1e-9)
    tr.counted = counted or {}
    tr.busy_s, tr._gaps = tr._union()
    tr.window_s = 0.1
    return tr


# a round: the edit and its state, the preview's generate, compile, tile,
# host copy and two PNG spans; one K1 launch of 2 ms, a copy of 1 ms
ROUND = [
    (0, 4, "rtt.edit"), (4, 10, "rtt.state"), (11, 14, "rtt.generate"),
    (14, 16, "rtt.compile"), (16, 30, "rtt.tile"), (30, 31, "rtt.sync.web.to_host"),
    (32, 50, "rtt.png"), (50, 55, "rtt.png"),
]
DEVICE = [(20, 22), (30, 31)]
K1 = "void phase_a_kernel<false, false, false>(float const*)"
WANT = {"edit_ms.preview": 10.0, "generate_ms.preview": 3.0, "compile_ms.preview": 2.0,
        "png_ms.preview": 23.0, "device_idle_pct.preview": 97.0,
        "k1_roofline.preview": 25.0}


def _ctx(loop, trace, readings=None):
    return types.SimpleNamespace(loop=loop, trace=trace, readings=readings or {})


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    """Each reader reads its span or kernel in the preview loop's trace,
    nothing in the render loop's, nor from a program whose trace has
    spans but not the editor's (one older than them), nor without a
    trace."""
    mod = metric_readers()[name]
    full = _trace(ROUND, DEVICE, {"K1": 1}, [K1, "Memcpy DtoH"])
    readings = {"k1_bound_ms": 0.5}
    assert mod.read(_ctx("preview", full, readings)) == pytest.approx(WANT[name])
    assert mod.read(_ctx("render", full, readings)) is None
    assert mod.read(_ctx("preview", None, readings)) is None
    older = _trace([(16, 30, "rtt.tile")], DEVICE, {"K1": 1}, [K1, "Memcpy DtoH"])
    got = mod.read(_ctx("preview", older, readings))
    if name.startswith(("k1_", "device_")):  # read from the device, in any program
        assert got == pytest.approx(WANT[name])
    else:
        assert got is None
