"""The port's progressive-render CLI and its utilities against the JAX
package's: ``rng.fold_in`` bit-equal to ``jax.random.fold_in``; the CLI
(``--device cpu``) logging, saving and resuming as ``ray_tracing_tpu.cli``
does, with the same depth-1 image; checkpoints that either package
reads; BMP, PNG and HDR bytes; ``RenderStats``; ``torch_trace``; and
``Renderer.render_to_noise`` / ``render_async``.  Scenes are 16x16 to
32x32 at depth 1 to 3."""

import asyncio
import glob
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import ray_tracing_tpu as jrt
import ray_tracing_tpu_torch as prt
from ray_tracing_tpu import native
from ray_tracing_tpu.cli import main as jax_main
from ray_tracing_tpu.render.renderer import RenderResult as JRenderResult
from ray_tracing_tpu.utils import checkpoint as jckpt
from ray_tracing_tpu.utils import image as jimage
from ray_tracing_tpu.utils.profiling import RenderStats as JRenderStats
from ray_tracing_tpu_torch.cli import main
from ray_tracing_tpu_torch.ops import rng
from ray_tracing_tpu_torch.utils import checkpoint as ckpt
from ray_tracing_tpu_torch.utils import image
from ray_tracing_tpu_torch.utils.profiling import RenderStats, torch_trace

torch.set_num_threads(2)

ZY = "data/zy_scene.json"
FOLD_DATA = (0, 1, 7, 4095, 2**31 - 1, 2**32 - 1)
SIZES = [(1, 1), (7, 5), (24, 16), (33, 2)]  # odd widths pad BMP rows


def _cli(tmp_path, out, *extra, depth=3, size=(24, 16), fn=main):
    argv = ["-i", ZY, "-o", str(tmp_path / out), "--width", str(size[0]),
            "--height", str(size[1]), "--max-depth", str(depth), *extra]
    if fn is main:
        argv += ["--device", "cpu"]
    assert fn(argv) == 0


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _u8(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 42, -3, 2**31 - 1])
def test_fold_in_equals_jax(seed):
    """Both words equal jax.random.fold_in's for every data value, the
    uint32 extremes included."""
    for d in FOLD_DATA:
        want = np.asarray(jax.random.key_data(jax.random.fold_in(jax.random.key(seed), d)))
        got = rng.fold_in(rng.key(seed), d)
        assert got.dtype == np.uint32 and np.array_equal(got, want), (seed, d)


@pytest.mark.parametrize("data", [-1, 2**32])
def test_fold_in_refuses_non_uint32(data):
    with pytest.raises(ValueError, match="uint32"):
        rng.fold_in(rng.key(0), data)


def test_cli_logs_and_saves(tmp_path, capsys):
    """The reference's log lines (``Iter N +Ts``, ``Iter N saved`` after
    every pass with --save-interval 0) and a BMP of the asked size."""
    _cli(tmp_path, "out.bmp", "--iterations", "2", "--save-interval", "0")
    out = capsys.readouterr().out
    for line in ("Iter 1 +", "Iter 2 +", "Iter 1 saved", "Iter 2 saved"):
        assert line in out
    assert _pixels(tmp_path / "out.bmp").shape == (16, 24, 3)


def test_cli_depth_one_matches_jax(tmp_path):
    """Same seed, 32^2 depth 1, two passes: >= 99.9 % of the pixels of
    the port's BMP and of its checkpoint's sum equal the JAX CLI's."""
    for fn, tag in ((main, "torch"), (jax_main, "jax")):
        _cli(tmp_path, f"{tag}.bmp", "--iterations", "2", "--seed", "5", "--checkpoint",
             str(tmp_path / f"{tag}.ckpt"), depth=1, size=(32, 32), fn=fn)
    a, b = _pixels(tmp_path / "torch.bmp"), _pixels(tmp_path / "jax.bmp")
    assert a.shape == b.shape == (32, 32, 3)
    assert np.all(a == b, axis=-1).mean() >= 0.999
    sa, sb = (ckpt.load_render(str(tmp_path / f"{t}.ckpt"))[0].sum for t in ("torch", "jax"))
    assert np.all(sa == sb, axis=-1).mean() >= 0.999


def test_cli_resume_equals_straight_run(tmp_path, capsys):
    """4 passes in one run (with --stats) == 2 passes, then a resumed run
    to 4: checkpoint sums np.array_equal, BMP files byte-equal."""
    _cli(tmp_path, "a.bmp", "--iterations", "4", "--checkpoint", str(tmp_path / "a.ckpt"),
         "--stats", str(tmp_path / "a.json"))
    _cli(tmp_path, "b.bmp", "--iterations", "2", "--checkpoint", str(tmp_path / "b.ckpt"))
    capsys.readouterr()
    _cli(tmp_path, "b.bmp", "--iterations", "4", "--checkpoint", str(tmp_path / "b.ckpt"))
    assert "resumed at iteration 2" in capsys.readouterr().out
    (ra, seed_a), (rb, seed_b) = (ckpt.load_render(str(tmp_path / f"{t}.ckpt")) for t in "ab")
    assert ra.count == rb.count == 4 and seed_a == seed_b == 0
    assert np.array_equal(ra.sum, rb.sum)
    assert (tmp_path / "a.bmp").read_bytes() == (tmp_path / "b.bmp").read_bytes()
    with open(tmp_path / "a.json") as fh:
        stats = json.load(fh)
    assert stats["summary"]["passes"] == 4 and stats["summary"]["total_segments"] > 0


def test_cli_hdr_output(tmp_path):
    """-o out.hdr writes the linear mean radiance as RGBE."""
    _cli(tmp_path, "r.hdr", "--iterations", "1")
    img = image.load_hdr(str(tmp_path / "r.hdr"))
    assert img.shape == (16, 24, 3)
    assert np.isfinite(img).all() and (img >= 0).all() and img.max() > 0


def test_cli_without_gpu_exits(tmp_path, monkeypatch):
    """The default device is cuda; with no GPU the CLI exits non-zero
    with a message before loading the scene, and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        main(["-i", ZY, "-o", str(tmp_path / "x.bmp"), "--iterations", "1"])
    assert exc.value.code not in (0, None)
    assert "no CUDA device" in str(exc.value.code)
    assert not (tmp_path / "x.bmp").exists()


def test_cli_module_entry_point(tmp_path):
    """``python -m ray_tracing_tpu_torch.cli --device cpu`` renders,
    logs, writes the PNG, and imports neither jax nor ray_tracing_tpu
    (``-X importtime`` lists every module imported)."""
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    out = tmp_path / "out.png"
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "ray_tracing_tpu_torch.cli", "-i", ZY,
         "-o", str(out), "--iterations", "1", "--width", "16", "--height", "16",
         "--max-depth", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Iter 1 +" in proc.stdout and "Iter 1 saved" in proc.stdout
    assert _pixels(out).shape == (16, 16, 3)
    modules = [line.split("|")[-1].strip() for line in proc.stderr.splitlines()
               if line.startswith("import time:")]
    assert "ray_tracing_tpu_torch.render.renderer" in modules
    assert not [m for m in modules if m.split(".")[0] in ("jax", "ray_tracing_tpu")]


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_checkpoints_cross_load(tmp_path, direction):
    """Render and fit checkpoints written by one package load in the
    other with the same values."""
    src, dst = (jckpt, ckpt) if direction == "jax-to-port" else (ckpt, jckpt)
    result = (JRenderResult if src is jckpt else prt.RenderResult)(8, 6)
    r = np.random.RandomState(0)
    for _ in range(3):
        result.add(r.uniform(0, 1, (6, 8, 3)).astype(np.float32))
    src.save_render(str(tmp_path / "r.ckpt"), result, seed=42)
    back, seed = dst.load_render(str(tmp_path / "r.ckpt"))
    assert seed == 42 and back.count == 3 and (back.width, back.height) == (8, 6)
    assert back.sum.dtype == np.float32 and np.array_equal(back.sum, result.sum)
    colors = r.uniform(0, 1, (5, 3)).astype(np.float32)
    src.save_fit(str(tmp_path / "f.ckpt"), step=17, color_table=colors,
                 extra={"lr": np.float32(0.5)})
    step, got, extra = dst.load_fit(str(tmp_path / "f.ckpt"))
    assert step == 17 and np.array_equal(got, colors) and float(extra["lr"]) == 0.5
    with pytest.raises(ValueError, match="checkpoint"):
        ckpt.load_render(str(tmp_path / "f.ckpt"))


@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_bmp_bytes_equal_native_writer(tmp_path, size):
    """The port's BMP equals ray_tracing_tpu.native.write_bmp's bytes
    where the native library loads, and otherwise decodes (Pillow) to
    the same pixels."""
    w, h = size
    rgb = _u8(h, w, w * 100 + h)
    image.save_image(str(tmp_path / "port.bmp"), rgb)
    assert np.array_equal(_pixels(tmp_path / "port.bmp"), rgb)
    if native.write_bmp(str(tmp_path / "native.bmp"), rgb):
        assert (tmp_path / "port.bmp").read_bytes() == (tmp_path / "native.bmp").read_bytes()


@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_png_decodes_to_same_pixels(tmp_path, size):
    w, h = size
    rgb = _u8(h, w, w * 7 + h)
    image.save_image(str(tmp_path / "x.png"), rgb)
    with Image.open(tmp_path / "x.png") as im:
        assert im.format == "PNG" and im.mode == "RGB"
    assert np.array_equal(_pixels(tmp_path / "x.png"), rgb)


def test_hdr_bytes_equal_jax(tmp_path):
    """save_hdr writes the JAX package's bytes (HDR values, zeros, a
    negative, a NaN and a ~2^127 firefly), and load_hdr reads them back
    as the JAX package does."""
    r = np.random.RandomState(0)
    img = (r.uniform(0, 1, (7, 5, 3)) ** 2).astype(np.float32)
    img *= r.choice([0.01, 1.0, 37.5], size=(7, 5, 1)).astype(np.float32)
    img[0, 0] = 0.0
    img[1, 1] = (-1.0, np.nan, 2.0)
    img[2, 2] = 1.5e38
    image.save_hdr(str(tmp_path / "port.hdr"), img)
    jimage.save_hdr(str(tmp_path / "jax.hdr"), img)
    assert (tmp_path / "port.hdr").read_bytes() == (tmp_path / "jax.hdr").read_bytes()
    got = image.load_hdr(str(tmp_path / "port.hdr"))
    want = jimage.load_hdr(str(tmp_path / "port.hdr"))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_other_formats_need_pillow(tmp_path, monkeypatch):
    """A .jpg goes through Pillow; without Pillow it is refused with an
    ImportError naming the formats that work, and nothing is written."""
    rgb = _u8(4, 6, 3)
    image.save_image(str(tmp_path / "x.jpg"), rgb)
    assert _pixels(tmp_path / "x.jpg").shape == (4, 6, 3)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=r"\.bmp and \.png.*\.hdr"):
        image.save_image(str(tmp_path / "y.jpg"), rgb)
    assert not (tmp_path / "y.jpg").exists()
    image.save_image(str(tmp_path / "y.bmp"), rgb)  # no Pillow needed
    image.save_image(str(tmp_path / "y.png"), rgb)


def test_render_stats_matches_jax():
    """Same summary keys and the same totals for the same records."""
    ours, ref = RenderStats(), JRenderStats()
    for stats in (ours, ref):
        for seg in (1000.0, 500.0):
            stats.start_pass()
            stats.end_pass(segments=seg)
    a, b = ours.summary(), ref.summary()
    assert a.keys() == b.keys()
    assert a["passes"] == b["passes"] == 2 and a["total_segments"] == b["total_segments"]
    assert ours.passes[1].iteration == 2 and a["rays_per_s"] > 0


def test_torch_trace_writes_chrome_trace(tmp_path):
    """A profiled CPU render leaves one Chrome trace that parses as JSON
    and holds the pass's ops; no directory, no trace."""
    bundle = prt.load_scene_json(ZY)
    r = prt.Renderer(prt.RendererParam(8, 8, max_depth=1), bundle.camera, bundle.scene,
                     device="cpu")
    with torch_trace(None):
        r.render(0)
    with torch_trace(str(tmp_path / "prof"), "cpu"):
        r.render(0)
    (path,) = glob.glob(str(tmp_path / "prof" / "*.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


@pytest.fixture(scope="module")
def zy_depth_one():
    ours, ref = prt.load_scene_json(ZY), jrt.load_scene_json(ZY)
    param = dict(width=32, height=32, max_depth=1)
    return (prt.Renderer(prt.RendererParam(**param), ours.camera, ours.scene, device="cpu"),
            jrt.Renderer(jrt.RendererParam(**param), ref.camera, ref.scene))


@pytest.mark.parametrize("target", [0.0039, 0.0035])
def test_render_to_noise_matches_jax(zy_depth_one, target):
    """32^2 zy at depth 1, checks every 4 passes from 4 on: the same pass
    count as JAX (8 and 52 passes: the error of this image is 0.00436
    after 4 passes, 0.00388 after 8, 0.00341 after 52), the image
    allclose at rtol 1e-5 and the error at rtol 1e-4 (float32 sums in
    another order); the image equals the port's own accumulate over the
    same fold_in keys divided by the count, bit for bit."""
    ours, ref = zy_depth_one
    kw = dict(target_rel_err=target, max_passes=64, min_passes=4, check_every=4)
    img, n, rel = ours.render_to_noise(0, **kw)
    jimg, jn, jrel = ref.render_to_noise(0, **kw)
    assert img.dtype == np.float32 and img.shape == (32, 32, 3)
    assert n == jn and 4 < n < 64 and rel <= target
    np.testing.assert_allclose(img, jimg, rtol=1e-5)
    np.testing.assert_allclose(rel, jrel, rtol=1e-4)
    acc = None
    for i in range(n):
        acc = ours.accumulate(rng.fold_in(rng.key(0), i), acc)
    assert np.array_equal(img, acc.numpy() / n)


def test_render_async_equals_render(zy_depth_one):
    ours, _ = zy_depth_one
    got = asyncio.run(ours.render_async(3))
    assert isinstance(got, np.ndarray) and np.array_equal(got, ours.render(3).numpy())
