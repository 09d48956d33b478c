"""The kernels' first use from several threads at once, on the CPU: a
fake nvcc stands in for the toolkit, so the test needs no card.
``ops/_build.py:build`` compiles a library once however many threads ask
for it, each ``_library()`` loads and binds its library once, and the
temporary output is named by process and thread."""

import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch.utils.cpp_extension

from ray_tracing_tpu_torch.ops import _build
from ray_tracing_tpu_torch.ops import cuda_intersect as ci
from ray_tracing_tpu_torch.ops import cuda_scatter as cs
from ray_tracing_tpu_torch.ops import cuda_triangles as ct

THREADS = 4


class FakeNvcc:
    """Records each call, sleeps (so the threads overlap), or waits at
    ``rendezvous`` for the other compiles when one is set, then writes its
    ``-o`` file."""

    def __init__(self):
        self.calls = []
        self.lock = threading.Lock()
        self.rendezvous = None

    def __call__(self, cmd, **kwargs):
        out = cmd[cmd.index("-o") + 1]
        with self.lock:
            self.calls.append((out, threading.get_ident()))
        if self.rendezvous is None:
            time.sleep(0.3)
        else:
            self.rendezvous.wait()  # breaks (raises) unless all run at once
        with open(out, "wb") as fh:
            fh.write(b"library")
        return subprocess.CompletedProcess(cmd, 0, stdout="ptxas info\n", stderr="")


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    fake = FakeNvcc()
    monkeypatch.setattr(torch.utils.cpp_extension, "CUDA_HOME", "/usr/local/cuda")
    monkeypatch.setattr(_build.subprocess, "run", fake)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    return fake


def _all_at_once(fn, *args):
    """``fn(*args)`` from THREADS threads released together."""
    barrier = threading.Barrier(THREADS)

    def one(_):
        barrier.wait()
        return fn(*args)

    with ThreadPoolExecutor(THREADS) as pool:
        return list(pool.map(one, range(THREADS)))


def test_build_compiles_once_for_four_threads(fake_nvcc, tmp_path):
    before = _build.COMPILES
    paths = _all_at_once(_build.build, ci.SOURCE)
    assert len(fake_nvcc.calls) == 1
    assert _build.COMPILES == before + 1
    assert len(set(paths)) == 1
    lib = paths[0]
    assert lib == _build.library_path(ci.SOURCE) and lib.parent == tmp_path / "kernels"
    assert lib.read_bytes() == b"library"
    assert lib.with_suffix(".log").read_text() == "ptxas info\n"
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted([lib.name, lib.stem + ".log"])
    # a built library is reused without a compile
    assert _build.build(ci.SOURCE) == lib and len(fake_nvcc.calls) == 1


def test_temporary_output_is_named_by_process_and_thread(fake_nvcc):
    _build.build(cs.SOURCE)
    (out, ident), = fake_nvcc.calls
    assert os.path.basename(out).endswith(f".{os.getpid()}.{ident}.tmp")


def test_each_source_builds_once_in_parallel(fake_nvcc):
    """Three sources from three threads each: three compiles, which run
    side by side (one lock per library, not one for all: the fake
    compiles wait for each other)."""
    fake_nvcc.rendezvous = threading.Barrier(3, timeout=30)
    sources = [ci.SOURCE, cs.SOURCE, ct.SOURCE] * 3
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = list(pool.map(_build.build, sources))
    assert sorted(os.path.basename(out).split(".")[0] for out, _ in fake_nvcc.calls) == sorted(
        p.stem for p in set(paths))
    assert len(fake_nvcc.calls) == 3 and len(set(paths)) == 3


@pytest.mark.parametrize("module", [ci, ct, cs], ids=["intersect", "triangles", "scatter"])
def test_library_loads_once_for_four_threads(module, monkeypatch):
    """``_library()`` from four threads: one build, one load, one
    binding, and every thread gets the same handle."""
    loads = []

    class FakeLib:
        def __getattr__(self, name):  # every entry point and query function
            fn = lambda *args: 1  # noqa: E731
            setattr(self, name, fn)
            return fn

    def fake_cdll(path):
        loads.append(path)
        time.sleep(0.3)
        return FakeLib()

    monkeypatch.setattr(module, "_lib", None)
    for cached in ("_max_segments", "_max_blocks", "_block_rows"):  # cuda_scatter's
        if hasattr(module, cached):
            monkeypatch.setattr(module, cached, getattr(module, cached))  # restored after
    monkeypatch.setattr(module._build, "build", lambda source: "/nowhere/" + source.name)
    monkeypatch.setattr(module.ctypes, "CDLL", fake_cdll)
    libs = _all_at_once(module._library)
    assert loads == ["/nowhere/" + module.SOURCE.name]
    assert all(lib is libs[0] for lib in libs)
