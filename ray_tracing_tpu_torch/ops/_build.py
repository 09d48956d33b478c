"""Building the port's CUDA kernels: ``nvcc`` for ``sm_90a`` at first
use, one shared library with a plain C interface per source, loaded
with ``ctypes``; and :func:`on_device`, which the launch wrappers share.

Each library lands in ``build/kernels/`` beside the package, named by
its source's stem and a hash of the source and the flags, so an edited
source or flag builds anew and an unchanged one is reused.  A failed
build raises.  Threads of one process that ask for the same library
wait for one compile (a lock per library); processes sharing the build
directory each compile into a temporary file of their own (named by pid
and thread) and rename it into place.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)
COMPILES = 0  # nvcc runs of this process that built a library
_LOCKS: dict = {}  # library path -> the lock its builders take
_LOCKS_GUARD = threading.Lock()


def build_key(source: Path, flags=None) -> str:
    """Hash of a source's bytes and the compiler flags (``NVCC_FLAGS`` as
    it stands when called, by default)."""
    return hashlib.sha256(
        Path(source).read_bytes() + " ".join(NVCC_FLAGS if flags is None else flags).encode()
    ).hexdigest()[:16]


def library_path(source: Path) -> Path:
    source = Path(source)
    return BUILD_DIR / f"{source.stem}_{build_key(source)}.so"


def build(source: Path) -> Path:
    """Compile one source (once per source and flags) and return its
    library path.  Raises if the build fails."""
    global COMPILES
    source = Path(source)
    lib = library_path(source)
    if lib.exists():
        return lib
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(lib, threading.Lock())
    with lock:
        if lib.exists():
            return lib
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is None:
            raise RuntimeError("building the CUDA kernels needs the CUDA toolkit (nvcc); "
                               "none was found")
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {source.name} failed ({proc.returncode}):\n{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
        COMPILES += 1
    return lib


def build_all(sources) -> list:
    """Compile several sources at once, one ``nvcc`` for each (build());
    returns their library paths.  A launcher of several processes calls
    this before it starts them, so that they only load."""
    sources = list(sources)
    with ThreadPoolExecutor(len(sources)) as pool:
        return list(pool.map(build, sources))


def on_device(device: torch.device):
    """A context that makes CUDA ``device`` current for a launch, or
    nothing when it already is (entering torch.cuda.device costs more
    host time than a short kernel)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
