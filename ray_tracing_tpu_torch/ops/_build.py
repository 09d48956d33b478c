"""Building the port's CUDA kernels: ``nvcc`` for ``sm_90a`` at first
use, one shared library with a plain C interface per source, loaded
with ``ctypes``.

Each library lands in ``build/kernels/`` beside the package, named by
its source's stem and a hash of the source and the flags, so an edited
source or flag builds anew and an unchanged one is reused.  A failed
build raises.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)


def build_key(source: Path, flags=NVCC_FLAGS) -> str:
    """Hash of a source's bytes and the compiler flags."""
    return hashlib.sha256(
        Path(source).read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]


def library_path(source: Path) -> Path:
    source = Path(source)
    return BUILD_DIR / f"{source.stem}_{build_key(source)}.so"


def build(source: Path) -> Path:
    """Compile one source (once per source and flags) and return its
    library path.  Raises if the build fails."""
    source = Path(source)
    lib = library_path(source)
    if lib.exists():
        return lib
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("building the CUDA kernels needs the CUDA toolkit (nvcc); none was found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp")
    cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {source.name} failed ({proc.returncode}):\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib
