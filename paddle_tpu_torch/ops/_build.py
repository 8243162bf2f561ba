"""Build and load the port's CUDA kernels (no reference file: new).

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes``; sources may
include the shared ``csrc/*.cuh`` headers. Nothing
includes PyTorch's headers, so a build takes seconds, not minutes.

Libraries go to ``build/paddle_tpu_torch/`` at the repository root,
named by a hash of the source and the flags, and are built at first use
(never at import: the CPU tests import every module on a machine
without ``nvcc``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_dir", "compile_file", "library_path",
           "load_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_lock = threading.Lock()


def build_dir() -> Path:
    return _PKG.parent / "build" / "paddle_tpu_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of paddle_tpu_torch "
                       "are built on the machine with the card")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (keyed by the source, the shared
    ``csrc/*.cuh`` headers and the flags)."""
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{name}_{key[:16]}.so"


def compile_file(src: Path, out: Path) -> Path:
    """Compile the source ``src`` into the library ``out``; ``src`` may
    include the ``csrc/*.cuh`` headers wherever it lies."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def compile_source(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists."""
    out = library_path(name)
    if out.exists():
        return out
    return compile_file(CSRC / f"{name}.cu", out)


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(compile_source(name)))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _lock:
        return _load(name)
