"""Native host code of the port (reference: ``paddle_tpu/core/__init__.py``
``_build``, ``load_library`` and ``_configure``, the sparse table's part).

The parameter server's sparse table is host C++, as in the reference:
``csrc/sparse_table.cc`` is the reference's
``paddle_tpu/core/csrc/sparse_table.cc`` kept unchanged. A new row's
values come from ``std::mt19937`` seeded by ``(key ^ seed) *
0x9E3779B97F4A7C15`` through ``std::uniform_real_distribution<float>``,
so only the same source under the same standard library gives the same
rows; a rewrite would not. It is no kernel: nothing of it runs on the
card.

``g++ -O2 -std=c++17 -shared -fPIC -pthread`` builds it into
``build/paddle_tpu_torch/`` at the repository root (the directory of the
CUDA libraries, ``ops/_build.py``), named by a hash of the source and
the flags, at first use and never at import; the library is loaded with
``ctypes`` (plain C interface). ``compile_library`` builds without
loading, so a caller can start it beside the ``nvcc`` builds. A failed
build raises: there is no fallback.

The data feed's ``BlockingQueue`` (the reference's
``csrc/blocking_queue.cc``) is not on the parameter server's path and is
not ported (ROADMAP Queue A, "the PS remainder").
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["GXX_FLAGS", "compile_library", "library_path", "load_library"]

_SRC = Path(__file__).resolve().parent / "csrc" / "sparse_table.cc"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the table's library builds to (keyed by its source and the
    flags)."""
    from ..ops._build import build_dir

    key = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()
    return build_dir() / f"sparse_table_{key[:16]}.so"


def compile_library() -> Path:
    """Build the table's library unless it exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded table library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(compile_library()))
            _configure(lib)
            _lib = lib
    return _lib


def _configure(lib):
    c = ctypes
    u64p = c.POINTER(c.c_uint64)
    f32p = c.POINTER(c.c_float)

    lib.pt_sparse_table_create.restype = c.c_void_p
    lib.pt_sparse_table_create.argtypes = [
        c.c_int, c.c_int, c.c_int, c.c_float, c.c_float, c.c_float,
        c.c_uint64]
    lib.pt_sparse_table_destroy.argtypes = [c.c_void_p]
    lib.pt_sparse_table_dim.argtypes = [c.c_void_p]
    lib.pt_sparse_table_dim.restype = c.c_int
    lib.pt_sparse_table_size.argtypes = [c.c_void_p]
    lib.pt_sparse_table_size.restype = c.c_uint64
    lib.pt_sparse_table_pull.argtypes = [c.c_void_p, u64p, c.c_int64, f32p,
                                         c.c_int]
    lib.pt_sparse_table_push.argtypes = [c.c_void_p, u64p, c.c_int64, f32p,
                                         c.c_float]
    lib.pt_sparse_table_assign.argtypes = [c.c_void_p, u64p, c.c_int64, f32p]
    lib.pt_sparse_table_add.argtypes = [c.c_void_p, u64p, c.c_int64, f32p]
    lib.pt_sparse_table_keys.argtypes = [c.c_void_p, u64p, c.c_int64]
    lib.pt_sparse_table_keys.restype = c.c_int64
    lib.pt_sparse_table_shrink.argtypes = [c.c_void_p, c.c_float, c.c_float]
    lib.pt_sparse_table_shrink.restype = c.c_int64
    lib.pt_sparse_table_add_show.argtypes = [c.c_void_p, u64p, c.c_int64,
                                             c.c_float]
    lib.pt_sparse_table_save.argtypes = [c.c_void_p, c.c_char_p]
    lib.pt_sparse_table_save.restype = c.c_int
    lib.pt_sparse_table_load.argtypes = [c.c_void_p, c.c_char_p]
    lib.pt_sparse_table_load.restype = c.c_int
    lib.pt_sparse_table_enable_ssd.argtypes = [c.c_void_p, c.c_char_p]
    lib.pt_sparse_table_enable_ssd.restype = c.c_int
    lib.pt_sparse_table_spill.argtypes = [c.c_void_p, c.c_int64]
    lib.pt_sparse_table_spill.restype = c.c_int64
    lib.pt_sparse_table_ssd_compact.argtypes = [c.c_void_p]
    lib.pt_sparse_table_ssd_compact.restype = c.c_int64
    lib.pt_sparse_table_ssd_rows.argtypes = [c.c_void_p]
    lib.pt_sparse_table_ssd_rows.restype = c.c_int64
    lib.pt_sparse_table_mem_rows.argtypes = [c.c_void_p]
    lib.pt_sparse_table_mem_rows.restype = c.c_uint64
