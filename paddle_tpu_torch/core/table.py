"""The host sparse table (reference: ``paddle_tpu/core/table.py``
``SparseTable``, lines 16-163, with its SSD-tier calls).

A ctypes wrapper over the native table (``csrc/sparse_table.cc``, built
by ``paddle_tpu_torch.core``): pull and push move keys and fp32 rows
across the boundary as numpy arrays; hashing, row creation and the three
push rules run in C++ on the host. The rules (``sparse_table.cc``
``pt_sparse_table_push``): SGD ``emb -= lr * g``; Adagrad ``G += g * g;
emb -= lr * g / (sqrt(G) + eps)`` with ``eps = aux`` (1e-6 by default);
Momentum ``v = aux * v + g; emb -= lr * v``. Duplicate keys in one push
fold one after another. ``save`` writes the reference's file format, so a
table saved by either package loads in the other.
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import load_library

__all__ = ["SparseTable"]

_OPT = {"sgd": 0, "adagrad": 1, "momentum": 2}


class SparseTable:
    """Host-resident sparse embedding table (C++ MemorySparseTable analog).

    pull/push move (keys, float rows) across the ctypes boundary with
    zero-copy numpy views; all hashing/updating happens in native code.
    """

    def __init__(self, dim, shard_bits=6, optimizer="adagrad",
                 init_range=0.01, lr=0.05, aux=1e-6, seed=0,
                 ssd_path=None, mem_budget_rows=0):
        self._lib = load_library()
        self._h = self._lib.pt_sparse_table_create(
            int(dim), int(shard_bits), _OPT[optimizer], float(init_range),
            float(lr), float(aux), int(seed))
        if not self._h:
            raise ValueError("bad sparse table config")
        self.dim = int(dim)
        self.optimizer = optimizer
        # SSD overflow tier (reference ssd_sparse_table.cc): cold rows spill
        # to a log file past mem_budget_rows; pull/push fault them back in
        self.mem_budget_rows = int(mem_budget_rows)
        self._push_count = 0
        if ssd_path is not None:
            self.enable_ssd(ssd_path)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pt_sparse_table_destroy(h)
            self._h = None

    @staticmethod
    def _keys_arr(keys):
        arr = np.ascontiguousarray(np.asarray(keys).reshape(-1),
                                   dtype=np.uint64)
        return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

    def pull(self, keys, create_if_missing=True):
        arr, kp = self._keys_arr(keys)
        out = np.empty((arr.size, self.dim), dtype=np.float32)
        self._lib.pt_sparse_table_pull(
            self._h, kp, arr.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            1 if create_if_missing else 0)
        self._maybe_auto_spill()  # fault-ins/creates count against budget
        return out

    def push(self, keys, grads, lr=-1.0):
        arr, kp = self._keys_arr(keys)
        g = np.ascontiguousarray(np.asarray(grads, dtype=np.float32)
                                 .reshape(arr.size, self.dim))
        self._lib.pt_sparse_table_push(
            self._h, kp, arr.size,
            g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), float(lr))
        self._maybe_auto_spill()

    def _maybe_auto_spill(self):
        """Enforce mem_budget_rows: check residency every ~64 pull/push
        calls (the check walks the shards) and evict past 1.25x budget
        down to budget. Pull-driven fault-in and row creation grow memory
        exactly like pushes do, so both paths count."""
        if not self.mem_budget_rows:
            return
        self._push_count += 1
        if self._push_count % 64 == 0 and (
                self.mem_rows() > self.mem_budget_rows * 1.25):
            self.spill(self.mem_budget_rows)

    def assign(self, keys, values):
        arr, kp = self._keys_arr(keys)
        v = np.ascontiguousarray(np.asarray(values, dtype=np.float32)
                                 .reshape(arr.size, self.dim))
        self._lib.pt_sparse_table_assign(
            self._h, kp, arr.size,
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

    def add(self, keys, deltas):
        """Atomic server-side += (geo-SGD delta merge)."""
        arr, kp = self._keys_arr(keys)
        v = np.ascontiguousarray(np.asarray(deltas, dtype=np.float32)
                                 .reshape(arr.size, self.dim))
        self._lib.pt_sparse_table_add(
            self._h, kp, arr.size,
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

    def keys(self):
        n = len(self)
        out = np.empty(n, dtype=np.uint64)
        got = self._lib.pt_sparse_table_keys(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n)
        return out[:got]

    def shrink(self, decay=0.98, threshold=1.0):
        n = int(self._lib.pt_sparse_table_shrink(self._h, float(decay),
                                                 float(threshold)))
        if n < 0:
            raise IOError("shrink hit a disk write failure on the SSD tier")
        return n

    def add_show(self, keys, amount=1.0):
        arr, kp = self._keys_arr(keys)
        self._lib.pt_sparse_table_add_show(self._h, kp, arr.size,
                                           float(amount))

    def save(self, path):
        rc = self._lib.pt_sparse_table_save(self._h, path.encode())
        if rc != 0:
            raise IOError(f"sparse table save failed rc={rc}")

    def load(self, path):
        rc = self._lib.pt_sparse_table_load(self._h, path.encode())
        if rc != 0:
            raise IOError(f"sparse table load failed rc={rc}")

    def __len__(self):
        return int(self._lib.pt_sparse_table_size(self._h))

    # ---- SSD overflow tier ----

    def enable_ssd(self, path):
        rc = self._lib.pt_sparse_table_enable_ssd(self._h, str(path).encode())
        if rc != 0:
            raise IOError(f"enable_ssd({path}) failed rc={rc}")

    def spill(self, max_mem_rows=None):
        """Evict the coldest rows beyond the budget to the disk log."""
        budget = self.mem_budget_rows if max_mem_rows is None else max_mem_rows
        n = int(self._lib.pt_sparse_table_spill(self._h, int(budget)))
        if n == -1:
            raise RuntimeError("spill needs enable_ssd()/ssd_path first")
        if n < 0:
            raise IOError("spill hit a disk write failure; unwritten rows "
                          "remain in memory")
        return n

    def ssd_compact(self):
        """Rewrite the log dropping stale records; returns live row count."""
        n = int(self._lib.pt_sparse_table_ssd_compact(self._h))
        if n < 0:
            raise RuntimeError(f"ssd_compact failed rc={n}")
        return n

    def mem_rows(self):
        return int(self._lib.pt_sparse_table_mem_rows(self._h))

    def ssd_rows(self):
        return int(self._lib.pt_sparse_table_ssd_rows(self._h))
