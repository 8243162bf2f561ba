"""The local parameter server (reference:
``paddle_tpu/distributed/ps/__init__.py``: ``DenseTable``, lines
177-211; ``LocalPs``, 700-803; ``TheOnePSRuntime``, 805-870;
``distributed_lookup_table`` and ``distributed_push_sparse``, 873-922).

The sparse rows live on the host in the native table
(``paddle_tpu_torch/core``); ``LocalPs`` serves its tables in process,
``TheOnePSRuntime`` owns the client and the trainer's communicator
(``communicator.py``). ``distributed_lookup_table`` pulls rows for a
batch of ids onto the caller's device, and its backward pushes the rows'
gradient to the table, through the runtime's communicator when the
caller names no client. The pass path keeps a pass's rows on the card
instead (``heter_cache.DevicePassCache``, ``heter_trainer``).

Not ported, each raising ``NotImplementedError`` that names its ROADMAP
item: the TCP wire (``PsServer``, ``PsClient``: ``init_server``,
``run_server``, ``init_worker`` with server endpoints) and the graph
tables (``LocalPs.create_graph_table`` and the ``graph_*`` calls), both
"the PS remainder".
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ...core.table import SparseTable
from ...framework.device import resolve_device, to_device
from .heter_cache import DevicePassCache
from .heter_trainer import CompiledPassStep, HeterPassTrainer, heter_embedding

__all__ = ["DenseTable", "LocalPs", "TheOnePSRuntime", "DevicePassCache",
           "CompiledPassStep", "HeterPassTrainer", "heter_embedding",
           "distributed_lookup_table", "distributed_push_sparse",
           "PS_ITEM"]

PS_ITEM = "ROADMAP Queue A, 'the PS remainder'"


class DenseTable:
    """A server-side dense parameter block with SGD, Adagrad or Momentum
    applied at the server, in host numpy."""

    def __init__(self, shape, opt="sgd", lr=0.05, momentum=0.9,
                 epsilon=1e-6, init_value=0.0):
        self.value = np.full(shape, float(init_value), np.float32)
        self.opt = opt
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self._slot = np.zeros(shape, np.float32)

    def pull(self):
        return self.value

    def push(self, grad, lr=-1.0):
        g = np.asarray(grad, np.float32).reshape(self.value.shape)
        eta = lr if lr > 0 else self.lr
        if self.opt == "adagrad":
            self._slot += g * g
            self.value -= eta * g / (np.sqrt(self._slot) + self.epsilon)
        elif self.opt == "momentum":
            self._slot = self.momentum * self._slot + g
            self.value -= eta * self._slot
        else:
            self.value -= eta * g

    def assign(self, value):
        self.value[...] = np.asarray(value, np.float32).reshape(
            self.value.shape)


class LocalPs:
    """The in-process client over local tables (the single-machine PS)."""

    def __init__(self):
        self.tables: Dict[int, SparseTable] = {}
        self.dense_tables: Dict[int, DenseTable] = {}

    def create_table(self, table_id, dim, **kw):
        self.tables[int(table_id)] = SparseTable(dim=dim, **kw)

    def create_dense_table(self, table_id, shape, **kw):
        self.dense_tables[int(table_id)] = DenseTable(tuple(shape), **kw)

    def pull_dense(self, table_id):
        return self.dense_tables[int(table_id)].pull()

    def push_dense(self, table_id, grad, lr=-1.0):
        self.dense_tables[int(table_id)].push(grad, lr)

    def assign_dense(self, table_id, value):
        self.dense_tables[int(table_id)].assign(value)

    def pull(self, table_id, keys, create_if_missing=True):
        return self.tables[int(table_id)].pull(keys, create_if_missing)

    def push(self, table_id, keys, grads, lr=-1.0):
        self.tables[int(table_id)].push(keys, grads, lr)

    def assign(self, table_id, keys, values):
        self.tables[int(table_id)].assign(keys, values)

    def add(self, table_id, keys, deltas):
        self.tables[int(table_id)].add(keys, deltas)

    def table_size(self, table_id):
        return len(self.tables[int(table_id)])

    def save(self, table_id, path):
        self.tables[int(table_id)].save(path)

    def load(self, table_id, path):
        self.tables[int(table_id)].load(path)

    def shrink(self, table_id, decay=0.98, threshold=1.0):
        return self.tables[int(table_id)].shrink(decay, threshold)

    def create_graph_table(self, table_id, **kw):
        raise NotImplementedError(f"graph tables are not ported ({PS_ITEM})")

    def __getattr__(self, name):
        if name.startswith("graph_"):
            raise NotImplementedError(f"LocalPs.{name}: graph tables are "
                                      f"not ported ({PS_ITEM})")
        raise AttributeError(name)

    def barrier(self, group="worker", n=1):
        pass

    def stop_all(self):
        pass


class TheOnePSRuntime:
    """The runtime facade: the client and the trainer's communicator.
    The class keeps the last runtime made (``_current``), which
    ``distributed_lookup_table`` uses when no client is named."""

    _current: Optional["TheOnePSRuntime"] = None

    def __init__(self, role_maker=None):
        self.role_maker = role_maker
        self.server = None
        self.client = None
        self.communicator = None
        TheOnePSRuntime._current = self

    @classmethod
    def current(cls):
        if cls._current is None:
            cls._current = TheOnePSRuntime()
            cls._current.client = LocalPs()
        return cls._current

    def init_server(self, host="127.0.0.1", port=0):
        raise NotImplementedError(f"PsServer (the TCP wire) is not ported "
                                  f"({PS_ITEM})")

    def run_server(self):
        raise NotImplementedError(f"PsServer (the TCP wire) is not ported "
                                  f"({PS_ITEM})")

    def init_worker(self, server_endpoints=None, strategy=None):
        eps = server_endpoints or [
            e for e in os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST",
                                      "").split(",") if e]
        if eps:
            raise NotImplementedError(f"PsClient (the TCP wire) is not "
                                      f"ported ({PS_ITEM})")
        self.client = LocalPs()
        from .communicator import Communicator

        self.communicator = Communicator.create(self.client, strategy)
        self.communicator.start()
        return self.client

    def comm(self):
        """The communicator (a started sync one if none was set)."""
        if self.communicator is None:
            from .communicator import Communicator

            self.communicator = Communicator(self.client or LocalPs())
            if self.client is None:
                self.client = self.communicator.client
            self.communicator.start()
        return self.communicator

    def stop_worker(self):
        if self.communicator is not None:
            self.communicator.stop()


class _LookupPush(torch.autograd.Function):
    """The lookup's node: forward returns the pulled rows; backward
    pushes their gradient to the table and gives no gradient back."""

    @staticmethod
    def forward(ctx, rows, anchor, push):
        ctx.push = push
        return rows

    @staticmethod
    def backward(ctx, grad):
        ctx.push(grad)
        return None, None, None


def distributed_lookup_table(ids, table_id=0, client=None, lr=-1.0,
                             device="cuda"):
    """Rows of ``table_id`` for ``ids`` (numpy or a tensor of any shape),
    as ``[*ids.shape, dim]`` fp32 on ``device``. With grad enabled, the
    backward pushes the rows' gradient (``lr``; the table's default when
    it is not positive): through the runtime's communicator, or straight
    to ``client`` when one is named."""
    dev = resolve_device(device)
    comm = None if client is not None else TheOnePSRuntime.current().comm()
    if client is None:
        client = comm.client
    ids_np = np.asarray(ids.detach().cpu().numpy()
                        if isinstance(ids, torch.Tensor) else ids)
    flat = ids_np.reshape(-1).astype(np.uint64)
    rows = (comm.pull_sparse(table_id, flat) if comm is not None
            else client.pull(table_id, flat))
    dim = rows.shape[1]
    out = to_device(rows.reshape(ids_np.shape + (dim,)), dev, torch.float32)
    if not torch.is_grad_enabled():
        return out

    def push(grad):
        g = grad.detach().reshape(-1, dim).cpu().numpy()
        if comm is not None:
            comm.push_sparse(table_id, flat, g, lr=lr)
        else:
            client.push(table_id, flat, g, lr=lr)

    anchor = torch.empty(0, device=dev, requires_grad=True)
    return _LookupPush.apply(out, anchor, push)


def distributed_push_sparse(ids, grads, table_id=0, client=None, lr=-1.0):
    """Push ``grads`` (one row per id) to the table directly."""
    client = client or TheOnePSRuntime.current().client

    def host(x):
        return np.asarray(x.detach().cpu().numpy()
                          if isinstance(x, torch.Tensor) else x)

    ids_np, g_np = host(ids), host(grads)
    client.push(table_id, ids_np.reshape(-1).astype(np.uint64),
                g_np.reshape(ids_np.size, -1), lr=lr)
