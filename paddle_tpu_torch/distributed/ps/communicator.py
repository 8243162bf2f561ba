"""Trainer-side parameter-server communicators (reference:
``paddle_tpu/distributed/ps/communicator.py``, lines 1-270:
``merge_sparse``, ``Communicator``, ``AsyncCommunicator``,
``GeoCommunicator``).

- ``Communicator``: synchronous, each push merged and sent at once; its
  ``create`` picks the mode from a strategy (``a_sync`` off: sync;
  ``a_sync_configs["k_steps"] > 0``: geo; else async, the merge window
  and send wait from the strategy or the ``FLAGS_communicator_*``
  defaults).
- ``AsyncCommunicator``: the trainer enqueues pushes on a bounded queue;
  a daemon thread takes a window of up to ``max_merge_var_num`` pushes of
  one table and learning rate, merges duplicate keys (``merge_sparse``)
  and sends them in one client call. ``flush`` waits until every queued
  push has reached the client; ``stop`` flushes, ends the thread and
  raises the first send error.
- ``GeoCommunicator``: pushes update a local replica of the rows; every
  ``k_steps`` pushes the deltas go to the table (its atomic ``add``) and
  every cached row is pulled fresh.

All of it is host numpy; the gradients a caller pushes come off the card
once per push. Every push and pull counts in ``ps_rpcs_total`` (by op)
of the port's metrics registry; under ``FLAGS_enable_rpc_profiler``
each also writes the reference's debug record ("ps_rpc": op, table id,
key count, gradient bytes) into the global event log.

One difference, no result changes: the reference's ``flush`` can return
early. Its push clears the drained event and then enqueues, and the send
thread sets the event whenever it sees the queue empty, so a check
between the two sets it with a push on its way in (ROADMAP Queue C). The
port counts pushes not yet sent under a lock; the event is set only when
that count is zero.
"""
from __future__ import annotations

import queue as queue_mod
import threading
from typing import Dict, Optional

import numpy as np

from ...framework.flags import flag
from ...observability import get_event_log, rpc_profiler_enabled
from ...observability.metrics import get_registry

__all__ = ["Communicator", "AsyncCommunicator", "GeoCommunicator",
           "merge_sparse"]

_m_rpcs = get_registry().counter("ps_rpcs_total",
                                 help="PS push/pull RPCs issued",
                                 labels=("op",))


def _record_rpc(op: str, table_id, keys, grads=None) -> None:
    """Count one RPC; under FLAGS_enable_rpc_profiler also log it."""
    _m_rpcs.labels(op=op).inc()
    if rpc_profiler_enabled():
        get_event_log().debug(
            "ps_rpc", op=op, table_id=int(table_id), n_keys=int(keys.size),
            bytes=int(grads.nbytes) if grads is not None else None)


def merge_sparse(keys: np.ndarray, grads: np.ndarray):
    """Sum the gradient rows of duplicate keys: (unique sorted keys, one
    summed row each), the rows added in their order of appearance."""
    uniq, inv = np.unique(keys, return_inverse=True)
    out = np.zeros((uniq.size, grads.shape[1]), grads.dtype)
    np.add.at(out, inv, grads)
    return uniq, out


class Communicator:
    """Synchronous: a push goes straight to the client. Also the factory
    the runtime uses."""

    def __init__(self, client, mode: str = "sync", **configs):
        self.client = client
        self.mode = mode
        self.running = False

    @staticmethod
    def create(client, strategy=None):
        """The mode from a ``DistributedStrategy``-like object:
        ``a_sync`` False -> sync; True -> async, or geo when
        ``a_sync_configs["k_steps"] > 0``."""
        if strategy is None or not getattr(strategy, "a_sync", False):
            return Communicator(client)
        cfg = getattr(strategy, "a_sync_configs", {}) or {}
        k = int(cfg.get("k_steps", 0))
        if k > 0:
            return GeoCommunicator(client, k_steps=k)
        return AsyncCommunicator(
            client,
            max_merge_var_num=int(cfg.get(
                "max_merge_var_num",
                flag("FLAGS_communicator_max_merge_var_num"))),
            send_wait_times=float(cfg.get(
                "send_wait_times",
                flag("FLAGS_communicator_send_wait_times"))))

    def start(self):
        self.running = True

    def stop(self):
        self.running = False

    def is_running(self):
        return self.running

    def push_sparse(self, table_id, keys, grads, lr=-1.0):
        keys, grads = merge_sparse(np.asarray(keys, np.uint64).reshape(-1),
                                   np.asarray(grads, np.float32))
        _record_rpc("push_sparse", table_id, keys, grads)
        self.client.push(table_id, keys, grads, lr=lr)

    def pull_sparse(self, table_id, keys):
        _record_rpc("pull_sparse", table_id, np.asarray(keys))
        return self.client.pull(table_id, keys)

    def flush(self):
        pass


class AsyncCommunicator(Communicator):
    """Enqueue on the trainer; a daemon merges up to ``max_merge_var_num``
    pending pushes of one table and lr, then sends once."""

    def __init__(self, client, max_merge_var_num=20, send_wait_times=0.005,
                 send_queue_size=None, **configs):
        super().__init__(client, mode="async")
        self.max_merge = int(max_merge_var_num)
        self.wait = float(send_wait_times)
        # bounded: a stalled server holds the trainer back instead of
        # buffering without limit
        qsize = int(send_queue_size if send_queue_size is not None
                    else flag("FLAGS_communicator_send_queue_size"))
        self._q: "queue_mod.Queue" = queue_mod.Queue(
            maxsize=max(qsize, 1) * self.max_merge)
        self._thread: Optional[threading.Thread] = None
        self._err = []
        self._pending = 0               # pushes enqueued, not yet sent
        self._lock = threading.Lock()
        self._drained = threading.Event()
        self._drained.set()

    def start(self):
        if self.running:
            return
        self.running = True
        self._thread = threading.Thread(target=self._send_loop, daemon=True)
        self._thread.start()

    def stop(self):
        if not self.running:
            return
        self.flush()
        self.running = False
        self._q.put(None)
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self._err:
            raise self._err[0]

    def push_sparse(self, table_id, keys, grads, lr=-1.0):
        if not self.running:
            return Communicator.push_sparse(self, table_id, keys, grads, lr)
        with self._lock:
            self._pending += 1
            self._drained.clear()
        self._q.put((int(table_id),
                     np.asarray(keys, np.uint64).reshape(-1),
                     np.asarray(grads, np.float32), float(lr)))

    def flush(self):
        """Block until every queued push has been sent (the barrier
        before a save or an evaluation)."""
        self._drained.wait(timeout=60)
        if self._err:
            raise self._err[0]

    def _sent(self, n: int) -> None:
        with self._lock:
            self._pending -= n
            if self._pending == 0:
                self._drained.set()

    def _send_loop(self):
        while True:
            try:
                item = self._q.get(timeout=self.wait)
            except queue_mod.Empty:
                continue
            if item is None:
                self._drained.set()
                return
            # a window of pushes for the same table and lr
            batch = [item]
            while len(batch) < self.max_merge:
                try:
                    nxt = self._q.get_nowait()
                except queue_mod.Empty:
                    break
                if nxt is None:
                    self._q.put(None)
                    break
                if nxt[0] != item[0] or nxt[3] != item[3]:
                    self._q.put(nxt)   # another table or lr: next window
                    break
                batch.append(nxt)
            try:
                keys = np.concatenate([b[1] for b in batch])
                grads = np.concatenate([b[2] for b in batch])
                keys, grads = merge_sparse(keys, grads)
                _record_rpc("push_sparse_merged", item[0], keys, grads)
                self.client.push(item[0], keys, grads, lr=item[3])
            except Exception as e:      # raised again by flush/stop
                self._err.append(e)
                self._drained.set()
                return
            self._sent(len(batch))


class GeoCommunicator(Communicator):
    """Local training, delta exchange every ``k_steps`` pushes: the
    trainer keeps a replica of the rows it touched; a sync pushes each
    row's ``new - synced`` to the table's atomic ``add`` and pulls every
    cached row fresh."""

    def __init__(self, client, k_steps=100, **configs):
        super().__init__(client, mode="geo")
        self.k_steps = int(k_steps)
        self._local: Dict[int, Dict[int, np.ndarray]] = {}   # table: row
        self._synced: Dict[int, Dict[int, np.ndarray]] = {}
        self._step = 0

    def pull_sparse(self, table_id, keys):
        """From the local replica; missing rows fault in from the table."""
        t = int(table_id)
        local = self._local.setdefault(t, {})
        synced = self._synced.setdefault(t, {})
        keys = np.asarray(keys, np.uint64).reshape(-1)
        missing = [k for k in keys.tolist() if k not in local]
        if missing:
            rows = self.client.pull(t, np.asarray(missing, np.uint64))
            for k, r in zip(missing, rows):
                local[k] = r.astype(np.float32).copy()
                synced[k] = r.astype(np.float32).copy()
        return np.stack([local[k] for k in keys.tolist()])

    def push_sparse(self, table_id, keys, grads, lr=-1.0):
        """SGD on the local replica; a sync every ``k_steps`` pushes."""
        t = int(table_id)
        local = self._local.setdefault(t, {})
        keys = np.asarray(keys, np.uint64).reshape(-1)
        grads = np.asarray(grads, np.float32)
        eta = lr if lr > 0 else 0.05
        mk, mg = merge_sparse(keys, grads)
        for k, g in zip(mk.tolist(), mg):
            if k not in local:
                self.pull_sparse(t, np.asarray([k], np.uint64))
            local[k] = local[k] - eta * g
        self._step += 1
        if self._step % self.k_steps == 0:
            self.flush()

    def flush(self):
        """The sync round: deltas to the table, every cached row fresh."""
        for t, local in self._local.items():
            synced = self._synced[t]
            rows, deltas = [], []
            for k, v in local.items():
                d = v - synced[k]
                if np.any(d):
                    rows.append(k)
                    deltas.append(d)
            if rows:
                # the table's add: a pull + assign here would lose other
                # trainers' deltas
                self.client.add(t, np.asarray(rows, np.uint64),
                                np.stack(deltas))
            if not local:
                continue
            all_keys = np.asarray(list(local.keys()), np.uint64)
            fresh = self.client.pull(t, all_keys)
            for k, r in zip(all_keys.tolist(), fresh):
                local[k] = r.astype(np.float32).copy()
                synced[k] = r.astype(np.float32).copy()
