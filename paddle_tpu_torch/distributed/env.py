"""Distributed environment (reference: ``paddle_tpu/distributed/env.py``:
``get_rank``, ``get_world_size``, ``init_parallel_env``,
``is_initialized``, ``ParallelEnv``).

Rank and world size come from ``torch.distributed`` once its process
group is up, else from the launch protocol's environment
(``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM``, or ``RANK`` /
``WORLD_SIZE``). ``init_parallel_env`` starts the process group: the
rendezvous is ``PADDLE_MASTER`` (``host:port``, or a ``tcp://`` or
``file://`` URL) or ``MASTER_ADDR``/``MASTER_PORT``.

Backend: ``"nccl"`` when every rank on this host can have a card of its
own, else ``"gloo"``, which also takes CUDA tensors and stages them
through host memory (two ranks that share one card, as on a one-card
machine). The ranks on this host are ``LOCAL_WORLD_SIZE`` (or
``PADDLE_LOCAL_SIZE``) when the launcher sets it, else the whole world;
a rank's card is its ``LOCAL_RANK`` (or ``PADDLE_LOCAL_RANK``), and only
when neither is set ``rank % torch.cuda.device_count()``. The choice is
logged and readable as ``ParallelEnv().backend``. Every collective of the group
times out after ``PADDLE_RENDEZVOUS_TIMEOUT`` seconds (300 by default),
so no rank waits forever on a peer that died.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["get_rank", "get_world_size", "init_parallel_env",
           "is_initialized", "ParallelEnv", "collective_timeout",
           "get_local_rank", "local_world_size", "default_backend",
           "device_index"]

_log = logging.getLogger(__name__)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    if is_initialized():
        return dist.get_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID",
                              os.environ.get("RANK", 0)))


def get_world_size() -> int:
    if is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("PADDLE_TRAINERS_NUM",
                              os.environ.get("WORLD_SIZE", 1)))


def collective_timeout() -> datetime.timedelta:
    return datetime.timedelta(
        seconds=float(os.environ.get("PADDLE_RENDEZVOUS_TIMEOUT", "300")))


def _init_method() -> str:
    coord = os.environ.get("PADDLE_MASTER") or os.environ.get("MASTER_ADDR")
    if not coord:
        raise RuntimeError(
            "init_parallel_env: no rendezvous; set PADDLE_MASTER "
            "(host:port, tcp:// or file:// URL) or MASTER_ADDR/MASTER_PORT")
    if "://" in coord:
        return coord
    if ":" not in coord:
        coord = f"{coord}:{os.environ.get('MASTER_PORT', '8476')}"
    return f"tcp://{coord}"


def _env_int(*names) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v not in (None, ""):
            return int(v)
    return None


def get_local_rank() -> int:
    """This rank's index among the ranks of its host: ``LOCAL_RANK`` (or
    ``PADDLE_LOCAL_RANK``), else the global rank (one host)."""
    v = _env_int("LOCAL_RANK", "PADDLE_LOCAL_RANK")
    return get_rank() if v is None else v


def local_world_size() -> int:
    """The ranks on this host: ``LOCAL_WORLD_SIZE`` (or
    ``PADDLE_LOCAL_SIZE``), else the whole world (one host)."""
    v = _env_int("LOCAL_WORLD_SIZE", "PADDLE_LOCAL_SIZE")
    return get_world_size() if v is None else v


def default_backend() -> str:
    """``"nccl"`` when every local rank has a card of its own, else
    ``"gloo"``."""
    return ("nccl" if torch.cuda.is_available()
            and torch.cuda.device_count() >= local_world_size() else "gloo")


def device_index() -> int:
    """The card of this rank: its local rank, or, with no local rank in
    the environment, ``rank % torch.cuda.device_count()``."""
    v = _env_int("LOCAL_RANK", "PADDLE_LOCAL_RANK")
    return get_rank() % torch.cuda.device_count() if v is None else v


def init_parallel_env(backend: Optional[str] = None) -> "ParallelEnv":
    """Start the process group when the launch protocol says there is
    more than one rank (a no-op for one rank or when it is up)."""
    world = get_world_size()
    if world > 1 and not is_initialized():
        if backend is None:
            backend = default_backend()
        rank = get_rank()
        if backend == "nccl":
            torch.cuda.set_device(device_index())
        dist.init_process_group(backend, init_method=_init_method(),
                                world_size=world, rank=rank,
                                timeout=collective_timeout())
        _log.info("init_parallel_env: rank %d of %d on backend %s", rank,
                  world, backend)
    return ParallelEnv()


class ParallelEnv:
    """``paddle.distributed.ParallelEnv``: rank, world and backend."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return get_local_rank()

    @property
    def nranks(self):
        return get_world_size()

    @property
    def backend(self) -> Optional[str]:
        """The process group's backend (None before it is up)."""
        return dist.get_backend() if is_initialized() else None

    @property
    def dev_id(self):
        return int(os.environ.get("FLAGS_selected_gpus", "0"))

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else ["127.0.0.1:6170"]
