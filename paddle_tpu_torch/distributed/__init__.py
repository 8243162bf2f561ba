"""Distributed pieces of the port (reference: ``paddle_tpu/distributed``:
``env.py``, ``collective.py``, ``parallel.py``, ``grad_comm.py`` and
``spawn`` in ``__init__.py``).

One process per rank over ``torch.distributed``: ``spawn`` starts the
ranks, ``init_parallel_env`` their process group, the collectives reduce
tensors in place, ``GradCommunicator`` reduces gradient buckets through
the wire codecs and ``DataParallel`` wraps a model for eager data
parallelism. ``distributed.ps`` is the parameter server (reference:
``paddle_tpu/distributed/ps``), imported on its own.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time

from .env import (ParallelEnv, get_rank, get_world_size,  # noqa: F401
                  init_parallel_env, is_initialized)
from .collective import (ReduceOp, all_gather, all_reduce,  # noqa: F401
                         alltoall, barrier, broadcast, get_group, new_group,
                         recv, reduce_scatter, send, split, wait)
from . import grad_comm  # noqa: F401
from .grad_comm import GradCommConfig, GradCommunicator  # noqa: F401
from .parallel import DataParallel  # noqa: F401

__all__ = ["ParallelEnv", "get_rank", "get_world_size", "init_parallel_env",
           "is_initialized", "ReduceOp", "all_reduce", "broadcast",
           "barrier", "wait", "get_group", "new_group", "GradCommConfig",
           "GradCommunicator", "DataParallel", "spawn"]


def _run_rank(rank, func, args, nprocs, tmp):
    """One spawned rank: the launch protocol's environment, ``func``, its
    result saved for the parent, the process group closed."""
    import torch
    import torch.distributed as dist

    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(nprocs),
                      PADDLE_MASTER=f"file://{tmp}/rendezvous")
    try:
        result = func(*args)
        torch.save(result, os.path.join(tmp, f"result_{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(func, args=(), nprocs=-1, join=True, daemon=False,
          timeout=None, **options):
    """``paddle.distributed.spawn``: run ``func(*args)`` in ``nprocs``
    processes (the spawn start method) with the launch protocol's
    environment set, so ``init_parallel_env()`` in ``func`` joins them
    into one process group. Returns each rank's result, in rank order.

    The rendezvous is a file in a new temporary directory, so concurrent
    callers never share a port. ``func`` and its results must pickle,
    and its module must import in a fresh process. If a rank fails, the
    others are stopped and the error is raised; so they are when
    ``timeout`` seconds pass. ``nprocs`` of -1, 0 or 1 runs ``func`` in
    this process."""
    if options:
        raise TypeError(f"spawn: unknown options {sorted(options)}")
    if nprocs in (-1, 0, 1):
        return [func(*args)]
    if not join:
        raise NotImplementedError(
            "spawn(join=False) is not ported: the caller gets the ranks' "
            "results, so spawn waits for them")
    import torch
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_spawn_")
    ctx = mp.start_processes(_run_rank, args=(func, args, nprocs, tmp),
                             nprocs=nprocs, join=False, daemon=daemon,
                             start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"spawn: ranks still running after {timeout} s")
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
