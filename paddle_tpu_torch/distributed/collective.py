"""Collective communication (reference:
``paddle_tpu/distributed/collective.py`` lines 58-340 and 384-470:
``ReduceOp``, ``Group``, ``new_group``, ``get_group``, ``all_reduce``,
``all_gather``, ``reduce_scatter``, ``broadcast``, ``barrier``, ``wait``
and the ``collectives_total`` counter).

The reference lowers collectives to XLA over the mesh; the port runs one
process per rank and calls ``torch.distributed`` (``env.py`` starts the
process group). Tensors are reduced in place, as ``torch.distributed``
does. With one rank every function leaves its tensor as it is.

``ReduceOp.AVG`` is a SUM followed by a division by a device tensor that
holds the world size: a division by a Python number is a multiply by its
reciprocal on the card, which rounds differently
(``framework/numeric.py`` ``div_rn``).

``reduce_scatter`` keeps this rank's ``1/nranks`` chunk of dim 0 of the
sum over the ranks (``dist.reduce_scatter_tensor``; SUM and AVG only, as
in the reference); ``all_gather`` stacks every rank's tensor on a new
leading axis (``dist.all_gather_into_tensor``), so
``all_gather(None, reduce_scatter(x)).reshape(-1)`` is the all-reduce of
a flat ``x``. Both return new tensors. With one rank (no process group)
they degrade as the reference's eager forms do: ``reduce_scatter``
returns its input (the list form the sum of its list) and ``all_gather``
a copy.

Every call is synchronous: ``sync_op=False`` (a task handle to wait on)
is not ported yet and raises. Not ported yet either: ``alltoall``,
``send``/``recv``, ``split`` and the in-trace helpers raise
``NotImplementedError`` (ROADMAP Queue A 5, parallelism).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..framework.numeric import div_rn
from ..observability.metrics import get_registry as _get_registry
from .env import collective_timeout, get_world_size, is_initialized

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "broadcast", "barrier", "wait", "reduce_scatter", "all_gather",
           "alltoall", "send", "recv", "split", "in_trace_psum",
           "in_trace_all_gather", "in_trace_pmax"]

_m_collectives = _get_registry().counter(
    "collectives_total", help="collectives issued through this module",
    labels=("op",))


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OP = {ReduceOp.SUM: "SUM", ReduceOp.MAX: "MAX", ReduceOp.MIN: "MIN",
             ReduceOp.PROD: "PRODUCT", ReduceOp.AVG: "SUM"}


class Group:
    """A communication group: a set of ranks over a ``torch.distributed``
    process group (``pg`` None is the default group)."""

    def __init__(self, gid: int, ranks: Optional[List[int]] = None,
                 pg=None, timeout=None):
        self.id = gid
        self.ranks = list(ranks) if ranks else []
        self.pg = pg
        self.timeout = timeout

    @property
    def nranks(self) -> int:
        return len(self.ranks) if self.ranks else get_world_size()

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def name(self):
        return f"group_{self.id}"

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if self.ranks else rank

    def __repr__(self):
        return f"Group(id={self.id}, nranks={self.nranks})"


_groups: Dict[int, Group] = {}
_next_gid = [1]


def new_group(ranks=None, backend=None, timeout=None) -> Group:
    """A group over ``ranks`` (every rank when None); ``timeout``
    (seconds or timedelta) bounds its collectives."""
    if hasattr(timeout, "total_seconds"):
        timeout = timeout.total_seconds()
    pg = None
    if ranks is not None and is_initialized():
        import datetime

        pg = dist.new_group(
            ranks=list(ranks), backend=backend,
            timeout=(datetime.timedelta(seconds=float(timeout))
                     if timeout else collective_timeout()))
    gid = _next_gid[0]
    _next_gid[0] += 1
    g = Group(gid, ranks, pg=pg, timeout=timeout)
    _groups[gid] = g
    return g


def get_group(gid: int = 0) -> Group:
    return _groups.get(gid) or Group(0)


def _pg(group: Optional[Group]):
    return None if group is None else group.pg


def _nranks(group: Optional[Group]) -> int:
    if not is_initialized():
        return 1
    return group.nranks if group is not None else get_world_size()


def _synchronous(name: str, sync_op) -> None:
    if not sync_op:
        raise NotImplementedError(
            f"{name}(sync_op=False) (an asynchronous task handle) is not "
            f"ported yet (ROADMAP Queue A 5, parallelism)")


def all_reduce(tensor: torch.Tensor, op=ReduceOp.SUM, group=None,
               sync_op=True) -> torch.Tensor:
    """Reduce ``tensor`` over the group's ranks, in place."""
    _synchronous("all_reduce", sync_op)
    _m_collectives.labels(op="all_reduce").inc()
    n = _nranks(group)
    if n <= 1:
        return tensor
    if op not in _TORCH_OP:
        raise ValueError(f"unsupported ReduceOp {op}")
    dist.all_reduce(tensor, op=getattr(dist.ReduceOp, _TORCH_OP[op]),
                    group=_pg(group))
    if op == ReduceOp.AVG:
        tensor.copy_(div_rn(tensor, n))
    return tensor


def broadcast(tensor: torch.Tensor, src=0, group=None, sync_op=True):
    """Copy ``src``'s tensor to every rank of the group, in place."""
    _synchronous("broadcast", sync_op)
    _m_collectives.labels(op="broadcast").inc()
    if _nranks(group) > 1:
        dist.broadcast(tensor, src=src, group=_pg(group))
    return tensor


def barrier(group=None):
    if _nranks(group) > 1:
        dist.barrier(group=_pg(group))


def wait(tensor):
    """Wait until the card has finished the work queued on ``tensor``
    (every group's: the collectives run on the compute stream)."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)
    return tensor


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Tensor form: a new tensor, this rank's ``1/nranks`` chunk of dim 0
    of ``tensor`` reduced over the ranks (dim 0 divisible by the rank
    count). List form (``tensor_list`` one tensor a rank): rank r's
    result is the reduction over the ranks of ``tensor_list[r]``, written
    into ``tensor`` when it is given. AVG divides the sum by the rank
    count with ``div_rn``, as ``all_reduce`` does."""
    _synchronous("reduce_scatter", sync_op)
    _m_collectives.labels(op="reduce_scatter").inc()
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError("reduce_scatter supports SUM/AVG only")
    n = _nranks(group)
    if tensor_list is not None:
        if n <= 1:
            out = tensor_list[0].clone()
            for t in tensor_list[1:]:
                out = out + t
        else:
            if len(tensor_list) != n:
                raise ValueError(f"reduce_scatter: {len(tensor_list)} "
                                 f"tensors for {n} ranks")
            out = _reduce_scatter(torch.stack(list(tensor_list)), n, op,
                                  group)[0]
        if tensor is not None:
            tensor.copy_(out)
            return tensor
        return out
    if n <= 1:
        return tensor
    if tensor.dim() == 0 or tensor.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(tensor.shape)} "
                         f"does not split over {n} ranks")
    return _reduce_scatter(tensor, n, op, group)


def _reduce_scatter(tensor, n, op, group):
    out = tensor.new_empty((tensor.shape[0] // n, *tensor.shape[1:]))
    dist.reduce_scatter_tensor(out.view(-1), tensor.contiguous().view(-1),
                               op=dist.ReduceOp.SUM, group=_pg(group))
    if op == ReduceOp.AVG:
        out.copy_(div_rn(out, n))
    return out


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Every rank's ``tensor``: appended to ``tensor_list`` in rank order
    when it is given (and returned), else stacked on a new leading axis,
    ``[nranks, *tensor.shape]``. One rank: a copy of ``tensor``."""
    _synchronous("all_gather", sync_op)
    _m_collectives.labels(op="all_gather").inc()
    n = _nranks(group)
    if n <= 1:
        out = tensor.clone()
        if tensor_list is not None:
            tensor_list.append(out)
            return tensor_list
        return out
    out = tensor.new_empty((n, *tensor.shape))
    dist.all_gather_into_tensor(out.view(-1), tensor.contiguous().view(-1),
                                group=_pg(group))
    if tensor_list is not None:
        tensor_list.extend(out.unbind(0))
        return tensor_list
    return out


def _later(name: str):
    def f(*args, **kwargs):
        raise NotImplementedError(
            f"distributed.{name} is not ported yet (ROADMAP Queue A 5, "
            f"parallelism)")

    f.__name__ = name
    return f


alltoall = _later("alltoall")
send = _later("send")
recv = _later("recv")
split = _later("split")
in_trace_psum = _later("in_trace_psum")
in_trace_all_gather = _later("in_trace_all_gather")
in_trace_pmax = _later("in_trace_pmax")
