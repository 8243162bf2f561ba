"""``paddle.distributed.sharding``: group-sharded (ZeRO) data
parallelism (reference: ``paddle_tpu/distributed/sharding/__init__.py``
``group_sharded_parallel``, ``save_group_sharded_model``).

The eager path over ``torch.distributed``, one process a rank:

- ``os`` (stage 1): the optimizer is marked (``_slot_shard_axis``) and
  nothing else changes, as in the reference's eager path; the compiled
  slot sharding (``dist_spec``, ``zero_slot_spec``, ``TrainStep``'s slot
  shardings) waits for a mesh, ROADMAP Queue A item 10 (parallelism);
- ``os_g`` (stage 2): ``model._grad_comm``, a communicator whose
  ``sync(params, world, use_reduce_scatter=True)`` has each rank reduce
  only its shard of every bucket (overlapped with ``overlap_comm``:
  ``distributed/overlap.py``); with ``fuse_update``,
  ``model._fused_update``, a ``FusedFlatUpdater`` on the communicator's
  buckets, laid out padded for the world, whose ``step_sharded(rank,
  world)`` updates the owned shard in one launch and all-gathers it;
- ``p_g_os`` (stage 3): stage 2, and with more than one rank the model's
  parameters sharded at rest (``model._zero3``, a
  ``Stage3ParamShards`` with its hooks installed; ``stage3.py``), which
  ``step_sharded(..., param_store=model._zero3)`` updates with no gather.

The wire config is the reference's (bf16, bucket caps from
``buffer_max_size`` and ``segment_size``) unless the port's keyword-only
``grad_comm`` (a codec name, or a ``GradCommConfig`` whose caps it then
holds) says otherwise; ``overlap_comm`` sets its ``overlap``.
``offload=True`` raises as in the reference.
``save_group_sharded_checkpoint`` needs the reference's
``robustness/checkpoint.py`` ``CheckpointManager``: ROADMAP Queue A
item 14 ("the rest").
"""
from __future__ import annotations

import contextlib
import os

from . import reshard  # noqa: F401
from .stage3 import Stage3ParamShards

__all__ = ["group_sharded_parallel", "save_group_sharded_model",
           "save_group_sharded_checkpoint", "Stage3ParamShards",
           "reshard"]

_LEVELS = ("os", "os_g", "p_g_os")
_MB_F = 1024.0 * 1024.0


def group_sharded_parallel(model, optimizer, level, scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, overlap_comm=False,
                           fuse_update=False, *, grad_comm=None):
    """Wrap ``model`` and ``optimizer`` for ZeRO at ``level`` (module
    docstring); returns ``(model, optimizer, scaler)``."""
    if level not in _LEVELS:
        raise ValueError(f"level must be one of {_LEVELS}, got {level!r}")
    if offload:
        raise NotImplementedError(
            "offload=True (host-memory opt state) is not supported; "
            "level='p_g_os' shards the parameters on the card instead")
    from ...framework.modules import torch_parameters
    from ..env import get_world_size
    from ..grad_comm import GradCommConfig
    from ..overlap import communicator_for

    optimizer._slot_shard_axis = "sharding"
    if level in ("os_g", "p_g_os"):
        if isinstance(grad_comm, GradCommConfig):
            cfg = GradCommConfig(grad_comm.codec, grad_comm.comm_buffer_size,
                                 grad_comm.last_comm_buffer_size,
                                 grad_comm.error_feedback, overlap_comm,
                                 grad_comm.block_size)
        else:
            cfg = GradCommConfig(
                grad_comm or "bf16",
                comm_buffer_size=buffer_max_size / _MB_F,
                last_comm_buffer_size=max(segment_size / _MB_F, 0.001),
                overlap=overlap_comm)
        model._grad_comm = communicator_for(cfg, group=group)
        world = get_world_size()
        params = [p for p in torch_parameters(model) if p.requires_grad]
        if fuse_update:
            from ...optimizer.fused import FusedFlatUpdater

            model._fused_update = FusedFlatUpdater(
                optimizer, params, communicator=model._grad_comm,
                world=world)
        if level == "p_g_os" and world > 1:
            store = Stage3ParamShards(params, communicator=model._grad_comm,
                                      world=world, group=group)
            store.shard_()
            store.install_hooks(model)
            model._zero3 = store
            if fuse_update:
                model._fused_update.release_param_buffers()
    return model, optimizer, scaler


def save_group_sharded_checkpoint(model, root, step, optimizer=None,
                                  rank=None, world_size=None, barrier=None,
                                  manager=None, fs=None, fused=None,
                                  job_state=None, metadata=None):
    raise NotImplementedError(
        "save_group_sharded_checkpoint needs the robustness "
        "CheckpointManager, which is not ported yet (ROADMAP Queue A "
        "item 14, the rest); save_group_sharded_model writes the full "
        "weights")


def save_group_sharded_model(model, output, optimizer=None):
    """Write the FULL (unsharded) weights to ``output/model.pdparams``
    (and the optimizer's state to ``model.pdopt``) with the port's
    ``paddle.save``; a stage-3 model's buckets are gathered around the
    save (``materialize``) and freed again on every exit."""
    from ...framework.io import save

    os.makedirs(output, exist_ok=True)
    store = getattr(model, "_zero3", None)
    ctx = (store.materialize() if store is not None and store.sharded
           else contextlib.nullcontext())
    with ctx:
        save(model.state_dict(), os.path.join(output, "model.pdparams"))
    if optimizer is not None:
        save(optimizer.state_dict(), os.path.join(output, "model.pdopt"))
