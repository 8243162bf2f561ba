"""DataParallel (reference: ``paddle_tpu/distributed/parallel.py``).

Eager data parallelism: each rank runs ``forward`` and ``backward`` on
its own batch, then ``apply_collective_grads()`` averages the gradients
over the ranks through ``GradCommunicator.sync``, bucket by bucket.

    model = DataParallel(net)
    loss = model.scale_loss(loss_fn(model(x), y))
    loss.backward()
    model.apply_collective_grads()
    opt.step()

The wire codec comes from a ``DistributedStrategy`` as in the
reference (``grad_comm.config_from_strategy``: ``grad_comm_configs``
when its ``grad_comm`` toggle is on, else bf16 under ``fp16_allreduce``,
else the gradients' own dtype, fp32), read again at every forward and
sync, so a toggle changed on the strategy rebuilds the communicator
(its key: codec, caps, error feedback, overlap). Without a strategy the
port also takes the config itself as ``grad_comm`` (a ``GradCommConfig``
or a codec name; not beside a strategy) and defaults to the fp32 wire.
``comm_buffer_size`` and ``last_comm_buffer_size`` shape the config
built from a strategy without ``grad_comm``, from a codec name or the
default; a ``GradCommConfig`` holds its own, and passing them beside one
raises. With ``overlap`` the communicator is an
``OverlappedGradCommunicator`` (``distributed/overlap.py``): ``forward``
arms it, so each bucket's collective launches as backward completes it,
and ``apply_collective_grads`` is its flush. A parameter without a
gradient raises, or with ``find_unused_parameters`` gets a zero one
first, as in the reference.
"""
from __future__ import annotations

import torch

from ..framework.modules import torch_named_parameters, torch_parameters
from .env import get_world_size
from .grad_comm import (GradCommConfig, GradCommunicator,
                        config_from_strategy)
from .overlap import communicator_for

__all__ = ["DataParallel"]


class DataParallel(torch.nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=None,
                 last_comm_buffer_size=None, find_unused_parameters=False,
                 group=None, grad_comm=None):
        super().__init__()
        caps = {k: v for k, v in (("comm_buffer_size", comm_buffer_size),
                                  ("last_comm_buffer_size",
                                   last_comm_buffer_size)) if v is not None}
        if strategy is not None and grad_comm is not None:
            raise ValueError("DataParallel: pass strategy= or grad_comm=, "
                             "not both")
        if strategy is not None:
            # the caps are validated now, not at the first sync
            grad_comm = GradCommConfig(**caps)
        elif grad_comm is None or isinstance(grad_comm, str):
            grad_comm = GradCommConfig(grad_comm or "fp32", **caps)
        elif not isinstance(grad_comm, GradCommConfig):
            raise TypeError(f"grad_comm must be a GradCommConfig or a codec "
                            f"name, got {type(grad_comm).__name__}")
        elif caps:
            raise ValueError(
                f"DataParallel: {sorted(caps)} given with a GradCommConfig, "
                f"which holds the bucket caps; set them in the config")
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self.group = group
        self._strategy = strategy
        self._config = None if strategy is not None else grad_comm
        self.comm_buffer_size = grad_comm.comm_buffer_size
        self.last_comm_buffer_size = grad_comm.last_comm_buffer_size
        self._grad_comm = None
        self._grad_comm_key = None
        self._grad_communicator()

    def _grad_communicator(self) -> GradCommunicator:
        """The communicator of the current config, rebuilt when the
        strategy's config changed (its key)."""
        cfg = self._config or config_from_strategy(
            self._strategy, self.comm_buffer_size,
            self.last_comm_buffer_size)
        key = (cfg.codec, cfg.comm_buffer_size, cfg.last_comm_buffer_size,
               cfg.error_feedback, cfg.overlap, cfg.block_size)
        if self._grad_comm is None or key != self._grad_comm_key:
            self._grad_comm = communicator_for(cfg, group=self.group)
            self._grad_comm_key = key
        return self._grad_comm

    @property
    def grad_communicator(self) -> GradCommunicator:
        return self._grad_communicator()

    def _trainable(self):
        return [p for p in torch_parameters(self._layers) if p.requires_grad]

    def forward(self, *inputs, **kwargs):
        out = self._layers(*inputs, **kwargs)
        world = get_world_size()
        if world > 1:
            comm = self._grad_communicator()
            if hasattr(comm, "prepare"):
                comm.prepare(self._trainable(), world=world)
        return out

    def scale_loss(self, loss):
        # the sync averages the gradients; the loss stays unscaled
        return loss

    @torch.no_grad()
    def apply_collective_grads(self):
        """Average every trainable parameter's gradient over the ranks."""
        world = get_world_size()
        if world <= 1:
            return
        params = self._trainable()
        missing = [(n, p) for n, p in torch_named_parameters(self._layers)
                   if p.requires_grad and p.grad is None]
        if missing:
            if not self.find_unused_parameters:
                names = [n for n, _ in missing[:8]]
                raise RuntimeError(
                    f"{len(missing)} parameter(s) produced no gradient this "
                    f"step (e.g. {names}); ranks would desync in the grad "
                    f"allreduce. Pass find_unused_parameters=True to "
                    f"DataParallel if parts of the model are conditionally "
                    f"unused.")
            for _, p in missing:
                p.grad = torch.zeros_like(p)
        self._grad_communicator().sync(params, world=world)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    set_state_dict = load_state_dict

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, prefix="", recurse=True, **kwargs):
        return self._layers.named_parameters(prefix, recurse, **kwargs)
