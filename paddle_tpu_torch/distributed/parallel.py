"""DataParallel (reference: ``paddle_tpu/distributed/parallel.py``).

Eager data parallelism: each rank runs ``forward`` and ``backward`` on
its own batch, then ``apply_collective_grads()`` averages the gradients
over the ranks through ``GradCommunicator.sync``, bucket by bucket.

    model = DataParallel(net)
    loss = model.scale_loss(loss_fn(model(x), y))
    loss.backward()
    model.apply_collective_grads()
    opt.step()

The wire codec: the reference reads it from a ``DistributedStrategy``
(``config_from_strategy``: ``grad_comm_configs``, else bf16 under
``fp16_allreduce``, else the gradients' own dtype). Strategies are not
ported yet (ROADMAP Queue A 2), so ``strategy`` raises; the port takes
the config itself as ``grad_comm`` (a ``GradCommConfig`` or a codec
name) and defaults to what the reference does without a strategy, the
fp32 wire. ``comm_buffer_size`` and ``last_comm_buffer_size`` shape the
config built from a codec name (or the default); a ``GradCommConfig``
holds its own, and passing them beside one raises. The overlapped
communicator is not ported either: the sync runs after backward.
"""
from __future__ import annotations

import torch

from .env import get_world_size
from .grad_comm import GradCommConfig, GradCommunicator

__all__ = ["DataParallel"]


class DataParallel(torch.nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=None,
                 last_comm_buffer_size=None, find_unused_parameters=False,
                 group=None, grad_comm=None):
        super().__init__()
        if strategy is not None:
            raise NotImplementedError(
                "DataParallel(strategy=...) is not ported yet (ROADMAP "
                "Queue A 2, config_from_strategy); pass grad_comm=")
        caps = {k: v for k, v in (("comm_buffer_size", comm_buffer_size),
                                  ("last_comm_buffer_size",
                                   last_comm_buffer_size)) if v is not None}
        if grad_comm is None or isinstance(grad_comm, str):
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
        self.comm_buffer_size = grad_comm.comm_buffer_size
        self.last_comm_buffer_size = grad_comm.last_comm_buffer_size
        self._grad_comm = GradCommunicator(grad_comm, group=group)

    @property
    def grad_communicator(self) -> GradCommunicator:
        return self._grad_comm

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        # the sync averages the gradients; the loss stays unscaled
        return loss

    @torch.no_grad()
    def apply_collective_grads(self):
        """Average every trainable parameter's gradient over the ranks."""
        world = get_world_size()
        if world <= 1:
            return
        params = [p for p in self._layers.parameters() if p.requires_grad]
        missing = [(n, p) for n, p in self._layers.named_parameters()
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
        self._grad_comm.sync(params, world=world)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    set_state_dict = load_state_dict

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def named_parameters(self, prefix="", recurse=True, **kwargs):
        return self._layers.named_parameters(prefix, recurse, **kwargs)
