"""``nn.Layer``, the base of every layer (reference:
``paddle_tpu/nn/layer/layers.py``).

**Design.** Paddle's ``Layer`` and PyTorch's ``torch.nn.Module`` share
most names and disagree on some: ``parameters``, ``named_parameters``,
``buffers``, ``named_buffers`` and ``state_dict`` return eager
``Tensor``s in Paddle (lists, a dict of ``Tensor``s whose ``shape`` is a
list) and ``torch.Tensor``s in PyTorch; ``to`` and ``register_buffer``
take other arguments. The port's models (GPT, BERT, ResNet, Wide&Deep)
keep plain ``torch.Tensor``s from end to end, and the port's code
(``TrainStep``, the fused updater, ``DataParallel``, ``amp.decorate``,
the weight converters) reads PyTorch's meanings. So:

- ``Layer`` subclasses ``torch.nn.Module``: its parameters are
  registered as ``torch.nn.Parameter``s, its buffers as tensors, its
  sublayers as modules, and PyTorch's own machinery (``_apply``,
  ``load_state_dict``, hooks, ``children``, ``apply``, ``train``,
  ``eval``, ``float``, ``bfloat16``) works unchanged.
- Each registered ``torch.nn.Parameter`` has one eager ``Parameter``
  view whose payload it is (``framework/tensor.py`` ``param_view``);
  each buffer an eager view that writes into it. Paddle's accessors,
  and attribute access (``layer.weight``), return the views, so a
  user gets Paddle's answers (``layer.weight.shape == [400, 120]``,
  ``p.grad.numpy()``), and the optimizers update the payloads in place
  (the identity of a leaf never changes).
- A layer's own ``forward`` reads its ``torch.nn.Parameter``s
  (``self._parameters[...]``), never the views: given a
  ``torch.Tensor`` input it computes on ``torch.Tensor``s alone, and
  given an eager ``Tensor`` the functionals wrap the result
  (``framework/autograd.py`` ``eager_fn``). The port's code that wants
  PyTorch's meaning of an accessor on a model that may be a ``Layer``
  reads it through ``framework/modules.py`` (``torch_parameters``,
  ``torch_named_parameters``, ``torch_buffers``), the
  ``torch.nn.Module`` methods themselves.

Another design, a ``Layer`` that is no ``torch.nn.Module``, would fork
the port's layers into two families; a subclass of ``torch.Tensor`` as
the parameter would break PyTorch's own code with Paddle's method names
(``framework/tensor.py``).
"""
from __future__ import annotations

import collections
import itertools
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from ...framework import device as device_mod, dtype as dtype_mod
from ...framework.autograd import unwrap
from ...framework.modules import torch_parameters
from ...framework.param_attr import ParamAttr
from ...framework.tensor import (Parameter, Tensor, buffer_view,
                                 param_view)
from .. import initializer as I

__all__ = ["Layer", "unique_name", "param_device"]

_COUNTERS: Dict[str, itertools.count] = collections.defaultdict(
    itertools.count)


def unique_name(key: str) -> str:
    """``key_N``, N counting from 0 for each key (the reference's
    ``utils.unique_name.generate``)."""
    return f"{key}_{next(_COUNTERS[key])}"


def param_device(device=None) -> torch.device:
    """Where a new layer's parameters go: ``device``, or the current
    place (the card unless ``set_device("cpu")``)."""
    if device is None:
        return device_mod.current_place().torch_device
    return device_mod.resolve_device(device)


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = (dtype_mod.convert_dtype(dtype) if dtype
                       else torch.float32)
        self._full_name = unique_name(name_scope
                                      or type(self).__name__.lower())

    # ------------------------------------------------------------ registry
    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            value = value._value
        elif isinstance(value, Tensor) and name in self.__dict__.get(
                "_buffers", ()):
            value = value._value
        super().__setattr__(name, value)

    def __getattr__(self, name):
        d = self.__dict__
        params = d.get("_parameters")
        if params is not None and name in params:
            p = params[name]
            return None if p is None else param_view(p)
        buffers = d.get("_buffers")
        if buffers is not None and name in buffers:
            b = buffers[name]
            return None if b is None else buffer_view(b)
        return super().__getattr__(name)

    # ------------------------------------------------------------ creation
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None):
        """A new ``Parameter`` of ``shape`` (not registered: assign it to
        an attribute), initialised by ``attr.initializer``, else
        ``default_initializer``, else the global initializer, else
        ``Constant(0)`` for a bias and ``XavierUniform`` for a weight;
        None when ``attr`` is False."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dt = dtype_mod.convert_dtype(dtype) if dtype else self._dtype
        init = (attr.initializer or default_initializer
                or I.global_initializer(is_bias))
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierUniform()
        name = attr.name or unique_name(
            f"{self._full_name}.{'b' if is_bias else 'w'}")
        data = torch.zeros([int(s) for s in shape], dtype=dt,
                           device=param_device(device))
        p = Parameter(data, name=name, trainable=attr.trainable)
        init(p)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name: str, parameter):
        if parameter is None:
            self.register_parameter(name, None)
        else:
            setattr(self, name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable=True,
                        persistent=None):
        """Paddle's ``persistable`` (or PyTorch's ``persistent``); an
        eager ``Tensor`` is registered by its payload."""
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, unwrap(tensor), persistent=keep)
        return tensor

    # ----------------------------------------------------------- iteration
    def named_parameters(self, prefix="", include_sublayers=True,
                         **kwargs) -> Iterator[Tuple[str, Parameter]]:
        for name, p in torch.nn.Module.named_parameters(
                self, prefix, include_sublayers):
            yield name, param_view(p)

    def parameters(self, include_sublayers=True) -> List[Parameter]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True, **kwargs):
        for name, b in torch.nn.Module.named_buffers(self, prefix,
                                                     include_sublayers):
            yield name, buffer_view(b)

    def buffers(self, include_sublayers=True) -> List[Tensor]:
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def sublayers(self, include_self=False) -> list:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    # ---------------------------------------------------------- state dict
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, **torch_kw):
        """Structured names -> the parameters' views and the persistable
        buffers' views. Called with PyTorch's ``prefix``/``keep_vars``
        (a ``torch.nn.Module`` parent's ``state_dict`` walking its
        children), it is PyTorch's."""
        if torch_kw:
            return super().state_dict(destination=destination, **torch_kw)
        dest = (collections.OrderedDict() if destination is None
                else destination)
        for name, p in self.named_parameters(
                include_sublayers=include_sublayers):
            dest[structured_name_prefix + name] = p
        mods = (self.named_modules() if include_sublayers
                else [("", self)])
        seen = set()
        for prefix, m in mods:
            for bname, b in m._buffers.items():
                if (b is None or id(b) in seen
                        or bname in m._non_persistent_buffers_set):
                    continue
                seen.add(id(b))
                full = f"{prefix}.{bname}" if prefix else bname
                dest[structured_name_prefix + full] = buffer_view(b)
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each value (a ``Tensor``, a ``torch.Tensor`` or a numpy
        array) into the parameter or buffer of its name, in place;
        returns ``(missing, unexpected)``."""
        own = self.state_dict()
        missing = [k for k in own if k not in state_dict]
        unexpected = []
        for k, v in state_dict.items():
            tgt = own.get(k)
            if tgt is None:
                unexpected.append(k)
                continue
            src = unwrap(v)
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.asarray(src))
            if tuple(src.shape) != tuple(tgt._value.shape):
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{tuple(src.shape)} vs "
                                 f"{tuple(tgt._value.shape)}")
            tgt._write(src.detach())
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # ---------------------------------------------------------- conversion
    def to(self, device=None, dtype=None, blocking=None, **kwargs):
        """Paddle's ``to(device, dtype)`` (a place, a device name or a
        dtype name), or PyTorch's arguments: the floating parameters and
        buffers cast, everything moved, in place (the parameters' views
        stay valid)."""
        args = []
        if isinstance(device, (str, device_mod.Place, torch.device)):
            name = device if isinstance(device, str) else ""
            if name and name.split(":")[0].lower() not in (
                    "cpu", "gpu", "cuda", "tpu"):
                dtype = device
            else:
                args.append(device_mod._parse(device).torch_device)
        elif device is not None:
            dtype = device
        if dtype is not None:
            dt = dtype_mod.convert_dtype(dtype)
            args.append(dt)
            self._dtype = dt
            for m in self.modules():
                if isinstance(m, Layer):
                    m._dtype = dt
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # --------------------------------------------------------------- hooks
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)``; a value it returns replaces
        the output. Returns a handle with ``remove()``."""
        return self.register_forward_hook(hook)

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def full_name(self) -> str:
        return self._full_name

    def clear_gradients(self, set_to_zero=True):
        for p in torch_parameters(self):
            p.grad = None
