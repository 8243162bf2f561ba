"""The eager ``Tensor`` (reference: ``paddle_tpu/framework/tensor.py``).

A ``Tensor`` holds its payload in ``_value``, a ``torch.Tensor``, as the
reference's holds a ``jax.Array``. It is not a ``torch.Tensor`` and not
a subclass of one: Paddle's ``shape`` is a list and ``size`` a
property, and ``transpose(perm)``, ``sum(axis=)``, ``max``, ``gather``,
``sort``, ``expand(list)`` and ``flatten(start_axis, stop_axis)`` mean
other things than their PyTorch namesakes; a subclass overriding them
would break PyTorch's own code wherever such a tensor reached it.

Semantics kept from the reference:

- ``stop_gradient`` (default True) is ``not _value.requires_grad`` for a
  floating tensor; setting it False on a leaf makes PyTorch record the
  ops that read it, setting it True on an op's output detaches it. On a
  tensor that is not floating it is a flag that nothing reads, as there.
- Mutation rebinds the payload: ``__setitem__`` and the ``*_`` ops run
  out of place and ``_replace_from`` adopts the result, so a graph that
  read the old payload keeps it (``y = x * x; x[0] = 5; y.backward()``
  gives ``2 x`` of the old ``x``). A leaf rebound this way keeps its
  old payload in ``_leaf``, where its ``.grad`` lands, as the
  reference deposits into the same Python object. ``set_value``,
  ``fill_`` and ``zero_`` write a leaf in place (no graph reads it
  then), so an optimizer's update keeps the leaf.
- New tensors go to the current place (``framework/device.py``): the
  card unless ``set_device("cpu")`` or ``place="cpu"``.

The arithmetic dunders and the op methods are set on the class by
``paddle_tpu_torch.tensor`` (the reference's ``math_op_patch``).
"""
from __future__ import annotations

import builtins
import weakref

import numpy as np
import torch

from . import autograd, device as device_mod, dtype as dtype_mod
from .autograd import call_op, run_backward, wrap
from .grads import clear_grad
from .io import to_torch

__all__ = ["Tensor", "to_tensor", "Parameter", "param_view",
           "buffer_view", "create_parameter"]


class Tensor:
    __slots__ = ("_value", "__weakref__", "__dict__")

    # class-level defaults: an op's result sets only ``_value``
    name = ""
    persistable = False
    _leaf = None        # the leaf payload a rebinding op replaced
    _sg = True          # stop_gradient of a tensor that is not floating

    def __init__(self, data, dtype=None, place=None,
                 stop_gradient=True):
        self._value = _payload(data, dtype, place)
        self.stop_gradient = stop_gradient

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        """A PyTorch function or method given eager ``Tensor``s (code that
        mixes a layer's parameter views with ``torch.Tensor``s, such as
        ``torch_tensor + layer.bias``) runs on their payloads and returns
        what PyTorch returns: ``torch.Tensor``s."""
        return func(*_payloads(args), **_payloads(kwargs or {}))

    # ------------------------------------------------------------ properties
    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def ndim(self):
        return self._value.ndim

    ndimension = ndim

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def size(self):
        return self._value.numel()

    @property
    def place(self):
        return device_mod._parse(self._value.device)

    @property
    def T(self):
        from .. import tensor as ops

        return ops.transpose(self, list(range(self.ndim))[::-1])

    @property
    def is_leaf(self):
        return self._value.grad_fn is None

    def numel(self):
        return self.size

    def dim(self):
        return self.ndim

    # ---------------------------------------------------------- gradients
    @property
    def stop_gradient(self):
        v = self._value
        if v.is_floating_point() or v.is_complex():
            return not v.requires_grad
        return self._sg

    @stop_gradient.setter
    def stop_gradient(self, flag):
        v = self._value
        if not (v.is_floating_point() or v.is_complex()):
            self._sg = builtins.bool(flag)
        elif flag:
            if v.requires_grad:
                if v.is_leaf:
                    v.requires_grad_(False)
                else:
                    self._value = v.detach()
        elif not v.requires_grad:
            v.requires_grad_(True)

    def _grad_holder(self):
        v = self._value
        return v if v.is_leaf else self._leaf

    @property
    def grad(self):
        h = self._grad_holder()
        g = None if h is None else h.grad
        return None if g is None else wrap(g)

    @grad.setter
    def grad(self, g):
        h = self._grad_holder()
        if h is not None:
            h.grad = g._value if isinstance(g, Tensor) else g

    @property
    def gradient(self):
        g = self.grad
        return None if g is None else g.numpy()

    def backward(self, grad_tensor=None, retain_graph=False):
        run_backward([self], None if grad_tensor is None else [grad_tensor],
                     retain_graph=retain_graph)

    def clear_grad(self):
        h = self._grad_holder()
        if h is not None:
            clear_grad(h)

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """``hook(grad)`` on this tensor's gradient; a ``Tensor`` it
        returns replaces the gradient. Returns a handle with
        ``remove()``."""
        def on_grad(g):
            out = hook(wrap(g))
            return out._value if isinstance(out, Tensor) else out

        return self._value.register_hook(on_grad)

    # -------------------------------------------------------- conversions
    def numpy(self):
        """A host copy (never a view of the payload, which an in-place
        op may change); bf16 comes back as float32 (numpy has no bf16).
        A lazy conjugate (``torch.fft``'s) is resolved first."""
        v = self._value.detach().resolve_conj().resolve_neg()
        if v.dtype == torch.bfloat16:
            v = v.float()
        if v.device.type == "cpu":
            return v.numpy().copy()
        return v.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def item(self, *args):
        return self.numpy().item(*args)

    def tolist(self):
        return self.numpy().tolist()

    def astype(self, dtype):
        dt = dtype_mod.convert_dtype(dtype)
        return call_op(lambda v: dtype_mod.cast_value(v, dt), self,
                       op_name="cast")

    def cast(self, dtype):
        return self.astype(dtype)

    def clone(self):
        return call_op(torch.clone, self, op_name="clone")

    def detach(self):
        t = wrap(self._value.detach())
        t.name = self.name
        return t

    def _moved(self, device):
        """A new leaf on ``device`` with this tensor's stop_gradient (the
        reference's ``device_put`` of the payload)."""
        t = wrap(self._value.detach().to(device))
        t.stop_gradient = self.stop_gradient
        return t

    def cpu(self):
        return self._moved(torch.device("cpu"))

    def cuda(self, device_id=None, blocking=True):
        return self._moved(device_mod.resolve_device(
            "cuda" if device_id is None else f"cuda:{int(device_id)}"))

    def to(self, *args, **kwargs):
        out = self
        for a in args:
            if isinstance(a, (str, device_mod.Place, torch.device)) and (
                    not isinstance(a, str)
                    or a.split(":")[0].lower() in ("cpu", "gpu", "cuda",
                                                   "tpu")):
                out = out._moved(device_mod._parse(a).torch_device)
            else:
                out = out.astype(a)
        if kwargs.get("dtype") is not None:
            out = out.astype(kwargs["dtype"])
        return out

    def pin_memory(self):
        return self

    # ----------------------------------------------------------- mutation
    def set_value(self, value):
        """Overwrite the values (the reference's ``SetValue``); the shape
        must match."""
        if isinstance(value, Tensor):
            val = value._value
        elif isinstance(value, torch.Tensor):
            val = value
        else:
            val = to_torch(value)
        if tuple(val.shape) != tuple(self._value.shape):
            raise ValueError(f"set_value shape mismatch: {tuple(val.shape)} "
                             f"vs {tuple(self._value.shape)}")
        self._write(val.detach())
        return self

    def copy_(self, other, *a):
        return self.set_value(other)

    def fill_(self, v):
        self._write(torch.full_like(self._value, v))
        return self

    def zero_(self):
        self._write(torch.zeros_like(self._value))
        return self

    def _write(self, val):
        v = self._value
        if v.is_leaf and v.requires_grad:
            with torch.no_grad():
                v.copy_(val)
        else:
            sg = self.stop_gradient
            self._value = val.to(v.device, v.dtype)
            self.stop_gradient = sg

    def _replace_from(self, new: "Tensor"):
        """Adopt ``new``'s payload and graph (an in-place op run out of
        place); a leaf keeps its old payload for ``.grad``."""
        v = self._value
        if self._leaf is None and v.is_leaf and v.requires_grad:
            self._leaf = v
        self._value = new._value
        if not (new._value.is_floating_point() or new._value.is_complex()):
            self._sg = new._sg

    # ----------------------------------------------------------- indexing
    def __getitem__(self, idx):
        idx = _sanitize_index(idx, self._value.device)
        return call_op(lambda v: v[idx], self, op_name="getitem")

    def __setitem__(self, idx, value):
        idx = _sanitize_index(idx, self._value.device)

        def put(v, *u):
            out = v.clone()
            src = u[0] if u else torch.as_tensor(np.asarray(value))
            out[idx] = src.to(v.device, v.dtype)
            return out

        if isinstance(value, Tensor):
            new = call_op(put, self, value, op_name="setitem")
        else:
            new = call_op(put, self, op_name="setitem")
        self._replace_from(new)

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._value.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ---------------------------------------------------------- operators
    def __bool__(self):
        return builtins.bool(self.numpy())

    def __int__(self):
        return int(self.item())

    def __float__(self):
        return float(self.item())

    def __index__(self):
        return int(self.item())

    def __hash__(self):
        return id(self)

    def __repr__(self):
        vals = np.array2string(self.numpy(), precision=8, separator=", ")
        return (f"Tensor(shape={self.shape}, "
                f"dtype={dtype_mod.dtype_name(self.dtype)}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},\n"
                f"       {vals})")

    __str__ = __repr__


autograd._Tensor = Tensor


class _Bound(Tensor):
    """An eager view of a tensor that something else owns (a layer's
    parameter or buffer): writes go into the payload in place, so the
    owner sees them, and the payload is never rebound."""

    __slots__ = ()

    def _write(self, val):
        with torch.no_grad():
            self._value.copy_(val.to(self._value.device, self._value.dtype))

    def _replace_from(self, new):
        self._write(new._value.detach())


def _on_payload(attr, default):
    """A ``Parameter`` attribute kept on its ``torch.Tensor`` payload, so
    code that holds only the payload (``TrainStep``, the fused updater,
    the optimizers' ``lr_mult``) reads what the view set."""
    def get(self):
        return getattr(self._value, attr, default)

    def put(self, v):
        setattr(self._value, attr, v)

    return property(get, put)


class Parameter(_Bound):
    """A trainable ``Tensor`` (reference: ``framework/tensor.py:329-356``):
    ``stop_gradient`` False unless ``trainable=False``, ``name``,
    ``persistable`` True. Its payload is a ``torch.nn.Parameter``, which
    a ``Layer`` registers as its own (``nn/layer/layers.py``), and which
    carries the view's ``name``, ``optimize_attr``, ``regularizer``,
    ``need_clip`` and ``trainable`` (``_on_payload``). An in-place op on
    a parameter writes into that payload (``_Bound``)."""

    __slots__ = ()

    def __init__(self, data, dtype=None, name="", trainable=True):
        v = _payload(data, dtype, None)
        self._value = torch.nn.Parameter(
            v, requires_grad=builtins.bool(trainable)
            and (v.is_floating_point() or v.is_complex()))
        self.name = name
        self.persistable = True
        self._value._paddle_view = weakref.ref(self)

    name = _on_payload("_paddle_name", "")
    persistable = _on_payload("persistable", True)
    optimize_attr = _on_payload("optimize_attr", {"learning_rate": 1.0})
    regularizer = _on_payload("regularizer", None)
    need_clip = _on_payload("need_clip", True)
    is_distributed = False

    @property
    def trainable(self):
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, v):
        self.stop_gradient = not v

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()

    __str__ = __repr__


def _view(v: torch.Tensor, cls):
    """The one live eager view of ``v`` (kept by a weak reference on
    ``v``, so a view nobody holds goes, and no cycle keeps ``v``)."""
    ref = getattr(v, "_paddle_view", None)
    t = None if ref is None else ref()
    if t is None or type(t) is not cls or t._value is not v:
        t = object.__new__(cls)
        t._value = v
        v._paddle_view = weakref.ref(t)
    return t


def param_view(v: torch.Tensor) -> Parameter:
    """``v`` (a layer's ``torch.nn.Parameter``) as its eager
    ``Parameter``; the same object while anyone holds it."""
    return _view(v, Parameter)


def buffer_view(v: torch.Tensor) -> Tensor:
    """``v`` (a layer's buffer) as an eager ``Tensor`` that writes into
    it."""
    return _view(v, _Bound)


def _payloads(x):
    """``x`` with every eager ``Tensor`` in it (through tuples, lists and
    dicts) replaced by its payload."""
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, (tuple, list)):
        return type(x)(_payloads(v) for v in x)
    if isinstance(x, dict):
        return {k: _payloads(v) for k, v in x.items()}
    return x


def _sanitize_index(idx, device):
    def conv(i):
        if isinstance(i, Tensor):
            return i._value
        if isinstance(i, (list, np.ndarray)):
            return torch.as_tensor(np.asarray(i), device=device)
        return i

    if isinstance(idx, tuple):
        return tuple(conv(i) for i in idx)
    return conv(idx)


def _place_device(place) -> torch.device:
    if place is None:
        return device_mod.current_place().torch_device
    return device_mod._parse(place).torch_device


def _payload(data, dtype, place) -> torch.Tensor:
    """``data`` as the payload the reference's constructor makes: float64
    host data takes the default dtype, 64-bit types narrow, and host data
    goes to ``place`` (the current place when None). A tensor already on
    a device stays there unless ``place`` is given."""
    dt = dtype_mod.convert_dtype(dtype)
    if isinstance(data, Tensor):
        data = data._value
    if isinstance(data, torch.Tensor):
        v = data.detach()
        dev = v.device if place is None else _place_device(place)
    else:
        arr = np.asarray(data)
        if dt is None:
            dt = (dtype_mod.get_default_dtype() if arr.dtype == np.float64
                  else dtype_mod.convert_dtype(arr.dtype))
        if arr.dtype == np.float64 and dt != torch.float64:
            arr = arr.astype(np.float32)     # via fp32, as ml_dtypes rounds
        v = to_torch(arr)          # a copy; ml_dtypes bf16 by its bits
        dev = _place_device(place)
    if dt is None:
        dt = dtype_mod.convert_dtype(v.dtype)
    return v.to(device=dev, dtype=dt)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: a new leaf ``Tensor`` of ``data``."""
    t = object.__new__(Tensor)
    t._value = _payload(data, dtype, place)
    t.stop_gradient = stop_gradient
    return t


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """``paddle.create_parameter`` (reference: ``framework/tensor.py:
    367-382``): ``Layer.create_parameter`` of a new ``Layer``, so the
    ``ParamAttr`` handling and the default initializers are the same."""
    from ..framework.param_attr import ParamAttr
    from ..nn import Layer

    if name is not None and attr is None:
        attr = ParamAttr(name=name)
    return Layer().create_parameter(shape, attr=attr, dtype=dtype,
                                    is_bias=is_bias,
                                    default_initializer=default_initializer)
