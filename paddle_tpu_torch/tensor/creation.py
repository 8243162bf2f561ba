"""Creation ops (reference: ``paddle_tpu/tensor/creation.py``).

New tensors go to the current place (``framework/device.py``): the card
unless the caller set the CPU. ``linspace`` computes as JAX does,
``start (1 - t) + stop t`` in fp32 with the end point set, where
``torch.linspace`` counts half the points back from the end.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import amp as _amp
from ..framework import device as device_mod, dtype as dtype_mod
from ..framework.tensor import Tensor, to_tensor  # noqa: F401
from ._helpers import as_tensor, convert_dtype, op, scalar_of, val, wrap


def _dt(dtype):
    return (convert_dtype(dtype) if dtype is not None
            else dtype_mod.get_default_dtype())


def _dev():
    return device_mod.current_place().torch_device


def _shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape.numpy())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(val(s)) for s in shape)


def zeros(shape, dtype=None, name=None):
    return wrap(torch.zeros(_shape(shape), dtype=_dt(dtype), device=_dev()))


def ones(shape, dtype=None, name=None):
    return wrap(torch.ones(_shape(shape), dtype=_dt(dtype), device=_dev()))


def full(shape, fill_value, dtype=None, name=None):
    fill_value = val(fill_value)
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    if dtype is None and isinstance(fill_value, (bool, int)):
        dtype = "bool" if isinstance(fill_value, bool) else "int64"
    dt = _dt(dtype)
    return wrap(torch.full(_shape(shape), scalar_of(fill_value, dt),
                           dtype=dt, device=_dev()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def _like(fn, x, dtype):
    dt = convert_dtype(dtype)
    return op(lambda v: fn(v, dt), x)


def zeros_like(x, dtype=None, name=None):
    return _like(lambda v, dt: torch.zeros_like(v, dtype=dt), x, dtype)


def ones_like(x, dtype=None, name=None):
    return _like(lambda v, dt: torch.ones_like(v, dtype=dt), x, dtype)


def full_like(x, fill_value, dtype=None, name=None):
    f = val(fill_value)

    def fn(v, dt):
        dt = dt or v.dtype
        return torch.full_like(v, scalar_of(f, dt) if isinstance(
            f, (bool, int, float)) else f, dtype=dt)

    return _like(fn, x, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = val(start), val(end), val(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step))
                 else dtype_mod.get_default_dtype())
    dt = convert_dtype(dtype)
    if not dt.is_floating_point:
        return wrap(torch.arange(start, end, step, dtype=dt, device=_dev()))
    # the reference's values: start + i * step, each op rounded in the
    # dtype (torch.arange computes them in double and rounds once)
    n = max(0, int(np.ceil((float(end) - float(start)) / float(step))))
    i = torch.arange(n, dtype=dt, device=_dev())
    return wrap(i * torch.tensor(step, dtype=dt, device=_dev())
                + torch.tensor(start, dtype=dt, device=_dev()))


def linspace(start, stop, num, dtype=None, name=None):
    dt = _dt(dtype)
    num = int(val(num))
    cd = dt if dt.is_floating_point else torch.float32
    start_v = torch.tensor(float(val(start)), dtype=cd, device=_dev())
    stop_v = torch.tensor(float(val(stop)), dtype=cd, device=_dev())
    if num > 1:
        div = num - 1
        t = (torch.arange(div, dtype=torch.float32, device=_dev())
             / float(div)).to(cd)
        out = torch.cat([start_v * (1 - t) + stop_v * t, stop_v[None]])
    else:
        out = start_v.reshape(1)[:num]
    if not dt.is_floating_point:
        out = torch.floor(out)
    return wrap(out.to(dt))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    lin = linspace(start, stop, num, dtype=dtype)._value
    b = torch.tensor(float(base), dtype=lin.dtype, device=lin.device)
    return wrap(torch.pow(b, lin))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    m = num_rows if num_columns is None else num_columns
    return wrap(torch.eye(int(num_rows), int(m), dtype=_dt(dtype),
                          device=_dev()))


def diag(x, offset=0, padding_value=0, name=None):
    def fn(v):
        d = torch.diag(v, offset)
        if v.ndim == 1 and padding_value != 0:
            return torch.where(_diag_mask(d, offset), d,
                               scalar_of(padding_value, d.dtype))
        return d

    return op(fn, x, op_name="diag")


def _diag_mask(d, offset):
    r = torch.arange(d.shape[0], device=d.device)[:, None]
    c = torch.arange(d.shape[1], device=d.device)[None, :]
    return (c - r) == offset


def diagflat(x, offset=0, name=None):
    return op(lambda v: torch.diagflat(v, offset), x)


def tril(x, diagonal=0, name=None):
    return op(lambda v: torch.tril(v, diagonal), x)


def triu(x, diagonal=0, name=None):
    return op(lambda v: torch.triu(v, diagonal), x)


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    outs = op(lambda *vs: tuple(torch.meshgrid(*vs, indexing="ij")), *args,
              op_name="meshgrid")
    return list(outs)


def assign(x, output=None):
    src = x if isinstance(x, Tensor) else wrap(as_tensor(np.asarray(x)))
    res = op(torch.clone, src, op_name="assign")
    if output is not None:
        output._replace_from(res)
        return output
    return res


def clone(x, name=None):
    """A copy of an eager ``Tensor`` (the reference's ``x + 0``). On the
    models' path, a plain ``torch.Tensor``, it is the cast point "clone"
    and no copy (dropout's identity: nothing writes to it in place)."""
    if isinstance(x, Tensor):
        return x.clone()
    (x,) = _amp.cast("clone", x)
    return x


def numel(x, name=None):
    v = val(x)
    return wrap(torch.tensor(v.numel(), dtype=torch.int32, device=v.device))


def complex(real, imag, name=None):
    return op(torch.complex, real, imag, op_name="complex")


def real(x, name=None):
    return op(lambda v: torch.real(v) if v.is_complex() else v.clone(), x)


def imag(x, name=None):
    return op(lambda v: torch.imag(v) if v.is_complex()
              else torch.zeros_like(v), x)
