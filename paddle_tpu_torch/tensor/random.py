"""Random sampling ops (reference: ``paddle_tpu/tensor/random.py``, lines
29-131, and ``tensor/manipulation.py:606`` ``shuffle_batch``).

Each draw takes the generator of the device it lands on from the global
stream (``framework/random.py``): the current place for a new tensor,
the input's device for an op on one. ``seed`` makes every draw repeat on
its device; the bits are not the reference's (``framework/random.py``
says what a test can hold). The shapes, dtypes (the reference's
narrowed names: "int64" is int32, as there) and ranges are the
reference's:

- ``rand``/``uniform`` draw from ``[min, max)``, ``randn``/
  ``standard_normal``/``normal`` from N(0, 1) scaled and shifted as the
  reference does (``normal * std + mean``), ``randint`` from ``[low,
  high)``, ``randperm`` a permutation of ``[0, n)``;
- ``bernoulli(x)`` is 1 with probability ``x``, ``poisson(x)`` a count
  of rate ``x``, ``multinomial`` draws category indices of the rows of
  ``x`` (proportional to their weights; without replacement, distinct in
  a row);
- ``uniform_``, ``normal_`` and ``exponential_`` overwrite a tensor's
  values in place, as ``set_value`` does, so a leaf stays that leaf;
- ``shuffle_batch(x, seed)`` permutes ``x``'s rows and returns ``(out,
  order)``.

The ops of an input go through ``call_op`` under the reference's op
names (``bernoulli``, ``poisson``, ``multinomial``, ``shuffle_batch``):
given an eager ``Tensor`` they return one, given a ``torch.Tensor`` a
``torch.Tensor``. The draws of new tensors return eager ``Tensor``s, as
the reference's do. A draw with ``seed=k`` uses a generator of its own,
seeded with ``k``.
"""
from __future__ import annotations

import torch

from ..framework import random as rng
from ._helpers import Tensor, op, val, wrap
from .creation import _dev, _dt, _shape

__all__ = ["rand", "randn", "standard_normal", "normal", "uniform",
           "uniform_", "randint", "randint_like", "randperm", "rand_like",
           "randn_like", "bernoulli", "poisson", "multinomial",
           "exponential_", "normal_", "shuffle_batch"]


def _float_dt(dt: torch.dtype) -> torch.dtype:
    return dt if dt.is_floating_point else torch.float32


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, min=0.0, max=1.0)


def standard_normal(shape, dtype=None, name=None):
    dev = _dev()
    return wrap(torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                            generator=rng.generator_for(dev)))


def randn(shape, dtype=None, name=None):
    return standard_normal(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """``N(0, 1) * std + mean`` in the default dtype; a ``Tensor`` mean
    or std broadcasts with the other (no gradient reaches them, as in
    the reference)."""
    m, s = val(mean), val(std)
    if isinstance(m, torch.Tensor) or isinstance(s, torch.Tensor):
        shp = torch.broadcast_shapes(*(tuple(getattr(v, "shape", ()))
                                       for v in (m, s)))
        dev = next(v.device for v in (m, s) if isinstance(v, torch.Tensor))
    else:
        shp = _shape(shape) if shape is not None else ()
        dev = _dev()
    with torch.no_grad():
        z = torch.randn(shp, dtype=_dt(None), device=dev,
                        generator=rng.generator_for(dev))
        return wrap(z * s + m)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev, dt = _dev(), _dt(dtype)
    out = torch.empty(_shape(shape), dtype=dt, device=dev)
    out.uniform_(float(val(min)), float(val(max)),
                 generator=rng.generator_for(dev, seed))
    return wrap(out)


def _overwrite(x, values: torch.Tensor):
    """``x``'s values replaced in place (``Tensor.set_value``'s write), or
    a plain tensor's under ``no_grad``."""
    if isinstance(x, Tensor):
        x._write(values)
    else:
        with torch.no_grad():
            x.copy_(values)
    return x


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    v = val(x)
    out = torch.empty_like(v, dtype=_float_dt(v.dtype))
    out.uniform_(float(val(min)), float(val(max)),
                 generator=rng.generator_for(v.device, seed))
    return _overwrite(x, out)


def normal_(x, mean=0.0, std=1.0, name=None):
    v = val(x)
    z = torch.randn(v.shape, dtype=torch.float32, device=v.device,
                    generator=rng.generator_for(v.device))
    return _overwrite(x, z * std + mean)


def exponential_(x, lam=1.0, name=None):
    v = val(x)
    out = torch.empty_like(v, dtype=_float_dt(v.dtype))
    out.exponential_(1.0, generator=rng.generator_for(v.device))
    return _overwrite(x, out / lam)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = _dev()
    return wrap(torch.randint(int(low), int(high), _shape(shape),
                              dtype=_dt(dtype), device=dev,
                              generator=rng.generator_for(dev)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return randint(low, high, x.shape, dtype or x.dtype)


def randperm(n, dtype="int64", name=None):
    dev = _dev()
    return wrap(torch.randperm(int(n), dtype=_dt(dtype), device=dev,
                               generator=rng.generator_for(dev)))


def rand_like(x, dtype=None, name=None):
    return rand(x.shape, dtype or x.dtype)


def randn_like(x, dtype=None, name=None):
    return randn(x.shape, dtype or x.dtype)


def bernoulli(x, name=None):
    return op(lambda v: torch.bernoulli(
        v.detach(), generator=rng.generator_for(v.device)), x,
        op_name="bernoulli")


def poisson(x, name=None):
    return op(lambda v: torch.poisson(
        v.detach(), generator=rng.generator_for(v.device)), x,
        op_name="poisson")


def multinomial(x, num_samples=1, replacement=False, name=None):
    return op(lambda v: torch.multinomial(
        v.detach(), int(num_samples), bool(replacement),
        generator=rng.generator_for(v.device)), x, op_name="multinomial")


def shuffle_batch(x, seed=None, name=None):
    """Rows of ``x`` in a random order, and the order."""
    def fn(v):
        order = torch.randperm(v.shape[0], device=v.device,
                               generator=rng.generator_for(v.device,
                                                           seed or 0))
        return v[order], order

    return op(fn, x, op_name="shuffle_batch")
