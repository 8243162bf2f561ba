"""The sequence ops (reference: ``paddle_tpu/nn/functional/sequence.py``)
over the reference's carrier of a batch of sequences: padded data ``[B,
T, ...]`` with lengths ``[B]``.

Each is the reference's formula on PyTorch's ops, a cast point of
``amp`` under the reference's op name. The ops whose output size depends
on the lengths read them on the host, as the reference does:
``sequence_pad`` (its ``T``, from ``maxlen`` or the longest length, and
its row index), ``sequence_unpad``, ``sequence_expand`` (the repeat
counts), ``sequence_slice`` (the offsets and lengths), and
``sequence_mask`` without ``maxlen``. ``sequence_unpad`` and
``sequence_expand`` refuse an input that needs a gradient, as the
reference's do (ROADMAP Queue C). The others run on the device:

- ``sequence_reverse`` reverses each valid prefix in place (padding
  stays where it is), or the whole time axis without lengths;
- ``sequence_pool`` sums, averages (divided by ``max(len, 1)``), divides
  by ``sqrt(max(len, 1))`` ("sqrt"), takes the max or min (``-inf`` /
  ``inf`` for a sequence of length 0), or picks the first or the last
  valid step (the first step for a sequence of length 0);
- ``sequence_softmax`` masks the padding with ``-1e30``, takes the
  softmax over time in fp32 and zeroes the padding;
- ``sequence_concat`` concatenates along time.

Each takes ``torch.Tensor``s or eager ``Tensor``s (``eager_fn``).
"""
from __future__ import annotations

import numpy as np
import torch

from ...amp import cast
from ...framework.autograd import call_op, eager_fn, unwrap
from ...framework.dtype import convert_dtype

__all__ = [
    "sequence_mask", "sequence_pad", "sequence_unpad", "sequence_reverse",
    "sequence_pool", "sequence_softmax", "sequence_expand", "sequence_concat",
    "sequence_first_step", "sequence_last_step", "sequence_slice",
]


def _host_ints(v) -> np.ndarray:
    """``v`` (a tensor, an array or a list) as host int64."""
    v = unwrap(v)
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.int64).numpy()
    return np.asarray(v).astype(np.int64)


def _trailing(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """``mask`` ``[B, T]`` with size-1 axes for the feature axes."""
    return mask.reshape(tuple(mask.shape) + (1,) * (ndim - 2))


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < x[...]``; ``maxlen`` defaults to the longest
    length."""
    (x,) = cast("sequence_mask", x)
    m = int(maxlen) if maxlen is not None else int(x.max())
    pos = torch.arange(m, device=x.device)
    return (pos < x[..., None]).to(convert_dtype(dtype))


def sequence_pad(x, pad_value, lengths, maxlen=None, name=None):
    """Rows concatenated ``[sum(len), ...]`` -> ``[B, T, ...]`` with
    ``pad_value`` after each length; returns ``(padded, lengths)``."""
    lens = _host_ints(lengths)
    T = int(maxlen if maxlen is not None else lens.max())
    B = lens.size
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    if not isinstance(pad_value, torch.Tensor):
        pad_value = torch.tensor(np.asarray(pad_value, np.float32))
    x, pad_value = cast("sequence_pad", x, pad_value)
    feat = tuple(x.shape[1:])
    # each row's steps gathered with clamped indices, the tail masked
    idx = np.minimum(starts[:, None] + np.arange(T)[None, :],
                     x.shape[0] - 1)
    rows = x[torch.from_numpy(idx.reshape(-1)).to(x.device)].reshape(
        (B, T) + feat)
    valid = torch.from_numpy(np.arange(T)[None, :] < lens[:, None]).to(
        x.device)
    fill = pad_value.to(device=x.device, dtype=x.dtype)
    padded = torch.where(_trailing(valid, len(feat) + 2), rows, fill)
    return padded, torch.from_numpy(lens).to(x.device)


def _no_gradient(x: torch.Tensor, op: str) -> None:
    """The reference's ragged ops give no gradient: its ``call_op``
    traces an op whose input needs one, and they refuse a trace."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError(f"{op}: the output's size depends on the data, "
                         f"and the reference's op gives its input no "
                         f"gradient (ROADMAP Queue C)")


def sequence_unpad(x, length, name=None):
    """``[B, T, ...]`` -> the valid steps concatenated ``[sum(len),
    ...]`` (no gradient, as in the reference)."""
    _no_gradient(x, "sequence_unpad")
    lens = _host_ints(length)
    (x,) = cast("sequence_unpad", x)
    return torch.cat([x[b, :int(n)] for b, n in enumerate(lens)])


def sequence_reverse(x, lengths=None, name=None):
    """Each sequence's valid prefix reversed, the padding in place."""
    if lengths is None:
        (x,) = cast("sequence_reverse", x)
        return torch.flip(x, [1])
    x, lengths = cast("sequence_reverse", x, lengths)
    T = x.shape[1]
    pos = torch.arange(T, device=x.device)[None, :]
    lens = lengths.to(x.device)[:, None]
    idx = torch.where(pos < lens, lens - 1 - pos, pos)
    idx = _trailing(idx, x.ndim).expand(x.shape)
    return torch.gather(x, 1, idx)


def sequence_pool(x, pool_type, lengths=None, pad_value=0.0, name=None):
    """sum / average / sqrt / max / min / first / last over each valid
    prefix (the module docstring); ``pad_value`` is taken and not used."""
    pool_type = pool_type.lower()
    op_name = f"sequence_pool_{pool_type}"
    if lengths is None:
        (x,) = cast(op_name, x)
        lens = torch.full((x.shape[0],), x.shape[1], dtype=torch.int64,
                          device=x.device)
    else:
        x, lens = cast(op_name, x, lengths)
        lens = lens.to(x.device)
    B, T = x.shape[0], x.shape[1]
    valid = _trailing(torch.arange(T, device=x.device)[None, :]
                      < lens[:, None], x.ndim)
    n = torch.clamp(lens, min=1).reshape((B,) + (1,) * (x.ndim - 2))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if pool_type == "sum":
        return torch.sum(torch.where(valid, x, zero), 1)
    if pool_type in ("average", "mean"):
        return torch.sum(torch.where(valid, x, zero), 1) / n
    if pool_type == "sqrt":
        return torch.sum(torch.where(valid, x, zero), 1) / torch.sqrt(
            n.to(torch.float32))
    if pool_type in ("max", "min"):
        fill = torch.full((), -np.inf if pool_type == "max" else np.inf,
                          dtype=x.dtype, device=x.device)
        reduce = torch.amax if pool_type == "max" else torch.amin
        return reduce(torch.where(valid, x, fill), 1)
    if pool_type == "first":
        return x[:, 0]
    if pool_type == "last":
        idx = torch.clamp(lens - 1, min=0).reshape(
            (B, 1) + (1,) * (x.ndim - 2))
        return torch.gather(x, 1, idx.expand((B, 1) + tuple(x.shape[2:])))[
            :, 0]
    raise ValueError(f"unknown pool_type {pool_type!r}")


def sequence_first_step(x, lengths=None):
    return sequence_pool(x, "first", lengths)


def sequence_last_step(x, lengths=None):
    return sequence_pool(x, "last", lengths)


def sequence_softmax(x, lengths=None, name=None):
    """Softmax over time of each valid prefix, zero on the padding."""
    if lengths is None:
        (x,) = cast("sequence_softmax", x)
        return torch.softmax(x.to(torch.float32), 1).to(x.dtype)
    x, lengths = cast("sequence_softmax", x, lengths)
    T = x.shape[1]
    valid = _trailing(torch.arange(T, device=x.device)[None, :]
                      < lengths.to(x.device)[:, None], x.ndim)
    logits = torch.where(valid, x, torch.full((), -1e30, dtype=x.dtype,
                                              device=x.device))
    out = torch.softmax(logits.to(torch.float32), 1)
    out = torch.where(valid, out, torch.zeros((), device=x.device))
    return out.to(x.dtype)


def sequence_expand(x, repeat_times, name=None):
    """Row ``b`` repeated ``repeat_times[b]`` times (the counts read on
    the host; no gradient, as in the reference)."""
    _no_gradient(x, "sequence_expand")
    reps = torch.from_numpy(_host_ints(repeat_times))
    (x,) = cast("sequence_expand", x)
    return torch.repeat_interleave(x, reps.to(x.device), dim=0,
                                   output_size=int(reps.sum()))


def sequence_concat(inputs, name=None):
    """The sequences concatenated along time."""
    return call_op(lambda *vs: torch.cat(vs, 1), *inputs,
                   op_name="sequence_concat")


def sequence_slice(x, offset, length, name=None):
    """Each sequence's steps ``[offset[b], offset[b] + length[b])`` on a
    common frame of the longest length, zero after each."""
    offs = _host_ints(offset).reshape(-1)
    lens = _host_ints(length).reshape(-1)
    T_out = int(lens.max())
    (x,) = cast("sequence_slice", x)
    B = x.shape[0]
    pos = np.arange(T_out)
    idx = np.minimum(offs[:, None] + pos[None, :], x.shape[1] - 1)
    idx = _trailing(torch.from_numpy(idx).to(x.device), x.ndim)
    out = torch.gather(x, 1, idx.expand((B, T_out) + tuple(x.shape[2:])))
    valid = _trailing(torch.from_numpy(pos[None, :] < lens[:, None]).to(
        x.device), x.ndim)
    return torch.where(valid, out, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


for _name in __all__:
    if _name != "sequence_concat":      # call_op wraps it
        globals()[_name] = eager_fn(globals()[_name])
