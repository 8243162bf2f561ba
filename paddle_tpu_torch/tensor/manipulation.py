"""Shape and layout ops (reference: ``paddle_tpu/tensor/manipulation.py``).

``gather`` is ``index_select`` (a flattened index along ``axis``), as
there. The reference's host ops (``masked_select``, ``unique``,
``unique_consecutive``) run on the tensor's device here; their results,
like the reference's, carry no gradient. ``shuffle_batch`` draws from
the reference's random stream and waits for ``tensor/random.py``.
"""
from __future__ import annotations

import builtins

import torch

from ..framework.autograd import link
from ..framework.dtype import cast_value
from ._helpers import Tensor, convert_dtype, op, scalar_of, val, wrap

builtins_slice = builtins.slice
builtins_sum = builtins.sum


def _ints(seq):
    if isinstance(seq, Tensor):
        return [int(s) for s in seq.numpy()]
    return [int(val(s)) for s in seq]


def reshape(x, shape, name=None):
    shape = _ints(shape)
    if 0 in shape:   # 0 copies the input's dim (the reference's reshape_op)
        xs = val(x).shape
        shape = [xs[i] if s == 0 else s for i, s in enumerate(shape)]
    return op(lambda v: v.reshape(shape), x, op_name="reshape")


def reshape_(x, shape, name=None):
    x._replace_from(reshape(x, shape))
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes ``start_axis``..``stop_axis`` (inclusive) merged into one."""
    return op(lambda v: v.flatten(start_axis, stop_axis), x,
              op_name="flatten")


def transpose(x, perm, name=None):
    perm = [int(p) for p in perm]
    return op(lambda v: v.permute(perm), x, op_name="transpose")


def t(x, name=None):
    if val(x).ndim < 2:
        return x.clone()
    return op(lambda v: v.transpose(-1, -2), x, op_name="t")


def moveaxis(x, source, destination, name=None):
    return op(lambda v: torch.movedim(v, source, destination), x)


def swapaxes(x, axis0, axis1, name=None):
    return op(lambda v: torch.swapaxes(v, axis0, axis1), x)


def squeeze(x, axis=None, name=None):
    def fn(v):
        if axis is None:
            return v.squeeze()
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        axes = tuple(a + v.ndim if a < 0 else a for a in axes)
        axes = tuple(a for a in axes if v.shape[a] == 1)
        return v.squeeze(axes) if axes else v

    return op(fn, x, op_name="squeeze")


def squeeze_(x, axis=None, name=None):
    x._replace_from(squeeze(x, axis))
    return x


def unsqueeze(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = [int(val(a)) for a in axes]

    def fn(v):
        out = v
        for a in sorted(a + out.ndim + 1 if a < 0 else a for a in axes):
            out = out.unsqueeze(a)
        return out

    return op(fn, x, op_name="unsqueeze")


def unsqueeze_(x, axis, name=None):
    x._replace_from(unsqueeze(x, axis))
    return x


def _tensors(seq):
    return [t if isinstance(t, (Tensor, torch.Tensor)) else Tensor(t)
            for t in seq]


def concat(x, axis=0, name=None):
    ax = int(val(axis))
    return op(lambda *vs: torch.cat(vs, ax), *_tensors(x), op_name="concat")


def stack(x, axis=0, name=None):
    return op(lambda *vs: torch.stack(vs, axis), *_tensors(x),
              op_name="stack")


def unstack(x, axis=0, num=None, name=None):
    return list(op(lambda v: tuple(torch.unbind(v, axis)), x,
                   op_name="unstack"))


def unbind(input, axis=0, name=None):
    return unstack(input, axis=axis)


def split(x, num_or_sections, axis=0, name=None):
    ax = int(val(axis))
    total = val(x).shape[ax]
    if isinstance(num_or_sections, int):
        n = num_or_sections
        if total % n:
            raise ValueError(f"split: axis of size {total} does not divide "
                             f"into {n} equal sections")
        secs = [total // n] * n
    else:
        secs = [int(val(s)) for s in num_or_sections]
        known = builtins_sum(s for s in secs if s >= 0)
        secs = [s if s >= 0 else total - known for s in secs]
    return list(op(lambda v: tuple(torch.split(v, secs, ax)), x,
                   op_name="split"))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def tile(x, repeat_times, name=None):
    reps = _ints(repeat_times)
    return op(lambda v: torch.tile(v, reps), x, op_name="tile")


def expand(x, shape, name=None):
    shape = _ints(shape)

    def fn(v):
        tgt = list(shape)
        off = len(tgt) - v.ndim
        for i in range(len(tgt)):
            if tgt[i] == -1:
                tgt[i] = v.shape[i - off] if i >= off else 1
        return torch.broadcast_to(v, tgt)

    return op(fn, x, op_name="expand")


def expand_as(x, y, name=None):
    tgt = list(val(y).shape)
    return op(lambda v: torch.broadcast_to(v, tgt), x, op_name="expand_as")


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    return list(op(lambda *vs: tuple(torch.broadcast_tensors(*vs)), *inputs))


def flip(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return op(lambda v: torch.flip(v, list(axes)), x, op_name="flip")


def roll(x, shifts, axis=None, name=None):
    return op(lambda v: torch.roll(v, shifts, axis), x, op_name="roll")


def rot90(x, k=1, axes=(0, 1), name=None):
    return op(lambda v: torch.rot90(v, k, list(axes)), x)


def _wrapped(i, n):
    """Indices with the negative ones counted from the end, as the
    reference's take does. An index out of range raises here, where the
    reference fills (``ROADMAP.md`` Queue C, on purpose)."""
    return torch.where(i < 0, i + n, i)


def gather(x, index, axis=0, name=None):
    ax = int(val(axis))

    def fn(v, i):
        n = v.shape[ax]
        if i.ndim == 0:
            return v.select(ax, int(i) + n if int(i) < 0 else int(i))
        return torch.index_select(v, ax, _wrapped(i.reshape(-1), n))

    return op(fn, x, index, op_name="gather")


def _nd(idx):
    return tuple(idx[..., j].long() for j in range(idx.shape[-1]))


def gather_nd(x, index, name=None):
    return op(lambda v, idx: v[_nd(idx)], x, index, op_name="gather_nd")


def scatter(x, index, updates, overwrite=True, name=None):
    def fn(v, i, u):
        i = (i.reshape(-1).long(),)
        u = u.to(v.dtype)
        if overwrite:
            return v.index_put(i, u)
        base = v.index_put(i, torch.zeros_like(u))
        return base.index_put(i, u, accumulate=True)

    return op(fn, x, index, updates, op_name="scatter")


def scatter_(x, index, updates, overwrite=True, name=None):
    x._replace_from(scatter(x, index, updates, overwrite))
    return x


def scatter_nd_add(x, index, updates, name=None):
    return op(lambda v, idx, u: v.index_put(_nd(idx), u.to(v.dtype),
                                            accumulate=True),
              x, index, updates, op_name="scatter_nd_add")


def scatter_nd(index, updates, shape, name=None):
    u = val(updates)
    z = wrap(torch.zeros(_ints(shape), dtype=u.dtype, device=u.device))
    return scatter_nd_add(z, index, updates)


def index_select(x, index, axis=0, name=None):
    return op(lambda v, i: torch.index_select(
        v, axis, _wrapped(i, v.shape[axis])), x, index,
        op_name="index_select")


def index_sample(x, index, name=None):
    return op(lambda v, i: torch.gather(v, 1, i.long()), x, index,
              op_name="index_sample")


def take_along_axis(arr, indices, axis, name=None):
    return op(lambda v, i: torch.take_along_dim(v, i.long(), axis), arr,
              indices)


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    def fn(v, i, u):
        i = i.long()
        if not isinstance(u, torch.Tensor):
            u = torch.tensor(u, device=v.device)
        u = torch.broadcast_to(u, i.shape).to(v.dtype)
        if reduce == "assign":
            return v.scatter(axis, i, u)
        if reduce == "add":
            return v.scatter_add(axis, i, u)
        if reduce in ("multiply", "mul"):
            return v.scatter_reduce(axis, i, u, "prod")
        raise ValueError(f"unknown reduce {reduce}")

    return op(fn, arr, indices, values, op_name="put_along_axis")


def masked_select(x, mask, name=None):
    v, m = val(x), val(mask)
    return wrap(v.detach()[m.bool()])


def masked_fill(x, mask, value, name=None):
    f = val(value)

    def fn(a, m):
        fill = (f.detach().to(a.dtype) if isinstance(f, torch.Tensor)
                else scalar_of(f, a.dtype))
        return torch.where(m.bool(), fill, a)

    return op(fn, x, mask)


def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, Tensor):
        return op(lambda v, r: torch.repeat_interleave(v, r.long(), axis),
                  x, repeats)
    return op(lambda v: torch.repeat_interleave(v, repeats, axis), x,
              op_name="repeat_interleave")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    v = val(x).detach()
    flat = v.reshape(-1) if axis is None else v
    out, inv, cnt = torch.unique(flat, sorted=True, return_inverse=True,
                                 return_counts=True, dim=axis)
    res = [wrap(out)]
    if return_index:
        n = flat.shape[0 if axis is None else axis]
        pos = torch.arange(n, device=v.device)
        first = torch.full((cnt.shape[0],), n, dtype=pos.dtype,
                           device=v.device)
        res.append(wrap(first.scatter_reduce(0, inv, pos, "amin")))
    if return_inverse:   # numpy's: the input's shape when axis is None
        res.append(wrap(inv.reshape(v.shape) if axis is None else inv))
    if return_counts:
        res.append(wrap(cnt))
    return res[0] if len(res) == 1 else tuple(res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """Runs of equal slices along axis 0 (the flattened tensor when
    ``axis`` is None), as the reference compares them."""
    v = val(x).detach()
    arr = v.reshape(-1) if axis is None else v
    out, inv, cnt = torch.unique_consecutive(arr, return_inverse=True,
                                             return_counts=True, dim=0)
    if not (return_inverse or return_counts):
        return wrap(out)
    outs = [wrap(out)]
    if return_inverse:
        outs.append(wrap(inv))
    if return_counts:
        outs.append(wrap(cnt))
    return tuple(outs)


def _slices(v, axes, starts, ends, strides=None):
    idx = [builtins_slice(None)] * v.ndim
    for j, a in enumerate(axes):
        st = 1 if strides is None else int(val(strides[j]))
        idx[a] = builtins_slice(int(val(starts[j])), int(val(ends[j])), st)
    return idx


def slice(input, axes, starts, ends, name=None):
    return op(lambda v: v[tuple(_slices(v, axes, starts, ends))], input,
              op_name="slice")


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing per axis; a negative stride walks backwards (by an
    index gather, as PyTorch slices take positive steps only)."""
    def fn(v):
        out = v
        for a, s in enumerate(_slices(v, axes, starts, ends, strides)):
            if s.step is None or s.step == 1:
                out = out[(builtins_slice(None),) * a + (s,)]
            else:
                pos = torch.arange(*s.indices(v.shape[a]), device=v.device)
                out = out.index_select(a, pos)
        return out

    return op(fn, x, op_name="strided_slice")


def as_real(x, name=None):
    return op(lambda v: torch.stack([v.real, v.imag], -1), x)


def as_complex(x, name=None):
    return op(lambda v: torch.complex(v[..., 0], v[..., 1]), x)


def tensordot(x, y, axes=2, name=None):
    return op(lambda a, b: torch.tensordot(a, b, dims=axes), x, y)


def _atleast(fn, inputs):
    outs = [op(fn, t) for t in inputs]
    return outs if len(outs) > 1 else outs[0]


def atleast_1d(*inputs, name=None):
    return _atleast(torch.atleast_1d, inputs)


def atleast_2d(*inputs, name=None):
    return _atleast(torch.atleast_2d, inputs)


def atleast_3d(*inputs, name=None):
    return _atleast(torch.atleast_3d, inputs)


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    dt = convert_dtype(shape_or_dtype)
    return op(lambda v: v.view(dt), x)


def cast(x, dtype):
    if isinstance(x, torch.Tensor):
        return op(lambda v: cast_value(v, convert_dtype(dtype)), x,
                  op_name="cast")
    return x.astype(dtype)


def unflatten(x, axis, shape, name=None):
    """One axis split into ``shape`` (a -1 takes the rest)."""
    def fn(v):
        ax = axis % v.ndim
        return v.unflatten(ax, [int(s) for s in shape])

    return op(fn, x, op_name="unflatten")


def as_strided(x, shape, stride, offset=0, name=None):
    """The strided view of the flattened tensor, as a new tensor."""
    return op(lambda v: torch.as_strided(v.reshape(-1).contiguous(),
                                         list(shape), list(stride),
                                         offset).clone(),
              x, op_name="as_strided")


# ------------------------------------------------------ split/stack family
def tensor_split(x, num_or_indices, axis=0, name=None):
    return op(lambda v: tuple(torch.tensor_split(v, num_or_indices, axis)),
              x, op_name="tensor_split")


def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=1)


def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, axis=2)


def hstack(x, name=None):
    return op(lambda *vs: torch.hstack(vs), *x, op_name="hstack")


def vstack(x, name=None):
    return op(lambda *vs: torch.vstack(vs), *x, op_name="vstack")


def dstack(x, name=None):
    return op(lambda *vs: torch.dstack(vs), *x, op_name="dstack")


def column_stack(x, name=None):
    return op(lambda *vs: torch.column_stack(vs), *x, op_name="column_stack")


def row_stack(x, name=None):
    return vstack(x)


def crop(x, shape=None, offsets=None, name=None):
    offs = [int(o) for o in (offsets or [])]

    def fn(v):
        o2 = offs if offs else [0] * v.ndim
        shp = [int(s) if int(s) != -1 else v.shape[i] - o2[i]
               for i, s in enumerate(shape)]
        return v[tuple(builtins_slice(o, o + s) for o, s in zip(o2, shp))]

    return op(fn, x, op_name="crop")


def index_add(x, index, axis, value, name=None):
    return op(lambda v, idx, u: v.index_add(axis, idx, u.to(v.dtype)),
              x, index, value, op_name="index_add")


def index_put(x, indices, value, accumulate=False, name=None):
    def fn(v, u, *idx):
        return v.index_put(tuple(i if i.dtype == torch.bool else i.long()
                                 for i in idx),
                           u.to(v.dtype), accumulate=accumulate)

    return op(fn, x, value, *indices, op_name="index_put")


def masked_scatter(x, mask, value, name=None):
    return op(lambda v, u: v.masked_scatter(val(mask).bool(), u.to(v.dtype)),
              x, value, op_name="masked_scatter")


def reverse(x, axis, name=None):
    return flip(x, axis, name=name)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return op(lambda v: torch.diagonal(v, int(offset), int(axis1),
                                       int(axis2)),
              x, op_name="diagonal")


def multiplex(inputs, index, name=None):
    """Row i of candidate ``index[i]``."""
    seq = list(inputs)
    if len(seq) < 2:
        raise ValueError("multiplex expects at least two candidate tensors")

    def fn(idx, *cands):
        stacked = torch.stack(cands, 0)
        rows = torch.arange(stacked.shape[1], device=stacked.device)
        return stacked[idx.reshape(-1).long(), rows]

    return op(fn, index, *seq, op_name="multiplex")


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    """Class indices of one shard of a vocab-sharded label space: those in
    the shard become local offsets, the rest ``ignore_value``."""
    if shard_id < 0 or shard_id >= nshards:
        raise ValueError(
            f"shard_id {shard_id} out of range for nshards {nshards}")
    shard_size = (int(index_num) + int(nshards) - 1) // int(nshards)
    lo = int(shard_id) * shard_size

    def fn(v):
        ok = (v >= lo) & (v < lo + shard_size)
        return torch.where(ok, v - lo, scalar_of(ignore_value, v.dtype))

    return op(fn, input, op_name="shard_index")


def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    """The (offset) diagonal set to ``value``; ``wrap`` on a tall matrix
    restarts it after every ``cols`` rows."""
    off = int(offset)

    def fn(v):
        R, C = v.shape[-2], v.shape[-1]
        out = v.clone()
        if wrap and v.ndim == 2 and R > C and off == 0:
            flat = out.reshape(-1)
            flat[torch.arange(0, R * C, C + 1, device=v.device)] = value
            return flat.reshape(R, C)
        n = min(R - max(-off, 0), C - max(off, 0))
        if n <= 0:
            return out
        r = torch.arange(n, device=v.device)
        out[..., r + max(-off, 0), r + max(off, 0)] = value
        return out

    return op(fn, x, op_name="fill_diagonal")


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    x._replace_from(fill_diagonal(x, value, offset=offset, wrap=wrap))
    return x


def partial_concat(inputs, start_index=0, length=-1, name=None):
    """``concat([x[:, start:start + length] for x in inputs], axis=1)``."""
    def fn(*vals):
        return torch.cat([v[:, start_index:(v.shape[1] if length == -1
                                            else start_index + length)]
                          for v in vals], 1)

    return op(fn, *inputs, op_name="partial_concat")


def partial_sum(inputs, start_index=0, length=-1, name=None):
    """The sum of each input's column slice."""
    def fn(*vals):
        out = None
        for v in vals:
            end = v.shape[1] if length == -1 else start_index + length
            piece = v[:, start_index:end]
            out = piece if out is None else out + piece
        return out

    return op(fn, *inputs, op_name="partial_sum")


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """``y`` padded up to x's shape with ``pad_value``; ``x``, read for
    its shape, gets a zero gradient, as in the reference."""
    def fn(xv, yv):
        pads = []
        for xs, ys in reversed(list(zip(xv.shape, yv.shape))):
            pads += [0, xs - ys]
        return link(torch.nn.functional.pad(yv, pads, value=pad_value), xv)

    return op(fn, x, y, op_name="pad_constant_like")
