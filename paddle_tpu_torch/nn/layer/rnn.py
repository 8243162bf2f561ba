"""Recurrent layers (reference: ``paddle_tpu/nn/layer/rnn.py``):
``RNNCellBase``, ``SimpleRNNCell``, ``LSTMCell`` (with the reference's
LSTMP ``proj_size``), ``GRUCell``, the stacks ``SimpleRNN``/``LSTM``/
``GRU``, and ``RNN``/``BiRNN`` over any cell.

**The cells** compute the reference's step formulas written out, on
PyTorch's GEMMs and elementwise ops (one cast point each: "simple_rnn_cell",
"lstm_cell", "lstmp_cell", "gru_cell"):

- SimpleRNN: ``act(x W_ih^T + b_ih + h W_hh^T + b_hh)``, ``act`` tanh or
  relu;
- LSTM: ``z`` as above, split into the gates i, f, g, o; ``c' = sig(f) c
  + sig(i) tanh(g)``, ``h' = sig(o) tanh(c')``; with ``proj_size`` the
  emitted and recurrent state is ``h' W_proj^T`` and the cell state keeps
  ``hidden_size``;
- GRU: the gates r, z, n from ``x W_ih^T + b_ih`` and ``h W_hh^T +
  b_hh``, ``n = tanh(x_n + r (h W_hn^T + b_hn))``, ``h' = (1 - z) n + z h``.

``RNN`` and ``BiRNN`` run a cell in a Python loop over time, as the
reference's do.

**The stacks** (``_RNNBase``) run PyTorch's fused recurrence
(``torch._VF.lstm``, ``gru``, ``rnn_tanh``, ``rnn_relu``: cuDNN on the
card). The reference's recurrence is one ``lax.scan`` of plain GEMMs and
elementwise ops per layer and direction, no Pallas kernel, and the fused
recurrence computes the same formulas: PyTorch's gate orders are the
reference's (i, f, g, o; r, z, n) and its GRU applies ``r`` to ``W_hn h
+ b_hn``, as above. The call runs inside ``framework/precision.py``
``matmul_precision`` of its dtype and its outputs pass through
``backward_precision``, so an fp32 recurrence on the card is an fp32 one
forward and backward (cuDNN's default is TF32). The parameters carry the
reference's names (``weight_ih_l{k}``, ``weight_hh_l{k}``, ``bias_ih_l{k}``,
``bias_hh_l{k}``, ``_reverse`` for the second direction), which are
PyTorch's too, in the order the fused call takes them. A stack built on
the card, or moved there (``Layer.to``), lays them out as views of one
buffer, cuDNN's own layout (``torch._cudnn_rnn_flatten_weight``), so
cuDNN reads them in place; ``forward`` never lays them out again. Code
that later re-lays the parameters out, as ``optimizer.FusedFlatUpdater``
does for ``jit.TrainStep``, owns them from then on: cuDNN then copies the
weights into its layout on every call (a warning says so) and the
gradients flow back through the copy.

A call whose samples all run the whole length (no ``sequence_length``,
or every length ``T``) passes the time-major input, flattened to ``[T *
B, I]`` with ``batch_sizes`` all ``B``, to the fused recurrence's packed
form, with no sort and no gather. With shorter lengths it packs them
(``PackedSequence``, ``enforce_sorted=False``, padded back to ``T``).
The packed form is used throughout because on the card cuDNN's unpacked
form evaluates tanh and the sigmoid less exactly, 6e-6 to 1.3e-5 of the
outputs' largest magnitude from a float64 evaluation at 24 steps against
2e-7 for the packed form and for the CPU (``PERF.md``, PR 23).
``sequence_length`` is the reference's: each sample's states freeze past
its length, its padded outputs are zero, and the reverse direction starts
at its own end, as packing gives; a sample of length 0, which packing
refuses, keeps its initial states and zero outputs without running. The
lengths are read on the host.

Kept from the reference (ROADMAP Queue C "Reference caveats"):
``dropout`` is stored and never applied; the initial states are fp32
zeros whatever the input's dtype, so the operands are promoted with them
(a bf16 input gives fp32 outputs); ``RNN``/``BiRNN`` ignore
``sequence_length`` and ``**kwargs``; the ``*_attr`` arguments are taken
and not used, every parameter drawn from ``Uniform(-1/sqrt(hidden),
1/sqrt(hidden))``.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import _VF
from torch.nn.utils.rnn import (PackedSequence, pack_padded_sequence,
                                pad_packed_sequence)

from ... import tensor as T
from ...framework.autograd import call_op, link, unwrap, wrap
from ...framework.dtype import convert_dtype
from ...framework.precision import (backward_precision, matmul_precision,
                                    settings_for)
from ...framework.tensor import Tensor
from ..initializer import Uniform
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


class RNNCellBase(Layer):
    """The cells' base: ``get_initial_states`` and the state's shape."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """States of ``init_value`` (fp32 unless ``dtype``) for the batch
        of ``batch_ref``, on its device; eager ``Tensor``s when it is
        one."""
        b = batch_ref.shape[batch_dim_idx]
        shape = shape or self.state_shape
        dt = convert_dtype(dtype or "float32")
        device = unwrap(batch_ref).device

        def make(s):
            v = torch.full([b] + list(s), init_value, dtype=dt,
                           device=device)
            return wrap(v) if isinstance(batch_ref, Tensor) else v

        if isinstance(shape[0], (list, tuple)):
            return tuple(make(s) for s in shape)
        return make(shape)


def _uniform(hidden_size):
    std = 1.0 / math.sqrt(hidden_size)
    return Uniform(-std, std)


def _cell_params(layer, input_size, hidden_size, gates, recurrent_size=None):
    init = _uniform(hidden_size)
    layer.weight_ih = layer.create_parameter(
        shape=[gates * hidden_size, input_size], default_initializer=init)
    layer.weight_hh = layer.create_parameter(
        shape=[gates * hidden_size, recurrent_size or hidden_size],
        default_initializer=init)
    layer.bias_ih = layer.create_parameter(
        shape=[gates * hidden_size], is_bias=True, default_initializer=init)
    layer.bias_hh = layer.create_parameter(
        shape=[gates * hidden_size], is_bias=True, default_initializer=init)


def _promoted(*vals):
    """The operands in their common dtype, as ``jnp`` promotes them (an
    fp32 state with a bf16 input computes in fp32)."""
    dt = functools.reduce(torch.promote_types, [v.dtype for v in vals])
    return [v.to(dt) for v in vals]


def _simple_step(x, h, w_ih, w_hh, b_ih, b_hh, activation):
    x, h, w_ih, w_hh, b_ih, b_hh = _promoted(x, h, w_ih, w_hh, b_ih, b_hh)
    z = x @ w_ih.T + b_ih + h @ w_hh.T + b_hh
    return torch.tanh(z) if activation == "tanh" else torch.relu(z)


def _lstm_step(x, h, c, w_ih, w_hh, b_ih, b_hh):
    x, h, c, w_ih, w_hh, b_ih, b_hh = _promoted(x, h, c, w_ih, w_hh, b_ih,
                                                b_hh)
    z = x @ w_ih.T + b_ih + h @ w_hh.T + b_hh
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    return o * torch.tanh(c_new), c_new


def _gru_step(x, h, w_ih, w_hh, b_ih, b_hh):
    x, h, w_ih, w_hh, b_ih, b_hh = _promoted(x, h, w_ih, w_hh, b_ih, b_hh)
    xr, xz, xn = torch.chunk(x @ w_ih.T + b_ih, 3, dim=-1)
    hr, hz, hn = torch.chunk(h @ w_hh.T + b_hh, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1 - z) * n + z * h


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.activation = activation
        _cell_params(self, input_size, hidden_size, 1)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        p, act = self._parameters, self.activation
        out = call_op(lambda *v: _simple_step(*v, act), inputs, states,
                      p["weight_ih"], p["weight_hh"], p["bias_ih"],
                      p["bias_hh"], op_name="simple_rnn_cell")
        return out, out


class LSTMCell(RNNCellBase):
    """LSTM cell; ``proj_size > 0`` adds the reference's LSTMP recurrent
    projection (the module docstring)."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=0, name=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.proj_size = int(proj_size)
        _cell_params(self, input_size, hidden_size, 4,
                     recurrent_size=self.proj_size or None)
        if self.proj_size:
            self.weight_proj = self.create_parameter(
                shape=[self.proj_size, hidden_size],
                default_initializer=_uniform(hidden_size))

    @property
    def state_shape(self):
        h = self.proj_size or self.hidden_size
        return ((h,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        p = self._parameters
        weights = [p["weight_ih"], p["weight_hh"], p["bias_ih"],
                   p["bias_hh"]]
        if self.proj_size:
            def step(x, hv, cv, wi, wh, bi, bh, wp):
                h_new, c_new = _lstm_step(x, hv, cv, wi, wh, bi, bh)
                h_new, wp = _promoted(h_new, wp)
                return h_new @ wp.T, c_new

            out = call_op(step, inputs, h, c, *weights, p["weight_proj"],
                          op_name="lstmp_cell")
        else:
            out = call_op(_lstm_step, inputs, h, c, *weights,
                          op_name="lstm_cell")
        h_new, c_new = out
        return h_new, (h_new, c_new)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.hidden_size = hidden_size
        _cell_params(self, input_size, hidden_size, 3)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        p = self._parameters
        out = call_op(_gru_step, inputs, states, p["weight_ih"],
                      p["weight_hh"], p["bias_ih"], p["bias_hh"],
                      op_name="gru_cell")
        return out, out


# the fused recurrence by mode, and cuDNN's mode numbers
_FUSED = {"LSTM": _VF.lstm, "GRU": _VF.gru, "RNN_TANH": _VF.rnn_tanh,
          "RNN_RELU": _VF.rnn_relu}
_CUDNN_MODE = {"RNN_RELU": 0, "RNN_TANH": 1, "LSTM": 2, "GRU": 3}


def _full_call(kind, x, states, weights, num_layers, bidirectional,
               time_major, train):
    """The fused call over every sample's whole length: the packed form
    over the time-major input flattened to ``[T * B, I]``, ``batch_sizes``
    all ``B``; ``(out, h[, c])`` as :func:`_packed_call` gives them."""
    xt = x if time_major else x.transpose(0, 1)
    t_len, b = xt.shape[:2]
    sizes = torch.full((t_len,), b, dtype=torch.int64)
    hx = tuple(s.contiguous() for s in states)
    res = _FUSED[kind](xt.reshape(t_len * b, -1), sizes,
                       hx if kind == "LSTM" else hx[0], weights, True,
                       num_layers, 0.0, train, bidirectional)
    out = res[0].view(t_len, b, -1)
    return (out if time_major else out.transpose(0, 1), *res[1:])


def _packed_call(kind, x, states, weights, lengths, num_layers,
                 bidirectional, time_major, train):
    """The fused call over the samples of ``lengths`` (all > 0, on the
    host), padded back to ``x``'s length: ``(out, h)`` or, for the LSTM,
    ``(out, h, c)``, the states in the batch's order."""
    t_len = x.shape[0 if time_major else 1]
    packed = pack_padded_sequence(x, lengths, batch_first=not time_major,
                                  enforce_sorted=False)
    order, back = packed.sorted_indices, packed.unsorted_indices
    hx = tuple(s.index_select(1, order) for s in states)
    res = _FUSED[kind](packed.data, packed.batch_sizes,
                       hx if kind == "LSTM" else hx[0], weights, True,
                       num_layers, 0.0, train, bidirectional)
    out, _ = pad_packed_sequence(
        PackedSequence(res[0], packed.batch_sizes, order, back),
        batch_first=not time_major, total_length=t_len)
    return (out, *(s.index_select(1, back) for s in res[1:]))


def _stack_forward(kind, x, states, lengths, weights, num_layers,
                   bidirectional, time_major, hidden_size):
    """The stack on ``torch.Tensor``s: ``(out, h[, c])``, each sample's
    states frozen past its length (``lengths``, or None)."""
    dt = functools.reduce(torch.promote_types,
                          [x.dtype] + [s.dtype for s in states]
                          + [w.dtype for w in weights])
    x = x.to(dt)
    states = [s.to(dt) for s in states]
    weights = [w.to(dt) for w in weights]
    train = torch.is_grad_enabled()
    settings = settings_for(dt)
    with matmul_precision(settings):
        res = _over_lengths(kind, x, states, weights, lengths, num_layers,
                            bidirectional, time_major, train, hidden_size)
    return backward_precision(settings, *res)


def _over_lengths(kind, x, states, weights, lengths, num_layers,
                  bidirectional, time_major, train, hidden_size):
    """The fused run over ``lengths`` (every sample the whole length
    without them): :func:`_full_call` when every sample runs the whole
    length, else :func:`_packed_call` over the samples of length > 0; the
    samples of length 0 skip the call and keep their initial states and
    zero outputs."""
    b_axis = 1 if time_major else 0
    t_len = x.shape[1 - b_axis]
    if lengths is None:
        lengths = torch.full((x.shape[b_axis],), t_len)
    lens = unwrap(lengths).reshape(-1).to("cpu", torch.int64).clamp(0, t_len)
    live = torch.nonzero(lens > 0).reshape(-1)
    width = hidden_size * (2 if bidirectional else 1)
    out_shape = list(x.shape[:2]) + [width]
    if live.numel() == 0:
        return (link(x.new_zeros(out_shape), x),
                *(s.clone() for s in states))
    if bool((lens == t_len).all()):
        return _full_call(kind, x, states, weights, num_layers,
                          bidirectional, time_major, train)
    if live.numel() == lens.numel():
        return _packed_call(kind, x, states, weights, lens, num_layers,
                            bidirectional, time_major, train)
    idx = live.to(x.device)
    res = _packed_call(kind, x.index_select(b_axis, idx),
                       [s.index_select(1, idx) for s in states], weights,
                       lens[live], num_layers, bidirectional, time_major,
                       train)
    out = x.new_zeros(out_shape).index_copy(b_axis, idx, res[0])
    return (out, *(s.index_copy(1, idx, r)
                   for s, r in zip(states, res[1:])))


class _RNNBase(Layer):
    """The multi-layer, optionally bidirectional stack of
    ``SimpleRNN``/``LSTM``/``GRU`` (the module docstring)."""

    MODE = "RNN"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        if direction in ("bidirectional", "bidirect"):
            self.num_directions = 2
        elif direction == "forward":
            self.num_directions = 1
        else:
            raise ValueError(f"unknown direction {direction!r}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        gates = {"LSTM": 4, "GRU": 3, "RNN": 1}[self.MODE]
        init = _uniform(hidden_size)
        self._params = []
        for layer_i in range(num_layers):
            for d in range(self.num_directions):
                in_sz = (input_size if layer_i == 0
                         else hidden_size * self.num_directions)
                names = []
                for pname, shape, bias in (
                        ("weight_ih", [gates * hidden_size, in_sz], False),
                        ("weight_hh", [gates * hidden_size, hidden_size],
                         False),
                        ("bias_ih", [gates * hidden_size], True),
                        ("bias_hh", [gates * hidden_size], True)):
                    suffix = f"_l{layer_i}" + ("_reverse" if d else "")
                    setattr(self, pname + suffix, self.create_parameter(
                        shape=shape, is_bias=bias, default_initializer=init))
                    names.append(pname + suffix)
                self._params.append(names)
        self._flatten()

    @property
    def _kind(self):
        if self.MODE == "RNN":
            return "RNN_RELU" if self.activation == "relu" else "RNN_TANH"
        return self.MODE

    def _weights(self):
        """The parameters in the fused call's order."""
        return [self._parameters[n] for group in self._params for n in group]

    def _flatten(self):
        """Lay the parameters out as cuDNN's one buffer when they are on
        the card (the module docstring); the parameters stay the same
        objects and keep their values."""
        ws = self._weights()
        w0 = ws[0]
        if (w0.is_cuda and torch._use_cudnn_rnn_flatten_weight()
                and torch.backends.cudnn.is_acceptable(w0)
                and all(w.dtype == w0.dtype for w in ws)):
            with torch.no_grad(), torch.cuda.device_of(w0):
                torch._cudnn_rnn_flatten_weight(
                    ws, 4, self.input_size, _CUDNN_MODE[self._kind],
                    self.hidden_size, 0, self.num_layers,
                    not self.time_major, self.num_directions == 2)

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        self._flatten()
        return out

    def forward(self, inputs, initial_states=None, sequence_length=None):
        lstm = self.MODE == "LSTM"
        if initial_states is None:
            v = unwrap(inputs)
            b = v.shape[1 if self.time_major else 0]
            zeros = [torch.zeros(self.num_layers * self.num_directions, b,
                                 self.hidden_size, dtype=torch.float32,
                                 device=v.device)
                     for _ in range(2 if lstm else 1)]
            states = [wrap(z) if isinstance(inputs, Tensor) else z
                      for z in zeros]
        elif lstm:
            states = list(initial_states)
        else:
            states = [initial_states]
        n_states = len(states)
        weights = self._weights()
        kind = self._kind

        lens = None if sequence_length is None else unwrap(sequence_length)

        def fn(x, *rest):
            return _stack_forward(kind, x, rest[:n_states], lens,
                                  rest[n_states:], self.num_layers,
                                  self.num_directions == 2, self.time_major,
                                  self.hidden_size)

        out = call_op(fn, inputs, *states, *weights,
                      op_name=f"{self.MODE.lower()}_stack")
        if lstm:
            y, h, c = out
            return y, (h, c)
        y, h = out
        return y, h


class SimpleRNN(_RNNBase):
    MODE = "RNN"


class LSTM(_RNNBase):
    MODE = "LSTM"


class GRU(_RNNBase):
    MODE = "GRU"


class RNN(Layer):
    """A cell run over time in a Python loop (``sequence_length`` and
    ``**kwargs`` ignored, as in the reference)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        x = inputs if self.time_major else T.transpose(inputs, [1, 0, 2])
        steps = range(x.shape[0])
        if self.is_reverse:
            steps = reversed(steps)
        states = initial_states
        outs = []
        for t in steps:
            o, states = self.cell(x[t], states)
            outs.append(o)
        if self.is_reverse:
            outs = outs[::-1]
        y = T.stack(outs, axis=0)
        if not self.time_major:
            y = T.transpose(y, [1, 0, 2])
        return y, states


class BiRNN(Layer):
    """A forward and a backward cell, outputs concatenated."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        s_fw, s_bw = (initial_states if initial_states is not None
                      else (None, None))
        y_fw, st_fw = self.rnn_fw(inputs, s_fw, sequence_length)
        y_bw, st_bw = self.rnn_bw(inputs, s_bw, sequence_length)
        return T.concat([y_fw, y_bw], axis=-1), (st_fw, st_bw)
