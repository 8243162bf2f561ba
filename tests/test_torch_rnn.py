"""The port's recurrent ``nn`` (``paddle_tpu_torch/nn/layer/rnn.py``,
``nn/decode.py``) against the JAX reference's, eager, on the CPU.

- **The RNN family**: ``SimpleRNN`` (tanh, relu), ``LSTM`` and ``GRU``
  built on both sides (the reference after ``paddle.seed(0)``, its
  weights carried by ``models/convert.py`` ``load_layer_state``), one and
  two layers, forward and bidirectional, batch-major and ``time_major``,
  with zero initial states, and with given ones and ``sequence_length``
  holding a full length and a 0 (and in three more cases lengths all
  above 0, and all full): the outputs, the final states and the
  gradients of ``sum(out * cot) + sum(states * cot')`` with respect to
  the input, the initial states and every parameter, within 1e-5 relative
  (``np.allclose``, ``rtol=1e-5, atol=1e-6``). The cells
  (``SimpleRNNCell``, ``LSTMCell`` with and without ``proj_size``,
  ``GRUCell``) and ``RNN``/``BiRNN`` over them the same way.
- **The fused stack against a loop of cells**: the port's ``LSTM``,
  ``GRU`` and ``SimpleRNN`` (PyTorch's fused recurrence) against
  ``RNN``/``BiRNN`` of the port's cells (the reference's step formulas
  written out) on the same weights, layer by layer, within 1e-5.
- **Beam search**: ``BeamSearchDecoder`` over an ``LSTMCell`` and over a
  ``GRUCell`` with an embedding and an output layer, ``dynamic_decode``
  with ``return_length``: the token ids, the lengths and the beams'
  order bit for bit, the final log-probabilities within 1e-5; the
  decode's own ``gather_tree`` over its step outputs equal to
  ``finalize``'s backtrack on both sides.
- **The reference's caveats** (``ROADMAP.md`` Queue C), each pinned on
  both sides: ``dropout`` stored and not applied; initial states fp32
  zeros whatever the input's dtype (a bf16 input gives fp32 outputs);
  ``RNN``/``BiRNN`` ignoring ``sequence_length`` and ``**kwargs``;
  ``BeamSearchDecoder.step`` dropping ``**kwargs``; ``dynamic_decode``
  ignoring ``output_time_major``, ``impute_finished`` and ``is_test``
  and stopping after 64 steps by default.
- **A PTB-shaped language model** (``chip_smoke.py`` phase 40's network,
  ``tests/torch_rnn_checks.py`` ``ptb_lm``, at vocab 50, hidden 16, 2
  layers, 4 x 5 tokens, dropout 0): 3 steps of ``SGD(1.0,
  grad_clip=ClipGradByGlobalNorm(5.0))`` with the hidden state carried
  and detached, the losses within 1e-5 relative of the reference's eager
  steps, then the parameters.

The file collects one test that runs every case
(``tests/torch_checks.py`` says why).
"""
import numpy as np
import torch

import paddle_tpu as RP
import paddle_tpu_torch as PT
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.models.convert import load_layer_state
from test_torch_nn_functional import _np, close, compare
from torch_checks import run_checks
from torch_nn_checks import flat
from torch_rnn_checks import ptb_lm

torch.set_num_threads(2)

rng = np.random.RandomState(31)
IN, H, B, T = 5, 4, 3, 6


def _arr(*shape):
    return rng.normal(size=shape).astype(np.float32)


def _state(layer):
    return {n: _np(t) for n, t in layer.state_dict().items()}


def _carried(factory):
    """``factory(S)`` on both sides, the reference's weights in the
    port's."""
    RP.seed(0)
    ref = factory(RP)
    port = factory(PT)
    load_layer_state(port, _state(ref))
    return ref, port


def _leaf(arr, S):
    t = S.to_tensor(arr)
    t.stop_gradient = False
    return t


def _run(layer, S, x, states=None, lengths=None, **kw):
    """Outputs and gradients of one call; ``states`` is a nested
    structure of arrays."""
    tx = _leaf(x, S)
    ts = None
    live = [tx]
    if states is not None:
        ts = (tuple(_leaf(a, S) for a in states)
              if isinstance(states, tuple) else _leaf(states, S))
        live += flat(ts)
    args = [tx] if ts is None and lengths is None else [tx, ts]
    if lengths is not None:
        kw["sequence_length"] = S.to_tensor(lengths)
    out = layer(*args, **kw)
    loss = None
    for k, o in enumerate(flat(out)):
        cot = np.random.RandomState(k + 1).normal(size=o.shape).astype(
            np.float32)
        term = (o * S.to_tensor(cot)).sum()
        loss = term if loss is None else loss + term
    return out, S.grad(loss, live + layer.parameters())


# ------------------------------------------------------------ the family
FAMILY = []
for _mode, _kw in (("LSTM", {}), ("GRU", {}), ("SimpleRNN", {}),
                   ("SimpleRNN", {"activation": "relu"})):
    for _extra in ({}, {"num_layers": 2, "direction": "bidirectional"},
                   {"time_major": True, "direction": "bidirect"}):
        # zero initial states without lengths; given ones with lengths
        for _lens, _init in ((None, False),
                             (np.array([6, 0, 3], np.int64), True)):
            FAMILY.append((_mode, {**_kw, **_extra}, _lens, _init))
# every length > 0 (packed, no sample left out), and every length T given
FAMILY += [("LSTM", {"num_layers": 2, "direction": "bidirectional"},
            np.array([6, 2, 3], np.int64), True),
           ("GRU", {"time_major": True}, np.array([1, 6, 4], np.int64),
            False),
           ("SimpleRNN", {"direction": "bidirectional"},
            np.array([6, 6, 6], np.int64), True)]


def check_family(k):
    mode, kw, lens, init = FAMILY[k]
    ref, port = _carried(lambda S: getattr(S.nn, mode)(IN, H, **kw))
    x = _arr(T, B, IN) if kw.get("time_major") else _arr(B, T, IN)
    states = None
    if init:
        n = kw.get("num_layers", 1) * (2 if "direction" in kw else 1)
        states = _arr(n, B, H)
        if mode == "LSTM":
            states = (states, _arr(n, B, H))
    r = _run(ref, RP, x, states, lens)
    p = _run(port, PT, x, states, lens)
    assert list(port.state_dict()) == list(ref.state_dict())
    compare(r[0], p[0], f"{mode} {kw} out")
    compare(list(r[1]), list(p[1]), f"{mode} {kw} grad")


CELLS = [("SimpleRNNCell", (IN, H), {}),
         ("SimpleRNNCell", (IN, H), {"activation": "relu"}),
         ("LSTMCell", (IN, H), {}), ("LSTMCell", (IN, H), {"proj_size": 3}),
         ("GRUCell", (IN, H), {})]


def check_cells():
    for name, args, kw in CELLS:
        ref, port = _carried(lambda S: getattr(S.nn, name)(*args, **kw))
        assert list(port.state_dict()) == list(ref.state_dict()), name
        x = _arr(B, IN)
        shape = port.state_shape
        for given in (False, True):
            states = None
            if given:
                states = (tuple(_arr(B, *s) for s in shape)
                          if isinstance(shape[0], tuple) else _arr(B, *shape))
            r = _run(ref, RP, x, states)
            p = _run(port, PT, x, states)
            compare(r[0], p[0], f"{name} {kw} out")
            compare(list(r[1]), list(p[1]), f"{name} {kw} grad")
        for S, layer in ((RP, ref), (PT, port)):
            init = layer.get_initial_states(S.to_tensor(x), init_value=0.5)
            got = [(t.shape, _np(t).dtype.name, float(_np(t).mean()))
                   for t in flat(init)]
            want = [([B] + list(s), "float32", 0.5) for s in (
                shape if isinstance(shape[0], tuple) else [shape])]
            assert got == want, (name, S.__name__, got, want)


def check_rnn_wrappers():
    x = _arr(B, T, IN)
    for name, ctor in (
            ("RNN fwd", lambda S: S.nn.RNN(S.nn.LSTMCell(IN, H))),
            ("RNN reverse", lambda S: S.nn.RNN(S.nn.GRUCell(IN, H),
                                               is_reverse=True)),
            ("RNN time_major", lambda S: S.nn.RNN(
                S.nn.SimpleRNNCell(IN, H), time_major=True)),
            ("BiRNN", lambda S: S.nn.BiRNN(S.nn.LSTMCell(IN, H),
                                           S.nn.LSTMCell(IN, H)))):
        ref, port = _carried(ctor)
        assert list(port.state_dict()) == list(ref.state_dict()), name
        r = _run(ref, RP, x)
        p = _run(port, PT, x)
        compare(r[0], p[0], f"{name} out")
        compare(list(r[1]), list(p[1]), f"{name} grad")


def _cells_of(layer, mode, li, d, in_size):
    """The port's cell of layer ``li``, direction ``d``, of a stack, with
    the stack's weights."""
    cls = {"LSTM": PT.nn.LSTMCell, "GRU": PT.nn.GRUCell,
           "SimpleRNN": PT.nn.SimpleRNNCell}[mode]
    kw = {"activation": layer.activation} if mode == "SimpleRNN" else {}
    cell = cls(in_size, H, **kw)
    suffix = f"_l{li}" + ("_reverse" if d else "")
    cell.set_state_dict({n: _np(getattr(layer, n + suffix)) for n in
                         ("weight_ih", "weight_hh", "bias_ih", "bias_hh")})
    return cell


def check_fused_against_cells():
    x = PT.to_tensor(_arr(B, T, IN))
    for mode, kw in (("LSTM", {"num_layers": 2,
                               "direction": "bidirectional"}),
                     ("GRU", {"num_layers": 2}),
                     ("SimpleRNN", {"activation": "relu",
                                    "direction": "bidirectional"})):
        PT.seed(0)
        layer = getattr(PT.nn, mode)(IN, H, **kw)
        y, states = layer(x)
        cur, finals = x, []
        D = 2 if "direction" in kw else 1
        for li in range(kw.get("num_layers", 1)):
            in_size = IN if li == 0 else H * D
            cells = [_cells_of(layer, mode, li, d, in_size)
                     for d in range(D)]
            if D == 1:
                cur, st = PT.nn.RNN(cells[0])(cur)
                finals.append(st)
            else:
                cur, (s_fw, s_bw) = PT.nn.BiRNN(*cells)(cur)
                finals += [s_fw, s_bw]
        close(_np(cur), _np(y), f"{mode} fused against cells")
        if mode == "LSTM":
            close(np.stack([_np(s[0]) for s in finals]), _np(states[0]),
                  f"{mode} h")
            close(np.stack([_np(s[1]) for s in finals]), _np(states[1]),
                  f"{mode} c")
        else:
            close(np.stack([_np(s) for s in finals]), _np(states),
                  f"{mode} h")


# ------------------------------------------------------------ beam search
V, E, K = 12, 6, 3


def _seq2seq(S, cell):
    class Dec(S.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = S.nn.Embedding(V, E)
            self.cell = (S.nn.LSTMCell(E, H) if cell == "lstm"
                         else S.nn.GRUCell(E, H))
            self.out = S.nn.Linear(H, V)

    return Dec()


def _decode(S, model, init, steps, **kw):
    dec = S.nn.BeamSearchDecoder(model.cell, start_token=0, end_token=1,
                                 beam_size=K, embedding_fn=model.emb,
                                 output_fn=model.out)
    return dec, S.nn.dynamic_decode(dec, inits=init, max_step_num=steps,
                                    return_length=True, **kw)


def _init_states(S, cell, h, c):
    return ((S.to_tensor(h), S.to_tensor(c)) if cell == "lstm"
            else S.to_tensor(h))


def check_beam_search():
    for cell in ("lstm", "gru"):
        ref, port = _carried(lambda S: _seq2seq(S, cell))
        h, c = _arr(2, H) * 2, _arr(2, H) * 2
        res = {}
        for S, model in ((RP, ref), (PT, port)):
            steps = []
            dec = S.nn.BeamSearchDecoder(model.cell, 0, 1, K, model.emb,
                                         model.out)
            inner = dec.step

            def spy(*a, _inner=inner, _steps=steps, **k):
                out = _inner(*a, **k)
                _steps.append(out[0])
                return out

            dec.step = spy
            ids, (_, logp, fin), lens = S.nn.dynamic_decode(
                dec, inits=_init_states(S, cell, h, c), max_step_num=9,
                return_length=True)
            res[S] = (ids, logp, lens, steps)
        compare(res[RP][0], res[PT][0], f"beam {cell} ids")
        compare(res[RP][2], res[PT][2], f"beam {cell} lengths")
        close(res[RP][1], res[PT][1], f"beam {cell} log-probs")
        assert len(res[PT][3]) >= 2, len(res[PT][3])
        for S in (RP, PT):
            steps = res[S][3]
            tok = np.stack([o["token"] for o in steps]).transpose(0, 1, 2)
            par = np.stack([o["parent"] for o in steps])
            traced = _np(S.nn.functional.gather_tree(S.to_tensor(tok),
                                                     S.to_tensor(par)))
            # finalize orders the beams best first
            order = np.argsort(-res[S][1], axis=1, kind="stable")
            want = np.take_along_axis(traced.transpose(1, 2, 0),
                                      order[:, :, None], axis=1)
            assert np.array_equal(want, _np(res[S][0])), S.__name__


# -------------------------------------------------------------- caveats
def check_dropout_not_applied():
    x = _arr(B, T, IN)
    outs = {}
    for S in (RP, PT):
        RP.seed(0)
        plain = S.nn.LSTM(IN, H, num_layers=2)
        RP.seed(0)
        dropped = S.nn.LSTM(IN, H, num_layers=2, dropout=0.5)
        if S is PT:
            load_layer_state(plain, _state(outs[RP][0]))
            load_layer_state(dropped, _state(outs[RP][0]))
        dropped.train()
        assert dropped.dropout == 0.5
        a, b = plain(S.to_tensor(x))[0], dropped(S.to_tensor(x))[0]
        assert np.array_equal(_np(a), _np(b)), S.__name__
        outs[S] = (plain, a)
    compare(outs[RP][1], outs[PT][1], "LSTM dropout=0.5")


def check_initial_states_fp32():
    """fp32 zero states promote a bf16 input's step to fp32, in the
    stacks and in the cells (whose operands promote as ``jnp``'s)."""
    x = _arr(B, T, IN)
    for name, ctor in (("GRU", lambda S: S.nn.GRU(IN, H)),
                       ("LSTMCell", lambda S: S.nn.LSTMCell(IN, H)),
                       ("GRUCell", lambda S: S.nn.GRUCell(IN, H))):
        ref, port = _carried(ctor)
        outs = []
        for S, layer in ((RP, ref), (PT, port)):
            xin = S.to_tensor(x if name == "GRU" else x[:, 0]).astype(
                "bfloat16")
            out = flat(layer(xin))
            assert all(_np(t).dtype.name == "float32" for t in out), (
                name, S.__name__)
            outs.append(out)
        compare(outs[0], outs[1], f"{name} on a bf16 input")


def check_rnn_ignores_lengths_and_kwargs():
    x = _arr(B, T, IN)
    lens = np.array([2, 0, 6], np.int64)
    for ctor in (lambda S: S.nn.RNN(S.nn.GRUCell(IN, H)),
                 lambda S: S.nn.BiRNN(S.nn.GRUCell(IN, H),
                                      S.nn.GRUCell(IN, H))):
        ref, port = _carried(ctor)
        outs = []
        for S, layer in ((RP, ref), (PT, port)):
            a = layer(S.to_tensor(x))
            b = layer(S.to_tensor(x), None, S.to_tensor(lens), foo=3)
            for u, v in zip(flat(a), flat(b)):
                assert np.array_equal(_np(u), _np(v)), S.__name__
            outs.append(b)
        compare(outs[0], outs[1], "RNN with sequence_length")


class _Endless:
    """A decoder that never finishes: ``dynamic_decode``'s own bound."""

    def __init__(self):
        self.steps = 0

    def initialize(self, inits):
        return np.zeros(2, np.int64), None

    def step(self, time, inputs, states, **kwargs):
        self.steps += 1
        return {"t": time}, inputs, states, np.zeros(2, bool)

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, sequence_lengths


def check_decode_caveats():
    for S in (RP, PT):
        d = _Endless()
        outs, lens = S.nn.dynamic_decode(d)
        assert d.steps == 64 and len(outs) == 64, S.__name__
        assert list(lens) == [64, 64]
        d = _Endless()
        S.nn.dynamic_decode(d, max_step_num=5, output_time_major=True,
                            impute_finished=True, is_test=True)
        assert d.steps == 5
    ref, port = _carried(lambda S: _seq2seq(S, "gru"))
    h = _arr(2, H)
    got = []
    for S, model in ((RP, ref), (PT, port)):
        _, (a, _, la) = _decode(S, model, S.to_tensor(h), 6)
        _, (b, _, lb) = _decode(S, model, S.to_tensor(h), 6, foo=1,
                                output_time_major=True)
        assert np.array_equal(_np(a), _np(b)) and np.array_equal(
            _np(la), _np(lb)), S.__name__
        assert _np(b).shape[:2] == (2, K), _np(b).shape
        got.append(b)
    compare(got[0], got[1], "decode with kwargs")


# ------------------------------------------------- a PTB-shaped language model
LM_V, LM_H, LM_L, LM_B, LM_T = 50, 16, 2, 4, 5


def check_ptb_lm_trains_as_reference():
    ref, port = _carried(lambda S: ptb_lm(S, LM_V, LM_H, LM_L, 0.0, 0.05))
    ids = np.random.RandomState(7).randint(0, LM_V, (3, LM_B, LM_T + 1))
    res = {}
    for S, model in ((RP, ref), (PT, port)):
        opt = S.optimizer.SGD(learning_rate=1.0, parameters=model.parameters(),
                              grad_clip=S.nn.ClipGradByGlobalNorm(5.0))
        loss_fn = S.nn.CrossEntropyLoss()
        z = np.zeros((LM_L, LM_B, LM_H), np.float32)
        states = (S.to_tensor(z), S.to_tensor(z))
        losses = []
        for step in range(3):
            x = S.to_tensor(ids[step, :, :-1])
            y = S.to_tensor(ids[step, :, 1:])
            logits, states = model(x, states)
            loss = loss_fn(logits.reshape([-1, LM_V]), y.reshape([-1]))
            loss.backward()
            opt.step()
            opt.clear_grad()
            states = tuple(s.detach() for s in states)
            losses.append(float(loss))
        res[S] = (losses, [_np(p) for p in model.parameters()])
    for k, (a, b) in enumerate(zip(*(res[S][0] for S in (RP, PT)))):
        assert abs(a - b) <= 1e-5 * abs(a), f"step {k}: port {b}, ref {a}"
    for a, b in zip(res[RP][1], res[PT][1]):
        close(a, b, "LM parameters after 3 steps")


def test_rnn_matches_reference(fresh_mesh):
    prev = list(port_device._CURRENT)
    PT.set_device("cpu")
    try:
        run_checks([(check_family, (k,)) for k in range(len(FAMILY))]
                   + [(f, ()) for f in (
                       check_cells, check_rnn_wrappers,
                       check_fused_against_cells, check_beam_search,
                       check_dropout_not_applied,
                       check_initial_states_fp32,
                       check_rnn_ignores_lengths_and_kwargs,
                       check_decode_caveats,
                       check_ptb_lm_trains_as_reference)])
    finally:
        port_device._CURRENT[:] = prev
