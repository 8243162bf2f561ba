"""The port's recurrent ``nn`` and the rest of ``nn``'s tail on a device
against the same calls on the CPU (no JAX: ``chip_smoke.py`` phases
39-41 run these on the card; rehearse on the CPU with
``tail_vs_cpu(torch.device("cpu"))``).

:data:`TAIL_CASES` holds, as ``tests/torch_nn_checks.py`` cases
(:func:`torch_nn_checks.nn_case_vs_cpu`: outputs by their largest
difference over their largest magnitude, gradients by ``norm_rel``,
within ``NN_RTOL``; integer outputs bit for bit; every output on the
device), the RNN family (``SimpleRNN`` tanh and relu, ``LSTM``, ``GRU``;
forward and bidirectional, batch-major and ``time_major``, with
``sequence_length`` holding a full length and a 0), the cells
(``LSTMCell`` with ``proj_size``), ``HSigmoidLoss``, every sequence op,
every fluid-era functional and ``gather_tree``, ``hsigmoid_loss``,
``margin_cross_entropy`` and ``center_loss``, at a few thousand to a few
hundred thousand elements. :func:`tail_vs_cpu` runs them and the checks
that need more than one call: ``RNN``/``BiRNN`` over cells, the
``nn.utils`` functions, ``sequence_concat``, ``class_center_sample``
(the same numpy seed on both sides, bit for bit), ``center_loss``'s
centers after their update, and beam search (:func:`beam_vs_cpu`).

:func:`beam_vs_cpu` decodes on the device and on the CPU from the same
weights and compares each row's choices step by step
(:func:`held_steps`). Until a row parts, each step's candidate totals
(running log-probability plus the step's, in float64, as
``BeamSearchDecoder.step`` forms them from each device's own inputs)
must agree within ``SCORE_RTOL`` over the best ``beam + 1`` of either
device; the two decodes may part only at a near tie, a step where two of
the CPU's best ``beam + 1`` totals lie within the spread of that step's
measured differences (only then can their order differ); and a row that
never parts must finalize the same ids. The decodes scale their logits to
``LOGIT_STD`` (:func:`logit_scale`), so near ties are rare. It returns
how many rows parted, how many (row, step) pairs held a near tie, and
:class:`DecodeTimer` splits a decode step into the device's work, the
device-to-host copy of the logits and the host's bookkeeping.
"""
import time

import numpy as np
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.framework.modules import torch_parameters
from paddle_tpu_torch.nn import decode as decode_mod
from torch_checks import norm_rel
from torch_nn_checks import (NN_RTOL, flat, fn_case, layer_case,
                             nn_case_label, nn_case_vs_cpu)

F = paddle.nn.functional
# each step's candidate totals, device against CPU, over max(1, |the
# best total|), up to the step where a row parts: float32 running scores
# over at most 35 steps from logits that differ by rounding (1e-6 of
# their size); a wrong regather moves the totals by the gaps between
# candidates, 1e-2 and more at the spreads the decodes use
SCORE_RTOL = 1e-4
# the standard deviation the decodes give their logits (a temperature,
# logit_scale): untrained weights give logits of a few hundredths, where
# many of a step's best candidates lie within rounding of each other and
# a row is held only up to its first near tie; at this spread near ties
# are rare
LOGIT_STD = 4.0

B, T, IN, H = 8, 24, 32, 64
LENS = torch.tensor([24, 0, 7, 13, 1, 24, 5, 19])     # a 0, full lengths
X = ("n", (B, T, IN))
XT = ("n", (T, B, IN))
X3 = ("n", (B, T, 16))


def _tree_edges(n_trees, n_nodes, seed):
    """``[n_trees, n_nodes - 1, 2]`` edges of random trees (node ``v``'s
    parent drawn below it), the last rows padding."""
    rs = np.random.RandomState(seed)
    out = np.zeros((n_trees, n_nodes - 1, 2), np.int64)
    for b in range(n_trees):
        size = n_nodes - b
        for v in range(2, size + 1):
            out[b, v - 2] = (rs.randint(1, v), v)
    return torch.from_numpy(out)


def _csr(b, h, L, seed):
    rs = np.random.RandomState(seed)
    counts = rs.randint(0, 6, (b, h, L))
    counts[..., 3] = 0                                 # an empty row
    offs = np.concatenate([np.zeros((b, h, 1), np.int64),
                           np.cumsum(counts, -1)], -1)
    nnz = int(offs[..., -1].max())
    cols = rs.randint(0, L, (b, h, nnz))
    return (torch.from_numpy(offs.astype(np.int32)),
            torch.from_numpy(cols.astype(np.int32)))


def _ranks(n, max_rank, seed):
    rs = np.random.RandomState(seed)
    ro = np.zeros((n, 1 + 2 * max_rank), np.int32)
    ro[:, 0] = rs.randint(0, max_rank + 1, n)
    ro[:, 1::2] = rs.randint(-1, max_rank + 1, (n, max_rank))
    ro[:, 2::2] = rs.randint(0, n, (n, max_rank))
    return torch.from_numpy(ro)


TAIL_CASES = []
for _mode, _kw in (("LSTM", {}), ("GRU", {}), ("SimpleRNN", {}),
                   ("SimpleRNN", {"activation": "relu"})):
    TAIL_CASES += [
        layer_case(_mode, (IN, H), (X,), **_kw),
        layer_case(_mode, (IN, H), (X, None, LENS), num_layers=2,
                   direction="bidirectional", **_kw),
        layer_case(_mode, (IN, H), (XT, None, LENS), time_major=True,
                   **_kw)]
TAIL_CASES += [
    layer_case("GRU", (IN, H), (XT, ("n", (2, B, H))), time_major=True,
               direction="bidirect"),
    layer_case("LSTMCell", (IN, H), (("n", (B, IN)),), proj_size=16),
    layer_case("LSTMCell", (IN, H), (("n", (B, IN)),)),
    layer_case("GRUCell", (IN, H), (("n", (B, IN)), ("n", (B, H)))),
    layer_case("SimpleRNNCell", (IN, H), (("n", (B, IN)),),
               activation="relu"),
    layer_case("HSigmoidLoss", (32, 1000), (("n", (256, 32)),
                                            ("i", (256,), 1000))),
    # the sequence ops
    fn_case("sequence_mask", LENS),
    fn_case("sequence_pad", ("n", (int(LENS.sum()), 16)), 0.5, LENS),
    fn_case("sequence_unpad", ("c", (B, T, 16)), LENS),
    fn_case("sequence_reverse", X3, LENS),
    fn_case("sequence_softmax", X3, LENS),
    fn_case("sequence_first_step", X3, LENS),
    fn_case("sequence_last_step", X3, LENS),
    fn_case("sequence_expand", ("c", (B, 16)),
            torch.tensor([2, 0, 3, 1, 1, 4, 0, 2])),
    fn_case("sequence_slice", X3, torch.tensor([0, 3, 20, 5, 0, 1, 2, 9]),
            torch.tensor([24, 0, 4, 7, 1, 10, 3, 15])),
]
TAIL_CASES += [fn_case("sequence_pool", X3, kind, LENS)
               for kind in ("sum", "average", "sqrt", "max", "min",
                            "first", "last")]
_OFFS, _COLS = _csr(2, 4, 64, 5)
TAIL_CASES += [
    # the fluid-era tail
    fn_case("temporal_shift", ("n", (16, 32, 8, 8)), 4),
    fn_case("gather_tree", ("i", (T, B, 10), 1000), ("i", (T, B, 10), 10)),
    fn_case("affine_channel", ("n", (8, 32, 16, 16)), ("n", (32,)),
            ("n", (32,))),
    fn_case("cvm", ("n", (256, 16)), ("u", (256, 2))),
    fn_case("im2sequence", ("n", (4, 8, 16, 16)), [3, 3], [2, 2], [1, 1]),
    fn_case("conv_shift", ("n", (64, 128)), ("n", (64, 9))),
    fn_case("fsp_matrix", ("n", (8, 16, 16, 16)), ("n", (8, 24, 16, 16))),
    fn_case("batch_fc", ("n", (8, 64, 32)), ("n", (8, 32, 48)),
            ("n", (8, 48))),
    fn_case("correlation", ("n", (2, 16, 24, 24)), ("n", (2, 16, 24, 24)),
            4, 3, 4, 1, 2),
    fn_case("filter_by_instag", ("n", (64, 16)),
            np.arange(64).reshape(64, 1) % 7, np.array([1, 4])),
    fn_case("inplace_abn", ("n", (8, 32, 16, 16)), torch.zeros(32),
            torch.ones(32), ("n", (32,)), ("n", (32,)),
            activation="leaky_relu"),
    fn_case("bilateral_slice", ("n", (2, 8, 32, 32)), ("u", (2, 32, 32)),
            ("n", (2, 27, 4, 8, 8)), has_offset=True),
    fn_case("tree_conv", ("n", (4, 16, 8)), _tree_edges(4, 16, 3),
            ("n", (8, 3, 4, 4)), 3),
    fn_case("rank_attention", ("n", (64, 16)), _ranks(64, 3, 4),
            ("n", (144, 32))),
    fn_case("sparse_attention", ("n", (2, 4, 64, 32)),
            ("n", (2, 4, 64, 32)), ("n", (2, 4, 64, 32)), _OFFS, _COLS),
    # the losses
    fn_case("hsigmoid_loss", ("n", (256, 32)), ("i", (256,), 1000), 1000,
            ("n", (999, 32)), ("n", (999,))),
    fn_case("margin_cross_entropy", ("u", (256, 1000)), ("i", (256,), 1000),
            return_softmax=True),
    fn_case("center_loss", ("n", (256, 32)), ("i", (256,), 100),
            ("n", (100, 32)), update_center=False),
]


def _worst(what, dev, cpu, worst):
    """Each pair within ``NN_RTOL`` (an integer pair equal): the worst
    reading into ``worst``."""
    for k, (a, b) in enumerate(zip(dev, cpu)):
        a = getattr(a, "_value", a)
        b = getattr(b, "_value", b)
        a, b = a.detach().cpu(), b.detach()
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{what} {k}: integers differ")
            continue
        e = norm_rel(a, b)
        if not e <= NN_RTOL:
            raise AssertionError(f"{what} {k}: {e:.2e}, limit {NN_RTOL}")
        worst[what] = max(worst.get(what, 0.0), e)


def _on_place(device):
    paddle.set_device("cpu" if device.type == "cpu"
                      else f"gpu:{device.index or 0}")


def _both(device, build):
    """``build()`` on the CPU and on ``device`` (the state copied),
    after ``paddle.seed(0)``."""
    paddle.set_device("cpu")
    paddle.seed(0)
    cpu = build()
    _on_place(device)
    dev = build()
    dev.set_state_dict(cpu.state_dict())
    return cpu, dev


def _grads(layer, x, out):
    outs = [v for v in (getattr(o, "_value", o) for o in flat(out))
            if v.is_floating_point()]
    loss = sum(((o * torch.from_numpy(np.random.RandomState(k).normal(
        size=tuple(o.shape)).astype(np.float32)).to(o.device)).sum()
        for k, o in enumerate(outs)))
    return outs, torch.autograd.grad(loss, [x] + torch_parameters(layer))


def _wrappers(device, worst):
    x = torch.from_numpy(np.random.RandomState(1).normal(
        size=(B, T, IN)).astype(np.float32))
    for what, build in (
            ("RNN(LSTMCell)", lambda: paddle.nn.RNN(
                paddle.nn.LSTMCell(IN, H))),
            ("RNN(GRUCell) reverse", lambda: paddle.nn.RNN(
                paddle.nn.GRUCell(IN, H), is_reverse=True)),
            ("BiRNN(SimpleRNNCell)", lambda: paddle.nn.BiRNN(
                paddle.nn.SimpleRNNCell(IN, H),
                paddle.nn.SimpleRNNCell(IN, H)))):
        cpu, dev = _both(device, build)
        runs = []
        for layer, d in ((cpu, torch.device("cpu")), (dev, device)):
            xd = x.to(d, copy=True).requires_grad_()
            runs.append(_grads(layer, xd, layer(xd)))
        _worst(what, runs[1][0], runs[0][0], worst)
        _worst(what + " grad", runs[1][1], runs[0][1], worst)


def _utils(device, worst):
    rs = np.random.RandomState(2)
    for cls, args, shape in (("Linear", (64, 48), (32, 64)),
                             ("Conv2D", (8, 16, 3), (4, 8, 12, 12))):
        x = torch.from_numpy(rs.normal(size=shape).astype(np.float32))
        for fn, kw in (("weight_norm", {}), ("weight_norm", {"dim": 1}),
                       ("spectral_norm", {"n_power_iterations": 2})):
            cpu, dev = _both(device, lambda: getattr(paddle.nn, cls)(*args))
            for layer in (cpu, dev):
                getattr(paddle.nn.utils, fn)(layer, **kw)
            for step in range(2):
                runs = []
                for layer, d in ((cpu, torch.device("cpu")), (dev, device)):
                    xd = x.to(d, copy=True).requires_grad_()
                    runs.append(_grads(layer, xd, layer(xd)))
                what = f"{fn} {kw} {cls}"
                _worst(what, runs[1][0], runs[0][0], worst)
                _worst(what + " grad", runs[1][1], runs[0][1], worst)
            if fn == "weight_norm":
                for layer in (cpu, dev):
                    paddle.nn.utils.remove_weight_norm(layer)
                _worst(f"remove_weight_norm {cls}", [dev.weight],
                       [cpu.weight], worst)
    x = rs.normal(size=(16, 64)).astype(np.float32)
    cpu, dev = _both(device, lambda: paddle.nn.Linear(64, 48))
    got = []
    for layer, d in ((cpu, torch.device("cpu")), (dev, device)):
        params = layer.parameters()
        vec = paddle.nn.utils.parameters_to_vector(params)
        paddle.nn.utils.vector_to_parameters(vec * 0.5, params)
        out = layer(paddle.to_tensor(x, place=d))
        (out * out).sum().backward()
        total = paddle.nn.utils.clip_grad_norm_(params, 0.1)
        normed = [p.grad._value.clone() for p in params]
        paddle.nn.utils.clip_grad_value_(params, 1e-3)
        got.append([vec, total, *normed, *[p.grad for p in params]])
    _worst("nn.utils vectors and clips", got[1], got[0], worst)


def _sequence_concat(device, worst):
    rs = np.random.RandomState(6)
    parts = [torch.from_numpy(rs.normal(size=(B, t, 16)).astype(np.float32))
             for t in (5, 0, 9)]
    runs = []
    for d in (torch.device("cpu"), device):
        xs = [p.to(d, copy=True).requires_grad_() for p in parts]
        out = F.sequence_concat(xs)
        cot = torch.ones_like(out).cumsum(1)
        runs.append([out, *torch.autograd.grad((out * cot).sum(), xs)])
    _worst("sequence_concat", runs[1], runs[0], worst)


def _class_center_sample(device, worst):
    lbl = torch.from_numpy(np.random.RandomState(7).randint(0, 5000, (512,)))
    runs = []
    for d in (torch.device("cpu"), device):
        np.random.seed(11)
        runs.append(F.class_center_sample(lbl.to(d), 5000, 1024))
    for t in runs[1]:
        if t.device.type != device.type:
            raise AssertionError(f"class_center_sample output on {t.device}")
    _worst("class_center_sample", runs[1], runs[0], worst)


def _center_loss(device, worst):
    rs = np.random.RandomState(8)
    x = torch.from_numpy(rs.normal(size=(256, 32)).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 100, (256,)))
    c0 = torch.from_numpy(rs.normal(size=(100, 32)).astype(np.float32))
    runs = []
    for d in (torch.device("cpu"), device):
        c = c0.to(d, copy=True)
        out = F.center_loss(x.to(d), y.to(d), c, alpha=0.2)
        runs.append([out, c])
    if torch.equal(runs[0][1], c0):
        raise AssertionError("center_loss did not update its centers")
    _worst("center_loss and its centers", runs[1], runs[0], worst)


def _seq2seq(vocab, emb, hidden):
    class Seq2Seq(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = paddle.nn.Embedding(vocab, emb)
            self.cell = paddle.nn.LSTMCell(emb, hidden)
            self.out = paddle.nn.Linear(hidden, vocab)

    return Seq2Seq()


def tail_vs_cpu(device) -> dict:
    """Every case of :data:`TAIL_CASES` and every check of more than one
    call on ``device`` against the CPU; returns the worst readings and
    the small beam search's tie count."""
    prev = list(port_device._CURRENT)
    worst = {"out": (0.0, ""), "grad": (0.0, "")}
    try:
        for case in TAIL_CASES:
            errs = nn_case_vs_cpu(device, case)
            for k, v in errs.items():
                if v > worst[k][0]:
                    worst[k] = (v, nn_case_label(case))
        more = {}
        for check in (_wrappers, _utils, _sequence_concat,
                      _class_center_sample, _center_loss):
            check(device, more)
        cpu, dev = _both(device, lambda: _seq2seq(1000, 64, 128))
        rs = np.random.RandomState(9)
        h = rs.normal(size=(4, 128)).astype(np.float32)
        c = rs.normal(size=(4, 128)).astype(np.float32)

        def init(d):
            return (paddle.to_tensor(h, place=d),
                    paddle.to_tensor(c, place=d))

        with paddle.no_grad():
            start = paddle.to_tensor(np.zeros(4, np.int64),
                                     place=torch.device("cpu"))
            first = cpu.cell(cpu.emb(start), init(torch.device("cpu")))[0]
            scale = logit_scale(cpu.out(first), LOGIT_STD)
        beam = beam_vs_cpu(
            device, cpu, dev, lambda m: m.cell, lambda m: m.emb,
            lambda m: m.out, init, beam_size=4, steps=12, scale=scale)
    finally:
        port_device._CURRENT[:] = prev
    return {"worst": worst, "more": more, "beam": beam,
            "cases": len(TAIL_CASES)}


# ------------------------------------------------------------ beam search
class DecodeTimer:
    """Times a decoder's steps on the card: the device's work (until the
    logits are ready), the device-to-host copy of the logits (until the
    host's log-softmax starts) and the host's bookkeeping (the rest of
    the step, the states' regather launched). Records each step's
    ``(log_probs, finished)`` on entry and its logits, for the tie rule."""

    def __init__(self, decoder, sync):
        self.decoder, self.sync = decoder, sync
        self.rows = []          # (device, copy, host) ms a step
        self.inputs = []        # (log_probs, finished, logits) a step
        self.outputs = []       # each step's {"token", "parent"}
        self._marks = {}

    def __enter__(self):
        dec = self.decoder
        real_out, real_step = dec.output_fn, dec.step
        real_softmax = decode_mod._log_softmax

        def output_fn(x):
            logits = real_out(x)
            self.sync()
            self._marks["device"] = time.perf_counter()
            self._last_logits = logits
            return logits

        def log_softmax(x):
            self._marks["copy"] = time.perf_counter()
            return real_softmax(x)

        def step(time_, inputs, states, **kw):
            _, log_probs, finished = states
            t0 = time.perf_counter()
            out = real_step(time_, inputs, states, **kw)
            self.sync()
            t3 = time.perf_counter()
            m = self._marks
            self.rows.append(((m["device"] - t0) * 1e3,
                              (m["copy"] - m["device"]) * 1e3,
                              (t3 - m["copy"]) * 1e3))
            logits = getattr(self._last_logits, "_value", self._last_logits)
            self.inputs.append((log_probs.copy(), finished.copy(),
                                logits.detach().cpu().numpy()))
            self.outputs.append(out[0])
            return out

        dec.output_fn, dec.step = output_fn, step
        decode_mod._log_softmax = log_softmax
        self._restore = (real_out, real_step, real_softmax)
        return self

    def __exit__(self, *exc):
        dec = self.decoder
        dec.output_fn, dec.step, decode_mod._log_softmax = self._restore
        return False


def _totals(log_probs, finished, logits, end_token) -> np.ndarray:
    """``[b, beam * V]``: a step's float64 candidate totals, as
    ``BeamSearchDecoder.step`` forms them from these inputs."""
    b, K = log_probs.shape
    logp = decode_mod._log_softmax(np.asarray(logits, np.float64))
    V = logp.shape[-1]
    logp = logp.reshape(b, K, V)
    fin_mask = np.full((V,), -1e9)
    fin_mask[end_token] = 0.0
    logp = np.where(finished[:, :, None], fin_mask[None, None, :], logp)
    return (log_probs[:, :, None] + logp).reshape(b, K * V)


def held_steps(cpu_inputs, dev_inputs, split, end_token):
    """Each row's steps up to the one where it parts (``split``), from
    both devices' recorded inputs: ``(ties, worst)``. Over the best
    ``beam + 1`` totals of either device, ``d`` is each total's
    difference, device less CPU; two candidates can change order only
    when their gap is at most ``max(d) - min(d)``. ``ties[b, t]``: two
    of the CPU's best ``beam + 1`` totals lie that close; ``worst``: the
    largest ``|d|`` over ``max(1, |the best total|)``."""
    steps = min(len(cpu_inputs), len(dev_inputs))
    b, K = cpu_inputs[0][0].shape
    ties = np.zeros((b, steps), bool)
    worst = 0.0
    for t in range(steps):
        tc = _totals(*cpu_inputs[t], end_token)
        td = _totals(*dev_inputs[t], end_token)
        top_c = np.argpartition(-tc, K, axis=1)[:, :K + 1]
        top_d = np.argpartition(-td, K, axis=1)[:, :K + 1]
        for r in range(b):
            if split[r] is not None and t > split[r]:
                continue
            cand = np.union1d(top_c[r], top_d[r])
            d = td[r, cand] - tc[r, cand]
            best = -np.sort(-tc[r, top_c[r]])
            worst = max(worst, float(np.abs(d).max()) / max(1.0,
                                                            abs(best[0])))
            ties[r, t] = bool((-np.diff(best) <= d.max() - d.min()).any())
    return ties, worst


def logit_scale(logits, std) -> float:
    """The factor that gives ``logits`` (a CPU tensor) the standard
    deviation ``std``: a decode over logits this peaked has few near
    ties, so its rows are held to the end."""
    v = getattr(logits, "_value", logits).detach().double()
    return float(std / v.std())


def beam_vs_cpu(device, cpu_model, dev_model, cell, emb, out, init,
                beam_size, steps, scale, start_token=0, end_token=1) -> dict:
    """Beam search of the same model on the CPU and on ``device`` (the
    module docstring): ``cell``, ``emb``, ``out`` pick the decoder's
    parts off a model, ``init(device)`` makes the initial states, and the
    logits are ``out``'s times ``scale``. Returns the token ids'
    agreement, the tie count, the candidate totals' largest difference
    and the device's step times."""
    runs = []
    for d, model in ((torch.device("cpu"), cpu_model), (device, dev_model)):
        dec = paddle.nn.BeamSearchDecoder(
            cell(model), start_token, end_token, beam_size,
            embedding_fn=emb(model),
            output_fn=lambda x, head=out(model): head(x) * scale)
        sync = (torch.cuda.synchronize if d.type == "cuda"
                else (lambda: None))
        with paddle.no_grad(), DecodeTimer(dec, sync) as timer:
            ids, (_, logp, _), lens = paddle.nn.dynamic_decode(
                dec, inits=init(d), max_step_num=steps, return_length=True)
        runs.append((ids.numpy(), logp, lens.numpy(), timer))
        if ids._value.device.type != d.type:
            raise AssertionError(f"decoded ids on {ids._value.device}")
    cpu, dev = runs
    split = _first_split(cpu[3].outputs, dev[3].outputs)
    ties, score = held_steps(cpu[3].inputs, dev[3].inputs, split,
                             end_token)
    same = (cpu[0] == dev[0]).all(axis=(1, 2))
    # a row may part only at a step that held a near tie; until
    # then the two chose the same beams, and a row that never parts
    # decodes the same ids
    bad = [b for b, t in enumerate(split)
           if (t is None and not same[b])
           or (t is not None and not (t < ties.shape[1] and ties[b, t]))]
    if score > SCORE_RTOL:
        raise AssertionError(f"beam search: the candidates' totals differ "
                             f"by {score:.2e} of their size on {device} "
                             f"before their rows part (limit {SCORE_RTOL})")
    if bad:
        raise AssertionError(f"beam search: rows {bad} decode other ids on "
                             f"{device} with no near tie where they part "
                             f"(at steps {[split[b] for b in bad]})")
    rows = np.asarray(dev[3].rows)
    return {"rows": int(same.size), "rows_equal": int(same.sum()),
            "rows_parted_at_ties": sum(t is not None for t in split),
            "tie_steps": int(ties.sum()), "steps": len(dev[3].rows),
            "steps_held": sum(len(dev[3].rows) if t is None else t + 1
                              for t in split),
            "score_err": score, "scale": scale,
            "step_ms": rows.sum(1).tolist(), "split_ms": rows.tolist(),
            "lengths_equal": bool(np.array_equal(cpu[2], dev[2]))}


def _first_split(cpu_steps, dev_steps) -> list:
    """Each row's first step at which the two decodes chose other
    (token, parent) pairs, or None."""
    out = []
    for b in range(cpu_steps[0]["token"].shape[0]):
        split = None
        for t in range(max(len(cpu_steps), len(dev_steps))):
            if t >= min(len(cpu_steps), len(dev_steps)) or any(
                    not np.array_equal(cpu_steps[t][k][b], dev_steps[t][k][b])
                    for k in ("token", "parent")):
                split = t
                break
        out.append(split)
    return out


# ------------------------------------------------ the PTB language model
def ptb_lm(paddle_pkg, vocab, hidden, layers, dropout, init_scale):
    """The PTB word-level LSTM language model as a user writes it on the
    Paddle API of ``paddle_pkg`` (Zaremba et al. 2014, as PaddleNLP's
    ``examples/language_model/rnnlm`` builds it): embedding, dropout, a
    ``layers``-deep ``nn.LSTM`` (its ``dropout`` stored, not applied),
    dropout, the output layer; every parameter drawn from
    ``Uniform(-init_scale, init_scale)``. ``forward(ids, states)``
    returns the logits and the final states."""
    nn = paddle_pkg.nn

    class PTBLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(vocab, hidden)
            self.drop1 = nn.Dropout(dropout)
            self.lstm = nn.LSTM(hidden, hidden, num_layers=layers,
                                dropout=dropout)
            self.drop2 = nn.Dropout(dropout)
            self.fc = nn.Linear(hidden, vocab)
            init = nn.initializer.Uniform(-init_scale, init_scale)
            for p in self.parameters():
                init(p)

        def forward(self, ids, states=None):
            y, states = self.lstm(self.drop1(self.embedding(ids)), states)
            return self.fc(self.drop2(y)), states

    return PTBLM()
