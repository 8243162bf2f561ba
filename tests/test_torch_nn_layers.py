"""The port's ``nn`` layers (``paddle_tpu_torch/nn/layer``) against the
JAX reference's (``paddle_tpu.nn``), eager, on the CPU.

- **Every layer** of the activation, common, container, loss, norm and
  pooling modules, built on both sides (the reference after
  ``paddle.seed(0)``, its parameters and buffers carried into the port's
  by ``models/convert.py`` ``load_layer_state``), run on the same numpy
  inputs from ``RandomState``: the outputs, then the gradients of
  ``sum(out * cot)`` with respect to the floating inputs and the
  parameters through ``paddle.grad`` on both sides, within 1e-5
  relative (``np.allclose``, ``rtol=1e-5, atol=1e-6``). The dropout
  layers run at inference and at rate 0 here; their draws are held by
  property in ``tests/test_torch_nn_functional.py``.
- **The containers**: ``LayerList``, ``ParameterList``, ``LayerDict``
  (and ``Sequential``) give the reference's ``state_dict`` names
  (``"0.weight"``, ...) and iteration order, through ``append``,
  ``insert``, ``extend``, ``__setitem__``, ``pop`` and ``update``.
- **``SyncBatchNorm.convert_sync_batchnorm``**: every batch norm of a
  tree swapped, weights and statistics kept, the forward the
  reference's.
- **Signatures**: every name that both packages export from ``nn`` and
  ``nn.functional`` takes the reference's parameters, by the same names,
  kinds and defaults and in the same order (through ``eager_fn``'s
  ``__wrapped__``); the port may add only trailing keyword-only
  parameters of its own (``device``, ``rs``). ``name=`` is taken
  everywhere the reference takes it.
- **The names still missing** from the port's ``nn`` and
  ``nn.functional`` equal the backticked names of ``ROADMAP.md``'s
  paragraph "Names of nn and nn.functional not ported" (Queue A 4c-2).
- **BERT with dropout**: ``bert-test`` from the reference's weights
  (``tests/test_torch_bert_train.py``'s ``_carried`` and batch, 2 x 64),
  AdamW, 3 ``TrainStep`` steps: at dropout 0 the losses within 1e-5
  relative of the reference's ``TrainStep`` (that file's fp32
  tolerance); with dropout 0.1 in the embeddings, the attention
  probabilities and the encoder layers the step runs, its losses are
  finite, repeat after ``paddle.seed`` and differ with another seed and
  from the dropout-free step.

The file collects one test that runs every case
(``tests/torch_checks.py`` says why).
"""
import inspect
import os
import re
import types

import numpy as np
import pytest
import torch

import paddle_tpu as RP
import paddle_tpu_torch as PT
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.framework.dtype import dtype_name
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.bert import BertForPretraining, bert_presets
from paddle_tpu_torch.models.convert import load_layer_state
from paddle_tpu_torch.optimizer import AdamW
from test_torch_bert_train import LR as BERT_LR
from test_torch_bert_train import RTOL as BERT_RTOL
from test_torch_bert_train import (_batch, _carried, _jax_loss, _jt,
                                   _port_loss)
from torch_checks import run_checks

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
ROADMAP = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "ROADMAP.md")
rng = np.random.RandomState(0)


class A:
    """A tensor argument: the same numpy array on both sides."""

    def __init__(self, arr, grad=None):
        self.arr = np.asarray(arr)
        self.grad = grad if grad is not None else self.arr.dtype.kind == "f"


def _n(*shape):
    return A(rng.normal(size=shape).astype(np.float32))


def _u(lo, hi, *shape):
    return A(rng.uniform(lo, hi, shape).astype(np.float32))


def _ties(*shape):
    return A(rng.randint(-2, 3, shape).astype(np.float32))


def _np(t):
    return np.asarray(t.numpy())


def _dt(t):
    if isinstance(t, RP.Tensor):
        return np.dtype(t.dtype).name
    return dtype_name(t.dtype)


def close(r, p, what):
    r, p = np.asarray(r), np.asarray(p)
    if r.shape != p.shape:
        raise AssertionError(f"{what}: shape {p.shape} != {r.shape}")
    if r.dtype.kind in "biu":
        assert np.array_equal(r, p), f"{what}: {p} != {r}"
        return
    if not np.allclose(p.astype(np.float64), r.astype(np.float64),
                       rtol=RTOL, atol=ATOL, equal_nan=True):
        err = np.nanmax(np.abs(p.astype(np.float64) - r))
        raise AssertionError(f"{what}: max diff {err:.3e}\nport {p}\n"
                             f"reference {r}")


def compare(r, p, what):
    if isinstance(r, (tuple, list)):
        assert isinstance(p, (tuple, list)) and len(p) == len(r), what
        for k, (a, b) in enumerate(zip(r, p)):
            compare(a, b, f"{what}[{k}]")
        return
    assert isinstance(p, PT.Tensor), f"{what}: {type(p).__name__}"
    assert _dt(r) == _dt(p), f"{what}: dtype {_dt(p)} != {_dt(r)}"
    close(_np(r), _np(p), what)


def _state(layer):
    return {n: np.asarray(t.numpy()) for n, t in layer.state_dict().items()}


def _side_value(v, S):
    if isinstance(v, A):
        t = S.to_tensor(v.arr)
        if v.grad:
            t.stop_gradient = False
        return t
    return v


def L(cls, *args, inputs=(), train=False, **kw):
    return dict(cls=cls, args=args, kw=kw, inputs=inputs, train=train)


def _floats(out):
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return [o for o in outs if "float" in _dt(o)]


def _run(c, S, ref=None):
    args = [_side_value(a, S) for a in c["args"]]
    kw = {k: _side_value(v, S) for k, v in c["kw"].items()}
    if S is RP:
        RP.seed(0)
    layer = getattr(S.nn, c["cls"])(*args, **kw)
    if ref is not None:
        load_layer_state(layer, _state(ref))
    layer.train() if c["train"] else layer.eval()
    xs = [_side_value(a, S) for a in c["inputs"]]
    out = layer(*xs)
    live = [t for t in xs if isinstance(t, (RP.Tensor, PT.Tensor))
            and not t.stop_gradient]
    live += [p for p in layer.parameters() if not p.stop_gradient]
    loss = None
    for k, o in enumerate(_floats(out)):
        cot = np.random.RandomState(k + 1).normal(size=o.shape).astype(
            np.float32)
        term = (o * S.to_tensor(cot)).sum()
        loss = term if loss is None else loss + term
    grads = S.grad(loss, live) if live else []
    return layer, out, grads


def check_layer(cls, k):
    c = LAYERS[k]
    ref, r_out, r_grads = _run(c, RP)
    port, p_out, p_grads = _run(c, PT, ref)
    assert list(port.state_dict()) == list(ref.state_dict()), cls
    compare(r_out, p_out, "out")
    compare(list(r_grads), list(p_grads), "grad")


# ------------------------------------------------------------------ layers
KINK = A(np.array([[0.0, -0.0, 0.5, -0.5, 1.0, -1.0, 3.0, -3.0],
                   [6.0, 20.0, 25.0, -25.0, 0.25, -0.7, 2.2, -1.6]],
                  np.float32))
X = _n(2, 3, 6, 6)
X1 = _n(2, 3, 10)
X3 = _n(1, 3, 4, 6, 4)

LAYERS = [L(n, inputs=(KINK,)) for n in (
    "ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "LeakyReLU", "ELU", "SELU",
    "CELU", "Silu", "Swish", "Mish", "Hardswish", "Hardsigmoid", "Hardtanh",
    "Hardshrink", "Softshrink", "Tanhshrink", "Softplus", "Softsign",
    "LogSigmoid", "ThresholdedReLU", "Softmax", "LogSoftmax")]
LAYERS += [
    L("GELU", True, inputs=(KINK,)), L("LeakyReLU", 0.2, inputs=(KINK,)),
    L("ELU", 0.5, inputs=(KINK,)), L("CELU", alpha=2.0, inputs=(KINK,)),
    L("Hardtanh", -0.5, 2.0, inputs=(KINK,)),
    L("Hardshrink", 1.0, inputs=(KINK,)),
    L("Softplus", 2.0, 10.0, inputs=(KINK,)),
    L("ThresholdedReLU", threshold=0.25, inputs=(KINK,)),
    L("Softmax", 0, inputs=(KINK,)), L("LogSoftmax", axis=0, inputs=(KINK,)),
    L("Maxout", 3, inputs=(_n(2, 6, 3, 3),)),
    L("Maxout", 2, -1, inputs=(_ties(2, 3, 3, 4),)),
    L("ReLU", name="r", inputs=(KINK,)),
    L("PReLU", inputs=(X,)), L("PReLU", 3, 0.1, inputs=(X,)),
    L("PReLU", 3, data_format="NHWC", inputs=(_n(2, 4, 4, 3),)),
    # common
    L("Identity", 3, foo=1, inputs=(X,)),
    L("Dropout", 0.5, inputs=(X,)), L("Dropout", 0.0, train=True,
                                      inputs=(X,)),
    L("Dropout", 0.3, mode="downscale_in_infer", name="d", inputs=(X,)),
    L("Dropout2D", 0.5, inputs=(X,)), L("Dropout3D", 0.5, inputs=(X3,)),
    L("AlphaDropout", 0.5, inputs=(X,)),
    L("Upsample", scale_factor=1.7, mode="bilinear", inputs=(X,)),
    L("Upsample", size=[4, 9], inputs=(X,)),
    L("Upsample", scale_factor=0.7, mode="bicubic", inputs=(X,)),
    L("UpsamplingBilinear2D", scale_factor=2, inputs=(X,)),
    L("UpsamplingNearest2D", size=[5, 7], inputs=(X,)),
    L("Pad1D", [2, 1], mode="reflect", inputs=(X1,)),
    L("Pad2D", [1, 2, 0, 1], mode="replicate", inputs=(X,)),
    L("Pad3D", [1, 0, 2, 1, 0, 1], value=0.5, inputs=(X3,)),
    L("ZeroPad2D", [1, 0, 2, 1], inputs=(X,)),
    L("CosineSimilarity", inputs=(X, _n(2, 3, 6, 6))),
    L("PairwiseDistance", 1.5, keepdim=True, inputs=(_n(4, 5), _n(4, 5))),
    L("Bilinear", 5, 3, 4, inputs=(_n(6, 5), _n(6, 3))),
    L("PixelShuffle", 2, inputs=(_n(2, 8, 3, 3),)),
    L("PixelUnshuffle", 2, inputs=(X,)),
    L("ChannelShuffle", 3, inputs=(_n(2, 6, 3, 3),)),
    L("Unfold", 3, paddings=1, inputs=(X,)),
    L("Fold", [6, 6], 2, 2, inputs=(_n(2, 12, 9),)),
    # losses
    L("CrossEntropyLoss", inputs=(_n(6, 5), A(rng.randint(0, 5, 6)))),
    L("CrossEntropyLoss", A(rng.uniform(0.5, 2, 5).astype(np.float32),
                            grad=False), ignore_index=1,
      reduction="sum", inputs=(_n(6, 5), A(rng.randint(0, 5, 6)))),
    L("CrossEntropyLoss", soft_label=True, label_smoothing=0.1,
      inputs=(_n(6, 5), _u(0, 1, 6, 5))),
    L("MSELoss", inputs=(_n(4, 5), _n(4, 5))),
    L("L1Loss", "sum", inputs=(_n(4, 5), _n(4, 5))),
    L("NLLLoss", inputs=(_n(6, 5), A(rng.randint(0, 5, 6)))),
    L("SmoothL1Loss", delta=0.5, inputs=(_n(4, 5), _n(4, 5))),
    L("KLDivLoss", "batchmean", inputs=(_n(4, 5), _u(0, 1, 4, 5))),
    L("MarginRankingLoss", 0.2, inputs=(_n(6), _n(6), A(np.sign(
        rng.normal(size=6)).astype(np.float32)))),
    L("HingeEmbeddingLoss", inputs=(_n(6), A(np.sign(
        rng.normal(size=6)).astype(np.float32)))),
    L("CosineEmbeddingLoss", 0.1, inputs=(_n(5, 4), _n(5, 4), A(np.sign(
        rng.normal(size=5)).astype(np.float32)))),
    L("TripletMarginLoss", swap=True, inputs=(_n(5, 4), _n(5, 4),
                                              _n(5, 4))),
    L("SoftMarginLoss", inputs=(_n(4, 5), A(np.sign(
        rng.normal(size=(4, 5))).astype(np.float32)))),
    L("PoissonNLLLoss", full=True, inputs=(_n(4, 5), _u(0, 4, 4, 5))),
    L("GaussianNLLLoss", full=True, inputs=(_n(4, 5), _n(4, 5),
                                            _u(0.1, 2, 4, 5))),
    L("MultiMarginLoss", 2, 0.5, inputs=(_n(6, 5),
                                         A(rng.randint(0, 5, 6)))),
    L("CTCLoss", inputs=(_n(5, 2, 4), A(np.array([[1, 2], [3, 3]],
                                                 np.int32)),
                         A(np.array([5, 4], np.int32)),
                         A(np.array([2, 2], np.int32)))),
    L("BCELoss", inputs=(_u(0.05, 0.95, 4, 3), _u(0, 1, 4, 3))),
    L("BCEWithLogitsLoss", inputs=(_n(4, 3), _u(0, 1, 4, 3))),
    L("AdaptiveLogSoftmaxWithLoss", 8, 20, [5, 12], head_bias=True,
      inputs=(_n(6, 8), A(np.array([0, 4, 5, 11, 12, 19], np.int64)))),
    L("AdaptiveLogSoftmaxWithLoss", 8, 20, [6], 2.0,
      inputs=(_n(6, 8), A(np.array([1, 7, 3, 19, 6, 0], np.int64)))),
    # norms
    L("GroupNorm", 2, 4, inputs=(_n(2, 4, 3, 3),)),
    L("GroupNorm", 3, 6, weight_attr=False, bias_attr=False,
      inputs=(_n(2, 6, 4),)),
    L("InstanceNorm1D", 3, inputs=(X1,)),
    L("InstanceNorm2D", 3, 1e-3, inputs=(X,)),
    L("InstanceNorm3D", 3, weight_attr=False, inputs=(X3,)),
    L("LocalResponseNorm", 3, inputs=(X,)),
    L("SyncBatchNorm", 3, train=True, inputs=(X,)),
    L("SyncBatchNorm", 3, inputs=(X,)),
    # pools
    L("MaxPool1D", 3, 2, 1, inputs=(_ties(2, 3, 11),)),
    L("MaxPool2D", 3, 2, 1, inputs=(_ties(2, 3, 7, 7),)),
    L("MaxPool3D", 2, inputs=(X3,)),
    L("AvgPool1D", 3, 2, 1, inputs=(X1,)),
    L("AvgPool2D", 3, 2, 1, inputs=(X,)),
    L("AvgPool3D", 2, 1, inputs=(X3,)),
    L("AdaptiveAvgPool1D", 4, inputs=(X1,)),
    L("AdaptiveAvgPool2D", (4, 5), inputs=(X,)),
    L("AdaptiveAvgPool3D", 2, inputs=(X3,)),
    L("AdaptiveMaxPool1D", 4, inputs=(_ties(2, 3, 10),)),
    L("AdaptiveMaxPool2D", 3, inputs=(_ties(2, 3, 6, 6),)),
    L("AdaptiveMaxPool3D", (1, 2, 2), inputs=(X3,)),
]


def _unpool_case(nd, shape):
    """The unpool layer on a max pool's values and mask (the port's pool
    on torch tensors: nothing of JAX at import)."""
    v, m = getattr(PT.nn.functional, f"max_pool{nd}d")(
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)), 2,
        return_mask=True)
    return L(f"MaxUnPool{nd}D", 2, inputs=(A(v.numpy()),
                                           A(m.numpy(), grad=False)))


LAYERS += [_unpool_case(1, (2, 3, 8)), _unpool_case(2, (2, 3, 6, 8)),
           _unpool_case(3, (1, 2, 4, 6, 4))]


# -------------------------------------------------------------- containers
def check_containers_match_reference():
    for S in (RP, PT):
        S.seed(0)
    built = {}
    for S in (RP, PT):
        nn = S.nn
        ll = nn.LayerList([nn.Linear(3, 4), nn.ReLU()])
        ll.append(nn.Linear(4, 2))
        ll.insert(1, nn.LayerNorm(4))
        ll.extend([nn.Tanh()])
        ll[4] = nn.Sigmoid()
        pl = nn.ParameterList([S.create_parameter([2, 3], "float32")])
        pl.append(S.create_parameter([3], "float32", is_bias=True))
        ld = nn.LayerDict({"a": nn.Linear(2, 2)})
        ld["b"] = nn.Linear(2, 3)
        ld.update([("c", nn.Linear(3, 1))])
        popped = ld.pop("a")

        class Net(nn.Layer):
            def __init__(self, S=S):
                super().__init__()
                self.S = S
                self.ll, self.pl, self.ld = ll, pl, ld
                self.seq = nn.Sequential(("first", nn.Linear(2, 2)),
                                         ("second", nn.ReLU()))

            def forward(self, x):
                for layer in self.ll:
                    x = layer(x)
                x = self.S.matmul(self.seq(x), self.pl[0]) + self.pl[1]
                for k in self.ld:
                    x = x if k != "b" else self.ld[k](x[:, :2])
                return x

        built[S] = (Net(), [type(m).__name__ for m in ll],
                    list(ld.keys()), len(pl), type(popped).__name__,
                    "b" in ld, len(ll[1:3]))
    ref, port = built[RP][0], built[PT][0]
    assert built[RP][1:] == built[PT][1:], (built[RP][1:], built[PT][1:])
    assert list(port.state_dict()) == list(ref.state_dict()), (
        list(port.state_dict()), list(ref.state_dict()))
    assert "ll.0.weight" in ref.state_dict() and "pl.1" in ref.state_dict()
    load_layer_state(port, _state(ref))
    x = rng.normal(size=(4, 3)).astype(np.float32)
    compare(ref(RP.to_tensor(x)), port(PT.to_tensor(x)), "container net")
    assert [n for n, _ in port.named_parameters()] == [
        n for n, _ in ref.named_parameters()]


def check_convert_sync_batchnorm():
    nets = {}
    for S in (RP, PT):
        S.seed(0)
        nn = S.nn
        nets[S] = nn.Sequential(nn.Conv2D(3, 4, 3), nn.BatchNorm2D(4),
                                nn.Sequential(nn.BatchNorm2D(4), nn.ReLU()))
    load_layer_state(nets[PT], _state(nets[RP]))
    with torch.no_grad():
        nets[PT][1]._buffers["_mean"].fill_(0.25)
    nets[RP][1]._mean.set_value(np.full(4, 0.25, np.float32))
    outs = []
    for S in (RP, PT):
        before = _state(nets[S])
        conv = S.nn.SyncBatchNorm.convert_sync_batchnorm(nets[S])
        assert type(conv[1]).__name__ == "SyncBatchNorm"
        assert type(conv[2][0]).__name__ == "SyncBatchNorm"
        after = _state(conv)
        assert list(after) == list(before)
        for n in before:
            assert np.array_equal(after[n], before[n]), (S.__name__, n)
        conv.eval()
        x = np.random.RandomState(9).normal(size=(2, 3, 6, 6)).astype(
            np.float32)
        outs.append(conv(S.to_tensor(x)))
    compare(outs[0], outs[1], "converted forward")


def check_spectral_norm_raises():
    for S in (RP, PT):
        with pytest.raises(NotImplementedError):
            S.nn.SpectralNorm([4, 3])


# -------------------------------------------------------------- signatures
def _params(obj):
    fn = getattr(obj, "__wrapped__", obj)
    return list(inspect.signature(fn).parameters.values())


def _same_default(a, b) -> bool:
    if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
        return a is b
    try:
        return bool(a == b) and type(a) is type(b)
    except Exception:
        return a is b


def check_signatures_match_reference():
    bad = []
    for rmod, pmod in ((RP.nn, PT.nn),
                       (RP.nn.functional, PT.nn.functional)):
        for name in sorted(n for n in dir(pmod) if not n.startswith("_")):
            r, p = getattr(rmod, name, None), getattr(pmod, name)
            if r is None or not callable(p) or isinstance(
                    p, types.ModuleType):
                continue
            try:
                rp, pp = _params(r), _params(p)
            except (TypeError, ValueError):
                continue
            head, extra = pp[:len(rp)], pp[len(rp):]
            same = all(a.name == b.name and a.kind == b.kind
                       and _same_default(a.default, b.default)
                       for a, b in zip(rp, head)) and len(head) == len(rp)
            if not same or any(e.kind is not inspect.Parameter.KEYWORD_ONLY
                               for e in extra):
                bad.append(f"{rmod.__name__}.{name}: port "
                           f"{[str(x) for x in pp]}, reference "
                           f"{[str(x) for x in rp]}")
    assert not bad, "\n".join(bad)


def check_name_taken():
    x = PT.to_tensor(np.ones((2, 3), np.float32))
    F = PT.nn.functional
    F.relu(x, name="r")
    F.linear(x, PT.to_tensor(np.ones((3, 2), np.float32)), name="l")
    layer = PT.nn.Dropout(0.5, name="d")
    layer.train()
    assert layer(x).shape == [2, 3]


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and n != "annotations"}


def check_missing_names_match_roadmap():
    missing = sorted((_public(RP.nn) - _public(PT.nn))
                     | (_public(RP.nn.functional)
                        - _public(PT.nn.functional)))
    text = open(ROADMAP).read()
    m = re.search(r"Names of nn and nn\.functional not ported:(.*?)\n\n",
                  text, re.S)
    assert m, "ROADMAP.md has no 'Names of nn and nn.functional not " \
              "ported:' paragraph"
    listed = sorted(re.findall(r"`([A-Za-z_0-9]+)`", m.group(1)))
    assert missing == listed, (f"port lacks {missing}; ROADMAP lists "
                               f"{listed}")


# ------------------------------------------------------------ BERT dropout
def _bert_steps(state, batch, dropout, seed=0, steps=3):
    """The port's ``bert-test`` from ``state`` (the reference's weights),
    dropout ``dropout`` in the embeddings, the attention probabilities
    and the encoder layers: ``steps`` ``TrainStep`` steps after
    ``PT.seed(seed)``, AdamW, the losses."""
    cfg = bert_presets("bert-test", dropout=dropout, attn_dropout=dropout)
    PT.seed(seed)
    tm = BertForPretraining(cfg, seed=0, device="cpu")
    tm.load_state_dict(state)
    tm.train()
    ids, mlm, nsp = batch
    step = TrainStep(tm, _port_loss,
                     AdamW(learning_rate=BERT_LR, parameters=tm.parameters()))
    return [float(step(inputs=(ids, None, None, None, mlm), labels=(nsp,)))
            for _ in range(steps)]


def check_bert_trains_with_dropout():
    jm, tm = _carried()
    state = tm.state_dict()      # tm is never stepped
    batch = _batch()
    ids, mlm, nsp = batch
    jstep = JaxTrainStep(jm, _jax_loss, JaxAdamW(
        learning_rate=BERT_LR, parameters=jm.parameters()))
    ref = [float(jstep(inputs=(_jt(ids), None, None, None, _jt(mlm)),
                       labels=(_jt(nsp),))) for _ in range(3)]
    plain = _bert_steps(state, batch, 0.0)
    for i, (ours, want) in enumerate(zip(plain, ref)):
        assert abs(ours - want) <= BERT_RTOL[None] * abs(want), \
            f"dropout 0, step {i}: port {ours}, reference {want}"
    a, b = _bert_steps(state, batch, 0.1), _bert_steps(state, batch, 0.1)
    c = _bert_steps(state, batch, 0.1, seed=1)
    assert all(np.isfinite(a)) and a == b, (a, b)
    assert a != plain and a != c, (a, plain, c)


def test_nn_layers_match_reference(fresh_mesh):
    prev = list(port_device._CURRENT)
    PT.set_device("cpu")
    try:
        run_checks([(check_layer, (c["cls"], k))
                    for k, c in enumerate(LAYERS)]
                   + [(f, ()) for f in (
                       check_containers_match_reference,
                       check_convert_sync_batchnorm,
                       check_spectral_norm_raises,
                       check_signatures_match_reference,
                       check_name_taken,
                       check_missing_names_match_roadmap,
                       check_bert_trains_with_dropout)])
    finally:
        port_device._CURRENT[:] = prev
