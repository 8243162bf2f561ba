"""Port ResNet training (``paddle_tpu_torch``: ``nn.functional`` conv,
batch_norm and pooling, the ``Conv2D``/``BatchNorm*``/pooling/``ReLU``/
``Sequential``/``Flatten`` layers, ``tensor.flatten``,
``vision.models.resnet``, ``dense_state_dict_from_numpy``, ``TrainStep``
with Momentum under ``auto_cast``) against the JAX reference on the CPU:
``ResNet`` at ``num_classes=10``, batch 4 x 3 x 64 x 64 from
``RandomState(0)`` as ``bench.py``'s ``measure_resnet50`` makes it,
Momentum(0.01, 0.9), weights and running statistics carried from the
reference with ``dense_state_dict_from_numpy``. (At batch 2 and 32 x
32 the reference's ResNet-50 diverges within two steps; at 4 x 64 x 64
it trains.)

Cases and tolerances (the measured value beside each):

- ``conv2d`` over stride, padding forms ("SAME", "VALID", one a side,
  (low, high) pairs), dilation, groups, bias and NHWC, and
  ``conv1d``/``conv3d``: the output and the gradients of x, w and b
  within 1e-5 of each tensor's largest (measured 4.6e-7).
- ``max_pool2d(3, 2, 1)`` and uneven and "SAME" padding, ``avg_pool2d``
  (padded, exclusive or not, ``ceil_mode``, "SAME") and
  ``adaptive_avg_pool2d`` (8 -> 2, 8 -> 1, and 7 -> 3: the non-divisible
  per-cell mean), forward and backward, within 1e-6 (measured 1.2e-7).
  Max-pool ties: bf16 input on a 1/2 grid under O2 (a tied maximum in
  more than 30% of the 3 x 3 windows): output and input gradient bit for
  bit against the reference, so each tie's gradient goes to the same
  (first) maximum on both sides.
- ``batch_norm`` in training: output, ``_mean``, ``_variance`` and the
  gradients of x, w and b within 1e-5 (measured 1.9e-6). The per-channel
  sums of dx are the reference's (0.35, -1.62, 0.84 here), where
  PyTorch's training-mode batch norm gives ~1e-7; the running variance
  moves toward the biased variance (the unbiased one lands 8.2e-3 away).
  In eval mode and with ``use_global_stats``, from the buffers, nothing
  moved; ``BatchNorm1D`` on [N, C] and [N, C, L], ``BatchNorm3D`` and
  NHWC as the reference's, ``state_dict`` keys too.
- ``resnet18`` and ``resnet50``, one training-mode forward: the logits
  within 1e-4 of the largest (measured 5.1e-6 and 6.2e-5).
- fp32 training: 3 port ``TrainStep`` steps of ``resnet18`` against the
  reference's step op by op (forward, ``backward()``, ``step()``): the
  loss within 1e-5 relative at each step (measured 6.7e-6), every
  parameter within 2e-5 (measured 2.4e-7) and every ``_mean`` and
  ``_variance`` within 1e-5 (measured 6.8e-6); the port's first update
  is Momentum's, each weight less fp32 lr times its gradient, bit for
  bit.
- ``resnet50`` stage by stage (stem, 16 blocks, head; each fed the same
  input, the port's previous output, and one cotangent on both sides),
  in fp32 and under O2: the output within 1e-5 and 2^-7 of its largest
  (measured 1.2e-6, 5.6e-3), the input and parameter gradients within
  3e-2 and 5e-2 by ``torch_checks.norm_rel`` (measured: fp32 1e-6, and
  1.0e-2 in the one stage whose gradient a ReLU flip moved, at most two
  such stages allowed, the others within 1e-4; O2 1.9e-2), the running
  buffers within 1e-5 and 5e-3 (measured 3.9e-7, 1.1e-3). Whole-model
  resnet50 steps are not held to this: at batch 4 x 64 x 64 the model
  amplifies rounding. The reference against itself with every input one
  ulp up differs after 3 fp32 steps by 80% in the loss and 0.39 in the
  parameters (the port against it: 76%, 0.21); a forward's buffers by
  5.7e-5 against the port's; under O2, half a bf16 ulp of input noise
  moves the port's own gradients by 2.3 of each tensor's norm.
- A reference caveat, recorded: its compiled ``TrainStep`` is not its
  eager step. Its ``x.detach()`` wraps the traced value, which
  ``jax.grad`` differentiates through, so the compiled step takes the
  gradient through the batch statistics, where the eager step (the
  code as written, "no grad through the stat update") does not. On
  ``resnet18`` the compiled step's first update differs from the eager
  one by 2.3e-2 (``bn1.weight``; held above 1e-3) and equals within 2e-5
  (measured 1.3e-6) the port's step with a batch norm that
  differentiates through its statistics. The port's is the eager one.
- Under O2: the cast sequence, op for op: ``resnet50``'s port
  ``TrainStep`` and eager step against the reference's eager step (229
  casts a step, ten op names), ``resnet18``'s port ``TrainStep``
  against the reference's compiled trace (90); 3 port ``TrainStep``
  steps' losses finite, the first within 3e-2 relative of the
  reference's (measured 1.3e-2; the port's own moves by 3.5e-2 under
  half a bf16 ulp of input noise), the first update Momentum's bit for
  bit. (``torch_checks.bf16_step_parity`` holds an Adam step, about lr
  whatever the gradient; Momentum's first step is lr times it, and the
  gradients are held stage by stage above.)
- GEMM settings: an fp32 ``conv2d`` forward and backward run with
  cuDNN's TF32 off while the caller has set it on, and the caller's flag
  is back after the pass.
- What is not ported raises, naming ROADMAP Queue A 14: the transposed
  convolutions (``max_pool2d(return_mask=True)``, ported since, gives
  its int32 mask); ``pretrained=True`` raises as in the reference.

About 110 s on the CPU (two threads), nearly all of it the reference's
eager ResNet steps and stages (its per-op compiles) and its compiled
ResNet-18 steps. The file collects one test that runs every case
(``tests/torch_checks.py`` says why).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.vision import models as jmodels
import paddle_tpu_torch.amp as tamp
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import tensor as T
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import dense_state_dict_from_numpy
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as tmodels
from test_torch_bert_train import _ctx, _diff, _recording
from torch_checks import resnet_stages, run_checks, stage_errors, stage_run

torch.set_num_threads(2)

B, IMG, CLASSES = 4, 64, 10
LR, MOM = 0.01, 0.9
STEPS = 3
CONV_TOL = 1e-5        # of each tensor's largest
POOL_TOL = 1e-6
BN_TOL = 1e-5
LOGIT_TOL = 1e-4       # of the largest logit
LOSS_RTOL = {None: 1e-5}
PARAM_TOL = 2e-5
BUFFER_TOL = 1e-5
# a stage's output (largest difference over the largest value), input
# and parameter gradients (norm_rel) and running buffers (absolute); in
# fp32 the gradients of all but at most two stages within
# FP32_GRAD_CLEAN (a ReLU input within rounding of zero, ~2 in the 48
# ReLUs at this size, sends the gradient through on one side only)
STAGE_TOL = {None: {"out": 1e-5, "dx": 3e-2, "grads": 3e-2,
                    "buffers": 1e-5},
             "O2": {"out": 2.0 ** -7, "dx": 5e-2, "grads": 5e-2,
                    "buffers": 5e-3}}
O2_LOSS_RTOL = 3e-2
FP32_GRAD_CLEAN = 1e-4


# ------------------------------------------------------------ helpers
def _j(a, dtype="float32"):
    return paddle.to_tensor(np.asarray(a), dtype=dtype)


def _np(t):
    """A reference tensor or a port tensor as fp32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._value).astype(np.float32)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _both(jfn, tfn, arrays, grads=True):
    """``jfn`` on reference tensors and ``tfn`` on port tensors of the same
    fp32 ``arrays``; with ``grads``, the sum of the output times a fixed
    random cotangent is differentiated on both sides. Returns the outputs
    and the gradients of every input."""
    jin = [_j(a) for a in arrays]
    tin = [torch.from_numpy(np.array(a)).requires_grad_(grads)
           for a in arrays]
    for t in jin:
        t.stop_gradient = not grads
    jout, tout = jfn(*jin), tfn(*tin)
    if not grads:
        return (jout, tout), []
    ct = np.random.RandomState(9).randn(*tout.shape).astype(np.float32)
    (jout * _j(ct)).sum().backward()
    (tout * torch.from_numpy(ct)).sum().backward()
    return (jout, tout), [(jt.grad, tt.grad) for jt, tt in zip(jin, tin)]


def _carried(name, seed=0):
    """The reference's ``name`` model (seed ``seed``) and the port's with
    its parameters and running statistics."""
    paddle.seed(seed)
    jm = getattr(jmodels, name)(num_classes=CLASSES)
    tm = getattr(tmodels, name)(num_classes=CLASSES, device="cpu")
    tm.load_state_dict(dense_state_dict_from_numpy(_jstate(jm), tm))
    return jm, tm


def _jstate(jm):
    return {n: np.asarray(t._value).copy() for n, t in jm.state_dict().items()}


def _tstate(tm):
    return {n: t.detach().float().numpy().copy()
            for n, t in tm.state_dict().items()
            if not n.endswith("_extra_state")}


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, 3, IMG, IMG).astype(np.float32)
    return x, rs.randint(0, CLASSES, (B,))


def _jax_loss(logits, y):
    return JF.cross_entropy(logits, y)


def _port_loss(logits, y):
    return F.cross_entropy(logits, y)


def _jax_eager_steps(jm, level, batch, steps):
    """The reference's step op by op: the losses, the first step's casts
    and its (before, after, gradient) per parameter."""
    x, y = _j(batch[0]), _j(batch[1], "int64")
    opt = jopt.Momentum(learning_rate=LR, momentum=MOM,
                        parameters=jm.parameters())
    jm.train()
    losses, first, casts = [], None, None
    for i in range(steps):
        before = {n: _np(p) for n, p in jm.named_parameters()}
        with _recording(jamp) as seen, _ctx(jamp, level):
            loss = _jax_loss(jm(x), y)
        loss.backward()
        grads = {n: _np(p.grad) for n, p in jm.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        if i == 0:
            casts = seen
            first = {n: (torch.from_numpy(before[n]),
                         torch.from_numpy(_np(p)),
                         torch.from_numpy(grads[n]))
                     for n, p in jm.named_parameters()}
    return losses, casts, first


def _port_steps(tm, level, batch, steps):
    """The port's ``TrainStep``: losses, the first step's casts and its
    (before, after, gradient) per parameter."""
    x, y = batch
    step = TrainStep(tm, _port_loss, Momentum(
        learning_rate=LR, momentum=MOM, parameters=tm.parameters()))
    losses, first, casts = [], None, None
    for i in range(steps):
        before = {n: p.detach().clone() for n, p in tm.named_parameters()}
        with _recording(tamp) as seen, _ctx(tamp, level):
            losses.append(float(step(inputs=(x,), labels=(y,))))
        if i == 0:
            casts = seen
            first = {n: (before[n], p.detach().clone(),
                         p.grad.detach().clone())
                     for n, p in tm.named_parameters()}
    return losses, casts, first


def _close(a, b, rtol, what):
    assert abs(a - b) <= rtol * abs(b), f"{what}: {a} vs {b}"


# ------------------------------------------------------- functionals
CONV_CASES = [
    dict(),
    dict(stride=2, padding=1, bias=True),
    dict(stride=(2, 1), padding=[1, 2], dilation=2),
    dict(padding=[0, 1, 2, 1], groups=2, bias=True),
    dict(padding="SAME", stride=2, bias=True),
    dict(padding="VALID", dilation=(1, 2)),
    dict(padding=1, data_format="NHWC", bias=True),
    dict(groups=4, padding=1, stride=2),
]


def check_conv2d_matches_reference(opts):
    opts = dict(opts)
    rs = np.random.RandomState(1)
    groups = opts.get("groups", 1)
    x = rs.randn(2, 4, 9, 11).astype(np.float32)
    if opts.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = rs.randn(8, 4 // groups, 3, 3).astype(np.float32)
    arrays = [x, w] + ([rs.randn(8).astype(np.float32)]
                       if opts.pop("bias", False) else [])
    (jo, to), grads = _both(lambda *a: JF.conv2d(*a, **opts),
                            lambda *a: F.conv2d(*a, **opts), arrays)
    assert tuple(to.shape) == tuple(jo.shape), (to.shape, jo.shape)
    errs = [_rel(to, jo)] + [_rel(tg, jg) for jg, tg in grads]
    assert max(errs) <= CONV_TOL, f"{opts}: {errs}"
    return max(errs)


def check_conv1d_conv3d_match_reference():
    rs = np.random.RandomState(2)
    for jfn, tfn, xs, ws, kw in (
            (JF.conv1d, F.conv1d, (2, 4, 13), (6, 2, 3),
             dict(stride=2, padding=1, groups=2)),
            (JF.conv3d, F.conv3d, (1, 2, 5, 6, 7), (3, 2, 3, 3, 3),
             dict(padding=1, dilation=(1, 1, 2)))):
        arrays = [rs.randn(*xs).astype(np.float32),
                  rs.randn(*ws).astype(np.float32),
                  rs.randn(ws[0]).astype(np.float32)]
        (jo, to), grads = _both(lambda *a: jfn(*a, **kw),
                                lambda *a: tfn(*a, **kw), arrays)
        errs = [_rel(to, jo)] + [_rel(tg, jg) for jg, tg in grads]
        assert max(errs) <= CONV_TOL, (jfn.__name__, errs)


POOL_CASES = [
    ("max", dict(kernel_size=3, stride=2, padding=1)),
    ("max", dict(kernel_size=2, padding="SAME")),
    ("max", dict(kernel_size=3, stride=2, padding=[1, 0])),
    ("avg", dict(kernel_size=3, stride=2, padding=1)),
    ("avg", dict(kernel_size=3, stride=2, padding=1, exclusive=False)),
    ("avg", dict(kernel_size=3, stride=2, ceil_mode=True)),
    ("avg", dict(kernel_size=2, padding="SAME")),
    ("adaptive", dict(output_size=2)),
    ("adaptive", dict(output_size=(1, 1))),
    ("adaptive", dict(output_size=3)),
]


def check_pool_matches_reference(kind, opts):
    fns = {"max": (JF.max_pool2d, F.max_pool2d),
           "avg": (JF.avg_pool2d, F.avg_pool2d),
           "adaptive": (JF.adaptive_avg_pool2d, F.adaptive_avg_pool2d)}
    jfn, tfn = fns[kind]
    side = 7 if opts.get("output_size") == 3 else 8
    x = np.random.RandomState(3).randn(2, 3, side, side + 1 if
                                       kind != "adaptive" else side)
    x = x.astype(np.float32)
    (jo, to), ((jg, tg),) = _both(lambda v: jfn(v, **opts),
                                  lambda v: tfn(v, **opts), [x])
    assert tuple(to.shape) == tuple(jo.shape), (to.shape, jo.shape)
    errs = [float(np.abs(_np(a) - _np(b)).max())
            for a, b in ((to, jo), (tg, jg))]
    assert max(errs) <= POOL_TOL, f"{kind} {opts}: {errs}"
    return max(errs)


def check_max_pool_ties_route_alike_under_o2():
    """bf16 input on a 1/4 grid (most 3 x 3 windows hold a tied maximum)
    through the O2 max pool: the output and the input gradient bit for
    bit against the reference, every window's gradient on one input."""
    rs = np.random.RandomState(4)
    x = (np.round(rs.randn(2, 3, 12, 12) * 2) / 2).astype(np.float32)
    ct = rs.randn(2, 3, 6, 6).astype(np.float32)
    jx, tx = _j(x), torch.from_numpy(x).requires_grad_()
    jx.stop_gradient = False
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        jo = JF.max_pool2d(jx, 3, 2, 1)
    with tamp.auto_cast(level="O2", dtype="bfloat16"):
        to = F.max_pool2d(tx, 3, 2, 1)
    assert to.dtype == torch.bfloat16 and str(jo.dtype).endswith(
        "bfloat16"), (to.dtype, jo.dtype)
    (jo.astype("float32") * _j(ct)).sum().backward()
    (to.float() * torch.from_numpy(ct)).sum().backward()
    assert np.array_equal(_np(to), _np(jo))
    jg, tg = _np(jx.grad), _np(tx.grad)
    assert np.array_equal(tg, jg), float(np.abs(tg - jg).max())
    windows = torch.nn.functional.unfold(torch.from_numpy(x), 3, padding=1,
                                         stride=2)
    tied = (windows == windows.max(1, keepdim=True).values).sum(1) > 1
    assert float(tied.float().mean()) > 0.3, float(tied.float().mean())


def _bn_args(rs, shape, channel=1):
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    c = shape[channel]
    return x, rs.randn(c).astype(np.float32), (rs.rand(c) + 0.5).astype(
        np.float32), rs.randn(c).astype(np.float32), rs.randn(c).astype(
        np.float32)


def check_batch_norm_training_matches_reference():
    """The reference's training batch norm: output, running buffers and
    gradients; dx's per-channel sums (zero for PyTorch's training-mode
    batch norm) are the reference's, and far from zero."""
    rs = np.random.RandomState(5)
    x, rm, rv, w, b = _bn_args(rs, (4, 3, 5, 3))
    jrm, jrv = _j(rm), _j(rv)
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    (jo, to), grads = _both(
        lambda v, wt, bs: JF.batch_norm(v, jrm, jrv, wt, bs, training=True),
        lambda v, wt, bs: F.batch_norm(v, trm, trv, wt, bs, training=True),
        [x, w, b])
    checks = [("out", to, jo), ("_mean", trm, jrm), ("_variance", trv, jrv)]
    checks += [(f"grad {n}", tg, jg)
               for n, (jg, tg) in zip(("x", "w", "b"), grads)]
    errs = {what: float(np.abs(_np(a) - _np(b_)).max())
            for what, a, b_ in checks}
    assert max(errs.values()) <= BN_TOL, f"batch_norm training: {errs}"
    jsum = _np(grads[0][0]).sum((0, 2, 3))
    tsum = _np(grads[0][1]).sum((0, 2, 3))
    assert np.abs(jsum).min() > 0.1, jsum
    assert np.abs(tsum - jsum).max() <= BN_TOL * np.abs(jsum).max(), (
        tsum, jsum)
    n = x.size // x.shape[1]
    unbiased = MOM * rv + (1 - MOM) * x.var((0, 2, 3)) * n / (n - 1)
    assert np.abs(unbiased - _np(jrv)).max() > 100 * BN_TOL
    return {"worst": max(errs.values()), "dx_sums": jsum.tolist(),
            "unbiased_off": float(np.abs(unbiased - _np(jrv)).max())}


def check_batch_norm_eval_and_global_stats_match_reference():
    rs = np.random.RandomState(6)
    x, rm, rv, w, b = _bn_args(rs, (3, 4, 6, 5))
    for kw in (dict(training=False), dict(training=True,
                                          use_global_stats=True)):
        jrm, jrv = _j(rm), _j(rv)
        trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
        (jo, to), grads = _both(
            lambda v: JF.batch_norm(v, jrm, jrv, _j(w), _j(b), **kw),
            lambda v: F.batch_norm(v, trm, trv, torch.from_numpy(w),
                                   torch.from_numpy(b), **kw), [x])
        for a, b_ in ((to, jo), grads[0][::-1]):
            assert _rel(a, b_) <= BN_TOL, (kw, _rel(a, b_))
        assert np.array_equal(trm.numpy(), rm) and np.array_equal(
            trv.numpy(), rv), kw


def check_batch_norm_layers_match_reference():
    """BatchNorm1D on [N, C] and [N, C, L], BatchNorm3D, BatchNorm2D over
    NHWC, in training: outputs and both buffers."""
    rs = np.random.RandomState(7)
    for cls, shape, fmt in (("BatchNorm1D", (6, 5), "NCHW"),
                            ("BatchNorm1D", (3, 5, 7), "NCHW"),
                            ("BatchNorm3D", (2, 5, 3, 4, 2), "NCHW"),
                            ("BatchNorm2D", (2, 4, 3, 5), "NHWC")):
        x = (rs.randn(*shape) * 3 + 1).astype(np.float32)
        jl = getattr(jnn, cls)(5, momentum=0.8, data_format=fmt)
        tl = getattr(tnn, cls)(5, momentum=0.8, data_format=fmt,
                               device="cpu")
        jo, to = jl(_j(x)), tl(torch.from_numpy(x))
        for what, a, b in (("out", to, jo), ("_mean", tl._mean, jl._mean),
                           ("_variance", tl._variance, jl._variance)):
            assert _rel(a, b) <= BN_TOL, (cls, shape, what, _rel(a, b))
    assert set(tl.state_dict()) == set(jl.state_dict())


# ------------------------------------------------------------- models
def check_model_forward_matches_reference(name):
    """One training-mode forward: the logits. (The running buffers are
    held stage by stage and after resnet18's steps: the deep layers'
    batch statistics of resnet50 carry its amplification of rounding,
    below.)"""
    jm, tm = _carried(name)
    x, _ = _batch()
    jm.train()
    tm.train()
    jo, to = jm(_j(x)), tm(torch.from_numpy(x))
    assert _rel(to, jo) <= LOGIT_TOL, f"{name} logits: {_rel(to, jo):.2e}"
    js, ts = _jstate(jm), _tstate(tm)
    assert set(js) == set(ts), set(js) ^ set(ts)
    return {"logits": _rel(to, jo),
            "buffers": max(float(np.abs(js[n] - ts[n]).max()) for n in js
                           if n.endswith(("_mean", "_variance")))}


def _first_step_is_momentum(first) -> None:
    """Momentum's first step (zero velocity): every parameter moved by
    exactly ``-lr`` (fp32) times its gradient, and some by a nonzero
    amount."""
    lr = torch.tensor(LR, dtype=torch.float32)
    for n, (before, after, g) in first.items():
        assert torch.equal(after, before - lr * g.float()), n
    assert any(not torch.equal(a, b) for b, a, _ in first.values())


def check_fp32_training_matches_reference():
    """3 TrainStep steps of resnet18 against the reference's step op by
    op: losses, parameters and running statistics; the port's first
    update is Momentum's."""
    jm, tm = _carried("resnet18")
    batch = _batch()
    with _recording(tamp) as seen:
        losses, _, first = _port_steps(tm, None, batch, STEPS)
    assert not seen
    _first_step_is_momentum(first)
    jax_losses, _, _ = _jax_eager_steps(jm, None, batch, STEPS)
    for i, (a, b) in enumerate(zip(losses, jax_losses)):
        _close(a, b, LOSS_RTOL[None], f"fp32 loss {i}")
    assert jax_losses[-1] < jax_losses[0], jax_losses
    js, ts = _jstate(jm), _tstate(tm)
    worst = {"param": 0.0, "buffer": 0.0}
    for n in js:
        kind = "buffer" if n.endswith(("_mean", "_variance")) else "param"
        err = float(np.abs(js[n] - ts[n]).max())
        worst[kind] = max(worst[kind], err)
        assert err <= (BUFFER_TOL if kind == "buffer" else PARAM_TOL), (
            f"{n}: {err:.3e}")
    return {"loss": max(abs(a - b) / abs(b)
                        for a, b in zip(losses, jax_losses)), **worst}


def _jax_stage_run(jm, stage, x, ct, level):
    """:func:`torch_checks.stage_run` on the reference's model."""
    _, fn, prefixes = stage
    jm.train()
    jm.clear_gradients()
    jx = _j(x)
    jx.stop_gradient = False
    with _ctx(jamp, level):
        out = fn(jx)
    (out.astype("float32") * _j(ct)).sum().backward()

    def mine(n):
        return any(n == p or n.startswith(p + ".") for p in prefixes)

    t = torch.from_numpy
    return {"out": t(_np(out)), "dx": t(_np(jx.grad)),
            "grads": {n: t(_np(p.grad)) for n, p in jm.named_parameters()
                      if mine(n)},
            "buffers": {n: t(_np(b)) for n, b in jm.named_buffers()
                        if mine(n)}}


def check_resnet50_stages_match_reference(level):
    """Every stage of resnet50 (stem, the 16 blocks, head) fed the same
    input (the port's previous output) and cotangent on both sides, in
    training mode: output, input gradient, parameter gradients and
    running buffers."""
    jm, tm = _carried("resnet50")
    x = torch.from_numpy(_batch()[0])
    tol = STAGE_TOL[level]
    worst, flipped = dict.fromkeys(tol, 0.0), []
    for i, (jst, tst) in enumerate(zip(resnet_stages(jm, _jflatten),
                                       resnet_stages(tm, T.flatten))):
        got = stage_run(tm, tst, x, i, level)
        errs = stage_errors(got, _jax_stage_run(
            jm, jst, x.numpy(), got["ct"].numpy(), level))
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
            assert v <= tol[k], f"{level} {tst[0]} {k}: {v:.2e}"
        if max(errs["dx"], errs["grads"]) > FP32_GRAD_CLEAN:
            flipped.append(tst[0])
        x = got["out"]
    if level is None:
        assert len(flipped) <= 2, flipped
    return {**worst, "above_1e-4": flipped}


def _jflatten(x, axis):
    return x.flatten(axis)


def _bn_through_stats(x, running_mean, running_var, weight=None, bias=None,
                      training=False, momentum=0.9, epsilon=1e-05,
                      data_format="NCHW", use_global_stats=None):
    """The batch norm the reference's compiled TrainStep differentiates:
    the statistics as functions of x (NCHW, training)."""
    v = x.to(torch.float32)
    mean, var = v.mean((0, 2, 3)), v.var((0, 2, 3), unbiased=False)
    with torch.no_grad():
        running_mean.copy_(momentum * running_mean
                           + (1.0 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1.0 - momentum) * var)
    shape = (1, -1, 1, 1)
    out = ((v - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                   + epsilon)).to(x.dtype)
    return out * weight.reshape(shape) + bias.reshape(shape)


def check_reference_trainstep_differentiates_batch_statistics():
    """A reference caveat, recorded: its compiled TrainStep's first update
    is not its eager step's; it is the port's step with the gradient
    taken through the batch statistics."""
    batch = _batch()
    jm, tm = _carried("resnet18")
    jstep = JaxTrainStep(jm, _jax_loss, jopt.Momentum(
        learning_rate=LR, momentum=MOM, parameters=jm.parameters()))
    jstep(inputs=(_j(batch[0]),), labels=(_j(batch[1], "int64"),))
    compiled = _jstate(jm)
    je, _ = _carried("resnet18")
    _jax_eager_steps(je, None, batch, 1)
    eager = _jstate(je)
    apart = max(float(np.abs(compiled[n] - eager[n]).max())
                for n in compiled)
    assert apart > 1e-3, apart
    saved = tnn.layer.norm.F.batch_norm
    tnn.layer.norm.F.batch_norm = _bn_through_stats
    try:
        _port_steps(tm, None, batch, 1)
    finally:
        tnn.layer.norm.F.batch_norm = saved
    ts = _tstate(tm)
    err = max(float(np.abs(ts[n] - compiled[n]).max()) for n in ts)
    assert err <= PARAM_TOL, err
    return {"compiled_vs_eager": apart, "through_stats_vs_compiled": err}


def check_o2_casts_and_step_match_reference():
    """Under O2: the casts op for op (resnet50: the port's TrainStep and
    eager step against the reference's eager step; resnet18: the port's
    TrainStep against the reference's compiled trace), the first loss,
    3 steps' losses finite, and the first update Momentum's."""
    batch = _batch()
    jm, tm = _carried("resnet50")
    jax_losses, jax_casts, _ = _jax_eager_steps(jm, "O2", batch, 1)
    losses, casts, first = _port_steps(tm, "O2", batch, STEPS)
    assert casts == jax_casts, _diff(jax_casts, casts)
    assert len(casts) == 229, len(casts)
    ops = {c[0] for c in casts}
    assert {"conv2d", "bn_stats", "batch_norm", "relu", "max_pool2d",
            "add", "adaptive_avg_pool2d", "flatten", "linear",
            "cross_entropy"} == ops, ops
    assert all(np.isfinite(losses)), losses
    _close(losses[0], jax_losses[0], O2_LOSS_RTOL, "O2 first loss")
    _first_step_is_momentum(first)
    _, tm2 = _carried("resnet50")
    tm2.train()
    with _recording(tamp) as eager, _ctx(tamp, "O2"):
        loss = _port_loss(tm2(torch.from_numpy(batch[0])),
                          torch.from_numpy(batch[1]))
    loss.backward()
    assert eager == casts, _diff(eager, casts)
    jm18, tm18 = _carried("resnet18")
    jstep = JaxTrainStep(jm18, _jax_loss, jopt.Momentum(
        learning_rate=LR, momentum=MOM, parameters=jm18.parameters()))
    with _recording(jamp) as traced, _ctx(jamp, "O2"):
        jstep(inputs=(_j(batch[0]),), labels=(_j(batch[1], "int64"),))
    _, casts18, _ = _port_steps(tm18, "O2", batch, 1)
    assert traced == casts18, _diff(traced, casts18)
    assert len(casts18) == 90, len(casts18)
    return {"first_loss": abs(losses[0] - jax_losses[0]) / jax_losses[0],
            "losses": losses}


# ---------------------------------------------------------- settings
def check_conv_runs_with_cudnn_tf32_off():
    """The caller's cuDNN TF32 flag on: an fp32 conv's forward and its
    backward (read in a hook on the input's gradient, after the conv's
    backward) run with it off; the caller's flag is back after."""
    dnn = torch.backends.cudnn
    saved = dnn.allow_tf32
    seen = []
    try:
        dnn.allow_tf32 = True
        x = torch.randn(1, 2, 5, 5, requires_grad=True)
        w = torch.randn(3, 2, 3, 3, requires_grad=True)
        x.register_hook(lambda g: seen.append(dnn.allow_tf32))

        class Spy(torch.overrides.TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                if func is torch.nn.functional.conv2d:
                    seen.append(dnn.allow_tf32)
                return func(*args, **(kwargs or {}))

        with Spy():
            out = F.conv2d(x, w, padding=1)
        out.sum().backward()
        assert seen == [False, False], seen
        assert dnn.allow_tf32 is True
    finally:
        dnn.allow_tf32 = saved


def check_unported_paths_raise():
    x = torch.zeros(1, 2, 4, 4)
    for fn in (F.conv1d_transpose, F.conv2d_transpose, F.conv3d_transpose):
        with pytest.raises(NotImplementedError, match="Queue A 14"):
            fn(x, torch.zeros(2, 2, 3, 3))
    out, mask = F.max_pool2d(x, 2, return_mask=True)     # ported since
    assert out.shape == (1, 2, 2, 2) and mask.dtype == torch.int32
    with pytest.raises(ValueError, match="pretrained"):
        tmodels.resnet18(pretrained=True, device="cpu")


def test_resnet_port_matches_reference(fresh_mesh):
    run_checks(
        [(check_conv2d_matches_reference, (o,)) for o in CONV_CASES]
        + [(check_conv1d_conv3d_match_reference, ())]
        + [(check_pool_matches_reference, c) for c in POOL_CASES]
        + [(check_max_pool_ties_route_alike_under_o2, ()),
           (check_batch_norm_training_matches_reference, ()),
           (check_batch_norm_eval_and_global_stats_match_reference, ()),
           (check_batch_norm_layers_match_reference, ()),
           (check_model_forward_matches_reference, ("resnet18",)),
           (check_model_forward_matches_reference, ("resnet50",)),
           (check_fp32_training_matches_reference, ()),
           (check_resnet50_stages_match_reference, (None,)),
           (check_resnet50_stages_match_reference, ("O2",)),
           (check_reference_trainstep_differentiates_batch_statistics, ()),
           (check_o2_casts_and_step_match_reference, ()),
           (check_conv_runs_with_cudnn_tf32_off, ()),
           (check_unported_paths_raise, ())])
