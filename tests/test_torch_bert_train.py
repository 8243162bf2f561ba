"""Port BERT pretraining under ``paddle.amp`` (``paddle_tpu_torch``:
``amp``, the cast points of the functionals and of
``paddle_tpu_torch/tensor``, ``nn.functional.cross_entropy``,
``BertForPretraining`` with ``masked_lm_labels`` and
``fused_loss_chunk``, ``BertPretrainingCriterion``, ``TrainStep`` under
``auto_cast``, ``GradScaler``, ``decorate``, int8 BERT under O2) against
the JAX reference on the CPU, at ``bert-test`` size (2 layers, hidden 64,
vocab 256), batch 2 x 64 from numpy as ``bench.py``'s ``measure_bert``
makes it (15% of the positions masked), AdamW lr 1e-3, weights carried
from the reference with ``bert_state_dict_from_numpy`` (a non-zero
``mlm_bias`` included).

Cases and tolerances (the measured value beside each):

- Cast sequence: ``amp_cast_inputs`` wrapped on both sides records each
  cast point's op name, input dtypes and output dtypes (integer dtypes
  as "int": JAX runs int32). Under O1 and O2, unfused and with
  ``fused_loss_chunk=128``, the port's ``TrainStep`` and eager step
  record exactly the reference's ``TrainStep`` trace and eager step (64
  casts a step). The loss is ``paddle_tpu_torch.tensor.add(mlm_loss,
  cross_entropy(...))``, the reference's Tensor ``+`` ("add"). Without
  amp no cast point calls it.
- fp32 training, no amp: 3 ``TrainStep`` steps against the reference's,
  the loss within 1e-5 relative at each (measured 8.8e-8) and every
  parameter within 2e-5 (``tests/test_torch_train.py``'s tolerances;
  measured 1.4e-5) but the two key biases. Their gradient is zero in
  exact arithmetic (softmax is invariant to one value added to a row of
  scores, and ``q . b_k`` is one value a row), so Adam moves them by up
  to lr a step on rounding noise on both sides (measured 9.5e-4 apart):
  they are held within 3 lr of where they started.
- Under O1 and O2, unfused and fused: 3 port ``TrainStep`` steps against
  the reference's eager step (forward, ``backward()``, ``step()``), the
  loss within 3e-4 relative at each step (ROADMAP's bf16 CPU rule;
  measured: O2 bit for bit, the bf16 sum rounding both sides to the
  same value; O1 2.0e-4 at the first step, 3.2e-5 and 1.1e-6 after).
  Against the reference's compiled ``TrainStep`` the O2 loss differs by
  up to 1.7e-3: XLA keeps the bf16 ops of one program in fp32 (excess
  precision; its O2 losses are not bf16 values), so the op-by-op step is
  the reference's own arithmetic, as PR 14 held the clip. The first
  step's update is held as ``tests/test_torch_bf16_train.py`` holds one
  (``torch_checks.bf16_step_parity``: every element whose gradient is
  clear of the two sides' gradient difference stepped within 1e-2 lr of
  the reference's), with each gradient within 3e-2 of its tensor's
  largest (measured 2.1e-2, the tied word table under O2), the query and
  key projections' within 0.15 (measured 9.8e-2 under O2, 6.0e-2 under
  O1: their gradient comes only through the scores, a small difference
  of larger terms at initialisation, here through a bf16 softmax that
  the frameworks round in other places), the key biases left out as
  above. The two sides round bf16 in other places: the reference's CPU
  gelu after each op (XLA), the port's once (one bf16 ulp of an
  activation).
- The eager step of ``tests/test_bert.py``'s amp test (logits under O1,
  ``BertPretrainingCriterion``, ``backward()``, ``step()``): the loss
  within 3e-4, the update as above.
- ``BertPretrainingCriterion`` with and without ``masked_lm_weights``,
  fp32 and under O2: within 1e-6 relative of the reference's (measured
  0 and 1.2e-7).
- ``F.cross_entropy``: every option of the reference's (class weights,
  ``ignore_index``, each reduction, soft labels, ``axis``,
  ``use_softmax=False``, ``label_smoothing``, the ``[..., 1]`` label
  form) within 1e-6 relative (measured <= 1.5e-7), and a bf16 input
  under O2 cast to fp32.
- ``GradScaler``: a Linear trained with SGD through
  ``scale``/``backward``/``minimize`` with an inf planted in the
  gradient at two steps: the scale, the skipped steps and the weights
  equal the reference's trajectory (weights within 1e-6).
- ``decorate(level="O2")``: the port's parameters bf16 and bit-identical
  to the reference's decorated ones; a forward of the decorated models
  under O2 records the reference's casts, its logits within 2 bf16 ulps
  of the largest (measured 1).
- Int8 under O2: after ``convert_to_int8`` on both sides, the dtype of
  every ``quant_matmul`` launch equals the reference's, in order (9 bf16
  and 6 fp32 at ``bert-test``); MLM logits bf16 and NSP logits fp32 as
  the reference's; the MLM logits within the reference's int8 criterion,
  0.05 mean relative error, of its own (measured 7.8e-3).
- GEMM settings: a BERT forward and backward under O2, unfused and
  fused (the fused loss's node enters settings again inside the pass
  that BERT's output node entered), with the caller's flags opposite:
  every backward GEMM at the model's settings until the fused node, the
  caller's flags back after the pass, and after a pass that raises.
- The fault ``tests/test_torch_cuda.py`` plants in the bf16
  ``quant_matmul`` kernel finds its anchor exactly once.
- Dropout > 0 in training runs; the tensor-parallel marks still raise,
  naming "parallelism"; importing ``paddle_tpu_torch.amp`` loads
  neither ``jax`` nor ``paddle_tpu``.

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import contextlib
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import BertForPretraining as JaxBert
from paddle_tpu.models import BertPretrainingCriterion as JaxCriterion
from paddle_tpu.models import bert_presets as jax_presets
from paddle_tpu.quantization import convert_to_int8 as jax_convert
import paddle_tpu_torch.amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import tensor as T
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (BertForPretraining,
                                     BertPretrainingCriterion, bert_presets,
                                     bert_state_dict_from_numpy)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.quantization import convert_to_int8
from test_torch_bf16_train import _flags, _gemm_nodes, _set_flags
from torch_checks import (QMM_BF16_FAULTS, QMM_BF16_SECTION, bf16_step_parity,
                          bf16_ulp, plant_qmm_fault, run_checks)

torch.set_num_threads(2)

B, S = 2, 64
LR = 1e-3
STEPS = 3
RTOL = {None: 1e-5, "O1": 3e-4, "O2": 3e-4}   # losses, relative
PARAM_TOL = 2e-5                               # fp32, no amp
# the first amp step's gradients, port against reference, of each
# tensor's largest: the query and key projections (measured up to
# 9.8e-2 under O2, 6.0e-2 under O1) and the rest (2.1e-2, the tied word
# table under O2)
QK_GRAD_RTOL = 0.15
GRAD_RTOL = 3e-2

jqm = importlib.import_module("paddle_tpu.ops.quant_matmul")
tqm = importlib.import_module("paddle_tpu_torch.ops.quant_matmul")


# ------------------------------------------------------------ helpers
def _carried(chunk=0, seed=0):
    """A reference model and the port's model loaded with its weights and
    weight names (a non-zero ``mlm_bias``)."""
    cfg = bert_presets("bert-test", fused_loss_chunk=chunk)
    paddle.seed(seed)
    jm = JaxBert(jax_presets("bert-test", fused_loss_chunk=chunk))
    bias = (np.random.RandomState(seed).randn(cfg.vocab_size) * 0.1
            ).astype(np.float32)
    jm.mlm_bias.set_value(bias)
    params = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    names = {n: p.name for n, p in jm.named_parameters()}
    tm = BertForPretraining(cfg, seed=seed, device="cpu")
    tm.load_state_dict(bert_state_dict_from_numpy(params, cfg, names))
    return jm, tm


def _batch(b=B, s=S, vocab=256, seed=0):
    """``measure_bert``'s batch: ids, 15% masked (their labels, -1
    elsewhere), NSP labels."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, s))
    mlm = np.where(rs.rand(b, s) < 0.15, ids, -1)
    return ids, mlm, rs.randint(0, 2, (b,))


def _name(dtype) -> str:
    s = str(dtype).replace("torch.", "")
    return "int" if s.startswith(("int", "uint")) else s


@contextlib.contextmanager
def _recording(module):
    """Wrap ``module.amp_cast_inputs``; yields the list of (op, input
    dtypes, output dtypes) it sees."""
    seen, real = [], module.amp_cast_inputs

    def spy(op_name, vals):
        out = real(op_name, vals)
        seen.append((op_name, tuple(_name(v.dtype) for v in vals),
                     tuple(_name(v.dtype) for v in out)))
        return out

    module.amp_cast_inputs = spy
    try:
        yield seen
    finally:
        module.amp_cast_inputs = real


def _ctx(module, level):
    if level is None:
        return contextlib.nullcontext()
    return module.auto_cast(level=level, dtype="bfloat16")


def _jax_loss(a, n, lbl):
    return a + JF.cross_entropy(n, lbl)


def _port_loss(a, n, lbl):
    return T.add(a, F.cross_entropy(n, lbl))


def _jt(x):
    return paddle.to_tensor(x, dtype="int64")


def _jparams(jm):
    return {n: np.asarray(p._value).astype(np.float32)
            for n, p in jm.named_parameters()}


def _tparams(tm):
    return {n: p.detach().float().numpy().copy()
            for n, p in tm.named_parameters()}


def _jax_eager_steps(jm, level, batch, steps):
    """The reference's step op by op: losses, the step-1 casts, and the
    first step's (before, after, gradient) per parameter."""
    ids, mlm, nsp = (_jt(x) for x in batch)
    opt = jopt.AdamW(learning_rate=LR, parameters=jm.parameters())
    losses, first, casts = [], None, None
    for i in range(steps):
        before = _jparams(jm)
        with _recording(jamp) as seen, _ctx(jamp, level):
            a, n = jm(ids, None, None, None, mlm)
            loss = _jax_loss(a, n, nsp)
        loss.backward()
        grads = {n: np.asarray(p.grad._value).astype(np.float32)
                 for n, p in jm.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        if i == 0:
            casts = seen
            after = _jparams(jm)
            first = {n: tuple(torch.from_numpy(v) for v in
                              (before[n], after[n], grads[n]))
                     for n in before}
    return losses, casts, first


def _port_steps(tm, level, batch, steps):
    """The port's ``TrainStep``: losses, the step-1 casts and the first
    step's (before, after, gradient) per parameter."""
    ids, mlm, nsp = batch
    step = TrainStep(tm, _port_loss,
                     AdamW(learning_rate=LR, parameters=tm.parameters()))
    losses, first, casts = [], None, None
    for i in range(steps):
        before = _tparams(tm)
        with _recording(tamp) as seen, _ctx(tamp, level):
            losses.append(float(step(inputs=(ids, None, None, None, mlm),
                                     labels=(nsp,))))
        if i == 0:
            casts = seen
            first = {n: (torch.from_numpy(before[n]), p.detach().clone(),
                         p.grad.detach().clone())
                     for n, p in tm.named_parameters()}
    return losses, casts, first


def _close(a, b, rtol, what):
    assert abs(a - b) <= rtol * abs(b), f"{what}: {a} vs {b}"


# -------------------------------------------------------------- cases
def check_casts_and_losses_match_reference(level, chunk):
    """O1/O2, unfused or fused: the cast sequence of the port's
    TrainStep and eager step equal the reference's TrainStep and eager
    step; the losses and the first update against the reference's step
    op by op."""
    batch = _batch()
    jm, tm = _carried(chunk)
    jax_losses, jax_casts, jax_first = _jax_eager_steps(jm, level, batch,
                                                        STEPS)
    losses, casts, first = _port_steps(tm, level, batch, STEPS)
    assert casts == jax_casts, _diff(jax_casts, casts)
    assert len(casts) == 63, len(casts)
    for i, (a, b) in enumerate(zip(losses, jax_losses)):
        _close(a, b, RTOL[level], f"{level} chunk={chunk} loss {i}")
    keys = [n for n in first if n.endswith("k_proj.bias")]
    qk = [n for n in first if n not in keys
          and (".q_proj." in n or ".k_proj." in n)]
    rest = [n for n in first if n not in keys and n not in qk]
    bf16_step_parity({n: first[n] for n in rest},
                     {n: jax_first[n] for n in rest}, LR,
                     grad_rtol=GRAD_RTOL)
    bf16_step_parity({n: first[n] for n in qk},
                     {n: jax_first[n] for n in qk}, LR,
                     grad_rtol=QK_GRAD_RTOL)
    # the reference's compiled step traces the same casts
    jm2, tm2 = _carried(chunk)
    ids, mlm, nsp = batch
    jstep = JaxTrainStep(jm2, _jax_loss, jopt.AdamW(
        learning_rate=LR, parameters=jm2.parameters()))
    with _recording(jamp) as traced, _ctx(jamp, level):
        jstep(inputs=(_jt(ids), None, None, None, _jt(mlm)),
              labels=(_jt(nsp),))
    assert traced == casts, _diff(traced, casts)
    # and the port's eager step casts as its TrainStep does
    with _recording(tamp) as eager, _ctx(tamp, level):
        a, n = tm2(torch.from_numpy(ids), None, None, None,
                   torch.from_numpy(mlm))
        loss = _port_loss(a, n, torch.from_numpy(nsp))
    loss.backward()
    assert eager == casts, _diff(eager, casts)


def _diff(want, got):
    for i, (w, g) in enumerate(zip(want, got)):
        if w != g:
            return f"cast {i}: reference {w}, port {g}"
    return f"{len(want)} casts in the reference, {len(got)} in the port"


def check_fp32_training_matches_reference():
    """No amp: 3 TrainStep steps on both sides."""
    jm, tm = _carried()
    ids, mlm, nsp = _batch()
    jstep = JaxTrainStep(jm, _jax_loss, jopt.AdamW(
        learning_rate=LR, parameters=jm.parameters()))
    start = _tparams(tm)
    with _recording(tamp) as seen:
        losses, _, _ = _port_steps(tm, None, (ids, mlm, nsp), STEPS)
    assert not seen
    for i, ours in enumerate(losses):
        ref = float(jstep(inputs=(_jt(ids), None, None, None, _jt(mlm)),
                          labels=(_jt(nsp),)))
        _close(ours, ref, RTOL[None], f"fp32 loss {i}")
    jp, tp = _jparams(jm), _tparams(tm)
    for n in tp:
        err = float(np.abs(tp[n] - jp[n]).max())
        if n.endswith("k_proj.bias"):
            for side in (tp[n], jp[n]):
                moved = float(np.abs(side - start[n]).max())
                assert moved <= 3 * STEPS * LR, (n, moved)
        else:
            assert err <= PARAM_TOL, f"{n}: {err:.3e}"


def check_eager_o1_criterion_step_matches_reference():
    """The eager form of ``tests/test_bert.py``'s amp test: logits and
    NSP logits under O1, ``BertPretrainingCriterion`` (inside the
    ``auto_cast`` block), ``loss.backward()`` and ``opt.step()`` on both
    sides: the loss within 3e-4 and the update by ``bf16_step_parity``
    as above."""
    jm, tm = _carried()
    ids, mlm, nsp = _batch()
    jopt_ = jopt.AdamW(learning_rate=LR, parameters=jm.parameters())
    topt = AdamW(learning_rate=LR, parameters=tm.parameters())
    jbefore, tbefore = _jparams(jm), _tparams(tm)
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        lg, ns = jm(_jt(ids))
        jloss = JaxCriterion()(lg, ns, _jt(mlm), _jt(nsp))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad._value).astype(np.float32)
              for n, p in jm.named_parameters()}
    jopt_.step()
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        lg, ns = tm(torch.from_numpy(ids))
        tloss = BertPretrainingCriterion()(lg, ns, mlm, nsp)
    tloss.backward()
    topt.step()
    _close(float(tloss), float(jloss), RTOL["O1"], "eager O1 loss")
    jafter = _jparams(jm)
    ref = {n: tuple(torch.from_numpy(v) for v in
                    (jbefore[n], jafter[n], jgrads[n])) for n in jbefore}
    ours = {n: (torch.from_numpy(tbefore[n]), p.detach().clone(),
                p.grad.detach().clone()) for n, p in tm.named_parameters()}
    keys = [n for n in ref if n.endswith("k_proj.bias")]
    qk = [n for n in ref if n not in keys
          and (".q_proj." in n or ".k_proj." in n)]
    rest = [n for n in ref if n not in keys and n not in qk]
    bf16_step_parity({n: ours[n] for n in rest}, {n: ref[n] for n in rest},
                     LR, grad_rtol=GRAD_RTOL)
    bf16_step_parity({n: ours[n] for n in qk}, {n: ref[n] for n in qk}, LR,
                     grad_rtol=QK_GRAD_RTOL)


def check_criterion_matches_reference(weights, level):
    rs = np.random.RandomState(4)
    logits = rs.randn(B, 8, 256).astype(np.float32)
    nsp = rs.randn(B, 2).astype(np.float32)
    lbl = np.where(rs.rand(B, 8) < 0.4, rs.randint(0, 256, (B, 8)), -1)
    nsl = rs.randint(0, 2, (B,))
    w = rs.rand(B, 8).astype(np.float32) if weights else None
    with _ctx(jamp, level):
        want = float(JaxCriterion()(
            paddle.to_tensor(logits), paddle.to_tensor(nsp), _jt(lbl),
            _jt(nsl), None if w is None else paddle.to_tensor(w)))
    with _ctx(tamp, level):
        got = float(BertPretrainingCriterion()(
            torch.from_numpy(logits), torch.from_numpy(nsp), lbl, nsl,
            None if w is None else torch.from_numpy(w)))
    _close(got, want, 1e-6, f"criterion weights={weights} {level}")


CE_CASES = [
    dict(), dict(reduction="sum"), dict(reduction="none"),
    dict(ignore_index=3), dict(weight=True), dict(weight=True,
                                                  reduction="sum"),
    dict(weight=True, ignore_index=3, reduction="none"),
    dict(soft_label=True), dict(soft_label=True, label_smoothing=0.1),
    dict(label_smoothing=0.2), dict(label_smoothing=0.2, ignore_index=3),
    dict(use_softmax=False), dict(axis=1), dict(axis=1, weight=True),
    dict(column_label=True)]


def check_cross_entropy_matches_reference(opts):
    opts = dict(opts)
    rs = np.random.RandomState(5)
    axis = opts.get("axis", -1)
    shape = (6, 7) if axis == -1 else (3, 7, 4)
    x = rs.randn(*shape).astype(np.float32)
    if opts.pop("use_softmax", True) is False:
        x = np.abs(x) / np.abs(x).sum(axis, keepdims=True)
        opts["use_softmax"] = False
    k = shape[axis]
    if opts.get("soft_label"):
        lbl = rs.rand(*shape).astype(np.float32)
        lbl /= lbl.sum(axis, keepdims=True)
    else:
        lbl = rs.randint(0, k, np.delete(shape, axis % len(shape)))
        lbl.flat[::4] = 3
        if opts.pop("column_label", False):
            lbl = lbl[..., None]
    w = rs.rand(k).astype(np.float32) if opts.pop("weight", False) else None
    jl = (paddle.to_tensor(lbl) if opts.get("soft_label")
          else _jt(lbl))
    want = np.asarray(JF.cross_entropy(
        paddle.to_tensor(x), jl,
        weight=None if w is None else paddle.to_tensor(w), **opts)._value)
    got = F.cross_entropy(torch.from_numpy(x), torch.from_numpy(lbl),
                          weight=None if w is None else torch.from_numpy(w),
                          **opts).numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    assert err <= 1e-6, (opts, err)


def check_cross_entropy_casts_bf16_to_fp32():
    x = torch.randn(4, 5).bfloat16()
    with _recording(tamp) as seen, tamp.auto_cast(level="O2"):
        out = F.cross_entropy(x, torch.tensor([0, 1, 2, 3]))
    assert out.dtype == torch.float32
    assert seen == [("cross_entropy", ("bfloat16", "int"),
                     ("float32", "int"))]


def _scaler_run(jax_side: bool):
    """A Linear [3, 2] trained 6 steps with SGD through a dynamic
    GradScaler (init 2^10, grow by 2 after 2 good steps, shrink by half
    at each bad one), an inf planted in the input at steps 2 and 4.
    Returns the scales after each step, the skipped flags and the final
    weights."""
    rs = np.random.RandomState(6)
    w0 = rs.randn(3, 2).astype(np.float32)
    xs = [rs.randn(4, 3).astype(np.float32) for _ in range(6)]
    for i in (2, 4):
        xs[i][1, 2] = np.inf
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
    if jax_side:
        lin = jnn.Linear(3, 2)
        lin.weight.set_value(w0)
        opt = jopt.SGD(learning_rate=0.1, parameters=lin.parameters())
        scaler = jamp.GradScaler(**kw)
    else:
        lin = tnn.Linear(3, 2, device="cpu")
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w0))
        opt = SGD(learning_rate=0.1, parameters=lin.parameters())
        scaler = tamp.GradScaler(**kw)
    scales, skipped = [], []
    for x in xs:
        xin = paddle.to_tensor(x) if jax_side else torch.from_numpy(x)
        loss = (lin(xin) ** 2).mean()
        scaler.scale(loss).backward()
        scaler.minimize(opt)
        opt.clear_grad()
        scales.append(scaler.state_dict()["scale"])
        skipped.append(scaler.last_step_skipped)
    w = lin.weight
    return scales, skipped, (np.asarray(w._value) if jax_side
                             else w.detach().numpy())


def check_grad_scaler_matches_reference():
    want, got = _scaler_run(True), _scaler_run(False)
    assert got[0] == want[0] and got[1] == want[1], (got[:2], want[:2])
    assert want[1] == [False, False, True, False, True, False]
    assert float(np.abs(got[2] - want[2]).max()) <= 1e-6


def check_decorate_matches_reference():
    jm, tm = _carried()
    jamp.decorate(jm, level="O2")
    tamp.decorate(tm, level="O2")
    jp = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16, n
        assert np.array_equal(p.detach().view(torch.int16).numpy(),
                              jp[n].view(np.int16)), n
    ids = _batch()[0]
    with _recording(jamp) as jc, jamp.auto_cast(level="O2"):
        jl, _ = jm(_jt(ids))
    with _recording(tamp) as tc, tamp.auto_cast(level="O2"), \
            torch.no_grad():
        tl, _ = tm(torch.from_numpy(ids))
    assert tc == jc, _diff(jc, tc)
    a = np.asarray(jl._value).astype(np.float32)
    b = tl.float().numpy()
    top = float(bf16_ulp(torch.tensor(np.abs(a).max())))
    assert float(np.abs(a - b).max()) <= 2 * top


def check_int8_under_amp_matches_reference():
    jm, tm = _carried()
    jm.eval()
    tm.eval()
    jax_convert(jm)
    convert_to_int8(tm)
    ids = _batch()[0]
    jseen, tseen = [], []
    jreal, treal = jqm.quant_matmul, tqm.quant_matmul_plain

    def jspy(x, *a, **k):
        jseen.append(_name(x.dtype))
        return jreal(x, *a, **k)

    def tspy(x, *a, **k):
        tseen.append(_name(x.dtype))
        return treal(x, *a, **k)

    jqm.quant_matmul, tqm.quant_matmul_plain = jspy, tspy
    try:
        with jamp.auto_cast(level="O2"):
            jl, jn = jm(_jt(ids))
        with tamp.auto_cast(level="O2"), torch.no_grad():
            tl, tn = tm(torch.from_numpy(ids))
    finally:
        jqm.quant_matmul, tqm.quant_matmul_plain = jreal, treal
    assert tseen == jseen, (tseen, jseen)
    assert (jseen.count("bfloat16"), jseen.count("float32")) == (9, 6)
    assert (str(jl._value.dtype), str(jn._value.dtype)) == ("bfloat16",
                                                            "float32")
    assert (tl.dtype, tn.dtype) == (torch.bfloat16, torch.float32)
    a = np.asarray(jl._value).astype(np.float32)
    rel = np.abs(tl.float().numpy() - a).mean() / np.abs(a).mean()
    assert rel < 0.05, rel


class _PlantedError(RuntimeError):
    pass


def check_gemm_settings_of_the_amp_backward(chunk):
    """Under O2 the caller sets the opposite of BERT's GEMM settings:
    every GEMM node of the backward up to the fused loss's node runs at
    fp32's settings (TF32 off, no reduced-precision reduction), the
    caller's flags are back after the pass, and after a pass in which a
    node raises (a hook on the word-embedding gradient, after both
    entries)."""
    saved = _flags()
    caller = (True, True, True, True)
    try:
        jm, tm = _carried(chunk)
        ids, mlm, nsp = (torch.from_numpy(x) for x in _batch())
        _set_flags(caller)
        with tamp.auto_cast(level="O2"):
            loss = _port_loss(*tm(ids, None, None, None, mlm), nsp)
        assert _flags() == caller
        seen = []
        nodes = _gemm_nodes(loss.grad_fn)
        for node in nodes:
            node.register_prehook(lambda g: seen.append(_flags()))
        loss.backward()
        assert nodes and _flags() == caller, _flags()
        want = {(False, False, False, False)} | (
            {(True, False, False, False)} if chunk else set())
        assert set(seen) <= want and (False, False, False, False) in seen, \
            seen

        def fail(grad):
            raise _PlantedError("planted")

        tm.bert.embeddings.word_embeddings.weight.register_hook(fail)
        with tamp.auto_cast(level="O2"):
            loss = _port_loss(*tm(ids, None, None, None, mlm), nsp)
        with pytest.raises(_PlantedError):
            loss.backward()
        assert _flags() == caller, _flags()
    finally:
        _set_flags(saved)


def check_cast_points_inert_without_amp():
    x = torch.randn(3, 4)
    with _recording(tamp) as seen:
        assert T.clone(x) is x
        assert F.dropout(x, 0.0) is x
        F.linear(x, torch.randn(4, 2))
        F.layer_norm(x, 4)
    assert not seen


def check_planted_qmm_fault_armed():
    from paddle_tpu_torch.ops import _build

    src = (_build.CSRC / "quant_matmul.cu").read_text()
    head, sep, bf16 = src.partition(QMM_BF16_SECTION)
    planted = plant_qmm_fault(src)
    for loop, start, fault in QMM_BF16_FAULTS.values():
        assert sep and bf16.count(loop) == 1
        assert loop not in head
        assert loop not in planted
        assert planted.count(loop.replace(start, fault)) == 1


def check_unported_training_paths_raise():
    """Dropout > 0 trains now (``tests/test_torch_nn_layers.py`` holds
    its step); the tensor-parallel marks still raise, naming
    "parallelism"."""
    drop = BertForPretraining(bert_presets("bert-test", dropout=0.1),
                              device="cpu")
    ids = np.zeros((1, 4), np.int64)
    assert bool(torch.isfinite(drop(ids, masked_lm_labels=ids)[0]))
    with pytest.raises(NotImplementedError, match="parallelism"):
        drop.bert.mark_tensor_parallel()


def check_importing_amp_loads_no_jax():
    code = ("import paddle_tpu_torch.amp, paddle_tpu_torch.tensor, "
            "paddle_tpu_torch.nn.functional, sys; bad = [m for m in "
            "sys.modules if m in ('jax', 'paddle_tpu') or "
            "m.startswith(('jax.', 'paddle_tpu.'))]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(__file__)))


def test_bert_train_port_matches_reference(fresh_mesh):
    run_checks(
        [(check_casts_and_losses_match_reference, (level, chunk))
         for level in ("O2", "O1") for chunk in (0, 128)]
        + [(check_fp32_training_matches_reference, ()),
           (check_eager_o1_criterion_step_matches_reference, ())]
        + [(check_criterion_matches_reference, (w, level))
           for w in (False, True) for level in (None, "O2")]
        + [(check_cross_entropy_matches_reference, (tuple(o.items()),))
           for o in CE_CASES]
        + [(check_cross_entropy_casts_bf16_to_fp32, ()),
           (check_grad_scaler_matches_reference, ()),
           (check_decorate_matches_reference, ()),
           (check_int8_under_amp_matches_reference, ())]
        + [(check_gemm_settings_of_the_amp_backward, (c,)) for c in (0, 128)]
        + [(check_cast_points_inert_without_amp, ()),
           (check_planted_qmm_fault_armed, ()),
           (check_unported_training_paths_raise, ()),
           (check_importing_amp_loads_no_jax, ())])
