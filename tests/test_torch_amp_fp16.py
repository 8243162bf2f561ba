"""fp16 mixed precision in the port (``paddle_tpu_torch.amp``:
``decorate``/``auto_cast`` with ``dtype="float16"``, ``GradScaler``) on
BERT and GPT against the JAX reference on the CPU, at ``bert-test`` and
``gpt-test`` size, inputs from numpy.

- BERT pretraining (``bert-test``, batch 2 x 64, ``measure_bert``'s
  batch) under ``decorate(level="O2", dtype="float16")`` and
  ``auto_cast(level="O2", dtype="float16")``, the eager step
  (``scaler.scale(loss).backward()``, ``scaler.step(opt)``,
  ``scaler.update()``) with a ``GradScaler`` (init 2^10) and AdamW lr
  1e-3, on both sides from the same weights: the cast sequence of every
  step op for op (63 casts a step); the loss within 3e-4 relative at
  each of 3 steps (ROADMAP's 16-bit CPU rule; measured equal, the same
  fp16 values); the decorated parameters fp16 and bit for bit the
  reference's.
- An inf planted in one gradient after the backward: the step is skipped
  on both sides, every parameter keeps its bits, and the scale is
  halved; with ``incr_every_n_steps=2`` two good steps double it, on
  both sides.
- ``GradScaler.unscale_`` reads the device's finite flag once a step
  (``host_reads``) and leaves each gradient as the reference does, its
  fp32 product (lifted to fp32, times 1/scale, not rounded back), bit
  for bit, and finds a planted NaN.
- The same on a ``Linear(4, 4)`` decorated at O2 fp16, an input times
  2^-15, a loss times 2^-13 and a scale of 2^15, against the reference: the unscaled
  gradients' dtype and values (below fp16's smallest subnormal), the
  norm ``clip_grad_norm_`` returns after ``unscale_``, the gradients'
  dtype after a backward that accumulates onto them and after
  ``clear_grad()`` and a backward, and the step's parameters; after a
  gradient cleared by ``p.grad = None``, the next backward's dtype is the
  parameter's again (the scaler puts it back).
- GPT (``gpt-test``, batch 2 x 32) under ``auto_cast(level="O1",
  dtype="float16")``: the eager step's casts op for op and its loss
  within 3e-4 relative of the reference's.

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import contextlib

import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import BertForPretraining as JaxBert
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxGPTCriterion
from paddle_tpu.models import bert_presets as jax_bert_presets
from paddle_tpu.models import gpt_presets as jax_gpt_presets
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.amp as tamp
from paddle_tpu_torch import tensor as T
from paddle_tpu_torch.models import (BertForPretraining, GPTForCausalLM,
                                     GPTPretrainingCriterion, bert_presets,
                                     bert_state_dict_from_numpy, gpt_presets)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW
from torch_checks import run_checks

torch.set_num_threads(2)

B, S = 2, 64
LR = 1e-3
STEPS = 3
LOSS_RTOL = 3e-4
FP16 = "float16"


def _name(dtype) -> str:
    s = str(dtype).replace("torch.", "")
    return "int" if s.startswith(("int", "uint")) else s


@contextlib.contextmanager
def _recording(module):
    """Wrap ``module.amp_cast_inputs``; yields the (op, input dtypes,
    output dtypes) it sees."""
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


def _diff(want, got):
    for i, (w, g) in enumerate(zip(want, got)):
        if w != g:
            return f"cast {i}: reference {w}, port {g}"
    return f"{len(want)} casts in the reference, {len(got)} in the port"


def _jt(x):
    return paddle.to_tensor(x, dtype="int64")


def _bert_batch(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 256, (B, S))
    mlm = np.where(rs.rand(B, S) < 0.15, ids, -1)
    return ids, mlm, rs.randint(0, 2, (B,))


def _berts(seed=0):
    """The reference's bert-test and the port's on its weights, both
    decorated at O2 in fp16, with their AdamW."""
    cfg = bert_presets("bert-test")
    paddle.seed(seed)
    jm = JaxBert(jax_bert_presets("bert-test"))
    params = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    names = {n: p.name for n, p in jm.named_parameters()}
    tm = BertForPretraining(cfg, seed=seed, device="cpu")
    tm.load_state_dict(bert_state_dict_from_numpy(params, cfg, names))
    jamp.decorate(jm, level="O2", dtype=FP16)
    tamp.decorate(tm, level="O2", dtype=FP16)
    jp = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        assert p.dtype == torch.float16, n
        assert np.array_equal(p.detach().view(torch.int16).numpy(),
                              jp[n].view(np.int16)), n
    return (jm, jopt.AdamW(learning_rate=LR, parameters=jm.parameters()),
            tm, AdamW(learning_rate=LR, parameters=tm.parameters()))


def _jax_bert_step(jm, opt, scaler, batch, plant=None):
    ids, mlm, nsp = (_jt(x) for x in batch)
    with _recording(jamp) as casts, jamp.auto_cast(level="O2", dtype=FP16):
        a, n = jm(ids, None, None, None, mlm)
        loss = a + JF.cross_entropy(n, nsp)
    scaler.scale(loss).backward()
    if plant is not None:
        p = dict(jm.named_parameters())[plant]
        p.grad._value = p.grad._value.at[(0,) * p.grad._value.ndim].set(
            np.inf)
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    return float(loss.detach()), casts


def _port_bert_step(tm, opt, scaler, batch, plant=None):
    ids, mlm, nsp = (torch.from_numpy(x) for x in batch)
    with _recording(tamp) as casts, tamp.auto_cast(level="O2", dtype=FP16):
        a, n = tm(ids, None, None, None, mlm)
        loss = T.add(a, F.cross_entropy(n, nsp))
    scaler.scale(loss).backward()
    if plant is not None:
        g = dict(tm.named_parameters())[plant].grad
        g.view(-1)[0] = float("inf")
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    return float(loss.detach()), casts


def _bits(model, port):
    if port:
        return {n: p.detach().view(torch.int16).numpy().copy()
                for n, p in model.named_parameters()}
    return {n: np.asarray(p._value).view(np.int16).copy()
            for n, p in model.named_parameters()}


# -------------------------------------------------------------- cases
def check_bert_o2_fp16_steps_match_reference():
    jm, jo, tm, to = _berts()
    js = jamp.GradScaler(init_loss_scaling=2.0 ** 10)
    ts = tamp.GradScaler(init_loss_scaling=2.0 ** 10)
    batch = _bert_batch()
    for i in range(STEPS):
        jl, jc = _jax_bert_step(jm, jo, js, batch)
        tl, tc = _port_bert_step(tm, to, ts, batch)
        assert tc == jc, f"step {i}: " + _diff(jc, tc)
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (i, tl, jl)
        assert not js.last_step_skipped and not ts.last_step_skipped, i
    assert ts.host_reads == STEPS, ts.host_reads


def check_planted_inf_skips_and_halves_on_both_sides():
    jm, jo, tm, to = _berts()
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    batch = _bert_batch(1)
    plant = "bert.encoder.layers.0.linear1.weight"
    assert plant in dict(tm.named_parameters()), plant
    jb, tb = _bits(jm, False), _bits(tm, True)
    _jax_bert_step(jm, jo, js, batch, plant)
    _port_bert_step(tm, to, ts, batch, plant)
    assert js.last_step_skipped and ts.last_step_skipped
    for side, before, model, port in (("reference", jb, jm, False),
                                      ("port", tb, tm, True)):
        after = _bits(model, port)
        for n in before:
            assert np.array_equal(before[n], after[n]), (side, n)
    assert js.state_dict()["scale"] == ts.state_dict()["scale"] == 2.0 ** 9
    scales = []
    for _ in range(2):      # two good steps grow the scale
        _jax_bert_step(jm, jo, js, batch)
        _port_bert_step(tm, to, ts, batch)
        scales.append((js.state_dict()["scale"], ts.state_dict()["scale"]))
    assert scales == [(2.0 ** 9,) * 2, (2.0 ** 10,) * 2], scales


def check_unscale_one_read_and_same_bits():
    """``unscale_`` against the per-parameter form it replaced."""
    rs = np.random.RandomState(4)
    shapes = [(5, 3), (7,), (2, 2, 3)]
    dtypes = [torch.float16, torch.float32, torch.float16]
    params = [torch.nn.Parameter(torch.zeros(sh, dtype=dt))
              for sh, dt in zip(shapes, dtypes)]
    grads = [torch.from_numpy(rs.randn(*sh).astype(np.float32) * 3e3
                              ).to(dt) for sh, dt in zip(shapes, dtypes)]
    opt = AdamW(learning_rate=LR, parameters=params)
    for poison in (None, float("nan")):
        scaler = tamp.GradScaler(init_loss_scaling=2.0 ** 13)
        opt.clear_grad()
        for p, g in zip(params, grads):
            p.grad = g.clone()
        if poison is not None:
            params[1].grad[3] = poison
        # the reference's unscale_ leaves each gradient as its fp32
        # product (paddle_tpu/amp/__init__.py:161)
        want = [p.grad.to(torch.float32) * (1.0 / 2.0 ** 13)
                for p in params]
        scaler.unscale_(opt)
        scaler.unscale_(opt)            # once a step: a no-op
        assert scaler.host_reads == 1, scaler.host_reads
        assert scaler._found_inf == (poison is not None)
        for p, w in zip(params, want):
            assert p.grad.dtype == w.dtype
            assert torch.equal(p.grad.view(torch.int16 if w.element_size()
                                           == 2 else torch.int32),
                               w.view(torch.int16 if w.element_size() == 2
                                      else torch.int32)) or \
                (poison is not None and p is params[1])


def check_unscaled_grads_fp32_as_reference():
    """Queue C 1: after ``unscale_`` every gradient is the reference's
    fp32 product; what reads it between ``unscale_`` and ``step`` sees
    the reference's values; the gradient dtype of the next backward is
    the reference's, accumulated or after ``clear_grad()``; the step's
    update is the same."""
    import paddle_tpu_torch as PT
    from paddle_tpu.nn.utils import clip_grad_norm_ as jclip
    from paddle_tpu_torch.framework import device as port_device
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.nn.utils import clip_grad_norm_ as tclip

    rs = np.random.RandomState(11)
    w = rs.randn(4, 4).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    # a tiny input, a loss times 2^-13 (a normal fp16 value: a scalar
    # below fp16's range rounds to 0 in the reference's fp16 product) and
    # a scale of 2^15: the weight's unscaled gradient lies below fp16's
    # smallest subnormal
    x = (rs.randn(3, 4) * 2.0 ** -15).astype(np.float32)
    small = 2.0 ** -13
    jl = paddle.nn.Linear(4, 4)
    jl.weight.set_value(w)
    jl.bias.set_value(b)
    prev = list(port_device._CURRENT)
    PT.set_device("cpu")
    try:
        tl = Linear(4, 4)
    finally:
        port_device._CURRENT[:] = prev
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
        tl.bias.copy_(torch.from_numpy(b))
    jl = jamp.decorate(jl, level="O2", dtype=FP16)
    tl = tamp.decorate(tl, level="O2", dtype=FP16)
    jo = jopt.AdamW(learning_rate=LR, parameters=jl.parameters())
    to = AdamW(learning_rate=LR, parameters=tl.parameters())
    js, ts = (amp.GradScaler(init_loss_scaling=2.0 ** 15)
              for amp in (jamp, tamp))

    def backward(amp, layer, scaler, xin):
        with amp.auto_cast(level="O2", dtype=FP16):
            loss = layer(xin).sum() * small
        scaler.scale(loss).backward()

    def grads(layer, torch_side):
        out = []
        for p in layer.parameters():
            g = p.grad
            out.append(np.asarray(g.numpy() if torch_side
                                  else g._value).astype(np.float64))
        return out, [str(p.grad.dtype).split(".")[-1].replace(
            "paddle_tpu_", "") for p in layer.parameters()]

    backward(jamp, jl, js, paddle.to_tensor(x))
    backward(tamp, tl, ts, torch.from_numpy(x))
    js.unscale_(jo)
    ts.unscale_(to)
    (jg, jd), (tg, td) = grads(jl, False), grads(tl, True)
    assert td == ["float32", "float32"], td
    assert jd == td, (jd, td)
    for a, c in zip(jg, tg):
        assert np.array_equal(a, c), (a, c)
    assert 0 < np.abs(tg[0]).max() < 2.0 ** -24, "not below fp16's range"
    jn = float(jclip(list(jl.parameters()), 1.0))
    tn = float(tclip(list(tl.parameters()), 1.0))
    assert tn > 0 and abs(tn - jn) <= 1e-6 * jn, (jn, tn)
    # a backward that accumulates onto the unscaled gradients
    backward(jamp, jl, js, paddle.to_tensor(x))
    backward(tamp, tl, ts, torch.from_numpy(x))
    (_, jd), (_, td) = grads(jl, False), grads(tl, True)
    assert jd == td, ("accumulated", jd, td)
    js.step(jo)
    ts.step(to)
    js.update()
    ts.update()
    for p, q in zip(jl.parameters(), tl.parameters()):
        assert np.array_equal(np.asarray(p._value).view(np.int16),
                              q.detach().numpy().view(np.int16))
    jo.clear_grad()
    to.clear_grad()
    backward(jamp, jl, js, paddle.to_tensor(x))
    backward(tamp, tl, ts, torch.from_numpy(x))
    (_, jd), (_, td) = grads(jl, False), grads(tl, True)
    assert td == ["float16", "float16"] and jd == td, ("cleared", jd, td)
    # widened again, then cleared by PyTorch's own idiom (``p.grad =
    # None``): the scaler puts the gradient dtype back at the next scale()
    ts.unscale_(to)
    for p in tl.parameters():
        p._value.grad = None
    backward(tamp, tl, ts, torch.from_numpy(x))
    assert grads(tl, True)[1] == ["float16", "float16"], "set to None"


def check_gpt_o1_fp16_step_matches_reference():
    jm = JaxGPT(jax_gpt_presets("gpt-test"), seed=3)
    tm = GPTForCausalLM(gpt_presets("gpt-test"), seed=3, device="cpu")
    rs = np.random.RandomState(8)
    ids, labels = (rs.randint(0, 256, (2, 32)) for _ in range(2))
    with _recording(jamp) as jc, jamp.auto_cast(level="O1", dtype=FP16):
        jl = JaxGPTCriterion()(jm(_jt(ids)), _jt(labels))
    jl.backward()
    with _recording(tamp) as tc, tamp.auto_cast(level="O1", dtype=FP16):
        tl = GPTPretrainingCriterion()(tm(torch.from_numpy(ids)),
                                       torch.from_numpy(labels))
    tl.backward()
    assert tc == jc and len(tc) >= 7, _diff(jc, tc)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))


def test_amp_fp16_port_matches_reference(fresh_mesh):
    run_checks([
        (check_bert_o2_fp16_steps_match_reference, ()),
        (check_planted_inf_skips_and_halves_on_both_sides, ()),
        (check_unscale_one_read_and_same_bits, ()),
        (check_unscaled_grads_fp32_as_reference, ()),
        (check_gpt_o1_fp16_step_matches_reference, ()),
    ])
