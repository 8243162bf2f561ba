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
  (``host_reads``) and writes the unscaled gradients bit for bit as the
  per-parameter form did (each gradient lifted to fp32, times 1/scale,
  rounded back to its dtype), and finds a planted NaN.
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
        for p, g in zip(params, grads):
            p.grad = g.clone()
        if poison is not None:
            params[1].grad[3] = poison
        want = [(p.grad.to(torch.float32) * (1.0 / 2.0 ** 13)
                 ).to(p.grad.dtype) for p in params]
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
        (check_gpt_o1_fp16_step_matches_reference, ()),
    ])
