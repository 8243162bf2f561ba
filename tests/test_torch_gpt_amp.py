"""Port GPT under ``paddle.amp`` (``paddle_tpu_torch``: the cast points of
``models/gpt.py`` under the reference's op names "gpt_embed",
"gpt_block", "gpt_logits" and "gpt_loss", dropout's "clone", the final
norm's "layer_norm", the fused loss's "reshape" and
"fused_linear_cross_entropy"; the GEMM settings of the cast operands)
against the JAX reference on the CPU, at ``gpt-test`` size (2 layers,
hidden 64, 4 heads of 16, vocab 256), seed 0, batch 2 x 32 from
``RandomState(0)``, weights carried from the reference with
``state_dict_from_numpy``, AdamW lr 1e-3.

Cases and tolerances (the measured value beside each):

- Cast sequence: ``amp_cast_inputs`` wrapped on both sides records each
  cast point's op name, input dtypes and output dtypes (integer dtypes
  as "int": JAX runs int32). Under O1 and O2, unfused, with
  ``fused_loss_chunk=128`` and with ``recompute``, the port's eager
  forward, loss and backward record exactly the reference's eager step
  (7 casts unfused, 8 fused); the port's ``TrainStep`` records the same
  as its eager step.
- Eval logits: under O2 bf16, as the reference's, within 1e-2 of the
  larger of 1 and their largest (``tests/test_torch_bf16_train.py``'s
  forward tolerance; measured 3.9e-3, one bf16 ulp: the reference runs
  its einsum attention on the CPU in bf16, the port the flash kernels'
  plain versions); under O1 fp32 and bit for bit the port's forward
  without amp (no GPT op is on the white list), within 1e-5 of the
  reference's (measured 2.4e-7).
- One O2 eager step (forward, ``backward()``, ``step()``), unfused,
  fused and with ``recompute``: the loss within 3e-4 relative of the
  reference's eager step (ROADMAP's bf16 CPU rule; measured 1.1e-5
  unfused and with recompute, 1.3e-5 fused), and the first update held
  as ``tests/test_torch_bert_train.py`` holds BERT's
  (``torch_checks.bf16_step_parity``): every gradient within 3e-2 of
  its tensor's largest (measured 2.2e-2, a block's ``fc1_b``), the
  query and key thirds of ``qkv_w`` and ``qkv_b`` and the value bias
  within 0.15 (measured 1.8e-2 and 3.4e-2: the first two get their
  gradient only through the scores, the value bias its gradient as a sum
  over the batch's 64 positions of near-cancelling bf16 terms, at 3.4e-2
  on the reference's einsum attention too), the key bias left out (its
  gradient is zero in exact arithmetic: noise on both sides). The
  reference's compiled ``TrainStep`` keeps its bf16 ops in fp32 (XLA
  excess precision), so its eager step is the yardstick, as for BERT.
- ``decorate(level="O2")``: the port's parameters bf16 and bit for bit
  the reference's decorated ones; a forward of the decorated models
  under O2 records the reference's casts, its logits within the
  tolerance above.
- GEMM settings: with the caller's flags opposite, every ``@`` of an
  fp32 model's forward and every matmul node of its backward runs at
  bf16's settings under O2 (TF32 on for fp32 GEMMs, no reduced-precision
  reduction: the blocks and the LM head are bf16 GEMMs) and at fp32's
  under O1 (einsum attention, so that every product is a GEMM); the
  caller's flags are back after each pass.

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import contextlib

import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.optimizer as jopt
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt_presets as jax_presets
import paddle_tpu_torch.amp as tamp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_presets, state_dict_from_numpy)
from paddle_tpu_torch.optimizer import AdamW
from test_torch_bf16_train import _flags, _gemm_nodes, _set_flags
from torch_checks import bf16_step_parity, run_checks

torch.set_num_threads(2)

B, S = 2, 32
LR = 1e-3
LOSS_RTOL = 3e-4
LOGITS_TOL = 1e-2          # of the larger of 1 and the largest logit
GRAD_RTOL = 3e-2           # the first step's gradients, of each largest
QK_GRAD_RTOL = 0.15        # the query and key thirds, the value bias
VARIANTS = {"unfused": {}, "fused": {"fused_loss_chunk": 128},
            "recompute": {"recompute": True}}


# ------------------------------------------------------------ helpers
def _carried(**over):
    """The reference's GPT and the port's loaded with its weights."""
    jm = JaxGPT(jax_presets("gpt-test", **over), seed=0)
    params = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    cfg = gpt_presets("gpt-test", **over)
    tm = GPTForCausalLM(cfg, seed=0, device="cpu")
    tm.load_state_dict(state_dict_from_numpy(params, cfg))
    return jm, tm


def _batch():
    rs = np.random.RandomState(0)
    return rs.randint(0, 256, (B, S)), rs.randint(0, 256, (B, S))


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


def _jt(x):
    return paddle.to_tensor(x, dtype="int64")


def _jax_loss(jm, fused, ids, labels):
    if fused:
        return jm(_jt(ids), labels=_jt(labels))
    return JaxCriterion()(jm(_jt(ids)), _jt(labels))


def _port_loss(tm, fused, ids, labels):
    ids, labels = torch.from_numpy(ids), torch.from_numpy(labels)
    if fused:
        return tm(ids, labels=labels)
    return GPTPretrainingCriterion()(tm(ids), labels)


def _jax_step(jm, level, fused):
    """The reference's eager step: loss, casts and, per parameter,
    (before, after, gradient)."""
    ids, labels = _batch()
    opt = jopt.AdamW(learning_rate=LR, parameters=jm.parameters())
    before = {n: np.asarray(p._value).astype(np.float32)
              for n, p in jm.named_parameters()}
    with _recording(jamp) as seen, jamp.auto_cast(level=level):
        loss = _jax_loss(jm, fused, ids, labels)
    loss.backward()
    grads = {n: np.asarray(p.grad._value).astype(np.float32)
             for n, p in jm.named_parameters()}
    opt.step()
    first = {n: tuple(torch.from_numpy(v) for v in
                      (before[n], np.asarray(p._value).astype(np.float32),
                       grads[n]))
             for n, p in jm.named_parameters()}
    return float(loss), seen, first


def _port_step(tm, level, fused):
    ids, labels = _batch()
    opt = AdamW(learning_rate=LR, parameters=tm.parameters())
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    with _recording(tamp) as seen, tamp.auto_cast(level=level):
        loss = _port_loss(tm, fused, ids, labels)
    loss.backward()
    opt.step()
    first = {n: (before[n], p.detach().clone(), p.grad.detach().clone())
             for n, p in tm.named_parameters()}
    return loss.item(), seen, first


def _diff(want, got):
    for i, (w, g) in enumerate(zip(want, got)):
        if w != g:
            return f"cast {i}: reference {w}, port {g}"
    return f"{len(want)} casts in the reference, {len(got)} in the port"


def _split_qkv(step):
    """``(before, after, gradient)`` per parameter with ``qkv_w`` and
    ``qkv_b`` cut into their query, key and value thirds."""
    out = {}
    for n, ts in step.items():
        if n.endswith(("qkv_w", "qkv_b")):
            axis = 1 if n.endswith("qkv_w") else 0
            for i, part in enumerate("qkv"):
                out[f"{n}.{part}"] = tuple(t.select(axis, i) for t in ts)
        else:
            out[n] = ts
    return out


# -------------------------------------------------------------- cases
def check_casts_match_reference(level, variant):
    """The port's eager step and its TrainStep cast as the reference's
    eager step, op for op."""
    over = VARIANTS[variant]
    fused = "fused_loss_chunk" in over
    jm, tm = _carried(**over)
    _, want, _ = _jax_step(jm, level, fused)
    _, got, _ = _port_step(tm, level, fused)
    assert got == want, _diff(want, got)
    assert len(got) == (8 if fused else 7), len(got)
    assert got[0][0] == "gpt_embed" and ("gpt_block" in
                                          [op for op, _, _ in got])
    _, tm2 = _carried(**over)
    ids, labels = _batch()
    loss_fn = ((lambda loss: loss) if fused
               else GPTPretrainingCriterion())
    step = TrainStep(tm2, loss_fn, AdamW(learning_rate=LR,
                                         parameters=tm2.parameters()))
    with _recording(tamp) as traced, tamp.auto_cast(level=level):
        if fused:
            step(inputs=(ids, None, labels), labels=())
        else:
            step(inputs=(ids,), labels=(labels,))
    assert traced == got, _diff(got, traced)


def check_o2_step_matches_reference(variant):
    over = VARIANTS[variant]
    fused = "fused_loss_chunk" in over
    jm, tm = _carried(**over)
    jloss, _, ref = _jax_step(jm, "O2", fused)
    loss, _, ours = _port_step(tm, "O2", fused)
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (variant, loss,
                                                         jloss)
    ref, ours = _split_qkv(ref), _split_qkv(ours)
    keys = [n for n in ref if n.endswith("qkv_b.k")]
    qk = [n for n in ref if n not in keys
          and n.endswith((".q", ".k", "qkv_b.v"))]
    rest = [n for n in ref if n not in keys and n not in qk]
    bf16_step_parity({n: ours[n] for n in rest}, {n: ref[n] for n in rest},
                     LR, grad_rtol=GRAD_RTOL)
    bf16_step_parity({n: ours[n] for n in qk}, {n: ref[n] for n in qk}, LR,
                     grad_rtol=QK_GRAD_RTOL)


def _within(got, want, what):
    top = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= LOGITS_TOL * top, f"{what}: {err:.3e} (largest {top})"


def check_eval_logits_match_reference(level):
    jm, tm = _carried()
    jm.eval()
    tm.eval()
    ids, _ = _batch()
    with jamp.auto_cast(level=level):
        jl = jm(_jt(ids))
    with tamp.auto_cast(level=level), torch.no_grad():
        tl = tm(torch.from_numpy(ids))
    with torch.no_grad():
        plain = tm(torch.from_numpy(ids))
    want = np.asarray(jl._value).astype(np.float32)
    if level == "O2":
        assert str(jl._value.dtype) == "bfloat16"
        assert tl.dtype == torch.bfloat16, tl.dtype
        _within(tl.float().numpy(), want, "O2 logits")
        return
    assert tl.dtype == torch.float32 and torch.equal(tl, plain)
    assert float(np.abs(tl.numpy() - want).max()) <= 1e-5


def check_decorate_matches_reference():
    jm, tm = _carried()
    jamp.decorate(jm, level="O2")
    tamp.decorate(tm, level="O2")
    jp = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16, n
        assert np.array_equal(p.detach().view(torch.int16).numpy(),
                              jp[n].view(np.int16)), n
    ids, _ = _batch()
    with _recording(jamp) as jc, jamp.auto_cast(level="O2"):
        jl = jm(_jt(ids))
    with _recording(tamp) as tc, tamp.auto_cast(level="O2"), \
            torch.no_grad():
        tl = tm(torch.from_numpy(ids))
    assert tc == jc, _diff(jc, tc)
    assert tl.dtype == torch.bfloat16
    _within(tl.float().numpy(), np.asarray(jl._value).astype(np.float32),
            "decorated O2 logits")


def check_gemm_settings_follow_the_cast(level):
    want = (level == "O2", False, False)
    caller = (not want[0], True, True)
    saved = _flags()
    cfg = gpt_presets("gpt-test", use_flash_attention=False)
    model = GPTForCausalLM(cfg, seed=0, device="cpu")
    ids, labels = _batch()
    fwd, bwd = [], []
    real = torch.Tensor.__matmul__

    def spy(a, b):
        fwd.append(_flags())
        return real(a, b)

    try:
        _set_flags(caller)
        torch.Tensor.__matmul__ = spy
        try:
            with tamp.auto_cast(level=level):
                loss = _port_loss(model, False, ids, labels)
        finally:
            torch.Tensor.__matmul__ = real
        assert _flags() == caller
        nodes = _gemm_nodes(loss.grad_fn)
        for node in nodes:
            node.register_prehook(lambda grads: bwd.append(_flags()))
        loss.backward()
        assert len(fwd) == 4 * cfg.num_layers + 1, len(fwd)
        assert len(bwd) == 6 * cfg.num_layers + 1, len(bwd)
        assert set(fwd) == set(bwd) == {want}, (set(fwd), set(bwd))
        assert _flags() == caller
    finally:
        _set_flags(saved)


def test_gpt_amp_port_matches_reference(fresh_mesh):
    run_checks(
        [(check_casts_match_reference, (level, v))
         for level in ("O2", "O1") for v in VARIANTS]
        + [(check_o2_step_matches_reference, (v,)) for v in VARIANTS]
        + [(check_eval_logits_match_reference, (level,))
           for level in ("O2", "O1")]
        + [(check_decorate_matches_reference, ())]
        + [(check_gemm_settings_follow_the_cast, (level,))
           for level in ("O2", "O1")])
