"""Port training path (``paddle_tpu_torch``: GPT forward, criterion,
flash attention, AdamW, ``FusedFlatUpdater``, ``TrainStep``) against the
JAX reference on the CPU, at ``gpt-test`` size (2 layers, hidden 64,
4 heads of 16), batch 2 x 32 tokens, inputs made with numpy.

- Forward: port logits (flash attention, plain version on the CPU) and
  criterion loss, with and without ``loss_mask``, against the JAX model
  on the same converted weights (the JAX model runs its einsum attention
  on the CPU). Tolerance 1e-5 max abs on logits, 1e-5 relative on loss.
- Gradients: port autograd against the JAX model's gradients of the same
  loss (``loss.backward()``, ``jax.vjp`` underneath). Tolerance 1e-5 max
  abs.
- Training: 3 ``TrainStep`` steps (AdamW lr 1e-3, wd 0.01) against the
  JAX ``TrainStep`` from the same weights and batch, and 2 steps with
  ``grad_accum_steps=2``. Loss at every step within 1e-5 relative,
  parameters within 2e-5 max abs after the last step. The first plain
  step is also held by ``tests/torch_checks.py`` ``adam_step_parity``
  at its defaults (each side's parameters before and after the step, and
  its gradients of the step's loss from a second model on the same
  weights): every gradient within 1e-4 of its tensor's largest, and
  every element whose gradient is clear of the gradient noise moved by
  the reference's step within 1e-2 lr and by at least 0.9 lr. Why the
  flat parameter tolerance is not 1e-5:
  Adam's first steps move a weight by lr * g / (|g| + 1e-8), about lr
  whatever the gradient's size, so a weight whose gradient is at fp32
  noise level moves by an amount set by that noise. Measured: a
  ``fc2_w`` gradient of -2.130e-8 on the JAX side and -2.200e-8 on the
  port's (7e-10 apart, against a largest gradient of 0.022) gives steps
  7.0e-6 apart; the largest parameter difference is 1.06e-5 after one
  accumulated step and 8.5e-6 after three plain steps.
- The port's training forward equals its own serving ``forced_logits``
  (1e-5) and its einsum attention path (``use_flash_attention=False``).
- The options still left out raise ``NotImplementedError`` naming their
  ROADMAP item (``grad_comm``, ported since, takes only a config or a
  codec name; ``recompute``, ``fused_loss_chunk`` and ``grad_clip``,
  ported since, are held in ``tests/test_torch_train_options.py``).

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt_presets as jax_presets
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_presets, state_dict_from_numpy)
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.serving import GPTDecodeModel
from torch_checks import adam_step_parity, run_checks

torch.set_num_threads(2)

TOL = 1e-5
PARAM_TOL = 2e-5
SEED = 3


def _batch(seed=0, b=2, s=32, vocab=256):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, (b, s)).astype(np.int64),
            rs.randint(0, vocab, (b, s)).astype(np.int64))


def _jax_params(model):
    return {n: np.asarray(p._value) for n, p in model.named_parameters()}


def _models(cfg_overrides=None):
    """(JAX model, port model on the JAX model's converted weights)."""
    over = cfg_overrides or {}
    jm = JaxGPT(jax_presets("gpt-test", **over), seed=SEED)
    cfg = gpt_presets("gpt-test", **over)
    tm = GPTForCausalLM(cfg, seed=SEED + 1, device="cpu")
    tm.load_state_dict(state_dict_from_numpy(_jax_params(jm), cfg))
    return jm, tm


def _close(a, b, what, tol=TOL):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= tol, f"{what}: max abs diff {err} > {tol}"


def _rel(a, b, what, tol=TOL):
    a, b = float(a), float(torch.as_tensor(b).detach())
    assert abs(a - b) <= tol * abs(a), f"{what}: {b} vs {a}"


def check_forward_and_loss_match_jax():
    jm, tm = _models()
    ids, labels = _batch()
    mask = (np.random.RandomState(9).rand(*ids.shape) > 0.3
            ).astype(np.float32)
    jlog = jm(paddle.to_tensor(ids))
    tlog = tm(torch.from_numpy(ids))
    _close(np.asarray(jlog._value), tlog, "logits")
    jc, tc = JaxCriterion(), GPTPretrainingCriterion()
    _rel(float(jc(jlog, paddle.to_tensor(labels))),
         tc(tlog, torch.from_numpy(labels)), "loss")
    _rel(float(jc(jlog, paddle.to_tensor(labels), paddle.to_tensor(mask))),
         tc(tlog, torch.from_numpy(labels), torch.from_numpy(mask)),
         "masked loss")


def check_gradients_match_jax():
    jm, tm = _models()
    ids, labels = _batch(1)
    JaxCriterion()(jm(paddle.to_tensor(ids)),
                   paddle.to_tensor(labels)).backward()
    GPTPretrainingCriterion()(tm(torch.from_numpy(ids)),
                              torch.from_numpy(labels)).backward()
    jgrads = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()}
    tgrads = dict(tm.named_parameters())
    assert set(jgrads) == set(tgrads)
    for name, g in jgrads.items():
        _close(g, tgrads[name].grad, f"grad {name}")


def _grads(ids, labels):
    """Each side's gradients of the loss on (ids, labels), from a fresh
    pair of models on the weights ``_models()`` gives."""
    jm, tm = _models()
    JaxCriterion()(jm(paddle.to_tensor(ids)),
                   paddle.to_tensor(labels)).backward()
    GPTPretrainingCriterion()(tm(torch.from_numpy(ids)),
                              torch.from_numpy(labels)).backward()
    return ({n: torch.from_numpy(np.array(p.grad._value))
             for n, p in jm.named_parameters()},
            {n: p.grad.detach().clone() for n, p in tm.named_parameters()})


def _jax_state(jm):
    return {n: torch.from_numpy(v.copy()) for n, v in _jax_params(jm).items()}


def _train_both(steps, accum):
    jm, tm = _models()
    ids, labels = _batch(2, b=4 if accum > 1 else 2)
    if accum == 1:
        jgrad, tgrad = _grads(ids, labels)
        jbefore = _jax_state(jm)
        tbefore = {n: p.detach().clone() for n, p in tm.named_parameters()}
    jo = jopt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                    parameters=jm.parameters())
    jcrit = JaxCriterion()
    jstep = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb), jo,
                         grad_accum_steps=accum)
    to = AdamW(learning_rate=1e-3, weight_decay=0.01,
               parameters=tm.parameters())
    tstep = TrainStep(tm, GPTPretrainingCriterion(), to,
                      grad_accum_steps=accum)
    for i in range(steps):
        jl = jstep(inputs=(paddle.to_tensor(ids),),
                   labels=(paddle.to_tensor(labels),))
        tl = tstep(inputs=(ids,), labels=(labels,))
        _rel(float(jl), tl, f"loss at step {i}")
        if i == 0 and accum == 1:
            jafter = _jax_state(jm)
            adam_step_parity(
                {n: (tbefore[n], p.detach().clone(), tgrad[n])
                 for n, p in tm.named_parameters()},
                {n: (jbefore[n], jafter[n], jgrad[n]) for n in jbefore},
                lr=1e-3)
    tparams = dict(tm.named_parameters())
    for name, p in jm.named_parameters():
        _close(np.asarray(p._value), tparams[name], f"param {name}",
               PARAM_TOL)
    return tstep


def check_train_steps_match_jax():
    tstep = _train_both(3, 1)
    # one uniform (lr_mult, wd) group: the reference's bucket plan
    assert [b.param_indices for b in tstep.buckets] == [list(range(27, -1,
                                                                  -1))]


def check_grad_accum_matches_jax():
    _train_both(2, 2)


def check_mixed_hypers_get_uniform_buckets():
    _, tm = _models()
    tm.gpt.embeddings.position_embeddings.optimize_attr = {
        "learning_rate": 0.5}
    o = SGD(learning_rate=1e-2, parameters=tm.parameters())
    step = TrainStep(tm, GPTPretrainingCriterion(), o)
    assert len(step.buckets) == 2
    ids, labels = _batch(4)
    before = tm.gpt.embeddings.position_embeddings.detach().clone()
    for p in tm.parameters():
        p.grad = None
    GPTPretrainingCriterion()(tm(torch.from_numpy(ids)),
                              torch.from_numpy(labels)).backward()
    g = tm.gpt.embeddings.position_embeddings.grad.clone()
    step(inputs=(ids,), labels=(labels,))
    lr = torch.tensor(1e-2) * 0.5
    _close(before - lr * g, tm.gpt.embeddings.position_embeddings,
           "position embeddings at lr_mult 0.5", 1e-7)


def check_training_forward_matches_serving_and_einsum_path():
    _, tm = _models()
    ids, _ = _batch(5)
    logits = tm(torch.from_numpy(ids))
    _close(GPTDecodeModel(tm).forced_logits(ids).numpy(), logits,
           "serving forced_logits")
    tm.config.use_flash_attention = False
    try:
        _close(tm(torch.from_numpy(ids)).detach().numpy(), logits,
               "einsum attention")
    finally:
        tm.config.use_flash_attention = True


def check_left_out_options_raise():
    ids, _ = _batch()
    for over in ({"dropout": 0.1}, {"attn_dropout": 0.1}, {"mode": "scan"},
                 {"use_ring_attention": True},
                 {"use_ulysses_attention": True}):
        tm = GPTForCausalLM(gpt_presets("gpt-test", **over), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tm(torch.from_numpy(ids))
    with pytest.raises(NotImplementedError, match="training options"):
        GPTForCausalLM(gpt_presets("gpt-test",
                                   recompute_policy=("remat", "none")),
                       device="cpu")
    # recompute, fused_loss_chunk and grad_clip are ported
    # (tests/test_torch_train_options.py)
    tm = GPTForCausalLM(gpt_presets("gpt-test"), device="cpu")
    o = AdamW(parameters=tm.parameters())
    for kw in ("batch_spec", "grad_fn"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TrainStep(tm, GPTPretrainingCriterion(), o, **{kw: object()})
    # grad_comm is ported (tests/test_torch_dp_train.py); it takes a
    # GradCommConfig or a codec name
    with pytest.raises(TypeError, match="GradCommConfig"):
        TrainStep(tm, GPTPretrainingCriterion(), o, grad_comm=object())


def test_train_port_matches_reference(fresh_mesh):
    run_checks([(check_forward_and_loss_match_jax, ()),
                (check_gradients_match_jax, ()),
                (check_train_steps_match_jax, ()),
                (check_grad_accum_matches_jax, ()),
                (check_mixed_hypers_get_uniform_buckets, ()),
                (check_training_forward_matches_serving_and_einsum_path, ()),
                (check_left_out_options_raise, ())])
