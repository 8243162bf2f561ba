"""Port training options (``paddle_tpu_torch``: the chunked
``fused_linear_cross_entropy`` with its two chunk kernels' plain versions,
``GPTConfig.fused_loss_chunk`` and ``recompute``, the learning-rate
schedulers, the ``ClipGradBy*`` clips in the eager ``Optimizer.step()``
and in ``TrainStep``) against the JAX reference on the CPU, at
``gpt-test`` size, inputs made with numpy. Each case states its limit:

- ``fused_linear_cross_entropy`` against the reference's (N 48, H 16,
  V 77): bias and none, ``transposed_weight`` both ways,
  ``ignore_index``, the three reductions, chunks of 16 (a ragged last
  chunk of 13 columns against the reference's padded one), 77 and 100;
  the loss and ``dx``, ``dW``, ``db`` from the reference's ``backward``.
  fp32: within 1e-5 (the loss relative, the gradients absolute). A bf16
  weight and bias (fp32 ``x``, as GPT feeds it): the loss within 1e-5
  relative (the products are fp32), ``dx`` within 1e-5, and every
  element of the bf16 ``dW`` and ``db`` within one bf16 ulp of the
  reference's (both round one fp32 sum once; the fp32 sums differ by
  rounding, so a few elements land on the neighbouring bf16 value).
  Labels out of ``[0, V)`` give NaN at their positions only; a bad
  reduction raises ``ValueError``.
- ``ops/fused_ce.py``'s plain versions against the reference's scan
  bodies (``paddle_tpu/incubate/nn/functional.py:231-249`` and
  ``:266-279``, transcribed in jnp) chunk by chunk, the reference's last
  chunk padded with ``-inf`` columns, the port's ragged: the running
  max, sum and picked logit, and each chunk's dlogit within 1e-6
  relative (the same ops; the sums' order differs).
- GPT with ``fused_loss_chunk=16``: the loss against the reference
  model's fused loss and the port's own unfused
  ``GPTPretrainingCriterion`` (fp32 within 1e-5 relative, bf16 3e-4,
  the bf16 rule of ``tests/test_torch_bf16_train.py``); 3 steps of
  ``bench.py``'s form (``TrainStep(model, lambda loss: loss, opt)``,
  ``inputs=(ids, None, labels)``) against the reference's, the losses
  within the same limits.
- The fused loss's GEMM settings: its chunk GEMMs and every GEMM of the
  blocks' backward at the model dtype's settings while the caller has
  set the opposite, the caller's flags back after the forward and the
  backward (its backward node enters them: there is no logits node).
- ``recompute=True``: the port's gradients bit-identical to its own
  without recompute (unfused and fused loss, fp32 and bf16); 3 steps
  against the reference's ``recompute=True``, the losses as above.
- Every ``LRScheduler`` over 30 steps, ``step(epoch=)`` and a
  ``state_dict`` round trip: equal to the reference's float for float.
  ``set_lr`` under a scheduler raises, ``set_lr_scheduler`` swaps it, a
  fused updater refuses a ``grad_clip`` and makes a new lr tensor when
  the rate moves.
- Each ``ClipGradBy*`` (global norm 1.0, norm 0.1, value 0.02: each
  binds on these gradients, whose global norm is ~1.9), fp32 and bf16,
  SGD at lr 0.1 (the update is the clipped gradient itself; Adam would
  hide a scale). Two eager ``Optimizer.step()`` on both sides from the
  same gradients, the reference's op by op: fp32 parameters within
  1e-6, bf16 ones within one bf16 ulp. Two ``TrainStep`` steps (plain
  and ``grad_accum_steps=2``) against the reference's: fp32 parameters
  within 1e-6; in bf16 the losses within 3e-4, the fp32 final norm
  within 1e-2 lr and the share of
  bf16 elements within one ulp of the reference's no less than a
  no-clip control's less 2 points (``check_clip_train_step_matches``
  says why). The port's global norm sums the buckets' squares, the
  reference the parameters': fp32 rounding, inside these limits.
  ``TrainStep(grad_comm="int8_block")`` with a global-norm clip at
  world 2 (two gloo ranks, ``tests/torch_dp_workers.py``) against the
  reference's ``TrainStep(grad_comm=)`` with the same clip,
  ``FLAGS_kernel_autotune`` on and off (the reference turns its fused
  path off under a clip, and so does the port: ``_gc_fused`` False):
  the rule of ``tests/test_torch_dp_train.py`` (losses within 1e-5
  relative, 99.9% of the parameters within rtol 1e-6 / atol 1e-7: the
  local gradients differ by fp32 rounding, which moves an int8 level of
  the wire here and there).
- The losses of the table measured on the reference for this slice
  (``gpt-test``, seed 0, batch 2 x 32 from ``RandomState(0)``, AdamW lr
  1e-3, 3 steps; fused chunk 16, recompute, ``LinearWarmup(
  CosineAnnealingDecay)`` from lr 0 over 2 steps and
  ``ClipGradByGlobalNorm(1.0)``): the port's within 1e-5 relative in
  fp32 and 3e-4 in bf16.

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed.mesh as mesh_mod
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
import paddle_tpu.optimizer.lr as jlr
from paddle_tpu.framework import flags as jflags
from paddle_tpu.incubate.nn.functional import \
    fused_linear_cross_entropy as jax_fused_ce
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt_presets as jax_presets
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.incubate.nn.functional import fused_linear_cross_entropy
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_presets, state_dict_from_numpy)
from paddle_tpu_torch.ops import fused_ce
from paddle_tpu_torch.optimizer import SGD, AdamW, FusedFlatUpdater
from paddle_tpu_torch.optimizer import lr as tlr
from test_torch_bf16_train import _flags, _gemm_nodes, _set_flags
from test_torch_dp_train import _held
from torch_checks import bf16_ulp, run_checks
import torch_dp_workers as workers

torch.set_num_threads(2)

RTOL = {"float32": 1e-5, "bfloat16": 3e-4}   # losses, relative
TOL = 1e-5                                    # fp32 gradients, absolute
PARAM_TOL = 1e-6                              # fp32 parameters after SGD
SEED = 3
N, H, V = 48, 16, 77
CLIPS = {"global_norm": (tnn.ClipGradByGlobalNorm, jnn.ClipGradByGlobalNorm,
                         (1.0,)),
         "norm": (tnn.ClipGradByNorm, jnn.ClipGradByNorm, (0.1,)),
         "value": (tnn.ClipGradByValue, jnn.ClipGradByValue, (0.02,))}


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if hasattr(a, "_value"):
        a = a._value
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _abs_close(a, b, tol, what):
    a, b = _f32(a), _f32(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= tol, f"{what}: max abs diff {err:.3e} > {tol:.0e}"


def _rel_close(a, b, tol, what):
    a, b = float(a), float(b)
    assert abs(a - b) <= tol * abs(b), f"{what}: {a} vs {b}"


def _within_ulp(a, b, what):
    """Every element of the bf16 ``a`` within one bf16 ulp of ``b``."""
    a, b = _f32(a), _f32(b)
    lim = bf16_ulp(torch.from_numpy(np.maximum(np.abs(a), np.abs(b))))
    over = int((np.abs(a - b) > lim.numpy()).sum())
    assert not over, f"{what}: {over} elements more than one bf16 ulp apart"


def _close_param(a, b, dtype_name, what):
    if dtype_name == "bfloat16":
        _within_ulp(a, b, what)
    else:
        _abs_close(a, b, PARAM_TOL, what)


# ------------------------------------------------ fused_linear_cross_entropy
def _ce_inputs(seed, transposed, bias, ignore):
    rs = np.random.RandomState(seed)
    x = rs.randn(N, H).astype(np.float32)
    w = (rs.randn(*((V, H) if transposed else (H, V))) * 0.3
         ).astype(np.float32)
    b = (rs.randn(V) * 0.3).astype(np.float32) if bias else None
    lbl = rs.randint(0, V, (N,)).astype(np.int64)
    lbl[-1] = V - 1                  # a label in the last column
    if ignore:
        lbl[:7] = -100
    wts = rs.rand(N).astype(np.float32)   # cotangent of reduction='none'
    return x, w, b, lbl, wts


def check_fused_ce_matches_reference(dtype, transposed, bias, reduction,
                                     ignore, chunk):
    x, w, b, lbl, wts = _ce_inputs(chunk, transposed, bias, ignore)
    bf16 = dtype == "bfloat16"
    jw = paddle.to_tensor(w, dtype=dtype, stop_gradient=False)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jb = None if b is None else paddle.to_tensor(b, dtype=dtype,
                                                 stop_gradient=False)
    jout = jax_fused_ce(jx, jw, paddle.to_tensor(lbl), bias=jb,
                        vocab_chunk=chunk, reduction=reduction,
                        transposed_weight=transposed)
    tdt = getattr(torch, dtype)
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    tb = None if b is None else torch.from_numpy(b).to(tdt).requires_grad_()
    tout = fused_linear_cross_entropy(tx, tw, torch.from_numpy(lbl), bias=tb,
                                      vocab_chunk=chunk, reduction=reduction,
                                      transposed_weight=transposed)
    if reduction == "none":
        _abs_close(tout, jout, TOL, "per-position loss")
        (jout * paddle.to_tensor(wts)).sum().backward()
        (tout * torch.from_numpy(wts)).sum().backward()
    else:
        _rel_close(tout, float(jout), TOL, "loss")
        jout.backward()
        tout.backward()
    assert tx.grad.dtype == torch.float32 and tw.grad.dtype == tdt
    _abs_close(tx.grad, jx.grad, TOL, "dx")
    pairs = [("dW", tw.grad, jw.grad)]
    if b is not None:
        assert tb.grad.dtype == tdt
        pairs.append(("db", tb.grad, jb.grad))
    for what, tg, jg in pairs:
        if bf16:
            _within_ulp(tg, jg, what)
        else:
            _abs_close(tg, jg, TOL, what)


def check_fused_ce_out_of_range_and_bad_reduction():
    x, w, _, lbl, _ = _ce_inputs(1, True, False, False)
    lbl[0], lbl[1] = V, -3
    per = fused_linear_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(lbl),
        vocab_chunk=16, reduction="none", transposed_weight=True)
    jper = jax_fused_ce(paddle.to_tensor(x), paddle.to_tensor(w),
                        paddle.to_tensor(lbl), vocab_chunk=16,
                        reduction="none", transposed_weight=True)
    jp = _f32(jper)
    assert np.isnan(jp[:2]).all() and torch.isnan(per[:2]).all()
    _abs_close(per[2:], jp[2:], TOL, "in-range positions")
    with pytest.raises(ValueError):
        fused_linear_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(lbl), reduction="avg",
                                   transposed_weight=True)


def _ref_fwd_step(logit, lbl, carry, start, c, v):
    """``_fwd_state``'s step (functional.py:240-249) on one chunk's
    logits, the columns at or past ``v`` masked to -inf."""
    m, s, picked = carry
    col = jnp.arange(c) + start
    logit = jnp.where(col[None, :] < v, logit, -jnp.inf)
    m_new = jnp.maximum(m, jnp.max(logit, -1))
    s = s * jnp.exp(m - m_new) + jnp.sum(jnp.exp(logit - m_new[:, None]), -1)
    in_chunk = (lbl >= start) & (lbl < start + c)
    idx = jnp.clip(lbl - start, 0, c - 1)
    mine = jnp.take_along_axis(logit, idx[:, None], 1)[:, 0]
    return m_new, s, jnp.where(in_chunk, mine, picked)


def _ref_bwd_step(logit, lbl, lse, gf, start, c, v):
    """``_core_bwd``'s step (functional.py:275-279) on one chunk."""
    col = jnp.arange(c) + start
    valid = col[None, :] < v
    soft = jnp.where(valid, jnp.exp(logit - lse[:, None]), 0.0)
    onehot = (lbl[:, None] == col[None, :]).astype(jnp.float32)
    return (soft - onehot) * gf[:, None]


def check_chunk_plain_matches_reference_scan():
    rs = np.random.RandomState(5)
    c, v = 16, 77
    logits = (rs.randn(N, v) * 3).astype(np.float32)
    bias = (rs.randn(v) * 0.3).astype(np.float32)
    lbl = rs.randint(0, v, (N,)).astype(np.int32)
    lbl[0] = v - 1
    g = rs.rand(N).astype(np.float32)
    g[:5] = 0.0                                  # rows the mask drops
    m = torch.full((N,), float("-inf"))
    s, picked = torch.zeros(N), torch.zeros(N)
    carry = (jnp.full((N,), -jnp.inf), jnp.zeros((N,)), jnp.zeros((N,)))
    tl = torch.from_numpy(lbl)
    for start in range(0, v, c):
        cc = min(c, v - start)
        chunk = logits[:, start:start + cc] + bias[start:start + cc]
        padded = np.full((N, c), -np.inf, np.float32)
        padded[:, :cc] = chunk
        carry = _ref_fwd_step(jnp.asarray(padded), jnp.asarray(lbl), carry,
                              start, c, v)
        fused_ce.ce_chunk_fwd_plain(
            torch.from_numpy(logits[:, start:start + cc].copy()),
            torch.from_numpy(bias[start:start + cc].copy()), tl, start, m, s,
            picked)
        for what, t, j in (("m", m, carry[0]), ("s", s, carry[1]),
                           ("picked", picked, carry[2])):
            j = np.asarray(j)
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=0,
                                       err_msg=f"{what} after {start}")
    lse = m + torch.log(s)
    for start in range(0, v, c):
        cc = min(c, v - start)
        chunk = logits[:, start:start + cc] + bias[start:start + cc]
        padded = np.zeros((N, c), np.float32)
        padded[:, :cc] = chunk
        want = np.asarray(_ref_bwd_step(jnp.asarray(padded), jnp.asarray(lbl),
                                        jnp.asarray(lse.numpy()),
                                        jnp.asarray(g), start, c, v))
        got = torch.from_numpy(logits[:, start:start + cc].copy())
        fused_ce.ce_chunk_bwd_plain(got, torch.from_numpy(
            bias[start:start + cc].copy()), lse, tl, torch.from_numpy(g),
            start)
        np.testing.assert_allclose(got.numpy(), want[:, :cc], rtol=1e-6,
                                   atol=1e-7, err_msg=f"dlogit at {start}")
        assert not got[:5].any()


# ------------------------------------------------------------------- GPT
def _jax_params(model):
    return {n: np.asarray(p._value) for n, p in model.named_parameters()}


def _models(dtype="float32", **over):
    """(JAX model, port model on the JAX model's converted weights)."""
    over = dict(over, dtype=dtype)
    jm = JaxGPT(jax_presets("gpt-test", **over), seed=SEED)
    cfg = gpt_presets("gpt-test", **over)
    tm = GPTForCausalLM(cfg, seed=SEED + 1, device="cpu")
    tm.load_state_dict(state_dict_from_numpy(_jax_params(jm), cfg))
    return jm, tm


def _batch(seed, b=2, s=32):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (b, s)).astype(np.int64),
            rs.randint(0, 256, (b, s)).astype(np.int64))


def check_gpt_fused_loss_matches(dtype):
    jm, tm = _models(dtype, fused_loss_chunk=16)
    ids, labels = _batch(0)
    jl = float(jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels)))
    tl = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    _rel_close(tl, jl, RTOL[dtype], "fused loss vs the reference's")
    with torch.no_grad():
        unfused = GPTPretrainingCriterion()(tm(torch.from_numpy(ids)),
                                            torch.from_numpy(labels))
    _rel_close(tl, unfused, RTOL[dtype], "fused loss vs the port's unfused")


def _steps(jm, tm, ids, labels, steps, fused, lr=1e-3, **jopt_kw):
    """``steps`` of each side's TrainStep in ``bench.py``'s form (the
    fused loss) or with the criterion; returns both loss lists."""
    jo = jopt.AdamW(learning_rate=lr, weight_decay=0.01,
                    parameters=jm.parameters(), **jopt_kw)
    to = AdamW(learning_rate=lr, weight_decay=0.01,
               parameters=tm.parameters())
    if fused:
        jstep = JaxTrainStep(jm, lambda loss: loss, jo)
        tstep = TrainStep(tm, lambda loss: loss, to)
        jin = dict(inputs=(paddle.to_tensor(ids), None,
                           paddle.to_tensor(labels)), labels=())
        tin = dict(inputs=(ids, None, labels), labels=())
    else:
        jcrit = JaxCriterion()
        jstep = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb), jo)
        tstep = TrainStep(tm, GPTPretrainingCriterion(), to)
        jin = dict(inputs=(paddle.to_tensor(ids),),
                   labels=(paddle.to_tensor(labels),))
        tin = dict(inputs=(ids,), labels=(labels,))
    return ([float(jstep(**jin)) for _ in range(steps)],
            [float(tstep(**tin)) for _ in range(steps)])


def check_gpt_fused_train_matches(dtype):
    jm, tm = _models(dtype, fused_loss_chunk=16)
    ids, labels = _batch(2)
    jls, tls = _steps(jm, tm, ids, labels, 3, fused=True)
    for i, (t, j) in enumerate(zip(tls, jls)):
        _rel_close(t, j, RTOL[dtype], f"fused loss at step {i}")


def check_fused_loss_gemm_settings(dtype):
    """The fused loss's GEMMs and, through its backward node (the first
    of the pass: there is no logits node), every GEMM of the blocks'
    backward run at the model dtype's settings while the caller has set
    the opposite process-wide; the caller's flags are back after the
    forward and after the backward (``tests/test_torch_bf16_train.py``
    holds the unfused path the same way)."""
    saved = _flags()
    caller = (dtype == "float32", True, True)
    want = (dtype == "bfloat16", False, False)
    cfg = gpt_presets("gpt-test", dtype=dtype, fused_loss_chunk=64,
                      use_flash_attention=False)
    model = GPTForCausalLM(cfg, seed=0, device="cpu")
    ids, labels = _batch(6)
    chunk_mm, block_mm = [], []
    real = torch.matmul

    def spy(*args, **kwargs):
        chunk_mm.append(_flags())
        return real(*args, **kwargs)

    try:
        _set_flags(caller)
        with mock.patch("torch.matmul", spy):
            loss = model(torch.from_numpy(ids),
                         labels=torch.from_numpy(labels))
            assert _flags() == caller
            nodes = _gemm_nodes(loss.grad_fn)
            for node in nodes:
                node.register_prehook(
                    lambda grads: block_mm.append(_flags()))
            loss.backward()
        assert _flags() == caller
    finally:
        _set_flags(saved)
    # 4 chunks: their forward GEMMs, then in the backward each chunk's
    # recompute and dW; per layer 6 block GEMMs (einsum attention)
    assert len(chunk_mm) == 4 + 8, len(chunk_mm)
    assert len(nodes) == len(block_mm) == 6 * cfg.num_layers, len(block_mm)
    assert set(chunk_mm) == set(block_mm) == {want}, (set(chunk_mm),
                                                      set(block_mm))


def _grads(tm, ids, labels):
    tm.zero_grad()
    if tm.config.fused_loss_chunk:
        loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    else:
        loss = GPTPretrainingCriterion()(tm(torch.from_numpy(ids)),
                                         torch.from_numpy(labels))
    loss.backward()
    return {n: p.grad.clone() for n, p in tm.named_parameters()}


def check_recompute_gradients_same_bits(dtype, chunk):
    _, plain = _models(dtype, fused_loss_chunk=chunk)
    _, remat = _models(dtype, fused_loss_chunk=chunk, recompute=True)
    ids, labels = _batch(4)
    want, got = _grads(plain, ids, labels), _grads(remat, ids, labels)
    for n, g in want.items():
        assert torch.equal(got[n], g), f"{n}: recompute changed the bits"


def check_recompute_train_matches(dtype):
    jm, tm = _models(dtype, recompute=True)
    ids, labels = _batch(2)
    jls, tls = _steps(jm, tm, ids, labels, 3, fused=False)
    for i, (t, j) in enumerate(zip(tls, jls)):
        _rel_close(t, j, RTOL[dtype], f"recompute loss at step {i}")


# ------------------------------------------------------------- schedulers
def _schedulers(mod):
    return {
        "NoamDecay": lambda: mod.NoamDecay(64, 5, learning_rate=2.0),
        "PiecewiseDecay": lambda: mod.PiecewiseDecay([3, 9, 20],
                                                     [0.1, 0.05, 0.01, 1e-3]),
        "NaturalExpDecay": lambda: mod.NaturalExpDecay(0.5, 0.1),
        "InverseTimeDecay": lambda: mod.InverseTimeDecay(0.5, 0.1),
        "PolynomialDecay": lambda: mod.PolynomialDecay(0.1, 12, 1e-3, 2.0),
        "PolynomialDecay_cycle": lambda: mod.PolynomialDecay(
            0.1, 7, 1e-3, 1.5, cycle=True),
        "LinearWarmup": lambda: mod.LinearWarmup(0.1, 6, 0.0, 0.1),
        "LinearWarmup_cosine": lambda: mod.LinearWarmup(
            mod.CosineAnnealingDecay(1e-3, T_max=10), 4, 1e-5, 1e-3),
        "ExponentialDecay": lambda: mod.ExponentialDecay(0.1, 0.9),
        "MultiStepDecay": lambda: mod.MultiStepDecay(0.1, [4, 11, 17], 0.5),
        "StepDecay": lambda: mod.StepDecay(0.1, 4, 0.7),
        "LambdaDecay": lambda: mod.LambdaDecay(0.1, lambda e: 0.95 ** e),
        "MultiplicativeDecay": lambda: mod.MultiplicativeDecay(
            0.1, lambda e: 0.97),
        "CosineAnnealingDecay": lambda: mod.CosineAnnealingDecay(0.1, 13,
                                                                 1e-4),
        "OneCycleLR": lambda: mod.OneCycleLR(0.1, 25),
        "OneCycleLR_linear": lambda: mod.OneCycleLR(
            0.1, 25, anneal_strategy="linear", phase_pct=0.2),
        "CyclicLR": lambda: mod.CyclicLR(1e-3, 0.1, 4, 6),
        "CyclicLR_triangular2": lambda: mod.CyclicLR(
            1e-3, 0.1, 3, mode="triangular2"),
        "CyclicLR_exp_range": lambda: mod.CyclicLR(
            1e-3, 0.1, 3, mode="exp_range", exp_gamma=0.95),
        "CosineAnnealingWarmRestarts": lambda: mod.CosineAnnealingWarmRestarts(
            0.1, 5, T_mult=2, eta_min=1e-4),
    }


def _sequence(sched):
    out = [sched.get_lr(), sched()]
    for _ in range(30):
        sched.step()
        out.append(sched())
    for epoch in (3, 17, 0, 29):
        sched.step(epoch=epoch)
        out.append(sched())
    return out


def check_schedulers_match_reference():
    tmake, jmake = _schedulers(tlr), _schedulers(jlr)
    classes = {type(tmake[k]()).__name__ for k in tmake} | {"ReduceOnPlateau"}
    assert classes == set(tlr.__all__) - {"LRScheduler"}, classes
    for name in tmake:
        assert _sequence(tmake[name]()) == _sequence(jmake[name]()), name
        t, j = tmake[name](), jmake[name]()
        for _ in range(7):
            t.step()
            j.step()
        state = t.state_dict()
        assert state == j.state_dict(), name
        again = tmake[name]()
        again.set_state_dict(state)
        assert _sequence(again) == _sequence(j), f"{name} after a resume"
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.8, 0.85, 0.9, 0.91, 0.92, 0.93,
               0.94, 0.95, 0.96]
    for kw in ({"patience": 2},
               {"patience": 2, "mode": "max", "threshold_mode": "abs",
                "cooldown": 2},
               {"patience": 1, "factor": 0.5, "min_lr": 0.02}):
        t, j = tlr.ReduceOnPlateau(0.1, **kw), jlr.ReduceOnPlateau(0.1, **kw)
        seq_t, seq_j = [], []
        for v in metrics:
            t.step(v)
            j.step(v)
            seq_t.append(t())
            seq_j.append(j())
        assert seq_t == seq_j, (kw, seq_t, seq_j)
        assert t.state_dict() == j.state_dict(), kw


def check_optimizer_lr_api():
    _, tm = _models()
    sched = tlr.StepDecay(0.1, 2, 0.5)
    o = SGD(learning_rate=sched, parameters=tm.parameters())
    assert o.get_lr() == 0.1
    with pytest.raises(RuntimeError):
        o.set_lr(0.2)
    o.set_lr_scheduler(tlr.ExponentialDecay(0.3, 0.5))
    assert o.get_lr() == 0.3
    clipped = SGD(learning_rate=0.1, parameters=tm.parameters(),
                  grad_clip=tnn.ClipGradByNorm(1.0))
    with pytest.raises(ValueError, match="grad_clip"):
        FusedFlatUpdater(clipped, list(tm.parameters()))
    upd = FusedFlatUpdater(o, list(tm.parameters()))
    dev = torch.device("cpu")
    first = upd._lr_tensor(dev)
    assert upd._lr_tensor(dev) is first          # the rate has not moved
    o._learning_rate.step()
    second = upd._lr_tensor(dev)
    assert second is not first
    assert float(first) == float(torch.tensor(0.3))
    assert float(second) == float(torch.tensor(0.15))


def check_scheduled_train_matches():
    """A schedule read by each TrainStep call: the reference's and the
    port's parameters after three SGD steps whose lr moves every step."""
    jm, tm = _models()
    ids, labels = _batch(6)
    js, ts = jlr.PolynomialDecay(0.2, 3, 0.01), tlr.PolynomialDecay(0.2, 3,
                                                                     0.01)
    jo = jopt.SGD(learning_rate=js, parameters=jm.parameters())
    to = SGD(learning_rate=ts, parameters=tm.parameters())
    jcrit = JaxCriterion()
    jstep = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb), jo)
    tstep = TrainStep(tm, GPTPretrainingCriterion(), to)
    for i in range(3):
        jl = float(jstep(inputs=(paddle.to_tensor(ids),),
                         labels=(paddle.to_tensor(labels),)))
        tl = float(tstep(inputs=(ids,), labels=(labels,)))
        _rel_close(tl, jl, RTOL["float32"], f"loss at step {i}")
        js.step()
        ts.step()
    tp = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        _abs_close(tp[n], p, PARAM_TOL, f"param {n}")


# ------------------------------------------------------------------ clips
def _clip_opts(jm, tm, kind):
    tcls, jcls, args = CLIPS[kind]
    return (jopt.SGD(learning_rate=0.1, parameters=jm.parameters(),
                     grad_clip=jcls(*args)),
            SGD(learning_rate=0.1, parameters=tm.parameters(),
                grad_clip=tcls(*args)))


def _held_params(jm, tm, what):
    tp = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        _close_param(tp[n], p, "bfloat16" if tp[n].dtype == torch.bfloat16
                     else "float32", f"{what}: param {n}")


def _np_grad(p) -> np.ndarray:
    return p.grad.detach().float().numpy().copy()


def check_clip_eager_matches(kind, dtype):
    """Two eager steps on both sides from the same gradients (the port
    model's own, as fp32 numpy, each side casting them to the parameter's
    dtype as its ``step()`` does), so what is compared is the clip and the
    update alone. The reference's step runs op by op
    (``jax.disable_jit()``): compiled, XLA keeps the bf16 product
    ``g * scale`` in fp32 into the update (excess precision), where the
    reference's code and the port round it to bf16 first; that moves a
    few bf16 weights by a second ulp."""
    jm, tm = _models(dtype)
    jo, to = _clip_opts(jm, tm, kind)
    jp = dict(jm.named_parameters())
    bound = False
    for seed in (7, 8):
        ids, labels = _batch(seed)
        GPTPretrainingCriterion()(tm(torch.from_numpy(ids)),
                                  torch.from_numpy(labels)).backward()
        grads = {n: _np_grad(p) for n, p in tm.named_parameters()}
        before = {n: p.detach().float() for n, p in tm.named_parameters()}
        for n, g in grads.items():
            jp[n].grad = paddle.to_tensor(g)
        with jax.disable_jit():      # the reference's ops as written
            jo.step()
        jo.clear_grad()
        to.step()
        to.clear_grad()
        # the clip binds: some parameter moves by less than lr * |g|
        bound |= any(float((p.detach().float() - before[n]).abs().sum())
                     < 0.09 * float(np.abs(grads[n]).sum())
                     for n, p in tm.named_parameters())
        _held_params(jm, tm, f"eager {kind} {dtype} step {seed}")
    assert bound, f"{kind} did not bind"


def _bf16_share(jm, tm) -> float:
    """The share of the bf16 parameter elements within one bf16 ulp of
    the reference's."""
    tp = dict(tm.named_parameters())
    close = total = 0
    for n, p in jm.named_parameters():
        if tp[n].dtype != torch.bfloat16:
            continue
        a, b = _f32(tp[n]), _f32(p)
        lim = bf16_ulp(torch.from_numpy(np.maximum(np.abs(a), np.abs(b))))
        close += int((np.abs(a - b) <= lim.numpy()).sum())
        total += a.size
    return close / total


def _train_steps(jm, tm, jo, to, accum):
    """Two TrainStep steps on both sides; the loss of each within the
    dtype's limit."""
    ids, labels = _batch(9, b=4 if accum > 1 else 2)
    jcrit = JaxCriterion()
    jstep = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb), jo,
                         grad_accum_steps=accum)
    tstep = TrainStep(tm, GPTPretrainingCriterion(), to,
                      grad_accum_steps=accum)
    dtype = tm.config.dtype
    for i in range(2):
        jl = float(jstep(inputs=(paddle.to_tensor(ids),),
                         labels=(paddle.to_tensor(labels),)))
        tl = float(tstep(inputs=(ids,), labels=(labels,)))
        _rel_close(tl, jl, RTOL[dtype], f"loss at step {i}")


_control = {}


def _no_clip_share(accum) -> float:
    """The bf16 share of :func:`_bf16_share` after the same two steps
    without a clip (the control)."""
    if accum not in _control:
        jm, tm = _models("bfloat16")
        _train_steps(jm, tm, jopt.SGD(learning_rate=0.1,
                                      parameters=jm.parameters()),
                     SGD(learning_rate=0.1, parameters=tm.parameters()),
                     accum)
        _control[accum] = _bf16_share(jm, tm)
    return _control[accum]


def check_clip_train_step_matches(kind, dtype, accum):
    """Two clipped TrainStep steps against the reference's. fp32: every
    parameter within 1e-6. bf16: the losses within 3e-4, the fp32 final
    norm within 1e-2 lr (``tests/torch_checks.py`` ``bf16_step_parity``'s
    rule for it), and the share of bf16 elements within one ulp of
    the reference's at least the no-clip control's less 2 points: a
    bf16 model's gradients differ between the frameworks by bf16 ulps
    (``tests/test_torch_bf16_train.py``), so after two SGD steps ~85% of
    the elements are equal and ~4% more than an ulp apart with or
    without a clip; an unclipped or wrongly clipped update moves
    nearly all of them."""
    jm, tm = _models(dtype)
    jo, to = _clip_opts(jm, tm, kind)
    _train_steps(jm, tm, jo, to, accum)
    what = f"TrainStep {kind} {dtype} accum {accum}"
    tp = dict(tm.named_parameters())
    tol = PARAM_TOL if dtype == "float32" else 1e-2 * 0.1
    for n, p in jm.named_parameters():
        if tp[n].dtype == torch.float32:
            _abs_close(tp[n], p, tol, f"{what}: param {n}")
    if dtype == "bfloat16":
        share, control = _bf16_share(jm, tm), _no_clip_share(accum)
        assert share >= control - 0.02, (what, share, control)


DP_IDS = np.random.RandomState(11).randint(0, 256, (4, 16)).astype(np.int64)
DP_LABELS = np.random.RandomState(12).randint(0, 256, (4, 16)
                                              ).astype(np.int64)


def _ref_dp_run(fused_flag):
    """The reference's ``TrainStep(grad_comm="int8_block")`` on a
    2-device data mesh with a global-norm clip, 2 SGD steps; the flag
    and the mesh restored."""
    prev = jflags.flag("FLAGS_kernel_autotune")
    prev_mesh = mesh_mod.get_mesh()
    jflags.set_flags({"FLAGS_kernel_autotune": bool(fused_flag)})
    try:
        mesh_mod.set_mesh(mesh_mod.build_mesh({"data": 2},
                                              devices=jax.devices()[:2]))
        jm = JaxGPT(jax_presets("gpt-test"), seed=SEED)
        jo = jopt.SGD(learning_rate=0.1, parameters=jm.parameters(),
                      grad_clip=jnn.ClipGradByGlobalNorm(1.0))
        jcrit = JaxCriterion()
        step = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb), jo,
                            grad_comm="int8_block")
        losses = [float(step(inputs=(paddle.to_tensor(DP_IDS),),
                             labels=(paddle.to_tensor(DP_LABELS),)))
                  for _ in range(2)]
        return losses, [np.asarray(p._value) for p in jm.parameters()]
    finally:
        jflags.set_flags({"FLAGS_kernel_autotune": prev})
        mesh_mod.set_mesh(prev_mesh)


def check_clip_grad_comm_matches():
    params = _jax_params(JaxGPT(jax_presets("gpt-test"), seed=SEED))
    ranks = spawn(workers.clip_dp_case, args=(params, DP_IDS, DP_LABELS),
                  nprocs=2, timeout=240)
    r0, r1 = ranks
    assert r0["losses"] == r1["losses"]
    assert all(np.array_equal(a, b) for a, b in zip(r0["params"],
                                                    r1["params"]))
    assert r0["fused"] is False
    for flag in (True, False):
        losses, jparams = _ref_dp_run(flag)
        # the dp rule of tests/test_torch_dp_train.py: the local
        # gradients differ by fp32 rounding, which flips an int8 level
        # of the wire here and there
        _held(dict(r0, slots=[]), {"losses": losses, "params": jparams,
                                    "slots": []}, 0.1, 2,
              f"grad_comm clip, flag {flag}")


# ------------------------------------------- the reference's loss table
# this slice's measurement on the reference (gpt-test, seed 0, batch 2 x 32
# from RandomState(0), AdamW lr 1e-3, 3 steps): (dtype, chunk, recompute,
# schedule + clip) -> losses
TABLE = {("float32", 0, False, False): (5.517105, 5.166610, 4.924523),
         ("float32", 16, False, False): (5.517105, 5.166610, 4.924524),
         ("float32", 16, True, True): (5.517105, 5.517105, 5.317221),
         ("bfloat16", 0, False, False): (5.517026, 5.169362, 4.927392),
         ("bfloat16", 16, False, False): (5.517025, 5.169362, 4.927392),
         ("bfloat16", 16, True, True): (5.517025, 5.517025, 5.320199)}


def check_reference_table(dtype, chunk, recompute, schedule):
    cfg = gpt_presets("gpt-test", dtype=dtype, fused_loss_chunk=chunk,
                      recompute=recompute)
    tm = GPTForCausalLM(cfg, seed=0, device="cpu")
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab_size, (2, 32))
    labels = rs.randint(0, cfg.vocab_size, (2, 32))
    lr = (tlr.LinearWarmup(tlr.CosineAnnealingDecay(1e-3, T_max=10), 2, 0.0,
                           1e-3) if schedule else 1e-3)
    clip = tnn.ClipGradByGlobalNorm(1.0) if schedule else None
    opt = AdamW(learning_rate=lr, parameters=tm.parameters(), grad_clip=clip)
    if chunk:
        step = TrainStep(tm, lambda loss: loss, opt)
        run = lambda: step(inputs=(ids, None, labels), labels=())  # noqa
    else:
        step = TrainStep(tm, GPTPretrainingCriterion(), opt)
        run = lambda: step(inputs=(ids,), labels=(labels,))  # noqa
    for i, want in enumerate(TABLE[(dtype, chunk, recompute, schedule)]):
        _rel_close(float(run()), want, RTOL[dtype], f"loss at step {i}")
        if schedule:
            lr.step()


def test_train_options_port_matches_reference(fresh_mesh):
    run_checks([
        *((check_fused_ce_matches_reference, ("float32",) + case)
          for case in ((False, True, "mean", True, 16),
                       (True, False, "sum", False, 16),
                       (True, True, "none", True, 32),
                       (False, False, "mean", False, 77),
                       (True, False, "mean", True, 100))),
        *((check_fused_ce_matches_reference, ("bfloat16",) + case)
          for case in ((True, False, "mean", True, 16),
                       (False, True, "sum", False, 16))),
        (check_fused_ce_out_of_range_and_bad_reduction, ()),
        (check_chunk_plain_matches_reference_scan, ()),
        (check_gpt_fused_loss_matches, ("float32",)),
        (check_gpt_fused_loss_matches, ("bfloat16",)),
        (check_fused_loss_gemm_settings, ("float32",)),
        (check_fused_loss_gemm_settings, ("bfloat16",)),
        (check_gpt_fused_train_matches, ("float32",)),
        (check_gpt_fused_train_matches, ("bfloat16",)),
        *((check_recompute_gradients_same_bits, (dt, chunk))
          for dt in ("float32", "bfloat16") for chunk in (0, 16)),
        (check_recompute_train_matches, ("float32",)),
        (check_recompute_train_matches, ("bfloat16",)),
        (check_schedulers_match_reference, ()),
        (check_optimizer_lr_api, ()),
        (check_scheduled_train_matches, ()),
        *((check_clip_eager_matches, (kind, dt))
          for kind in CLIPS for dt in ("float32", "bfloat16")),
        *((check_clip_train_step_matches, (kind, dt, 1))
          for kind in CLIPS for dt in ("float32", "bfloat16")),
        (check_clip_train_step_matches, ("global_norm", "bfloat16", 2)),
        (check_clip_train_step_matches, ("norm", "float32", 2)),
        (check_clip_grad_comm_matches, ()),
        *((check_reference_table, key) for key in TABLE),
    ])
