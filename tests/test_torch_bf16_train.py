"""Port bf16 GPT training (``paddle_tpu_torch``: ``GPTConfig(dtype=
"bfloat16")``, the block LayerNorm, the fp32 LM head, the bf16 flash
plain versions, the bf16 cast chain of the fused update, ``TrainStep``'s
fp32 accumulation) against the JAX reference at ``dtype="bfloat16"`` on
the CPU, at ``gpt-test`` size (2 layers, hidden 64, 4 heads of 16),
batch 2 x 32, inputs from numpy.

Cases and tolerances (the measured maximum beside each; none is looser
than the reference's own bf16 flash tolerance, 2e-2,
``tests/test_pallas_kernels.py:333-350``):

- Weights: the port's bf16 ``GPTForCausalLM(cfg, seed=s)`` equals
  ``state_dict_from_numpy`` of the JAX bf16 model bit for bit, bf16
  blocks and tables, fp32 final norm.
- Flash plain versions on bf16 q, k, v, dO against the reference's
  ``flash_attention_val`` in interpret mode, gradients by ``jax.vjp``,
  causal and full: every element of out, dq, dk and dv within
  ``tests/torch_checks.py`` ``flash_bf16_limit`` of the reference's
  (2e-2 of its magnitude plus 1.6e-2 of its row's RMS plus 1e-5; the
  largest diff / limit measured 0.176, max abs 9.8e-4, one bf16 ulp).
- The bf16 kernels' rounding, modelled on the CPU (b1 n2 s1024 d64,
  causal and full): p as the kernels compute it (``exp2`` of the raw
  scores times ``scale * log2(e)``), p and ds rounded to bf16 before their second products (one pass, what
  the kernels do) within ``flash_bf16_limit``
  of the plain versions (largest diff / limit measured 0.392-0.487; a
  hi + lo split in two passes 0.206-0.283); the same model with keys
  0-15 left out of P.V and dS.K and queries 0-15 out of P^T.dO and
  dS^T.Q, the fault ``tests/test_torch_cuda.py`` plants in the kernels,
  over it (71-102 of the limit), on every long row (queries 512 and on)
  of out and dq, where the former limit, 2e-2 of the output's largest
  magnitude, flags 4-20% of them.
- Fused update, bf16 parameters and gradients, fp32 moments, every rule:
  the port's plain update against the reference's update run op by op
  (``reference_update_flat`` and ``_bucket_fn``'s body, the optimizer's
  ``_update`` then the cast) bit for bit, parameters, moments and beta
  powers; against the Pallas kernel in interpret mode parameters bit for
  bit, and moments bit for bit from zero moments (a first step) where
  no weight decay is added to the gradient; elsewhere XLA contracts
  ``beta * m + (1 - beta) * g`` or ``g + wd * p`` into an FMA on this
  CPU, so there the moments are held to 8 ulp of their largest, as
  ``tests/test_torch_fused_update.py`` says.
- One block: with the MLP's output projection zeroed, the block is
  ``x`` plus its attention half, and the port's block with the
  reference's CPU attention (einsum, ``use_flash_attention=False``)
  equals ``_block_apply`` bit for bit. That shows the LayerNorm's order
  (the affine in fp32, one rounding): the generic ``layer_norm``, which
  rounds twice, moves ~1.7% of the elements. The whole block (flash
  attention) within 1e-2 of the larger of 1 and its largest (measured
  7.8e-3 against a limit of 3.6e-2: one bf16 ulp of the residual
  stream, as the reference's bf16 tanh-gelu rounds after each op on
  this CPU and the port's once).
- Forward: fp32 logits (the LM head promoted as jnp promotes it)
  within 1e-2 of the larger of 1 and their largest (measured 3.2e-3;
  the JAX model runs its einsum attention on the CPU, in bf16), loss
  within 3e-4 relative (measured 2.2e-5).
- Training: 3 ``TrainStep`` steps (AdamW lr 1e-3, wd 0.01) against the
  JAX bf16 ``TrainStep``, the loss at every step within 3e-4 relative
  (measured 8.4e-5); 2 steps at ``grad_accum_steps=2`` the same
  (measured 6.7e-6). A control that is not a fault, the LM head in one
  bf16 pass (a TPU's default precision) instead of fp32, moves these
  losses by at most 5.3e-5: at this size the loss cannot tell the LM
  head's precision. The bucket plan is the
  reference's (bf16 buckets and one fp32 bucket, the final norm), the
  moments fp32.
- Accumulation: at ``grad_accum_steps=4`` the gradient the update reads
  equals the fp32 sum of the micro-batch gradients, divided by 4 and
  rounded to bf16, bit for bit (the reference's chain); a bf16 running
  sum differs from it. At 2 micro-batches the two agree (a sum of two
  bf16 values rounded once, then an exact halving), which is why the
  case takes 4.
- GEMM settings: every GEMM of a GPT forward and of a bare
  ``loss.backward()``, bf16 and fp32, runs at its dtype's settings
  (``framework/precision.py``) while the caller has set the opposite
  process-wide, and the caller's flags are back afterwards; the fp32
  serving steps and BERT forward run with TF32 off the same way. A bf16
  backward that raises (a hook on the word-embedding gradient, after
  the logits' node entered bf16's settings) leaves the caller's flags
  as they were, from a bare ``loss.backward()`` and from ``TrainStep``.
- What stays out raises ``NotImplementedError`` naming its ROADMAP
  item: float64 (float16 and bf16 BERT, ported since, run). A bf16 decode model is
  built, as the reference's is, and its ``decode`` raises
  ``TypeError`` as the reference's does (``tests/test_torch_serving.py``
  holds it against the reference).

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.grad_comm import build_buckets as jax_buckets
from paddle_tpu.framework.tensor import Parameter
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt_presets as jax_presets
from paddle_tpu.models.gpt import _block_apply
from paddle_tpu.ops.flash_attention import flash_attention_val as jax_flash
from paddle_tpu.ops.pallas import fused_update as jfu
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (BLOCK_PARAMS, BertForPretraining,
                                     GPTForCausalLM, GPTPretrainingCriterion,
                                     bert_presets, gpt_presets,
                                     state_dict_from_numpy)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused_update as tfu
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import GPTDecodeModel
from torch_checks import (FLASH_BF16_SECTION, FLASH_FAULTS, FUSED_HYPER,
                          flash_bf16_limit, flash_err, plant_flash_fault,
                          run_checks)

torch.set_num_threads(2)

BF16 = {"dtype": "bfloat16"}
SEED = 3
BLOCK_TOL = 1e-2
LOGIT_TOL = 1e-2
LOSS_RTOL = 3e-4
LR = 1e-3
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    """The tensor's bits as integers (bf16 -> int16, fp32 -> int32)."""
    t = t.detach().cpu()
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within(a, b, tol, what, scaled=True):
    """max |a - b| <= tol (times the larger of 1 and max |b|)."""
    a, b = _f32(a), _f32(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.abs(a - b).max())
    lim = tol * (max(1.0, float(np.abs(b).max())) if scaled else 1.0)
    assert err <= lim, f"{what}: max abs diff {err:.3e} > {lim:.3e}"
    return err


def _jax_params(model):
    return {n: np.asarray(p._value) for n, p in model.named_parameters()}


def _models():
    """(JAX bf16 model, port bf16 model on its converted weights)."""
    jm = JaxGPT(jax_presets("gpt-test", **BF16), seed=SEED)
    cfg = gpt_presets("gpt-test", **BF16)
    tm = GPTForCausalLM(cfg, seed=SEED + 1, device="cpu")
    tm.load_state_dict(state_dict_from_numpy(_jax_params(jm), cfg))
    return jm, tm


def _batch(seed, b=2, s=32, vocab=256):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, (b, s)).astype(np.int64),
            rs.randint(0, vocab, (b, s)).astype(np.int64))


# ------------------------------------------------------------------ weights
def check_weights_equal_converted_jax(seed):
    cfg = gpt_presets("gpt-test", **BF16)
    jm = JaxGPT(jax_presets("gpt-test", **BF16), seed=seed)
    converted = state_dict_from_numpy(_jax_params(jm), cfg)
    port = GPTForCausalLM(cfg, seed=seed, device="cpu").state_dict()
    assert list(port) == list(converted)
    for name, t in converted.items():
        want = (torch.float32 if name.startswith("gpt.final_norm")
                else torch.bfloat16)
        assert port[name].dtype == t.dtype == want, (name, t.dtype)
        assert np.array_equal(_bits(port[name]), _bits(t)), name


# -------------------------------------------------------------------- flash
def check_flash_plain_matches_jax(causal):
    """The port's plain flash forward and backward (what a CPU tensor
    takes) on bf16 inputs against the reference's Pallas kernels in
    interpret mode, gradients through ``jax.vjp``."""
    rs = np.random.RandomState(7 + causal)
    b, s, n, d = 2, 128, 2, 32
    q, k, v, do = (rs.randn(b, s, n, d).astype(np.float32)
                   for _ in range(4))
    jx = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    out, vjp = jax.vjp(lambda a, c, e: jax_flash(a, c, e, causal=causal,
                                                 block_q=64, block_k=32),
                       *jx[:3])
    jdq, jdk, jdv = vjp(jx[3])
    tx = [torch.from_numpy(x).bfloat16().requires_grad_(i < 3)
          for i, x in enumerate((q, k, v, do))]
    tout = tfa.flash_attention_val(*tx[:3], causal=causal)
    tdq, tdk, tdv = torch.autograd.grad(tout, tx[:3], tx[3])
    for name, a, ref in (("out", tout, out), ("dq", tdq, jdq),
                         ("dk", tdk, jdk), ("dv", tdv, jdv)):
        assert a.dtype == torch.bfloat16, (name, a.dtype)
        err, ratio = flash_err(name, torch.bfloat16, a.detach(),
                               torch.tensor(_f32(ref)))
        assert ratio <= 1.0, (f"flash causal={causal} {name}: max abs diff "
                              f"{err:.3e}, {ratio:.3f} of its limit")


def _rounding_model(q, k, v, do, causal, passes=1, drop=None):
    """out, dq, dk and dv as the bf16 kernels round their operands
    (``csrc/flash_attention.cu`` ``*_bf16``): bf16 products summed in
    fp32, and the fp32 p and ds rounded to bf16 before their second
    product (``passes=1``), or split into a bf16 high and low part
    (``passes=2``). p as each kernel computes it: ``exp2`` of the raw
    scores times ``scale * log2(e)`` in fp32, the forward less its row
    maximum so scaled, dq and dkv less ``lse * log2(e)``. Whole-row
    softmax: the kernels' tile order is not modelled. ``drop`` leaves a
    slice of keys out of P.V and dS.K and the same slice of queries out
    of P^T.dO and dS^T.Q: a kernel that skips a 16-wide chunk of a
    tile."""
    def rnd(x):
        return x.bfloat16().float()

    def mm(a, b):
        return rnd(a) @ b + (rnd(a - rnd(a)) @ b if passes == 2 else 0)

    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    scale = 1.0 / math.sqrt(q.shape[-1])
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    out, lse = tfa.flash_fwd_plain(q, k, v, causal)
    delta = (dof * out.float()).sum(-1, keepdim=True)
    raw = tfa._masked(qf @ kf.transpose(-1, -2), causal)
    e = torch.exp2(raw * sl2 - raw.amax(-1, keepdim=True) * sl2)
    p = torch.exp2(raw * sl2 - lse * LOG2E)
    dp = dof @ vf.transpose(-1, -2) - delta
    pk, dsk, pq, dsq = e.clone(), p * dp, p.clone(), p * dp
    if drop is not None:
        pk[..., drop] = dsk[..., drop] = 0.0
        pq[..., drop, :] = dsq[..., drop, :] = 0.0
    model = {"out": mm(pk, vf) / e.sum(-1, keepdim=True),
             "dq": mm(dsk, kf) * scale,
             "dk": mm(dsq.transpose(-1, -2), qf) * scale,
             "dv": mm(pq.transpose(-1, -2), dof)}
    plain = dict(zip(("dq", "dk", "dv"), tfa.flash_bwd_plain(
        q, k, v, do, lse, delta, causal)), out=out)
    return {n: (model[n].bfloat16(), plain[n]) for n in model}


def check_flash_rounding_model_within_limit(causal):
    """The bf16 kernels' one-pass rounding of p and ds holds
    ``flash_bf16_limit`` at s = 1024, d = 64, and a kernel that drops
    keys 0-15 from its second products does not: it is flagged on every
    long row (queries 512 and on) of out and dq, and on dk and dv."""
    rs = np.random.RandomState(11 + causal)
    q, k, v, do = (torch.from_numpy(rs.randn(1, 2, 1024, 64).astype(
        np.float32)).bfloat16() for _ in range(4))
    for passes in (1, 2):
        for name, (a, b) in _rounding_model(q, k, v, do, causal,
                                            passes).items():
            err, ratio = flash_err(name, torch.bfloat16, a, b)
            assert ratio <= 1.0, (f"{passes} pass(es) {name}: {err:.3e}, "
                                  f"{ratio:.3f} of its limit")
    fault = _rounding_model(q, k, v, do, causal, drop=slice(0, 16))
    for name, (a, b) in fault.items():
        flagged = ((a.float() - b.float()).abs()
                   > flash_bf16_limit(b)).any(-1)
        assert bool(flagged.any()), f"fault not seen in {name}"
        if name in ("out", "dq"):
            share = float(flagged[..., 512:].float().mean())
            assert share >= 0.9, f"fault flagged on {share:.3f} of {name}"


def check_planted_flash_fault_armed():
    """The fault ``tests/test_torch_cuda.py`` plants in the bf16 flash
    kernels on the card (``torch_checks.FLASH_FAULTS``) is armed in the
    source as it stands: each anchor occurs exactly once in the bf16
    section of ``csrc/flash_attention.cu``, one in each of the three
    bf16 kernels, and planting changes those lines and no other."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    head, _, bf16 = src.partition(FLASH_BF16_SECTION)
    kernels = []
    for loop, _ in FLASH_FAULTS:
        assert bf16.count(loop) == 1, loop
        before = bf16[:bf16.index(loop)]
        kernels.append(before[:before.rindex("_wgmma_kernel(")]
                       .split()[-1])
    assert sorted(kernels) == ["dkv", "dq", "fwd"], kernels
    mutant = plant_flash_fault(src)
    changed = [a for a, b in zip(src.splitlines(), mutant.splitlines())
               if a != b]
    assert mutant.startswith(head) and len(changed) == len(FLASH_FAULTS)


# ------------------------------------------------------------- fused update
def _update_case(kind, n, seed, zero_moments):
    rs = np.random.RandomState(seed)
    p = rs.randn(n).astype(np.float32) * 0.05
    g = rs.randn(n).astype(np.float32) * 1e-2
    slots = {}
    for nm in tfu.slot_names(kind):
        v = np.zeros(n, np.float32) if zero_moments else (
            rs.randn(n) * 1e-3).astype(np.float32)
        slots[nm] = np.abs(v) * 1e-2 if nm == "moment2" else v
    if kind in ("adam", "adamw"):
        step = 0 if zero_moments else 3
        slots["beta1_pow"] = np.float32(0.9 ** step)
        slots["beta2_pow"] = np.float32(0.999 ** step)
    pb = torch.from_numpy(p).bfloat16()
    gb = torch.from_numpy(g).bfloat16()
    return pb, gb, slots


def _jnp_bf16(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def check_fused_update_matches_reference(kind, wd, zero_moments):
    hyper = FUSED_HYPER[kind]
    n = 1000 + 3
    pb, gb, slots = _update_case(kind, n, 11 + len(kind), zero_moments)
    lr = np.float32(LR)
    js = {k: jnp.asarray(v) for k, v in slots.items()}
    jp, jg = _jnp_bf16(pb), _jnp_bf16(gb)
    tp = pb.clone()
    _, ts = tfu.fused_update_flat(tp, gb, {k: torch.tensor(v) for k, v in
                                           slots.items()},
                                  torch.tensor(lr), kind=kind, hyper=hyper,
                                  wd=wd)
    assert tp.dtype == torch.bfloat16
    # the reference's update run op by op: reference_update_flat, and
    # _bucket_fn's body (optimizer._update, then the cast)
    make = {"sgd": lambda ps: jopt.SGD(LR, parameters=ps),
            "momentum": lambda ps: jopt.Momentum(
                LR, 0.9, parameters=ps, use_nesterov=True),
            "adam": lambda ps: jopt.Adam(LR, parameters=ps),
            "adamw": lambda ps: jopt.AdamW(LR, parameters=ps)}[kind]
    o = make([Parameter(jnp.zeros(1))])
    with jax.disable_jit():
        ep, es = jfu.reference_update_flat(jp, jg, dict(js), jnp.asarray(lr),
                                           kind=kind, hyper=hyper, wd=wd)
        bp, bs = o._update(jp, jg.astype(jp.dtype), dict(js),
                           jnp.asarray(lr), 1.0, wd)
        bp = bp.astype(jp.dtype)
    kp, ks = jfu.fused_update_flat(jp, jg, dict(js), jnp.asarray(lr),
                                   kind=kind, hyper=hyper, wd=wd)
    what = f"{kind} wd={wd} zero_moments={zero_moments}"
    for name, ref in (("reference_update_flat", ep), ("_bucket_fn", bp),
                      ("Pallas interpret", kp)):
        assert np.array_equal(_bits(tp), _jbits(ref)), f"{what}: p vs {name}"
    for k in ts:
        for name, ref in (("reference_update_flat", es[k]),
                          ("_bucket_fn", bs[k])):
            assert np.array_equal(_bits(ts[k]), _jbits(ref)), \
                f"{what}: {k} vs {name}"
        mine, ref = ts[k].numpy(), np.asarray(ks[k])
        contracted = not zero_moments or (wd and kind in ("momentum",
                                                          "adam"))
        if not contracted or np.shape(ref) == ():
            assert np.array_equal(mine.view(np.int32), ref.view(np.int32)), \
                f"{what}: {k} vs Pallas interpret"
        else:
            bound = 8 * np.spacing(np.float32(np.abs(ref).max()))
            err = float(np.abs(mine - ref).max())
            assert err <= bound, f"{what}: {k} vs Pallas interpret {err}"


# -------------------------------------------------------------------- block
def _block_case(fc2_zero):
    cfg = gpt_presets("gpt-test", **BF16)
    tm = GPTForCausalLM(cfg, seed=1, device="cpu")
    blk = tm.gpt.decoder[0]
    rs = np.random.RandomState(5)
    h = cfg.hidden_size
    with torch.no_grad():      # LayerNorm affines away from (1, 0)
        for nm in ("ln1_w", "ln2_w"):
            getattr(blk, nm).copy_(torch.from_numpy(
                (1 + 0.5 * rs.randn(h)).astype(np.float32)))
        for nm in ("ln1_b", "ln2_b"):
            getattr(blk, nm).copy_(torch.from_numpy(
                (0.5 * rs.randn(h)).astype(np.float32)))
        if fc2_zero:
            blk.fc2_w.zero_()
            blk.fc2_b.zero_()
    x = torch.from_numpy(rs.randn(2, 32, h).astype(np.float32)).bfloat16()
    pd = {nm: _jnp_bf16(getattr(blk, nm).detach()) for nm in BLOCK_PARAMS}
    ref = _block_apply(pd, _jnp_bf16(x), jax_presets("gpt-test", **BF16))
    return cfg, blk, x, ref


def check_block_layer_norm_matches_block_apply():
    cfg, blk, x, ref = _block_case(fc2_zero=True)
    cfg.use_flash_attention = False     # the reference's CPU attention
    out = blk(x)
    assert out.dtype == torch.bfloat16
    assert np.array_equal(_bits(out), _jbits(ref)), \
        f"{int((_bits(out) != _jbits(ref)).sum())} elements differ"
    # the generic layer_norm, which rounds before the affine, differs
    generic = tgpt.block_layer_norm
    tgpt.block_layer_norm = lambda v, w, b, eps: tgpt.layer_norm(
        v, v.shape[-1], w, b, eps)
    try:
        twice = blk(x)
    finally:
        tgpt.block_layer_norm = generic
    assert not np.array_equal(_bits(twice), _jbits(ref))


def check_block_matches_block_apply():
    _, blk, x, ref = _block_case(fc2_zero=False)
    _within(blk(x), ref, BLOCK_TOL, "block (flash attention)")


# ------------------------------------------------------------------ forward
def check_forward_and_loss_match_jax():
    jm, tm = _models()
    ids, labels = _batch(0)
    jlog = jm(paddle.to_tensor(ids))
    with torch.no_grad():
        tlog = tm(torch.from_numpy(ids))
    assert tlog.dtype == torch.float32
    _within(tlog, np.asarray(jlog._value), LOGIT_TOL, "logits")
    jl = float(JaxCriterion()(jlog, paddle.to_tensor(labels)))
    tl = float(GPTPretrainingCriterion()(tlog, torch.from_numpy(labels)))
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)


# ----------------------------------------------------------------- training
def _train_both(steps, accum):
    jm, tm = _models()
    ids, labels = _batch(2, b=4 if accum > 1 else 2)
    jo = jopt.AdamW(learning_rate=LR, weight_decay=0.01,
                    parameters=jm.parameters())
    jcrit = JaxCriterion()
    jstep = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb), jo,
                         grad_accum_steps=accum)
    to = AdamW(learning_rate=LR, weight_decay=0.01,
               parameters=tm.parameters())
    tstep = TrainStep(tm, GPTPretrainingCriterion(), to,
                      grad_accum_steps=accum)
    for i in range(steps):
        jl = float(jstep(inputs=(paddle.to_tensor(ids),),
                         labels=(paddle.to_tensor(labels),)))
        tl = float(tstep(inputs=(ids,), labels=(labels,)))
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl), \
            f"loss at step {i}: {tl} vs {jl}"
    return jm, tstep


def check_train_steps_match_jax():
    jm, tstep = _train_both(3, 1)
    jplan = jax_buckets(list(jm.parameters()))
    assert [(b.param_indices, b.size, str(b.dtype)) for b in jplan] == \
        [(b.param_indices, b.size, str(b.dtype).split(".")[-1])
         for b in tstep.buckets]
    assert {str(b.dtype) for b in tstep.buckets} == {"torch.bfloat16",
                                                       "torch.float32"}
    for slots in tstep.updater._slots.values():
        assert all(v.dtype == torch.float32 for v in slots.values())


def check_grad_accum_matches_jax():
    _train_both(2, 2)


def check_accumulation_is_fp32():
    _, tm = _models()
    ids, labels = _batch(4, b=8)
    accum = 4
    micro = []
    for i in range(accum):         # each micro-batch's bf16 gradients
        tm.zero_grad()
        sl = slice(2 * i, 2 * i + 2)
        GPTPretrainingCriterion()(tm(torch.from_numpy(ids[sl])),
                                  torch.from_numpy(labels[sl])).backward()
        micro.append({n: p.grad.clone() for n, p in tm.named_parameters()})
    want = {n: (sum(m[n].float() for m in micro) / accum).to(m[n].dtype)
            for n, m in zip(micro[0], [micro[0]] * len(micro[0]))}
    running = {n: micro[0][n].clone() for n in micro[0]}
    for m in micro[1:]:
        for n in running:
            running[n] += m[n]
    o = AdamW(learning_rate=LR, parameters=tm.parameters())
    step = TrainStep(tm, GPTPretrainingCriterion(), o,
                     grad_accum_steps=accum)
    seen = {}
    real = step.updater.step

    def capture():
        for n, p in tm.named_parameters():
            seen[n] = p.grad.clone()
        real()

    step.updater.step = capture
    step(inputs=(ids,), labels=(labels,))
    for n, g in want.items():
        assert seen[n].dtype == g.dtype, (n, seen[n].dtype)
        assert np.array_equal(_bits(seen[n]), _bits(g)), n
    assert any(not np.array_equal(_bits((running[n] / accum).to(g.dtype)),
                                  _bits(g)) for n, g in want.items()
               if g.dtype == torch.bfloat16)


def _flags():
    mm = torch.backends.cuda.matmul
    return (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
            mm.allow_fp16_reduced_precision_reduction,
            torch.backends.cudnn.allow_tf32)


def _set_flags(flags):
    mm = torch.backends.cuda.matmul
    (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
     mm.allow_fp16_reduced_precision_reduction,
     torch.backends.cudnn.allow_tf32) = flags


def _gemm_nodes(root):
    """Every matmul node (``MmBackward0``, ``BmmBackward0``) of the
    backward graph from ``root``."""
    seen, stack, found = set(), [root], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if node.name() in ("MmBackward0", "BmmBackward0"):
            found.append(node)
        stack.extend(n for n, _ in node.next_functions)
    return found


def check_gemm_settings_are_the_models(dtype):
    """Every GEMM of a GPT forward and of a bare ``loss.backward()`` (no
    ``TrainStep``) runs at its dtype's settings (``framework/precision.py``;
    fp32, bf16 or fp16, ``tests/test_torch_fp16_train.py`` runs fp16)
    while the caller has set the opposite process-wide, and the caller's
    flags are back after the forward and after each backward pass, a
    partial one (``torch.autograd.grad`` of one weight) too; the fp32
    serving steps and BERT forward run with TF32 off the same way. The
    flags are read at every ``@`` of the forward and before every matmul
    node of the backward (the einsum attention,
    ``use_flash_attention=False``, so that every product is a GEMM)."""
    saved = _flags()
    try:
        _gemm_settings_case(dtype)
    finally:
        _set_flags(saved)


def _gemm_settings_case(dtype):
    caller = (dtype == "float32", True, True, True)
    want = (dtype != "float32", False, False, False)
    cfg = gpt_presets("gpt-test", dtype=dtype, use_flash_attention=False)
    model = GPTForCausalLM(cfg, seed=0, device="cpu")
    ids, labels = _batch(6)
    fwd, bwd = [], []
    real = torch.Tensor.__matmul__

    def spy(a, b):
        fwd.append(_flags())
        return real(a, b)

    def loss_of_step():
        return GPTPretrainingCriterion()(model(torch.from_numpy(ids)),
                                         torch.from_numpy(labels))

    _set_flags(caller)
    torch.Tensor.__matmul__ = spy
    try:
        loss = loss_of_step()
    finally:
        torch.Tensor.__matmul__ = real
    assert _flags() == caller
    nodes = _gemm_nodes(loss.grad_fn)
    for node in nodes:
        node.register_prehook(lambda grads: bwd.append(_flags()))
    loss.backward()
    # per layer: 4 block GEMMs (``@``) and 2 attention products (einsum),
    # then the LM head
    assert len(fwd) == 4 * cfg.num_layers + 1, len(fwd)
    assert len(nodes) == len(bwd) == 6 * cfg.num_layers + 1, len(bwd)
    assert set(fwd) == set(bwd) == {want}, (set(fwd), set(bwd))
    assert _flags() == caller
    torch.autograd.grad(loss_of_step(), [model.gpt.decoder[1].fc1_w])
    assert _flags() == caller
    if dtype != "float32":
        return
    fp32_off = (False, False, False, False)
    decode = GPTDecodeModel(model)
    bert = BertForPretraining(bert_presets("bert-test"), device="cpu")
    inside = []
    real_logits = decode._logits
    decode._logits = lambda x: inside.append(_flags()) or real_logits(x)
    bert.bert.encoder.register_forward_pre_hook(
        lambda *_: inside.append(_flags()))
    decode.prefill([[1, 2, 3], [4, 5]])
    bert(torch.zeros(1, 8, dtype=torch.int64))
    assert _flags() == caller
    assert len(inside) == 2 and set(inside) == {fp32_off}, inside


class _PlantedError(RuntimeError):
    pass


def check_gemm_settings_restored_after_a_failed_backward():
    """A bf16 backward that raises leaves the caller's four GEMM flags as
    it found them, from a bare ``loss.backward()`` and from ``TrainStep``:
    the caller sets the opposite of bf16's settings, and a hook on the
    word-embedding gradient, a node that runs after the logits' identity
    node has entered bf16's, raises."""
    saved = _flags()
    caller = (False, True, True, True)   # bf16's: (True, False, False, False)
    try:
        cfg = gpt_presets("gpt-test", **BF16)
        model = GPTForCausalLM(cfg, seed=0, device="cpu")
        seen = []

        def fail(grad):
            seen.append(_flags())
            raise _PlantedError("planted")

        model.gpt.embeddings.word_embeddings.register_hook(fail)
        ids, labels = _batch(5)
        step = TrainStep(model, GPTPretrainingCriterion(),
                         AdamW(parameters=model.parameters()))
        _set_flags(caller)
        loss = GPTPretrainingCriterion()(model(torch.from_numpy(ids)),
                                         torch.from_numpy(labels))
        with pytest.raises(_PlantedError):
            loss.backward()
        assert _flags() == caller, _flags()
        with pytest.raises(_PlantedError):
            step(inputs=(ids,), labels=(labels,))
        assert _flags() == caller, _flags()
        assert seen == [(True, False, False, False)] * 2, seen
    finally:
        _set_flags(saved)


def check_unported_paths_raise():
    """What stays out of this slice raises, naming its ROADMAP item: a
    dtype other than fp32, bf16 and fp16 (fp16 is ported since:
    ``tests/test_torch_fp16_train.py``). A bf16 GPT's decode model is built
    and refuses ``decode`` with the reference's ``TypeError`` (its fp32
    ``past`` promotes the scan carry). (bf16 buckets on
    the gradient wire are ported: tests/test_torch_bf16_dp.py holds them
    against the reference; so is bf16 BERT, a model with bf16 parameters
    running: tests/test_torch_bert_train.py holds it, decorated and
    under amp, against the reference.)"""
    with pytest.raises(NotImplementedError, match="other dtypes"):
        GPTForCausalLM(gpt_presets("gpt-test", dtype="float64"),
                       device="cpu")
    _, tm = _models()
    dm = GPTDecodeModel(tm)
    z = np.zeros(1, np.int64)
    with pytest.raises(TypeError, match="scan carry"):
        dm.decode(z, z, np.zeros((1, 8, dm.elems_per_token), np.float32), z)
    bert = BertForPretraining(bert_presets("bert-test"), device="cpu")
    bert.to(torch.bfloat16)
    logits, _ = bert(torch.zeros(1, 8, dtype=torch.int64))
    assert logits.dtype == torch.bfloat16


def test_bf16_train_port_matches_reference(fresh_mesh):
    run_checks([
        (check_weights_equal_converted_jax, (0,)),
        (check_weights_equal_converted_jax, (7,)),
        (check_flash_plain_matches_jax, (True,)),
        (check_flash_plain_matches_jax, (False,)),
        (check_flash_rounding_model_within_limit, (True,)),
        (check_flash_rounding_model_within_limit, (False,)),
        (check_planted_flash_fault_armed, ()),
        *((check_fused_update_matches_reference, (kind, wd, zero))
          for kind in ("sgd", "momentum", "adam", "adamw")
          for wd in (0.0, 0.01) for zero in (True, False)),
        (check_block_layer_norm_matches_block_apply, ()),
        (check_block_matches_block_apply, ()),
        (check_forward_and_loss_match_jax, ()),
        (check_train_steps_match_jax, ()),
        (check_grad_accum_matches_jax, ()),
        (check_accumulation_is_fp32, ()),
        (check_gemm_settings_are_the_models, ("bfloat16",)),
        (check_gemm_settings_are_the_models, ("float32",)),
        (check_gemm_settings_restored_after_a_failed_backward, ()),
        (check_unported_paths_raise, ()),
    ])
