"""Port fp16 GPT training (``paddle_tpu_torch``: ``GPTConfig(dtype=
"float16")``, the fp16 flash plain versions and the fp16 kernels'
rounding, the fp16 cast chain of the fused update, the bucket plan,
``TrainStep``, the GEMM settings, the decode model) against the JAX
reference at ``dtype="float16"`` on the CPU, at ``gpt-test`` size (2
layers, hidden 64, 4 heads of 16), batch 2 x 32, inputs from numpy.

Cases and tolerances:

- Weights: the port's fp16 ``GPTForCausalLM(cfg, seed=s)`` equals
  ``state_dict_from_numpy`` of the JAX fp16 model bit for bit, fp16
  blocks and tables, fp32 final norm.
- Flash plain versions on fp16 q, k, v, dO against the reference's
  ``flash_attention_val`` in interpret mode, gradients by ``jax.vjp``,
  causal and full, at unit-scale dO and at dO scaled by 2^-16 (a
  ``GradScaler``'s unscaled gradients): every element of out, dq, dk and
  dv within ``tests/torch_checks.py`` ``flash_fp16_limit`` (2.5e-3 of
  its magnitude plus 1.95e-3 of its row's RMS plus max(1e-5 s, 2^-23),
  ``s`` dO's scale: bf16's limit with the ulps scaled from 2^-8 to
  2^-11; largest diff / limit measured 0.136-0.284 at unit scale, 0 to
  0.465 at 2^-16).
- The fp16 kernels' rounding, modelled on the CPU
  (``ops/flash_attention.py`` ``flash_bwd_fp16_model``, b1 n2 s1024 d64,
  causal and full): p rounded to fp16 before P.V and P^T.dO, and dS
  rounded for dS.K and dS^T.Q three ways, at unit-scale dO, at the dO
  of a real ``gpt-test`` fp16 backward (its RMS measured here, 9.2e-4),
  at GPT-125M's ~1/(b s) = 1.2e-4 and at 2^-16: "scaled", the kernels'
  remedy (each row shifted by a power of two, its running largest |dS|
  into [2^14, 2^15), before the rounding), within the limit everywhere
  (largest over dq, dk, dv measured 0.35-0.50); "plain" (rounded as it
  is) and "split" (hi + lo, two products; at unit scale dq and dk 0.24-
  0.27 where "plain" reads 0.38-0.46) 1.24-1.48x the limit at
  ``gpt-test``'s dO, 2.09-2.76x at GPT-125M's and 2.46-2.48x at 2^-16,
  where dS lies among fp16's subnormals, and splitting cannot help. The
  forward's p rounding within the limit too. A kernel that drops keys
  0-15 from its second products (the fault ``tests/test_torch_cuda.py``
  plants) is flagged.
- Fused update, fp16 parameters and gradients, fp32 moments, every rule:
  the port's plain update against the reference's update run op by op
  (``reference_update_flat`` and ``_bucket_fn``'s body) bit for bit,
  parameters, moments and beta powers; against the Pallas kernel in
  interpret mode parameters bit for bit, moments bit for bit where XLA
  does not contract an FMA on this CPU and within 8 ulp of the largest
  where it does (``tests/test_torch_fused_update.py``'s bound).
- Forward: fp32 logits within 1e-2 of the larger of 1 and their
  largest (measured 4.7e-4; the JAX model runs its einsum attention on
  the CPU), loss within 3e-4 relative (measured 2.6e-6).
- Training: 3 ``TrainStep`` steps (AdamW lr 1e-3, wd 0.01) against the
  JAX fp16 ``TrainStep``, the loss at every step within 3e-4 relative
  (measured 2.2e-6, 5.5e-7, 9.6e-7);
  the bucket plan is the reference's (fp16 buckets and one fp32 bucket,
  the final norm), the moments fp32.
- GEMM settings: every GEMM of an fp16 GPT forward and bare backward
  runs at fp16's settings (TF32 for fp32 GEMMs, cuBLAS's fp16 and bf16
  reduced-precision reductions off, cuDNN's TF32 off) while the caller
  set the opposite, restored after (``test_torch_bf16_train.py``'s
  check at "float16").
- Decode model: an fp16 ``GPTDecodeModel`` does what the reference's
  does: ``prefill`` and ``forced_logits`` run, fp16, within 8 fp16 ulps
  of the reference's; ``decode`` and ``extend`` raise ``TypeError`` on
  both sides (the reference's scan carry).

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
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
from paddle_tpu.ops.flash_attention import flash_attention_val as jax_flash
from paddle_tpu.ops.pallas import fused_update as jfu
from paddle_tpu.serving import GPTDecodeModel as JaxDecodeModel
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_presets, state_dict_from_numpy)
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import fused_update as tfu
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import GPTDecodeModel
from test_torch_bf16_train import check_gemm_settings_are_the_models
from torch_checks import (FUSED_HYPER, flash_err, flash_fp16_limit,
                          run_checks)

torch.set_num_threads(2)

FP16 = {"dtype": "float16"}
SEED = 3
LOGIT_TOL = 1e-2
LOSS_RTOL = 3e-4
LR = 1e-3
SMALL_DO = 2.0 ** -16        # a GradScaler's unscaled gradients
DECODE_ULPS = 8


def _bits(t: torch.Tensor) -> np.ndarray:
    """The tensor's bits as integers (16-bit -> int16, fp32 -> int32)."""
    t = t.detach().cpu()
    return t.view(torch.int16 if t.element_size() == 2
                  else torch.int32).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _within(a, b, tol, what):
    """max |a - b| <= tol times the larger of 1 and max |b|."""
    a, b = _f32(a), _f32(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.abs(a - b).max())
    lim = tol * max(1.0, float(np.abs(b).max()))
    assert err <= lim, f"{what}: max abs diff {err:.3e} > {lim:.3e}"
    return err


def _jax_params(model):
    return {n: np.asarray(p._value) for n, p in model.named_parameters()}


def _models():
    """(JAX fp16 model, port fp16 model on its converted weights)."""
    jm = JaxGPT(jax_presets("gpt-test", **FP16), seed=SEED)
    cfg = gpt_presets("gpt-test", **FP16)
    tm = GPTForCausalLM(cfg, seed=SEED + 1, device="cpu")
    tm.load_state_dict(state_dict_from_numpy(_jax_params(jm), cfg))
    return jm, tm


def _batch(seed, b=2, s=32, vocab=256):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, (b, s)).astype(np.int64),
            rs.randint(0, vocab, (b, s)).astype(np.int64))


# ------------------------------------------------------------------ weights
def check_weights_equal_converted_jax(seed):
    cfg = gpt_presets("gpt-test", **FP16)
    jm = JaxGPT(jax_presets("gpt-test", **FP16), seed=seed)
    converted = state_dict_from_numpy(_jax_params(jm), cfg)
    port = GPTForCausalLM(cfg, seed=seed, device="cpu").state_dict()
    assert list(port) == list(converted)
    for name, t in converted.items():
        want = (torch.float32 if name.startswith("gpt.final_norm")
                else torch.float16)
        assert port[name].dtype == t.dtype == want, (name, t.dtype)
        assert np.array_equal(_bits(port[name]), _bits(t)), name


# -------------------------------------------------------------------- flash
def check_flash_plain_matches_jax(causal, do_scale):
    """The port's plain flash forward and backward (what a CPU tensor
    takes) on fp16 inputs against the reference's Pallas kernels in
    interpret mode, gradients through ``jax.vjp``, dO at ``do_scale``."""
    rs = np.random.RandomState(7 + causal)
    b, s, n, d = 2, 128, 2, 32
    q, k, v, do = (rs.randn(b, s, n, d).astype(np.float32)
                   for _ in range(4))
    do = do * np.float32(do_scale)
    jx = [jnp.asarray(x, jnp.float16) for x in (q, k, v, do)]
    out, vjp = jax.vjp(lambda a, c, e: jax_flash(a, c, e, causal=causal,
                                                 block_q=64, block_k=32),
                       *jx[:3])
    jdq, jdk, jdv = vjp(jx[3])
    tx = [torch.from_numpy(x).half().requires_grad_(i < 3)
          for i, x in enumerate((q, k, v, do))]
    tout = tfa.flash_attention_val(*tx[:3], causal=causal)
    tdq, tdk, tdv = torch.autograd.grad(tout, tx[:3], tx[3])
    for name, a, ref in (("out", tout, out), ("dq", tdq, jdq),
                         ("dk", tdk, jdk), ("dv", tdv, jdv)):
        assert a.dtype == torch.float16, (name, a.dtype)
        err, ratio = flash_err(name, torch.float16, a.detach(),
                               torch.tensor(_f32(ref)), do_scale)
        assert ratio <= 1.0, (f"flash causal={causal} dO x{do_scale} "
                              f"{name}: max abs diff {err:.3e}, "
                              f"{ratio:.3f} of its limit")


def _real_do_rms() -> float:
    """The RMS of the dO the first block's attention receives in a
    ``gpt-test`` fp16 backward (the mean LM loss over 2 x 32 tokens)."""
    cfg = gpt_presets("gpt-test", **FP16)
    tm = GPTForCausalLM(cfg, seed=SEED, device="cpu")
    seen = []
    real = tfa._FlashBNSD.backward

    def spy(ctx, do):
        seen.append(float(do.float().pow(2).mean().sqrt()))
        return real(ctx, do)

    ids, labels = _batch(9)
    tfa._FlashBNSD.backward = staticmethod(spy)
    try:
        GPTPretrainingCriterion()(tm(torch.from_numpy(ids)),
                                  torch.from_numpy(labels)).backward()
    finally:
        tfa._FlashBNSD.backward = staticmethod(real)
    assert len(seen) == cfg.num_layers, seen
    return seen[-1]     # the first block's, the last backward reached


def _fwd_model(q, k, v, causal, drop=None):
    """out as the fp16 forward rounds p: the fp32 p, less the row
    maximum, rounded to fp16 before P.V (``drop``: keys left out)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = 1.0 / np.sqrt(q.shape[-1])
    l2e = 1.4426950408889634
    raw = tfa._masked(qf @ kf.transpose(-1, -2), causal)
    e = torch.exp2(raw * (scale * l2e) - raw.amax(-1, keepdim=True)
                   * (scale * l2e))
    pe = e.clone()
    if drop is not None:
        pe[..., drop] = 0.0
    return (pe.half().float() @ vf / e.sum(-1, keepdim=True)).half()


def _dropped(dq, dk, q, k, v, do, lse, delta, causal):
    """dq and dk of the scaled model with keys 0-15 left out of dS.K and
    queries 0-15 out of dS^T.Q (the planted fault)."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    l2e = 1.4426950408889634
    s = tfa._masked(qf @ kf.transpose(-1, -2), causal)
    p = torch.exp2(s * (scale * l2e) - lse * l2e)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    return (dq.float() - ds[..., :16] @ kf[..., :16, :] * scale,
            dk.float() - ds[..., :16, :].transpose(-1, -2)
            @ qf[..., :16, :] * scale)


def check_flash_rounding_model_within_limit(causal, real_rms):
    """The fp16 kernels' rounding (p to fp16; dS scaled per row, then
    rounded) holds ``flash_fp16_limit`` at s = 1024, d = 64 for dO at
    unit scale, at the measured ``gpt-test`` scale, at GPT-125M's
    1/(b s) and at 2^-16; dS rounded as it is, or split hi + lo, does
    not at the small scales; a kernel that drops a 16-wide chunk is
    flagged."""
    rs = np.random.RandomState(11 + causal)
    q, k, v, do1 = (torch.from_numpy(rs.randn(1, 2, 1024, 64).astype(
        np.float32)) for _ in range(4))
    q, k, v = q.half(), k.half(), v.half()
    out, lse = tfa.flash_fwd_plain(q, k, v, causal)
    err, ratio = flash_err("out", torch.float16, _fwd_model(q, k, v, causal),
                           out)
    assert ratio <= 1.0, f"forward model: {err:.3e}, {ratio:.3f}"
    bad = _fwd_model(q, k, v, causal, drop=slice(0, 16)).float()
    assert bool(((bad - out.float()).abs() > flash_fp16_limit(out))
                .any()), "forward fault not seen"
    gpt125m = 1.0 / (8 * 1024)
    for sc in (1.0, real_rms, gpt125m, SMALL_DO):
        do = (do1 * sc).half()
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        plain = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal)
        ratios = {}
        for mode in ("scaled", "plain", "split"):
            got = tfa.flash_bwd_fp16_model(q, k, v, do, lse, delta, causal,
                                           mode)
            ratios[mode] = max(
                flash_err(n, torch.float16, a, b, sc)[1]
                for n, a, b in zip(("dq", "dk", "dv"), got, plain))
        assert ratios["scaled"] <= 1.0, (sc, ratios)
        if sc <= gpt125m:
            assert ratios["plain"] > 1.0 and ratios["split"] > 1.0, (
                sc, ratios)
        if sc == 1.0:
            dq, dk, _ = tfa.flash_bwd_fp16_model(q, k, v, do, lse, delta,
                                                 causal)
            for name, a, b in zip(("dq", "dk"), _dropped(
                    dq, dk, q, k, v, do, lse, delta, causal), plain):
                assert bool(((a - b.float()).abs()
                             > flash_fp16_limit(b)).any()), \
                    f"fault not seen in {name}"


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
    return (torch.from_numpy(p).half(), torch.from_numpy(g).half(), slots)


def check_fused_update_matches_reference(kind, wd, zero_moments):
    hyper = FUSED_HYPER[kind]
    pb, gb, slots = _update_case(kind, 1003, 11 + len(kind), zero_moments)
    lr = np.float32(LR)
    js = {k: jnp.asarray(v) for k, v in slots.items()}
    jp, jg = jnp.asarray(pb.numpy()), jnp.asarray(gb.numpy())
    tp = pb.clone()
    _, ts = tfu.fused_update_flat(tp, gb, {k: torch.tensor(v) for k, v in
                                           slots.items()},
                                  torch.tensor(lr), kind=kind, hyper=hyper,
                                  wd=wd)
    assert tp.dtype == torch.float16
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
        assert str(np.asarray(ref).dtype) == "float16", (what, name)
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


def check_fp16_on_the_wire():
    """The dequantizing update takes fp16 buckets (Queue A 6.4, ported
    since; ``tests/test_torch_fp16_wire.py`` holds them against the
    reference): a table of fp16 parameters is built with the fp16 dtype
    word, and a bucket dtype of the other 16-bit type is refused."""
    p = torch.zeros(8, dtype=torch.float16)
    q = torch.zeros(8, dtype=torch.int32)
    t = tfu.BucketTable("sgd", {}, [
        (p, tfu.WirePayload(q, torch.ones(2)), [], 0.0, 1.0)],
        block_size=4)
    assert int(t.words[0, 0, 9]) == tfu.BUCKET_DTYPES[torch.float16][0]
    with pytest.raises(TypeError, match="bucket dtype"):
        tfu.BucketTable("sgd", {}, [
            (p, tfu.WirePayload(q, torch.ones(2), None, torch.bfloat16), [],
             0.0, 1.0)], block_size=4)


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
def check_train_steps_match_jax():
    jm, tm = _models()
    ids, labels = _batch(2)
    jo = jopt.AdamW(learning_rate=LR, weight_decay=0.01,
                    parameters=jm.parameters())
    jcrit = JaxCriterion()
    jstep = JaxTrainStep(jm, lambda lg, lb: jcrit(lg, lb), jo)
    to = AdamW(learning_rate=LR, weight_decay=0.01,
               parameters=tm.parameters())
    tstep = TrainStep(tm, GPTPretrainingCriterion(), to)
    for i in range(3):
        jl = float(jstep(inputs=(paddle.to_tensor(ids),),
                         labels=(paddle.to_tensor(labels),)))
        tl = float(tstep(inputs=(ids,), labels=(labels,)))
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl), \
            f"loss at step {i}: {tl} vs {jl}"
    jplan = jax_buckets(list(jm.parameters()))
    assert [(b.param_indices, b.size, str(b.dtype)) for b in jplan] == \
        [(b.param_indices, b.size, str(b.dtype).split(".")[-1])
         for b in tstep.buckets]
    assert {str(b.dtype) for b in tstep.buckets} == {"torch.float16",
                                                       "torch.float32"}
    for slots in tstep.updater._slots.values():
        assert all(v.dtype == torch.float32 for v in slots.values())


# ------------------------------------------------------------------- decode
def _within_fp16_ulps(got, want, what):
    assert got.dtype == torch.float16, (what, got.dtype)
    want = np.asarray(want)
    assert want.dtype == np.float16, (what, want.dtype)
    want = want.astype(np.float32)
    err = float(np.abs(got.float().numpy() - want).max())
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 10)
    assert err <= DECODE_ULPS * ulp, f"{what}: {err / ulp:.1f} fp16 ulps"


def check_decode_model_as_reference():
    jm, tm = _models()
    jdm, tdm = JaxDecodeModel(jm), GPTDecodeModel(tm)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 256, n) for n in (5, 13, 9)]
    jl, jkv = jdm.prefill(prompts)
    tl, tkv = tdm.prefill(prompts)
    _within_fp16_ulps(tl, jl, "prefill logits")
    for i, (a, b) in enumerate(zip(tkv, jkv)):
        assert tuple(a.shape) == b.shape, (a.shape, b.shape)
        _within_fp16_ulps(a, b, f"prefill kv {i}")
    ids = rs.randint(0, 256, (2, 16))
    _within_fp16_ulps(tdm.forced_logits(ids), jdm.forced_logits(ids),
                      "forced_logits")
    ept = jdm.elems_per_token
    z = np.zeros(2, np.int32)
    past = np.zeros((2, 8, ept), np.float32)
    for dm in (jdm, tdm):
        with pytest.raises(TypeError):
            dm.decode(z, z, past, z)
        with pytest.raises(TypeError):
            dm.extend(np.zeros((2, 4), np.int32), np.zeros((2, 4), np.int32),
                      past, z, z + 4)


def test_fp16_train_port_matches_reference(fresh_mesh):
    real_rms = _real_do_rms()
    run_checks([
        (check_weights_equal_converted_jax, (0,)),
        (check_weights_equal_converted_jax, (7,)),
        *((check_flash_plain_matches_jax, (causal, sc))
          for causal in (True, False) for sc in (1.0, SMALL_DO)),
        (check_flash_rounding_model_within_limit, (True, real_rms)),
        (check_flash_rounding_model_within_limit, (False, real_rms)),
        *((check_fused_update_matches_reference, (kind, wd, zero))
          for kind in ("sgd", "momentum", "adam", "adamw")
          for wd in (0.0, 0.01) for zero in (True, False)),
        (check_fp16_on_the_wire, ()),
        (check_forward_and_loss_match_jax, ()),
        (check_train_steps_match_jax, ()),
        (check_gemm_settings_are_the_models, ("float16",)),
        (check_decode_model_as_reference, ()),
    ])
