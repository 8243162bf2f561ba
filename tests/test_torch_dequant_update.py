"""Port fused dequantize-and-update (``paddle_tpu_torch/ops/fused_update.py``
``reference_dequant_update_flat``, ``fused_dequant_update_flat``, the
plain version of the CUDA kernel ``fused_dequant_update``) against the
JAX reference's ``fused_dequant_update_flat`` (the Pallas
``_dequant_kernel`` in interpret mode, or its decode-then-update fallback
where ``block_size`` does not fold into 128-lane rows) and against the
reference's eager decode (``grad_comm.block_decode``) followed by the
optimizer's ``_update`` rule, on the CPU.

Grid: ``int8_block`` / ``fp8_block`` x residual off / on x SGD,
Momentum (Nesterov), Adam, AdamW (weight decay 0.01) x ``block_size``
1024 and 96 x n = 5000 and 4999 (not a multiple of the kernel's 4-wide
vectors, nor of a block). Each payload is two ranks' carriers summed,
with the shared scales of their summed abs-max, as the gradient wire
makes it; world 2.

Tolerances:
- the port's wrapper on a CPU tensor against its plain version:
  bit-identical; the decoded gradient against the reference's eager
  ``block_decode`` (+ residual): identical;
- parameters and moments against the reference's eager ``_update`` and
  against its compiled ``fused_dequant_update_flat`` (Pallas interpret,
  or its jitted fallback): within 8 ulp of the array's largest
  magnitude, beta powers exact. XLA contracts ``a*b+c`` into FMAs on
  this CPU (``tests/test_torch_fused_update.py`` measures it), and even
  op by op its Adam step is not the correctly rounded one everywhere:
  one parameter of 5000 in the Adam case at block 1024 differs from the
  port's by one ulp while the moments agree bit for bit (measured).

bf16 buckets (bf16 parameters, fp32 moments; ``int8_block`` and
``fp8_block`` x SGD, Momentum, AdamW x residual off / on, n = 4999):
the port's ``fused_dequant_update_flat`` with ``bucket_dtype`` bf16
against the reference's (Pallas interpret) and against the reference's
jnp decode, + residual, the bf16 cast and ``reference_update_flat`` run
op by op (``jax.disable_jit``): parameters bit for bit against both (the
bf16 rounding takes up XLA's FMA contraction), moments bit for bit op
by op and within 8 ulp of the Pallas kernel's, beta powers exact.

One more case pins how the port's decode relates to the reference
kernel's at world 3: compiled, the reference's ``vals / world`` is a
multiply by ``float32(1/3)``; the port divides correctly rounded (as the
reference's jnp decode does). With SGD, lr 1 and zero parameters the
update returns ``-g`` exactly, which exposes the kernel's gradient.

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import grad_comm as jgc
from paddle_tpu.framework.tensor import Parameter
from paddle_tpu.ops.pallas import fused_update as jfu
from paddle_tpu_torch.distributed import grad_comm as tgc
from paddle_tpu_torch.ops import fused_update as tfu
from torch_checks import FUSED_HYPER, run_checks

torch.set_num_threads(2)

KINDS = ("sgd", "momentum", "adam", "adamw")
WD = 0.01
LR = np.float32(1e-3)


def _payload(codec, n, bs, world, seed):
    """``world`` ranks' gradients encoded with their shared scales and
    summed: (q_sum carrier [nb, bs], scales [nb]) as torch tensors."""
    rs = np.random.RandomState(seed)
    gs = [torch.from_numpy((rs.randn(n) * 1e-2).astype(np.float32))
          for _ in range(world)]
    absmax = sum(tgc.block_absmax(g, bs) for g in gs)
    scales = tgc.block_scales(absmax, codec)
    q = sum(tgc.block_encode(g, scales, bs, codec, carrier=True)
            for g in gs)
    return q, scales


def _state(kind, n, seed):
    rs = np.random.RandomState(seed)
    p = rs.randn(n).astype(np.float32)
    slots = {}
    for nm in tfu.slot_names(kind):
        v = (rs.randn(n) * 1e-2).astype(np.float32)
        slots[nm] = np.abs(v) * 1e-2 if nm == "moment2" else v
    if kind in ("adam", "adamw"):
        slots["beta1_pow"] = np.float32(0.9 ** 3)
        slots["beta2_pow"] = np.float32(0.999 ** 3)
    return p, slots


def _bits_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape)
    assert (a.view(np.int32) == b.view(np.int32)).all(), \
        f"{what}: {(a != b).sum()} of {a.size} elements differ"


def _normwise(a, b, what, ulps=8):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    bound = ulps * np.spacing(np.float32(np.abs(b).max()))
    err = float(np.abs(a - b).max())
    assert err <= bound, f"{what}: max abs diff {err} > {bound}"


def _optimizer(kind):
    ps = [Parameter(jnp.zeros(1))]
    return {"sgd": lambda: jopt.SGD(1e-3, parameters=ps),
            "momentum": lambda: jopt.Momentum(1e-3, 0.9, parameters=ps,
                                              use_nesterov=True),
            "adam": lambda: jopt.Adam(1e-3, parameters=ps),
            "adamw": lambda: jopt.AdamW(1e-3, parameters=ps)}[kind]()


def check_dequant_update_matches_reference(codec, residual, kind, bs, n):
    seed = n + bs + 7 * KINDS.index(kind) + (100 if residual else 0)
    hyper = FUSED_HYPER[kind]
    q, scales = _payload(codec, n, bs, 2, seed)
    p, slots = _state(kind, n, seed + 1)
    res = (np.random.RandomState(seed + 2).randn(n) * 1e-4).astype(
        np.float32) if residual else None
    t_res = None if res is None else torch.from_numpy(res)
    t_slots = {k: torch.tensor(v) for k, v in slots.items()}
    lr = torch.tensor(LR)
    # the plain version, and the wrapper on CPU tensors (in place)
    ref_p, ref_s = tfu.reference_dequant_update_flat(
        torch.from_numpy(p), q, scales, 2, t_slots, lr, kind=kind,
        hyper=hyper, block_size=bs, wd=WD, residual=t_res)
    tp = torch.from_numpy(p.copy())
    out, ts = tfu.fused_dequant_update_flat(
        tp, q, scales, 2, {k: v.clone() for k, v in t_slots.items()}, lr,
        kind=kind, hyper=hyper, block_size=bs, bucket_dtype=torch.float32,
        wd=WD, residual=t_res)
    assert out is tp and set(ts) == set(ref_s)
    _bits_equal(tp.numpy(), ref_p.numpy(), "wrapper p")
    for k in ts:
        _bits_equal(ts[k].numpy(), ref_s[k].numpy(), f"wrapper {k}")
    # the reference's eager decode, then the optimizer's _update
    jq, js = jnp.asarray(q.numpy()), jnp.asarray(scales.numpy())
    g = jgc.block_decode(jq, js, 2, jnp.float32, n)
    if res is not None:
        g = g + jnp.asarray(res)
    _bits_equal(tfu.dequant_grad(q, scales, 2, bs, n, t_res).numpy(), g,
                "decoded gradient")
    jslots = {k: jnp.asarray(v) for k, v in slots.items()}
    ep, es = _optimizer(kind)._update(jnp.asarray(p), g, dict(jslots),
                                      jnp.asarray(LR), 1.0, WD)
    _normwise(tp.numpy(), ep, "p vs eager decode + _update")
    for k in ts:
        if ts[k].dim() == 0:
            _bits_equal(ts[k].numpy(), es[k], f"{k} vs eager _update")
        else:
            _normwise(ts[k].numpy(), es[k], f"{k} vs eager _update")
    # the reference's fused_dequant_update_flat (Pallas interpret mode)
    kp, ks = jfu.fused_dequant_update_flat(
        jnp.asarray(p), jq, js, 2, dict(jslots), jnp.asarray(LR), kind=kind,
        hyper=hyper, block_size=bs, bucket_dtype=jnp.float32, wd=WD,
        residual=None if res is None else jnp.asarray(res))
    _normwise(tp.numpy(), kp, "p vs Pallas")
    for k in ts:
        if ts[k].dim() == 0:
            _bits_equal(ts[k].numpy(), ks[k], f"{k} vs Pallas")
        else:
            _normwise(ts[k].numpy(), ks[k], f"{k} vs Pallas")


def check_world_3_true_division_vs_reciprocal(codec):
    """SGD, lr 1, p = 0: the update is ``-g``, so the reference kernel's
    gradient shows. It is ``q*s * float32(1/3)``; the port's is
    ``q*s / 3``, one rounding away on some elements."""
    n, bs = 4096, 1024
    q, scales = _payload(codec, n, bs, 3, 5)
    vals = (q.to(torch.float32) * scales[:, None]).reshape(-1)[:n]
    zero = np.zeros(n, np.float32)
    kp, _ = jfu.fused_dequant_update_flat(
        jnp.asarray(zero), jnp.asarray(q.numpy()), jnp.asarray(scales.numpy()),
        3, {}, jnp.asarray(np.float32(1.0)), kind="sgd", hyper={},
        block_size=bs)
    recip = (vals * np.float32(1.0 / 3)).numpy()
    # p - 1 * g with p = 0 is 0 - g: +0 where g is 0, as below
    _bits_equal(np.asarray(kp), zero - recip, "reference kernel's gradient")
    tp = torch.zeros(n)
    tfu.fused_dequant_update_flat(tp, q, scales, 3, {}, torch.tensor(1.0),
                                  kind="sgd", hyper={}, block_size=bs)
    exact = (vals / torch.tensor(3.0)).numpy()
    _bits_equal(tp.numpy(), zero - exact, "port's gradient")
    # the jnp decode divides exactly too
    _bits_equal(exact, jgc.block_decode(jnp.asarray(q.numpy()),
                                        jnp.asarray(scales.numpy()), 3,
                                        jnp.float32, n), "jnp decode")
    differ = exact != recip
    assert differ.any(), "world 3 should show the reciprocal's rounding"
    assert np.allclose(exact, recip, rtol=2 ** -23, atol=0)


def _bf16_np(t):
    """A bf16 tensor's values as fp32 numpy (exact)."""
    return t.to(torch.float32).numpy()


def check_bf16_bucket_matches_reference(codec, kind, residual):
    """A bf16 bucket (bf16 parameters, fp32 moments) at a ragged size, the
    same summed payload, parameters and moments through the port's
    ``fused_dequant_update_flat`` (its plain walk on the CPU), the
    reference's ``fused_dequant_update_flat`` with ``bucket_dtype``
    bfloat16 (Pallas interpret) and the reference's jnp decode (+
    residual), the bf16 cast and ``reference_update_flat`` op by op:
    parameters, moments and powers bit for bit, except the fp32 moments
    against the compiled Pallas kernel, within 8 ulp of the array's
    largest (XLA contracts FMAs, as in the fp32 cases above)."""
    n, bs = 4999, 1024
    seed = 300 + 7 * KINDS.index(kind) + (100 if residual else 0)
    hyper = FUSED_HYPER[kind]
    q, scales = _payload(codec, n, bs, 2, seed)
    p32, slots = _state(kind, n, seed + 1)
    p = torch.from_numpy(p32).to(torch.bfloat16)
    res = (np.random.RandomState(seed + 2).randn(n) * 1e-3).astype(
        np.float32) if residual else None
    t_res = None if res is None else torch.from_numpy(res)
    tp = p.clone()
    _, ts = tfu.fused_dequant_update_flat(
        tp, q, scales, 2, {k: torch.tensor(v) for k, v in slots.items()},
        torch.tensor(LR), kind=kind, hyper=hyper, block_size=bs,
        bucket_dtype=torch.bfloat16, wd=WD, residual=t_res)
    jp = jnp.asarray(_bf16_np(p)).astype(jnp.bfloat16)
    jq, js = jnp.asarray(q.numpy()), jnp.asarray(scales.numpy())
    jslots = {k: jnp.asarray(v) for k, v in slots.items()}
    jr = None if res is None else jnp.asarray(res)
    kp, ks = jfu.fused_dequant_update_flat(
        jp, jq, js, 2, dict(jslots), jnp.asarray(LR), kind=kind,
        hyper=hyper, block_size=bs, bucket_dtype=jnp.bfloat16, wd=WD,
        residual=jr)
    with jax.disable_jit():
        g = jgc.block_decode(jq, js, 2, jnp.float32, n)
        if jr is not None:
            g = g + jr
        ep, es = jfu.reference_update_flat(
            jp, g.astype(jnp.bfloat16), dict(jslots), jnp.asarray(LR),
            kind=kind, hyper=hyper, wd=WD)
    assert tp.dtype == torch.bfloat16
    what = f"{codec} {kind} residual={residual}"
    for ref, rp, rs in (("Pallas", kp, ks), ("op by op", ep, es)):
        assert rp.dtype == jnp.bfloat16, (ref, rp.dtype)
        _bits_equal(_bf16_np(tp), np.asarray(rp.astype(jnp.float32)),
                    f"{what} p vs {ref}")
        assert set(ts) == set(rs)
        for k in ts:
            if ref == "op by op" or ts[k].dim() == 0:
                _bits_equal(ts[k].numpy(), np.asarray(rs[k]),
                            f"{what} {k} vs {ref}")
            else:   # the fp32 moments: XLA's FMA contraction
                _normwise(ts[k].numpy(), rs[k], f"{what} {k} vs {ref}")


def check_wrapper_checks():
    p = torch.zeros(8)
    q, scales = _payload("int8_block", 8, 4, 2, 0)
    with pytest.raises(ValueError, match="kind"):
        tfu.fused_dequant_update_flat(p, q, scales, 2, {}, torch.tensor(1.0),
                                      kind="lamb", hyper={}, block_size=4)
    with pytest.raises(TypeError, match="bucket dtype"):
        tfu.fused_dequant_update_flat(p, q, scales, 2, {}, torch.tensor(1.0),
                                      kind="sgd", hyper={}, block_size=4,
                                      bucket_dtype=torch.float64)
    before = tfu.dequant_launch_counts()
    tfu.fused_dequant_update_flat(p, q, scales, 2, {}, torch.tensor(1.0),
                                  kind="sgd", hyper={}, block_size=4)
    assert tfu.dequant_launch_counts() == before   # CPU: no launch


def test_dequant_update_matches_reference(fresh_mesh):
    run_checks(
        [(check_dequant_update_matches_reference, (c, r, k, bs, n))
         for c in ("int8_block", "fp8_block") for r in (False, True)
         for k in KINDS for bs in (1024, 96) for n in (5000, 4999)]
        + [(check_world_3_true_division_vs_reciprocal, (c,))
           for c in ("int8_block", "fp8_block")]
        + [(check_bf16_bucket_matches_reference, (c, k, r))
           for c in ("int8_block", "fp8_block")
           for k in ("sgd", "momentum", "adamw") for r in (False, True)]
        + [(check_wrapper_checks, ())])
