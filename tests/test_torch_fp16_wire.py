"""fp16 on the port's quantized gradient wire (``paddle_tpu_torch``: the
codecs from and into fp16, the dequantizing update over fp16 buckets,
``TrainStep(grad_comm=...)`` on an fp16 GPT) against the JAX reference on
the CPU.

Bucket level, bit for bit, each payload ``world`` ranks' gradients
encoded with the scales of their summed abs-max and summed, as the wire
makes it:
- an fp16 flat encoded where it lies (``int8_block`` and ``fp8_block``,
  wire dtype and carrier, ``out=`` too): abs-max, scales, payload and
  error-feedback residual against the reference's jnp pair and its
  ``_encode_kernel`` in interpret mode, which lift the bucket to fp32;
- summed carriers decoded into fp16 at world 2 and 3 against the jnp
  pair; against ``_decode_kernel`` (interpret) at world 2, and at world 3
  its rounded ``vals * float32(1/3)`` pinned (the port divides exactly,
  as the jnp pair does: ROADMAP, "rounding matched on purpose");
- the dequantizing update over an fp16 bucket and over an fp16 bucket of
  fp32 parameters (SGD, Momentum, AdamW, residual off and on) at world 2
  and 3 against the reference's jnp decode, fp16 cast and
  ``reference_update_flat`` run op by op: parameters, moments and powers
  bit for bit; at world 2 against ``_dequant_kernel`` (interpret) too,
  whose compiled update XLA contracts into FMAs
  (``tests/test_torch_dequant_update.py`` measures it): fp32 values
  within 8 ulp of the array's largest, fp16 parameters within one fp16
  ulp on at most 0.1% of the elements, the rest bit for bit; the table's
  dtype words.
Every bucket plants fp16 subnormals (gradients of 1e-7 to 6e-5, below
fp16's least normal 6.1e-5); the codec cases also values near 65,504, so
that a decode keeps subnormals and rounds past 65,504 to inf as the
reference's ``.astype(float16)`` does.

Model level: ``gpt-test`` in fp16 (the reference's weights, seed 7; fp16
blocks and tables, the fp32 final norm) under ``TrainStep(grad_comm=
"int8_block")`` at world 2 for 2 steps, with error feedback and without.
The reference runs on a 2-device ``data`` mesh with
``FLAGS_kernel_autotune`` on (its Pallas dequantizing update) and off;
the port runs 2 gloo ranks (``tests/torch_dp_workers.py``
``fp16_dp_cases``). Held as ``tests/test_torch_bf16_dp.py`` holds bf16:
losses within 3e-4 relative, ``comm_stats`` the reference's, every
parameter and moment within ``2 * lr * steps``, and the shares of fp16
parameters within one fp16 ulp and of fp32 elements within rtol 1e-6 /
atol 1e-7 at least the no-wire control's (each framework's plain
``TrainStep``) less 2 points; the ranks end bit-identical.

The kernels themselves run on the card only (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 48). The file collects one test that runs every
case (``tests/torch_checks.py`` says why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed.mesh as mesh_mod
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import grad_comm as jgc
from paddle_tpu.framework import flags as jflags
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_presets as jax_presets
from paddle_tpu.ops.pallas import codec as jpc
from paddle_tpu.ops.pallas import fused_update as jfu
from paddle_tpu_torch.distributed import grad_comm as tgc
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.ops import codec as tcodec
from paddle_tpu_torch.ops import fused_update as tfu
from paddle_tpu_torch.optimizer import AdamW
from test_torch_dp_train import IDS, LABELS, _gpt_loss, _ref_run
from torch_checks import FUSED_HYPER, fp16_ulp, run_checks
import torch_dp_workers as workers

torch.set_num_threads(2)

F16 = torch.float16
CODECS = ("int8_block", "fp8_block")
WD = 0.01
LR, STEPS = 1e-3, 2
LOSS_RTOL = 3e-4
MARGIN = 0.02          # points of share below the no-wire control
WIRE_BYTES = 125_164   # gpt-test's two buckets on the int8_block wire


# ------------------------------------------------------------ bucket level
def _fp16_grads(n, bs, world, seed, big=True):
    """``world`` ranks' fp16 gradients: randn * 1e-3 with a block of fp16
    subnormals (1e-7 .. 6e-5) and, with ``big``, a block whose largest
    values lie near 65,504 in every rank, so that the average does."""
    rs = np.random.RandomState(seed)
    out = []
    for r in range(world):
        x = rs.randn(n) * 1e-3
        x[:bs] = rs.choice([-1, 1], bs) * np.exp(rs.uniform(
            np.log(1e-7), np.log(6e-5), bs))
        if big and n >= 2 * bs:
            x[bs:2 * bs] = rs.randn(bs) * 1e4
            x[bs:bs + 4] = [65504.0, -65504.0, 65488.0, 65000.0 + r]
        out.append(torch.from_numpy(x.astype(np.float32)).to(F16))
    return out


def _jf16(t):
    """An fp16 tensor as the same jnp float16 values."""
    return jnp.asarray(t.numpy())


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32, 1: np.uint8}[a.dtype.itemsize])


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (what, a.shape, b.shape, a.dtype, b.dtype)
    diff = _bits(a) != _bits(b)
    assert not diff.any(), f"{what}: {int(diff.sum())} of {a.size} differ"


def _payload(codec, grads, bs):
    """The summed carrier and the shared scales, the port's way."""
    absmax = sum(tgc.block_absmax(g, bs) for g in grads)
    scales = tgc.block_scales(absmax, codec)
    q = sum(tcodec.block_encode(g, scales, bs, codec, carrier=True)
            for g in grads)
    return q, scales


def check_fp16_encode_matches_reference(codec, n, bs, carrier):
    """Each rank's fp16 flat encoded where it lies: abs-max, scales, the
    payload and the residual bit for bit the jnp pair's and the interpret
    kernel's."""
    grads = _fp16_grads(n, bs, 3, seed=n + bs)
    t_am = [tgc.block_absmax(g, bs) for g in grads]
    j_am = [jgc.block_absmax(_jf16(g), bs) for g in grads]
    for a, b in zip(t_am, j_am):
        assert a.dtype == torch.float32
        _same(a.numpy(), b, "abs-max")
    t_s = tgc.block_scales(sum(t_am), codec)
    j_s = jgc.block_scales(sum(j_am), codec)
    _same(t_s.numpy(), j_s, "scales")
    for g in grads:
        t_q = tcodec.block_encode(g, t_s, bs, codec, carrier=carrier)
        ref = jgc.block_encode(_jf16(g), j_s, bs, codec)       # the carrier
        kern = jpc.block_encode(_jf16(g), j_s, bs, codec)      # interpret
        if carrier:
            assert t_q.dtype == tgc.CARRIER_DTYPE[codec]
            _same(t_q.numpy(), ref, "carrier vs jnp")
            _same(t_q.numpy(), np.asarray(kern).astype(t_q.numpy().dtype),
                  "carrier vs kernel")
        else:
            assert t_q.dtype == tgc.WIRE_DTYPE[codec]
            for r in (ref, kern):
                want = (np.asarray(r).astype(np.int8).view(np.uint8)
                        if codec == "int8_block" else np.asarray(
                            jnp.asarray(r).astype(jnp.float8_e4m3fn)
                        ).view(np.uint8))
                _same(t_q.view(torch.uint8).numpy(), want, "wire bytes")
        out = torch.empty_like(t_q)
        assert tcodec.block_encode(g, t_s, bs, codec, carrier=carrier,
                                   out=out) is out
        assert torch.equal(out.view(torch.uint8), t_q.view(torch.uint8))
        t_r = tgc.block_residual(g, t_q, t_s, n)
        j_r = jgc.block_residual(_jf16(g), ref, j_s, n)
        assert t_r.dtype == torch.float32
        _same(t_r.numpy(), j_r, "residual")


def check_fp16_decode_matches_reference(codec, n, bs, world):
    """``world`` ranks' summed carriers decoded into fp16 (rounded once,
    from the fp32 ``q * scale / world``): bit for bit the jnp pair's;
    the interpret kernel's at world 2, its reciprocal pinned at world 3.
    The planted blocks decode to fp16 subnormals and to inf."""
    grads = _fp16_grads(n, bs, world, seed=7 * n + bs + world)
    q, t_s = _payload(codec, grads, bs)
    t_d = tcodec.block_decode(q, t_s, world, n, dtype=F16)
    assert t_d.dtype == F16 and t_d.shape == (n,)
    jq, js = jnp.asarray(q.numpy()), jnp.asarray(t_s.numpy())
    ref = jgc.block_decode(jq, js, world, jnp.float16, n)
    _same(t_d.numpy(), ref, f"decode vs jnp, world {world}")
    kern = jpc.block_decode(jq, js, world, jnp.float16, n)
    if world & (world - 1) == 0:
        _same(t_d.numpy(), kern, f"decode vs kernel, world {world}")
    else:
        vals = (q.to(torch.float32) * t_s[:, None]).reshape(-1)[:n]
        _same(np.asarray(kern),
              (vals * np.float32(1.0 / world)).to(F16).numpy(),
              "kernel's reciprocal")
    d = t_d.float()
    sub = (d != 0) & (d.abs() < 2.0 ** -14)
    assert bool(sub[:bs].any()), "no fp16 subnormal decoded"
    if n >= 2 * bs:
        assert bool(torch.isinf(d[bs:2 * bs]).any()) or bool(
            (d[bs:2 * bs].abs() > 6e4).any()), "nothing near 65,504"


def _state(kind, n, seed, dtype):
    rs = np.random.RandomState(seed)
    p = torch.from_numpy(rs.randn(n).astype(np.float32)).to(dtype)
    slots = {}
    for nm in tfu.slot_names(kind):
        v = (rs.randn(n) * 1e-2).astype(np.float32)
        slots[nm] = np.abs(v) * 1e-2 if nm == "moment2" else v
    if kind in ("adam", "adamw"):
        slots["beta1_pow"] = np.float32(0.9 ** 3)
        slots["beta2_pow"] = np.float32(0.999 ** 3)
    return p, slots


def _within_8_ulp(a, b, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    bound = 8 * np.spacing(np.float32(np.abs(b).max()))
    err = float(np.abs(a - b).max())
    assert err <= bound, f"{what}: max abs diff {err} > {bound}"


def _one_fp16_ulp(a, b, what):
    """fp16 ``a`` bit for bit ``b`` but where XLA's FMA contraction moved
    the fp32 update across a rounding boundary: one fp16 ulp, on at most
    0.1% of the elements."""
    a, b = np.asarray(a), np.asarray(b)
    off = _bits(a) != _bits(b)
    ulp = fp16_ulp(torch.from_numpy(np.maximum(np.abs(a), np.abs(b))
                                    .astype(np.float32))).numpy()
    diff = np.abs(a.astype(np.float32) - b.astype(np.float32))
    assert (diff[off] <= ulp[off]).all() and off.mean() <= 1e-3, \
        f"{what}: {int(off.sum())} of {a.size} differ, worst {diff.max()}"


def check_fp16_dequant_matches_reference(codec, kind, residual, p_dtype):
    """An fp16 bucket (over fp16 parameters, or over fp32 ones) through
    the port's ``fused_dequant_update_flat`` (its plain walk on the CPU),
    at world 2 and 3, against the jnp decode, the fp16 cast and
    ``reference_update_flat`` op by op, bit for bit; at world 2 against
    ``_dequant_kernel`` in interpret mode as well, whose compiled fp32
    update XLA contracts into FMAs (8 ulp of the array's largest for fp32
    values, one fp16 ulp on at most 0.1% of the fp16 parameters). The
    gradients hold fp16 subnormals; none is near 65,504, whose inf would
    make the update NaN."""
    n, bs = 4999, 1024
    seed = 500 + 7 * ("sgd", "momentum", "adamw").index(kind) + (
        100 if residual else 0) + (50 if p_dtype == F16 else 0)
    hyper = FUSED_HYPER[kind]
    p, slots = _state(kind, n, seed + 1, p_dtype)
    res = (np.random.RandomState(seed + 2).randn(n) * 1e-5).astype(
        np.float32) if residual else None
    jr = None if res is None else jnp.asarray(res)
    jslots = {k: jnp.asarray(v) for k, v in slots.items()}
    jp = jnp.asarray(p.numpy())
    what = f"{codec} {kind} residual={residual} p {p_dtype}"
    for world in (2, 3):
        q, scales = _payload(codec, _fp16_grads(n, bs, world, seed + world,
                                                big=False), bs)
        tp = p.clone()
        _, ts = tfu.fused_dequant_update_flat(
            tp, q, scales, world,
            {k: torch.tensor(v) for k, v in slots.items()},
            torch.tensor(np.float32(LR)), kind=kind, hyper=hyper,
            block_size=bs, bucket_dtype=F16, wd=WD,
            residual=None if res is None else torch.from_numpy(res))
        assert tp.dtype == p_dtype
        jq, js = jnp.asarray(q.numpy()), jnp.asarray(scales.numpy())
        with jax.disable_jit():
            g = jgc.block_decode(jq, js, world, jnp.float32, n)
            if jr is not None:
                g = g + jr
            ep, es = jfu.reference_update_flat(
                jp, g.astype(jnp.float16), dict(jslots),
                jnp.asarray(np.float32(LR)), kind=kind, hyper=hyper, wd=WD)
        refs = [("op by op", ep, es)]
        if world == 2:
            refs.append(("Pallas", *jfu.fused_dequant_update_flat(
                jp, jq, js, 2, dict(jslots), jnp.asarray(np.float32(LR)),
                kind=kind, hyper=hyper, block_size=bs,
                bucket_dtype=jnp.float16, wd=WD, residual=jr)))
        for ref, rp, rs in refs:
            w = f"{what} world {world}"
            assert np.asarray(rp).dtype == tp.numpy().dtype, (w, rp.dtype)
            if ref == "op by op":
                _same(tp.numpy(), rp, f"{w} p vs {ref}")
            elif p_dtype == F16:
                _one_fp16_ulp(tp.numpy(), rp, f"{w} p vs {ref}")
            else:
                _within_8_ulp(tp.numpy(), rp, f"{w} p vs {ref}")
            assert set(ts) == set(rs)
            for k in ts:
                if ref == "op by op" or ts[k].dim() == 0:
                    _same(ts[k].numpy(), rs[k], f"{w} {k} vs {ref}")
                else:
                    _within_8_ulp(ts[k].numpy(), rs[k], f"{w} {k} vs {ref}")


def check_dequant_table_words():
    """The table's dtype words: fp16 parameters 3, an fp16 bucket over
    fp32 parameters 4 (its gradient rounded to fp16 first), bf16 over
    fp32 2; a 16-bit bucket over the other 16-bit type is refused."""
    q = torch.zeros(8, dtype=torch.int32)
    s = torch.ones(2)

    def word(p_dtype, b_dtype):
        t = tfu.BucketTable("sgd", {}, [
            (torch.zeros(8, dtype=p_dtype),
             tfu.WirePayload(q, s, None, b_dtype), [], 0.0, 1.0)],
            block_size=4)
        return int(t.words[0, 0, 9])

    assert [word(F16, None), word(F16, F16), word(F16, torch.float32),
            word(torch.float32, F16), word(torch.float32, torch.bfloat16),
            word(torch.float32, None)] == [3, 3, 3, 4, 2, 0]
    for pd, bd in ((F16, torch.bfloat16), (torch.bfloat16, F16)):
        try:
            word(pd, bd)
        except TypeError as e:
            assert "bucket dtype" in str(e)
        else:
            raise AssertionError(f"{bd} bucket over {pd} taken")


# ------------------------------------------------------------- model level
def _ref_gpt():
    return JaxGPT(jax_presets("gpt-test", dtype="float16"), seed=7)


def _gpt_bits():
    out = {}
    for n, p in _ref_gpt().named_parameters():
        a = np.asarray(p._value)
        out[n] = a.view(np.int16) if a.dtype.itemsize == 2 else a
    return out


_port, _control = {}, {}


def _port_runs():
    if not _port:
        _port["ranks"] = spawn(workers.fp16_dp_cases,
                               args=(_gpt_bits(), IDS, LABELS),
                               nprocs=2, timeout=240)
    return _port["ranks"]


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _shares(port, ref, what):
    """The share of fp16 parameter elements within one fp16 ulp of the
    reference's and of fp32 elements (the final norm, the moments) within
    rtol 1e-6 / atol 1e-7; asserts every element within
    ``2 * lr * steps``."""
    arrays = list(zip(port["params"], ref["params"], port["dtypes"]))
    for ps, rs in zip(port["slots"], ref["slots"]):
        assert set(ps) == set(rs), (what, set(ps), set(rs))
        arrays += [(ps[k], rs[k], "torch.float32") for k in rs]
    close = {"torch.float16": [0, 0], "torch.float32": [0, 0]}
    for a, b, dt in arrays:
        a, b = _f32(a), _f32(b)
        assert a.shape == b.shape, (what, a.shape, b.shape)
        diff = np.abs(a - b)
        worst = float(diff.max())
        assert worst <= 2 * LR * STEPS, f"{what}: max abs diff {worst}"
        if dt == "torch.float16":
            lim = fp16_ulp(torch.from_numpy(np.maximum(np.abs(a),
                                                       np.abs(b)))).numpy()
        else:
            lim = 1e-7 + 1e-6 * np.abs(b)
        close[dt][0] += int((diff <= lim).sum())
        close[dt][1] += diff.size
    return {dt: c / n for dt, (c, n) in close.items()}


def _no_wire_shares():
    if not _control:
        jm = _ref_gpt()
        jstep = JaxTrainStep(jm, _gpt_loss(), jopt.AdamW(
            learning_rate=LR, weight_decay=0.01, parameters=jm.parameters()))
        tm = workers.gpt_test_bf16(_gpt_bits(), "float16")
        tstep = TrainStep(tm, GPTPretrainingCriterion(), AdamW(
            learning_rate=LR, weight_decay=0.01, parameters=tm.parameters()))
        for _ in range(STEPS):
            jstep(inputs=(paddle.to_tensor(IDS),),
                  labels=(paddle.to_tensor(LABELS),))
            tstep(inputs=(IDS,), labels=(LABELS,))
        port = {"params": [workers._np(p) for p in tm.parameters()],
                "dtypes": [str(p.dtype) for p in tm.parameters()],
                "slots": workers._param_slots(tstep.updater)}
        ref = {"params": [np.asarray(p._value) for p in jm.parameters()],
               "slots": [{k: np.asarray(v) for k, v in s.items()}
                         for s in jstep._slots]}
        _control.update(_shares(port, ref, "no-wire control"))
    return _control


def check_gpt_fp16_int8_block_matches_reference(case, fused):
    port = _port_runs()[0][case]
    gc = jgc.GradCommConfig("int8_block", error_feedback=case == "ef")
    ref = _ref_run(_ref_gpt, _gpt_loss(), LR, gc, (IDS,), (LABELS,), STEPS,
                   fused)
    what = f"gpt-test fp16 {case} fused={fused}"
    np.testing.assert_allclose(port["losses"], ref["losses"],
                               rtol=LOSS_RTOL, err_msg=f"{what} losses")
    assert port["fused"] and port["table_builds"] == 1, what
    assert port["comm_stats"] == ref["comm_stats"], what
    assert (port["comm_stats"]["n_buckets"], port["comm_stats"]["collectives"],
            port["comm_stats"]["comm_bytes"]) == (2, 4, WIRE_BYTES), what
    assert set(port["dtypes"]) == {"torch.float16", "torch.float32"}
    shares, control = _shares(port, ref, what), _no_wire_shares()
    for dt, share in shares.items():
        assert share >= control[dt] - MARGIN, \
            (f"{what}: {share:.4f} of the {dt} elements close, the no-wire "
             f"control {control[dt]:.4f}")


def check_ranks_end_bit_identical():
    r0, r1 = _port_runs()
    for case in ("ef", "no_ef"):
        for a, b in zip(r0[case]["params"], r1[case]["params"]):
            assert a.view(np.int32).tobytes() == b.view(np.int32).tobytes(), \
                case
        assert r0[case]["losses"] == r1[case]["losses"], case
    res0 = r0["ef"]["residuals"]
    assert set(res0) == {0, 1} and all(r.dtype == np.float32
                                       for r in res0.values())
    assert r0["ef"]["state_round_trip"] and not r0["no_ef"]["residuals"]


def test_fp16_wire_port_matches_reference(fresh_mesh):
    prev_flag = jflags.flag("FLAGS_kernel_autotune")
    prev_mesh = mesh_mod.get_mesh()
    try:
        run_checks(
            [(check_fp16_encode_matches_reference, (c, n, bs, carrier))
             for c in CODECS for n, bs in ((5000, 1024), (777, 128))
             for carrier in (True, False)]
            + [(check_fp16_decode_matches_reference, (c, n, bs, w))
               for c in CODECS for n, bs in ((5000, 1024), (777, 128))
               for w in (2, 3)]
            + [(check_fp16_dequant_matches_reference, (c, k, r, pd))
               for c in CODECS for k in ("sgd", "momentum", "adamw")
               for r in (False, True) for pd in (F16, torch.float32)]
            + [(check_dequant_table_words, ())]
            + [(check_gpt_fp16_int8_block_matches_reference, (case, f))
               for case in ("ef", "no_ef") for f in (True, False)]
            + [(check_ranks_end_bit_identical, ())])
    finally:
        jflags.set_flags({"FLAGS_kernel_autotune": prev_flag})
        mesh_mod.set_mesh(prev_mesh)
        _port.clear()
        _control.clear()
