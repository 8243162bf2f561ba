"""int8 weight-only inference on fp16 activations in the port
(``paddle_tpu_torch.ops.quant_matmul`` on fp16 ``x``, ``Int8Linear`` under
``amp.decorate``/``auto_cast`` at O2 in float16) against the JAX
reference on the CPU.

- ``quant_matmul_plain`` (the plain version of the ``quant_matmul_16``
  kernels, which the wrapper takes on a CPU tensor) on fp16 ``x`` against
  the reference's ``quant_matmul`` at BERT-base's (k, n) narrowed to test
  width: m = 64 (the cluster route's m on the card) and m = 512 (an m of
  the wgmma route), k = 512, whose tiles the reference's Pallas kernel
  takes (interpret mode), and k = 768, which its default (256, 256, 512)
  tiles do not divide, so that it takes its ragged jnp route
  ``x.f32 @ (q.f32 * scales)`` (scaled before the sum, not after). Held
  within ``torch_checks.qmm_fp16_limit`` (the fp32 limit plus one fp16
  ulp of the port's element); some outputs past 65,504 would be inf on
  both sides. Also ``out_dtype=float32`` from fp16 ``x`` (the port's
  kernels write fp32 from the same accumulator, as the reference's
  ``(acc * s).astype(out_dtype)``), within ``qmm_limit``.
- ``bert-test`` decorated at O2 in float16, converted to int8 and run
  under ``auto_cast(level="O2", dtype="float16")`` on both sides: the
  cast sequence op for op, the dtype of every ``quant_matmul``'s ``x``
  (9 fp16 where a cast point fed it, 6 fp32 after a ``layer_norm``,
  which O2 runs in fp32, as at bf16), and the MLM and NSP logits fp16
  (the decorated NSP bias is fp16) within 4 fp16 ulps of the largest
  reference logit (measured: 1.69 and 1.75).

The kernels themselves run on the card only (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 50). The file collects one test that runs every
case (``tests/torch_checks.py`` says why).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu.amp as jamp
from paddle_tpu.quantization import convert_to_int8 as jax_convert
import paddle_tpu_torch.amp as tamp
from paddle_tpu_torch.quantization import convert_to_int8
from test_torch_bert_train import _batch, _carried, _diff, _jt, _name, \
    _recording
from torch_checks import fp16_ulp, qmm_fp16_limit, qmm_limit, run_checks

torch.set_num_threads(2)

jqm = importlib.import_module("paddle_tpu.ops.quant_matmul")
tqm = importlib.import_module("paddle_tpu_torch.ops.quant_matmul")
F16 = "float16"
LOGIT_ULPS = 4


def _operands(m, k, n, seed):
    """fp16 x (randn), int8 q and fp32 scales as BERT's weights quantize
    (``quantize_int8`` of randn * 0.02), as torch and jnp arrays."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(m, k).astype(np.float32)).half()
    q, s = tqm.quantize_int8_plain(torch.from_numpy(
        (rs.randn(k, n) * 0.02).astype(np.float32)))
    return x, q, s, (jnp.asarray(x.numpy()), jnp.asarray(q.numpy()),
                     jnp.asarray(s.numpy()))


def check_quant_matmul_fp16_matches_reference(m, k, n):
    x, q, s, (jx, jq, js) = _operands(m, k, n, seed=m + k + n)
    out = tqm.quant_matmul(x, q, s)
    assert out.dtype == torch.float16 and out.shape == (m, n)
    assert torch.equal(out.view(torch.int16), tqm.quant_matmul_plain(
        x, q, s).view(torch.int16))
    ref = torch.from_numpy(np.asarray(jqm.quant_matmul(jx, jq, js)))
    assert ref.dtype == torch.float16
    diff = torch.where(out == ref, 0.0, (out.double() - ref.double()).abs())
    limit = qmm_fp16_limit(x, q, s, out)
    assert bool((diff <= limit).all()), \
        f"{(m, k, n)}: max diff / limit {float((diff / limit).max()):.3f}"
    out32 = tqm.quant_matmul(x, q, s, out_dtype=torch.float32)
    ref32 = np.asarray(jqm.quant_matmul(jx, jq, js, out_dtype=jnp.float32))
    assert out32.dtype == torch.float32 and ref32.dtype == np.float32
    diff = (out32.double() - torch.from_numpy(ref32).double()).abs()
    assert bool((diff <= qmm_limit(x, q, s)).all()), (m, k, n, "fp32 out")


def check_bert_int8_o2_fp16_matches_reference():
    jm, tm = _carried()
    jm.eval()
    tm.eval()
    jm = jamp.decorate(jm, level="O2", dtype=F16)
    tm = tamp.decorate(tm, level="O2", dtype=F16)
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
        with _recording(jamp) as jc, jamp.auto_cast(level="O2", dtype=F16):
            jl, jn = jm(_jt(ids))
        with _recording(tamp) as tc, tamp.auto_cast(level="O2", dtype=F16), \
                torch.no_grad():
            tl, tn = tm(torch.from_numpy(ids))
    finally:
        jqm.quant_matmul, tqm.quant_matmul_plain = jreal, treal
    assert tc == jc, _diff(jc, tc)
    assert tseen == jseen, (tseen, jseen)
    assert (tseen.count(F16), tseen.count("float32")) == (9, 6), tseen
    for name, j, t in (("mlm", jl, tl), ("nsp", jn, tn)):
        a = np.asarray(j._value)
        assert str(a.dtype) == F16 and t.dtype == torch.float16, \
            (name, a.dtype, t.dtype)
        a = a.astype(np.float32)
        top = float(fp16_ulp(torch.tensor(np.abs(a).max())))
        err = float(np.abs(t.float().numpy() - a).max())
        assert err <= LOGIT_ULPS * top, (name, err / top)


def test_fp16_int8_port_matches_reference(fresh_mesh):
    run_checks(
        [(check_quant_matmul_fp16_matches_reference, shape)
         for shape in ((64, 768, 768), (64, 512, 256), (512, 512, 256),
                       (512, 768, 256))]
        + [(check_bert_int8_o2_fp16_matches_reference, ())])
