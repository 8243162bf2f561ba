"""Port int8 quantization (``paddle_tpu_torch/ops/quant_matmul.py``,
``paddle_tpu_torch/quantization``) against the JAX reference
(``paddle_tpu/ops/quant_matmul.py``, ``paddle_tpu/quantization``) on the
CPU, where the port takes its plain versions and the reference runs its
Pallas kernels in interpret mode (as ``tests/test_quant_matmul.py`` does).

- ``quantize_int8``: int8 payload and scales bit-identical to the
  reference's, nearest and stochastic (seeds 0, 1234 and 2^31 - 1), at
  [64, 128], [48, 24], [768, 2] and a matrix with an all-zero column
  (scale 1e-12, payload 0) and a column of values half-way between
  integers.
- The reference's scale is ``max(amax * float32(1/127), 1e-12)``: XLA
  turns the constant division into a multiply by the reciprocal, which
  is an ulp away from ``amax / 127`` on some columns. Pinned here, since
  the port's bit-identity rests on it.
- ``stable_seed``: equal for a few names.
- The wrappers on CPU tensors: shape checks, ``out_dtype``, block
  arguments raise (the kernel's tiles are fixed), no launch counted; on
  bf16 ``x`` at m = 1, 16 and 64 (the cluster route's sizes on the card)
  ``quant_matmul`` returns ``quant_matmul_plain``'s result bit for bit,
  counting no launch and no route.
- ``route16`` at the m = 64 / 65 boundary, on CPU tensors (it reads
  shapes and addresses only): "cluster" up to 64, then "wgmma" where
  TMA takes both operands, else "mma_sync" (n = 2, k % 8 != 0, an x off
  the 16-byte grid).
- ``quant_matmul`` on the same int8 weights, at a shape the reference's
  tiles divide (256 x 512 @ 512 x 256, its Pallas kernel) and a ragged
  one (10 x 48 @ 48 x 24, its plain fallback, which scales before the
  product). Tolerance: max abs diff <= 1e-5 x the output's largest
  magnitude (both sides sum k fp32 products in their own order;
  measured: 8.4e-7 of the largest at the tiled shape, 0 at the ragged).
- ``convert_to_int8`` on ``Sequential(Linear, ReLU, Linear)``, as
  ``test_int8_linear_serving_conversion``: the same layers replaced,
  payloads identical, outputs within 1e-5 of the largest (measured 0),
  and within a
  mean relative error of 0.05 of the fp32 outputs (the reference's own
  criterion).

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.quantization import Int8Linear as JaxInt8Linear
from paddle_tpu.quantization import convert_to_int8 as jax_convert
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.quantization import Int8Linear, convert_to_int8
from torch_checks import run_checks

torch.set_num_threads(2)

# the packages' ``ops`` export the function ``quant_matmul`` under the
# module's name, so the modules are taken from the import system
jqm = importlib.import_module("paddle_tpu.ops.quant_matmul")
tqm = importlib.import_module("paddle_tpu_torch.ops.quant_matmul")

RTOL = 1e-5
SEEDS = (0, 1234, 2 ** 31 - 1)


def _weights(shape, seed, zero_col=None):
    """Seeded weights; with ``zero_col`` also an all-zero column and a
    column whose amax of 127 gives scale 1.0, so ``w / scale`` lands
    half-way between integers (rint rounds half to even)."""
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if zero_col is not None:
        w[:, zero_col] = 0.0
        w[:, 1] = 0.0
        w[:9, 1] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    return w


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def check_quantize_bit_identical(shape, stochastic, seed, zero_col=None):
    w = _weights(shape, sum(shape), zero_col)
    jq, js = jqm.quantize_int8(jnp.asarray(w), stochastic=stochastic,
                               seed=seed)
    before = tqm.launch_counts()
    tq, ts = tqm.quantize_int8(torch.from_numpy(w), stochastic, seed)
    assert tqm.launch_counts() == before      # the CPU takes plain
    assert _same_bits(jq, tq.numpy()), "int8 payloads differ"
    assert _same_bits(js, ts.numpy()), "scales differ"
    if zero_col is not None:
        assert float(ts[0, zero_col]) == np.float32(1e-12)
        assert not tq[:, zero_col].any()


def check_reference_scale_is_a_reciprocal_multiply():
    w = _weights((768, 768), 0)
    _, js = jqm.quantize_int8(jnp.asarray(w))
    amax = np.abs(w).max(0, keepdims=True)
    recip = np.maximum(amax * np.float32(1.0 / 127.0), np.float32(1e-12))
    assert _same_bits(js, recip)
    assert (np.asarray(js) != amax / np.float32(127.0)).any()


def check_stable_seed_matches():
    for name in ("", "linear_0.w_0", "linear_74.w_0", "bert.nsp.weight",
                 "émbedding"):
        for base in (0, 7):
            assert tqm.stable_seed(name, base) == jqm.stable_seed(name, base)


def check_quant_matmul_matches_reference(m, k, n):
    rs = np.random.RandomState(m + k + n)
    x = rs.randn(m, k).astype(np.float32)
    w = rs.randn(k, n).astype(np.float32)
    jq, js = jqm.quantize_int8(jnp.asarray(w))
    j = np.asarray(jqm.quant_matmul(jnp.asarray(x), jq, js))
    t = tqm.quant_matmul(torch.from_numpy(x), torch.tensor(np.asarray(jq)),
                         torch.tensor(np.asarray(js)))
    assert t.dtype == torch.float32 and t.shape == (m, n)
    err = float(np.abs(j - t.numpy()).max())
    assert err <= RTOL * float(np.abs(j).max()), err


def check_wrappers_on_cpu():
    before, shapes = tqm.launch_counts(), tqm.shape_counts()
    with pytest.raises(ValueError, match=r"\[k, n\]"):
        tqm.quantize_int8(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="qw"):
        tqm.quant_matmul(torch.zeros(2, 3), torch.zeros(4, 5, dtype=torch.int8),
                         torch.ones(1, 5))
    with pytest.raises(ValueError, match="scales"):
        tqm.quant_matmul(torch.zeros(2, 4), torch.zeros(4, 5, dtype=torch.int8),
                         torch.ones(1, 4))
    out = tqm.quant_matmul(torch.ones(2, 4), torch.ones(4, 3, dtype=torch.int8),
                           torch.full((1, 3), 0.5), out_dtype=torch.float64)
    assert out.dtype == torch.float64 and torch.equal(out,
                                                      torch.full((2, 3), 2.0))
    with pytest.raises(ValueError, match="tiles are fixed"):
        tqm.quant_matmul(torch.ones(2, 4), torch.ones(4, 3, dtype=torch.int8),
                         torch.ones(1, 3), block_m=128)
    assert tqm.launch_counts() == before
    assert tqm.shape_counts() == shapes


def check_bf16_wrapper_on_cpu_is_plain(m):
    gen = torch.Generator().manual_seed(m)
    x = torch.randn(m, 768, generator=gen).bfloat16()
    q, s = tqm.quantize_int8_plain(torch.randn(768, 96, generator=gen))
    before, routes = tqm.launch_counts(), tqm.route_counts()
    out = tqm.quant_matmul(x, q, s)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, tqm.quant_matmul_plain(x, q, s))
    assert tqm.launch_counts() == before
    assert tqm.route_counts() == routes


def check_bf16_route_at_m_64():
    q = torch.zeros(768, 768, dtype=torch.int8)
    head = torch.zeros(768, 2, dtype=torch.int8)
    ragged = torch.zeros(100, 768, dtype=torch.int8)
    for m, w, want in ((64, q, "cluster"), (65, q, "wgmma"),
                       (1, q, "cluster"), (64, head, "cluster"),
                       (65, head, "mma_sync"), (64, ragged, "cluster"),
                       (65, ragged, "mma_sync")):
        x = torch.zeros(m, w.shape[0], dtype=torch.bfloat16)
        assert tqm.route16(x, w) == want, (m, tuple(w.shape), want)
    buf = torch.zeros(65 * 768 + 8, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0    # PyTorch's CPU allocator: 64 bytes
    for off, want in ((0, "wgmma"), (1, "mma_sync"), (4, "mma_sync"),
                      (8, "wgmma")):
        x = buf[off:off + 65 * 768].view(65, 768)
        assert tqm.route16(x, q) == want, off
        assert tqm.route16(x[:64], q) == "cluster", off


def _nets(seed):
    """The reference's Sequential(Linear(64,128), ReLU, Linear(128,32))
    and the port's, with the reference's weights and weight names."""
    ref = jnn.Sequential(jnn.Linear(64, 128), jnn.ReLU(), jnn.Linear(128, 32))
    rs = np.random.RandomState(seed)
    port = torch.nn.Sequential(Linear(64, 128, device="cpu"), torch.nn.ReLU(),
                               Linear(128, 32, device="cpu"))
    for i in (0, 2):
        r, p = ref[i], port[i]
        b = (rs.randn(*r.bias.shape) * 0.1).astype(np.float32)
        r.bias.set_value(b)
        with torch.no_grad():
            p.weight.copy_(torch.tensor(np.asarray(r.weight._value)))
            p.bias.copy_(torch.from_numpy(b))
        p.weight_name = r.weight.name
    return ref, port


def check_convert_sequential_matches_reference(stochastic):
    ref, port = _nets(3)
    x = np.random.RandomState(0).randn(16, 64).astype(np.float32)
    fp32 = port(torch.from_numpy(x)).detach().numpy()
    jax_convert(ref, stochastic=stochastic)
    assert convert_to_int8(port, stochastic=stochastic) is port
    replaced = [i for i in range(3) if isinstance(port[i], Int8Linear)]
    assert replaced == [i for i in range(3)
                        if isinstance(ref[i], JaxInt8Linear)] == [0, 2]
    for i in replaced:
        assert port[i].qweight.dtype == torch.int8
        assert _same_bits(ref[i].qweight._value, port[i].qweight.numpy())
        assert _same_bits(ref[i].scales._value, port[i].scales.numpy())
    j = ref(paddle.to_tensor(x)).numpy()
    t = port(torch.from_numpy(x))
    assert not t.requires_grad
    err = float(np.abs(j - t.numpy()).max())
    assert err <= RTOL * float(np.abs(j).max()), err
    rel = np.abs(t.numpy() - fp32).mean() / (np.abs(fp32).mean() + 1e-9)
    assert rel < 0.05, rel


def check_int8_linear_takes_a_strided_input():
    lin = Linear(8, 5, device="cpu", rs=np.random.RandomState(0))
    q = Int8Linear(lin)
    x = torch.randn(3, 4, 8, generator=torch.Generator().manual_seed(0))
    rows = x[:, 0]                         # non-contiguous, as the pooler's
    want = tqm.quant_matmul_plain(rows.contiguous(), q.qweight,
                                  q.scales) + lin.bias
    assert torch.equal(q(rows), want.detach())
    assert q(x).shape == (3, 4, 5)


def test_torch_quant_matches_reference():
    shapes = [((64, 128), None), ((48, 24), None), ((768, 2), None),
              ((40, 16), 3)]
    run_checks(
        [(check_quantize_bit_identical, (shape, False, 0, zc))
         for shape, zc in shapes]
        + [(check_quantize_bit_identical, (shape, True, seed, zc))
           for shape, zc in shapes for seed in SEEDS]
        + [(check_reference_scale_is_a_reciprocal_multiply, ()),
           (check_stable_seed_matches, ()),
           (check_quant_matmul_matches_reference, (256, 512, 256)),
           (check_quant_matmul_matches_reference, (10, 48, 24)),
           (check_wrappers_on_cpu, ()),
           (check_bf16_route_at_m_64, ())]
        + [(check_bf16_wrapper_on_cpu_is_plain, (m,)) for m in (1, 16, 64)]
        + [(check_convert_sequential_matches_reference, (False,)),
           (check_convert_sequential_matches_reference, (True,)),
           (check_int8_linear_takes_a_strided_input, ())])
