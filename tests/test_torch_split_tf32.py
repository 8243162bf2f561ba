"""CPU rehearsal of the split-TF32 arithmetic of the tensor-core kernels
(``paddle_tpu_torch/csrc/quant_matmul.cu`` ``quant_matmul`` and
``csrc/flash_attention.cu`` ``flash_fwd``, ``flash_dq`` and
``flash_dkv``), against the criteria the card
holds them to (``tests/torch_checks.py``: ``qmm_limit`` and
``FLASH_TOL``), which stay as they are.

``paddle_tpu_torch/ops/tf32.py`` models the kernels' operand rounding in
plain PyTorch: TF32 round-to-nearest (ties away from zero, as
``cvt.rna.tf32.f32``) on the fp32 bits, and the split ``x = big +
small`` with both parts TF32 (within 2^-22 of x; the flash backward's
``split_tf32_trunc`` truncates small, within 2^-21). ``quant_matmul_split_tf32``,
``flash_fwd_split_tf32`` and ``flash_bwd_split_tf32`` compute with split
operands:

- ``quant_matmul`` at k = 768 and 3072 (the BERT-base weight depths) and
  256 rows (the bound depends on k, not m), x unit randn and the weight
  ``randn * 0.02`` quantized: every element within ``qmm_limit`` of
  ``quant_matmul_plain``, and the largest diff / limit under
  ``QMM_SPLIT_CEILING``; a control, the product of plain (1x) TF32 ``x``
  (``tf32_rna(x) @ q * s``), passes ``qmm_limit`` at these k but reads
  over the ceiling, so the ceiling, which ``qmm_vs_plain`` holds the card
  to, tells the split from a kernel that skips ``x_small``. The file
  prints both ratios (``pytest -s``);
- ``flash_fwd`` at s 512 and 1024, d 64, causal and full: out and lse
  within ``FLASH_TOL`` of ``flash_fwd_plain``;
- ``flash_dq``/``flash_dkv`` at the same shapes: dq, dk and dv of
  ``flash_bwd_split_tf32`` within ``FLASH_TOL`` (times the larger of 1
  and the gradient's largest magnitude, as ``flash_vs_plain`` holds the
  card) of ``flash_bwd_plain``, and a control, the same backward with
  every operand rounded once to TF32 (``passes=1``, a kernel that drops
  the small parts), over that limit for each gradient: the unchanged
  tolerance already refuses one pass. The file prints both readings.

The emulation models the operands' rounding, not the tensor cores' order
of accumulation nor the kernel's tile-by-tile softmax: those only the
card shows (``tests/test_torch_cuda.py``, ``chip_smoke.py``). It imports
no JAX. The file collects one test that runs every case
(``tests/torch_checks.py`` says why).
"""
import importlib

import numpy as np
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops.tf32 import (split_tf32, split_tf32_trunc,
                                       tf32_rna)
from torch_checks import (FLASH_TOL, QMM_SPLIT_CEILING, qmm_limit,
                          run_checks)

torch.set_num_threads(2)

qm = importlib.import_module("paddle_tpu_torch.ops.quant_matmul")


def _bits(x):
    return torch.tensor(x, dtype=torch.float32).view(torch.int32)


def check_tf32_rounding():
    one = 0x3F800000
    cases = {   # fp32 bits -> TF32 bits
        one + 0x0FFF: one,                  # below half: down
        one + 0x1000: one + 0x2000,         # half: away from zero
        one + 0x1001: one + 0x2000,
        one + 0x2000 + 0x1000: one + 0x4000,
        0x3FFFF000: 0x40000000,             # carry into the exponent
        0x00000FFF: 0x00000000,             # subnormal rounds down
    }
    for src, want in cases.items():
        for sign in (0, -0x80000000):
            got = tf32_rna(torch.tensor([src + sign], dtype=torch.int32)
                           .view(torch.float32)).view(torch.int32)
            assert int(got) == want + sign, (hex(src), sign, hex(int(got)))
    special = torch.tensor([float("inf"), -float("inf"), float("nan")])
    out = tf32_rna(special)
    assert torch.isinf(out[:2]).all() and torch.isnan(out[2])


def check_split_is_tf32_and_close(seed):
    x = torch.from_numpy(np.random.RandomState(seed).randn(100_000)
                         .astype(np.float32) * 10.0 ** (seed - 2))
    for split, bound in ((split_tf32, 2.0 ** -22),
                         (split_tf32_trunc, 2.0 ** -21)):
        big, small = split(x)
        for part in (big, small):
            assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
        rel = ((x.double() - big.double() - small.double()).abs()
               / x.double().abs())
        assert float(rel.max()) <= bound, (split.__name__, float(rel.max()))


def _qmm_operands(m, k, n, seed):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(m, k).astype(np.float32))
    w = torch.from_numpy((rs.randn(k, n) * 0.02).astype(np.float32))
    q, s = qm.quantize_int8_plain(w)
    return x, q, s


def _over_limit(out, x, q, s) -> float:
    diff = (out.double() - qm.quant_matmul_plain(x, q, s).double()).abs()
    return float((diff / qmm_limit(x, q, s)).max())


def check_qmm_split_within_limit(k):
    x, q, s = _qmm_operands(256, k, 256, k)
    split = _over_limit(qm.quant_matmul_split_tf32(x, q, s), x, q, s)
    tf32 = _over_limit((tf32_rna(x) @ q.float()) * s, x, q, s)
    print(f"quant_matmul k={k}: max diff / limit, split TF32 {split:.4f}, "
          f"1xTF32 control {tf32:.4f} (ceiling {QMM_SPLIT_CEILING})")
    assert split <= QMM_SPLIT_CEILING, f"k={k}: split {split:.4f}"
    assert QMM_SPLIT_CEILING < tf32 <= 1.0, f"k={k}: 1xTF32 {tf32:.4f}"


def check_flash_3xtf32_within_tol(s, causal):
    rs = np.random.RandomState(s + causal)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, s, 64).astype(np.float32))
               for _ in range(3))
    out, lse = fa.flash_fwd_split_tf32(q, k, v, causal)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, causal)
    for name, a, b in (("out", out, p_out), ("lse", lse, p_lse)):
        err = float((a - b).abs().max())
        assert err <= FLASH_TOL[name], f"{name} s={s} causal={causal}: {err}"


def check_flash_bwd_3xtf32_within_tol(s, causal):
    rs = np.random.RandomState(s + causal)
    q, k, v, do = (torch.from_numpy(rs.randn(1, 2, s, 64).astype(np.float32))
                   for _ in range(4))
    out, lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do * out).sum(-1, keepdim=True)
    plain = fa.flash_bwd_plain(q, k, v, do, lse, delta, causal)
    reads = {}
    for passes in (3, 1):
        got = fa.flash_bwd_split_tf32(q, k, v, do, lse, delta, causal,
                                      passes=passes)
        reads[passes] = {
            name: float((a - b).abs().max())
            / (FLASH_TOL[name] * max(float(b.abs().max()), 1.0))
            for name, a, b in zip(("dq", "dk", "dv"), got, plain)}
    print(f"flash backward s={s} causal={causal}: max diff / FLASH_TOL "
          f"limit, 3xTF32 " + ", ".join(f"{n} {r:.4f}"
                                        for n, r in reads[3].items())
          + "; 1xTF32 control " + ", ".join(f"{n} {r:.2f}"
                                            for n, r in reads[1].items()))
    assert max(reads[3].values()) <= 1.0, reads[3]
    assert min(reads[1].values()) > 1.0, reads[1]


def test_split_tf32_rehearsal():
    run_checks([(check_tf32_rounding, ())]
               + [(check_split_is_tf32_and_close, (seed,))
                  for seed in (0, 2, 4)]
               + [(check_qmm_split_within_limit, (k,)) for k in (768, 3072)]
               + [(check_flash_3xtf32_within_tol, (s, c))
                  for s in (512, 1024) for c in (True, False)]
               + [(check_flash_bwd_3xtf32_within_tol, (s, c))
                  for s in (512, 1024) for c in (True, False)])
