"""Shared runner and comparisons for the PyTorch-port checks
(``tests/test_torch_*.py`` and ``chip_smoke.py``).

Each test file collects exactly ONE test item that runs all of the
file's cases through :func:`run_checks`. The reason is the scheduler of
the suite's parallel run (pytest-xdist, ``--dist loadfile``): it orders
files by their number of collected tests, largest first, and hands them
to workers in that order. A new file with many tests lands mid-queue and
shifts every smaller file onto other workers, after other files; some
existing tests depend on what ran before them on their worker (a mesh or
flag left behind). A file with one test sorts after every existing file,
so adding it leaves the existing files' schedule as it was.

The comparisons below hold a kernel against its plain version on the
same inputs; the on-card test and ``chip_smoke.py`` both call them, so
the two hold the kernels to one set of criteria:

- flash attention: out and lse within 2e-5 max abs; dq, dk and dv each
  within 1e-4 of the larger of 1 and the plain gradient's largest
  magnitude (unit-scale inputs; a gradient that is zero in exact
  arithmetic, as dq at s = 1, is rounding noise on both sides). The bf16
  kernels, element by element (:func:`flash_bf16_limit`): out, dq, dk
  and dv within ``2e-2 |plain| + 1.6e-2 rms(plain's row) + 1e-5``, the
  reference's own bf16 rtol (``tests/test_pallas_kernels.py:333-350``)
  plus four bf16 ulps (2^-8 each) of the row's RMS, over the last axis
  (a query row of out and dq, a key row of dk and dv), and a floor for
  a row that is zero in exact arithmetic (dq's first causal row). The
  kernels round p and ds to bf16 for their second products; a CPU model
  of that rounding (``tests/test_torch_bf16_train.py``) needs at most
  6.7e-3 of the row's RMS beside the rtol at s = 1024, d = 64, and the
  same model with one 16-key chunk dropped from a product, a fault that
  moves a long causal row by a few 1e-3, needs more than 1.6e-2 in
  over 90% of the long rows. lse within 1e-4 max abs (bf16 operands
  multiply exactly, so the scores are fp32 sums as in the fp32 kernel).
  The fp16 kernels (:func:`flash_fp16_limit`), derived the same way:
  ``2.5e-3 |plain| + 1.95e-3 rms(plain's row) + max(1e-5 s, 2^-23)``,
  bf16's rtol scaled by the ulps' ratio (2^-11 against 2^-8), four fp16
  ulps of the row's RMS, and bf16's floor scaled with the gradients'
  scale ``s`` (1 for unit-scale inputs; a backward at ``dO 2^-16`` has
  ``s = 2^-16``), but never under two subnormal fp16 steps (2^-24 each:
  a gradient that small is a subnormal, and the kernel and the plain
  version each round it once); each term no looser than bf16's.
  The CPU model of the fp16 kernels' rounding
  (``tests/test_torch_fp16_train.py``) stays within it at unit-scale and
  at 2^-16-scaled dO; lse as bf16's;
- ``fused_update``: bit-identical parameters and slots, fp32, bf16 or
  fp16 parameters (:func:`same_bits`);
- ``fused_update_buckets``: bit-identical parameters, slots and stepped
  beta powers over consecutive steps, against its plain walk of the same
  kind of table (:func:`buckets_vs_plain`);
- ``fused_dequant_update_buckets``: bit-identical parameters and slots
  on a table of one (:func:`dequant_vs_plain`) and over a table of many
  buckets, fp32 and bf16 together, over consecutive steps
  (:func:`buckets_vs_plain` with ``block_size``), fed by payloads whose
  carriers the ``codec_encode`` kernel wrote bit-identical to the plain
  encode's (:func:`encoded_inputs`, from fp32 or bf16 gradients);
- one Adam(W) training step on two devices: :func:`adam_step_parity`,
  and for a bf16 model :func:`bf16_step_parity`;
- a ResNet or a MobileNetV2 stage by stage (:func:`resnet_stages`,
  :func:`mobilenet_stages`, :func:`stage_run`, :func:`stage_errors`):
  each stage fed the same input and cotangent on
  both sides, so the model's own amplification of rounding (a ResNet-50
  at initialisation under batch-4 batch norm moves its O2 gradients by
  more than their size when its input moves by half a bf16 ulp) does not
  reach the comparison;
- ``ce_chunk_fwd`` (:func:`ce_fwd_vs_plain`): the running max and the
  picked logit bit-identical (a max and an fp32 add are exact the same
  way), the running sum within ``CE_SUM_RTOL`` relative (a sum of C
  exponentials in another order, each within 2 ulp: measured ~1e-7);
  ``ce_chunk_bwd`` (:func:`ce_bwd_vs_plain`): every element within
  ``CE_RTOL (|plain| + |g| onehot)`` (one exp of 2 ulp against the CPU's
  0.5-1 ulp, a subtraction and a multiply: a few ulp of the result, and
  at the label's column of ``|g|``, as ``exp - 1`` rounds to 1's ulp),
  rows with ``g = 0`` exactly 0;
- ``quantize_int8``: int8 payload and scales bit-identical, nearest and
  stochastic;
- ``quant_matmul`` on bf16 ``x`` (:func:`qmm_bf16_vs_plain`): every
  element within the fp32 bound below plus one bf16 ulp of the plain
  element (both round an fp32 sum to bf16 once); faults planted in the
  wgmma kernel, the route of m > 64 (16 of the k products dropped), and
  in the cluster kernel, the route of m <= 64 (cluster rank 0's partial
  sums left out of the reduction: 1/8 of k) (:func:`plant_qmm_fault`),
  are over it;
- ``quant_matmul``: every element within the forward-error bound of two
  fp32 dot products of length k, ``2 k 2^-24 (|x| @ |q| s)`` (each side
  sums k products in its own order; the bound is computed in float64);
  and, at k >= 768, where that bound is loose enough for a product of
  plain (1x) TF32 ``x`` to pass it, the largest diff / limit at most
  ``QMM_SPLIT_CEILING``, which the split-TF32 product stays under and a
  product of plain (1x) TF32 ``x`` does not (``tests/test_torch_split_tf32.py``
  shows both).

``bench_eager_loops`` hands the test of the eager API and ``chip_smoke.py``
the two loops of ``bench.py``'s ``measure_eager``, in bench.py's own
text, over the ``paddle`` module they are given.
"""
import ast
import contextlib
import importlib
import os
import textwrap

import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_ce as fce
from paddle_tpu_torch.ops import fused_update as fu

# ``paddle_tpu_torch.ops`` exports the function ``quant_matmul`` under the
# module's name, as the reference's ``ops`` does
qm = importlib.import_module("paddle_tpu_torch.ops.quant_matmul")

FLASH_TOL = {"out": 2e-5, "lse": 2e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4}
# the bf16 flash outputs, element by element (:func:`flash_bf16_limit`)
FLASH_BF16_RTOL = 2e-2     # of the plain element's magnitude
FLASH_BF16_ROW = 1.6e-2    # of the RMS of the plain element's row
FLASH_BF16_FLOOR = 1e-5    # absolute, for unit-scale inputs
FLASH_BF16_LSE = 1e-4      # max abs
# the fp16 flash outputs, element by element (:func:`flash_fp16_limit`)
FLASH_FP16_RTOL = 2.5e-3   # FLASH_BF16_RTOL * 2^-11 / 2^-8
FLASH_FP16_ROW = 1.95e-3   # four fp16 ulps (2^-11 each) of the row's RMS
FLASH_FP16_SUBNORMAL = 2.0 ** -23   # two of fp16's steps below 2^-14
# a bf16 GPT step's loss, card against CPU, relative: read 2.46e-5 at
# GPT-125M width, 2 layers, b2 s128 (``chip_smoke.py`` phase 18) and
# 2.4e-6 at gpt-test, b2 s37, where the kernels with a planted fault
# (``tests/test_torch_cuda.py``) read 1.3e-3
BF16_LOSS_RTOL = 1e-4
# the chunk epilogues of the fused loss against their plain versions
CE_SUM_RTOL = 1e-5
CE_RTOL = 1e-6
# largest diff / limit ``quant_matmul`` may read at k >= QMM_SPLIT_MIN_K
QMM_SPLIT_CEILING = 0.04
QMM_SPLIT_MIN_K = 768
# bench.py's eager mode (measure_eager): the no-grad chain on a
# [256, 256] ones tensor, 200 iterations, and the grad loop on [16, 16]
# with k = 20, max(1, 200 // (2 k)) iterations; its w.grad card against
# CPU, relative (fp32 GEMMs with TF32 off)
EAGER_CHAIN = ([256, 256], 200)
EAGER_GRAD = ([16, 16], 20)
EAGER_GRAD_RTOL = 1e-5
FUSED_HYPER = {"sgd": {}, "momentum": {"momentum": 0.9, "nesterov": True},
               "adam": {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8},
               "adamw": {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8}}


def run_checks(checks):
    """Run every ``(fn, args)`` case, then fail once naming each case
    that failed (a skip still ends the run at once)."""
    failures = []
    for fn, args in checks:
        try:
            fn(*args)
        except Exception as e:
            failures.append(f"{fn.__name__}{tuple(args)}: "
                            f"{type(e).__name__}: {e}")
    if failures:
        raise AssertionError(f"{len(failures)} of {len(checks)} cases "
                             f"failed:\n" + "\n".join(failures))


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def same_bits(a, b) -> bool:
    """True if the two tensors hold the same bits (fp32 or bf16)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}
    return a.dtype == b.dtype and torch.equal(a.view(ints[a.dtype]),
                                              b.view(ints[b.dtype]))


def _over_limit(what: str, errs) -> None:
    over = [f"{n} {e:.3e} ({r:.3f} of its limit)"
            for n, (e, r) in errs.items() if not r <= 1.0]
    if over:
        raise AssertionError(f"{what}: max abs diff " + ", ".join(over))


def flash_bf16_limit(plain: torch.Tensor) -> torch.Tensor:
    """The limit of each element of a bf16 flash output against its
    plain version ``plain``: ``FLASH_BF16_RTOL |plain| + FLASH_BF16_ROW
    rms(row) + FLASH_BF16_FLOOR``, the RMS over the last axis (see the
    module docstring)."""
    b = plain.float()
    rms = b.pow(2).mean(-1, keepdim=True).sqrt()
    return (FLASH_BF16_RTOL * b.abs() + FLASH_BF16_ROW * rms
            + FLASH_BF16_FLOOR)


def flash_fp16_limit(plain: torch.Tensor, scale: float = 1.0
                     ) -> torch.Tensor:
    """The limit of each element of an fp16 flash output against its
    plain version ``plain``: ``FLASH_FP16_RTOL |plain| + FLASH_FP16_ROW
    rms(row) + max(FLASH_BF16_FLOOR scale, 2^-23)``, ``scale`` the
    gradients' scale (module docstring)."""
    b = plain.float()
    rms = b.pow(2).mean(-1, keepdim=True).sqrt()
    floor = max(FLASH_BF16_FLOOR * scale, FLASH_FP16_SUBNORMAL)
    return FLASH_FP16_RTOL * b.abs() + FLASH_FP16_ROW * rms + floor


def flash_err(name, dtype, got, plain, scale: float = 1.0):
    """``(max abs diff, largest diff / limit)`` of one flash output
    against its plain version; ``dtype`` is the inputs', ``scale`` the
    gradients' (fp16; the module docstring gives the limits)."""
    diff = (got.float() - plain.float()).abs()
    err = float(diff.max())
    if dtype == torch.float16:
        if name == "lse":
            return err, err / FLASH_BF16_LSE
        lim = flash_fp16_limit(plain, scale if name != "out" else 1.0)
        return err, float((diff / lim).max())
    if dtype == torch.bfloat16:
        if name == "lse":
            return err, err / FLASH_BF16_LSE
        return err, float((diff / flash_bf16_limit(plain)).max())
    tol = FLASH_TOL[name]
    lim = tol if name in ("out", "lse") else tol * max(
        float(plain.abs().max()), 1.0)
    return err, err / lim


# A planted fault in the bf16 flash kernels (the control of the bf16
# limit on the card): each kernel skips the first 16-wide chunk of its
# first streamed tile in its second products (keys 0-15 of P.V and dS.K,
# queries 0-15 of P^T.dO and dS^T.Q), which moves a long causal row of
# out or dq by a few 1e-3. All three issue those products as wgmma on
# 16-key (16-query) chunks; each anchor is the head of one such chunk
# loop, and the fault starts it at 1 on the first tile.
FLASH_BF16_SECTION = ("// ---------------------------------------------"
                      "--------------- bf16 forms")
FLASH_FAULTS = (
    ("// O += P V, P from registers, V MN-major: the tile's 4 key chunks\n"
     "#pragma unroll\n    for (int c = 0; c < 4; ++c) {", "kt == 0"),
    ("// dQ += dS K, dS from registers, K MN-major: the tile's 4 key "
     "chunks\n#pragma unroll\n    for (int c = 0; c < 4; ++c) {", "kt == 0"),
    ("// query chunks of 16\n#pragma unroll\n"
     "      for (int c = 0; c < BQ / 16; ++c) {", "qt == 0"))


def plant_flash_fault(src: str) -> str:
    """``csrc/flash_attention.cu``'s text ``src`` with the fault above
    planted in its bf16 kernels; raises unless every anchor occurs
    exactly once in the bf16 section (so the fault cannot be disarmed
    by an edit that moves or copies a loop)."""
    head, sep, bf16 = src.partition(FLASH_BF16_SECTION)
    if not sep:
        raise AssertionError("no bf16 section in flash_attention.cu")
    for loop, first in FLASH_FAULTS:
        if bf16.count(loop) != 1:
            raise AssertionError(f"{bf16.count(loop)} copies of the fault "
                                 f"anchor {loop!r} in the bf16 section")
        bf16 = bf16.replace(loop, loop.replace("c = 0", f"c = ({first})"))
    return head + sep + bf16


def flash_fwd_vs_plain(q, k, v, causal: bool):
    """``flash_fwd`` against its plain version (fp32, bf16 or fp16 inputs).
    Returns ``(errs, out, lse)``: ``errs`` maps out and lse to (max abs
    diff, largest diff / limit); raises when one is over its limit."""
    out, lse = fa.flash_fwd(q, k, v, causal)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, causal)
    if out.dtype != q.dtype or lse.dtype != torch.float32:
        raise AssertionError(f"flash_fwd gave {out.dtype} out, "
                             f"{lse.dtype} lse for {q.dtype} inputs")
    errs = {"out": flash_err("out", q.dtype, out, p_out),
            "lse": flash_err("lse", q.dtype, lse, p_lse)}
    _over_limit(f"flash_fwd {list(q.shape)} {q.dtype} causal={causal}",
                errs)
    return errs, out, lse


def flash_vs_plain(q, k, v, do, causal: bool, scale: float = 1.0):
    """The three flash kernels and their plain versions on the same
    inputs (fp32, bf16 or fp16; ``scale``: dO's, for the fp16 limit).
    Returns ``(errs, lse, delta)``: ``errs`` maps out, lse, dq, dk and dv
    to (max abs diff, largest diff / limit); raises when one is over its
    limit."""
    errs, out, lse = flash_fwd_vs_plain(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    dq = fa.flash_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal)
    p_dq, p_dk, p_dv = fa.flash_bwd_plain(q, k, v, do, lse, delta, causal)
    for name, a, b in (("dq", dq, p_dq), ("dk", dk, p_dk), ("dv", dv, p_dv)):
        if a.dtype != q.dtype:
            raise AssertionError(f"flash {name} is {a.dtype} for {q.dtype} "
                                 f"inputs")
        errs[name] = flash_err(name, q.dtype, a, b, scale)
    _over_limit(f"flash {list(q.shape)} {q.dtype} causal={causal}", errs)
    return errs, lse, delta


def ce_inputs(n, c, start, vocab, gen, device, bias=True, ignored=0):
    """One chunk of the fused loss: fp32 logits [n, c] at GPT's scale, the
    chunk's bias (or None), int32 labels over the vocabulary (the first
    in the chunk's last column, the second in its first), a running
    state (m, s, picked) as an earlier chunk leaves it, the rows' lse
    and upstream gradient g, 0 on the first ``ignored`` rows (the
    positions the mask drops)."""
    def randn(*shape):
        return torch.randn(*shape, device=device, generator=gen)

    logit = randn(n, c) * 3
    b = randn(c) * 0.3 if bias else None
    labels = torch.randint(0, vocab, (n,), device=device, generator=gen,
                           dtype=torch.int32)
    labels[:2] = torch.tensor([start + c - 1, start])[:n]
    m = randn(n) * 3 + 6
    s = torch.rand(n, device=device, generator=gen) * 100 + 1
    picked = randn(n)
    lse = (logit if b is None else logit + b).logsumexp(-1) + randn(n).abs()
    g = torch.rand(n, device=device, generator=gen) / n
    g[:ignored] = 0.0
    return logit, b, labels, (m, s, picked), lse, g


def ce_fwd_vs_plain(logit, bias, labels, start, vocab, state) -> dict:
    """``ce_chunk_fwd`` against its plain version from the same running
    ``state`` (m, s, picked; left unchanged). Returns the max abs
    differences and the sum's largest relative one; raises when the max
    or the picked logit differs or the sum is over ``CE_SUM_RTOL``."""
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    fce.ce_chunk_fwd(logit, bias, labels, start, vocab, *got)
    fce.ce_chunk_fwd_plain(logit, bias, labels, start, *want)
    out = {"m": _max_abs(got[0], want[0]), "s": _max_abs(got[1], want[1]),
           "picked": _max_abs(got[2], want[2]),
           "s_rel": float(((got[1] - want[1]).abs() / want[1]).max())}
    shape = list(logit.shape)
    if not (same_bits(got[0], want[0]) and same_bits(got[2], want[2])):
        raise AssertionError(f"ce_chunk_fwd {shape}: max or picked logit "
                             f"differs from plain: {out}")
    if not out["s_rel"] <= CE_SUM_RTOL:
        raise AssertionError(f"ce_chunk_fwd {shape}: running sum "
                             f"{out['s_rel']:.3e} relative from plain")
    return out


def ce_bwd_vs_plain(logit, bias, lse, labels, g, start, offset=0) -> dict:
    """``ce_chunk_bwd`` against its plain version on copies of ``logit``,
    the kernel's starting ``offset`` floats past a 16-byte boundary.
    Returns the max abs difference and the largest diff / limit; raises
    when an element is over ``CE_RTOL (|plain| + |g| onehot)`` or a row
    with ``g = 0`` is not 0."""
    buf = torch.empty(logit.numel() + offset, dtype=logit.dtype,
                      device=logit.device)
    got = buf[offset:].view_as(logit).copy_(logit)
    want = logit.clone()
    fce.ce_chunk_bwd(got, bias, lse, labels, g, start)
    fce.ce_chunk_bwd_plain(want, bias, lse, labels, g, start)
    col = torch.arange(logit.shape[1], device=logit.device) + start
    hot = (labels.long()[:, None] == col[None, :]).float()
    lim = CE_RTOL * (want.abs() + g.abs()[:, None] * hot) + 1e-38
    diff = (got - want).abs()
    out = {"dlogit": float(diff.max()), "over_limit": float((diff / lim)
                                                           .max())}
    shape = list(logit.shape)
    if not out["over_limit"] <= 1.0:
        raise AssertionError(f"ce_chunk_bwd {shape}: {out}")
    if bool(got[g == 0].any()):
        raise AssertionError(f"ce_chunk_bwd {shape}: a row with g = 0 is "
                             f"not 0")
    return out


def quantize_vs_plain(w, stochastic: bool, seed: int) -> float:
    """``quantize_int8`` against its plain version on the same weights.
    Returns the max abs difference of the payloads (0.0); raises unless
    payload and scales are bit-identical."""
    q, s = qm.quantize_int8(w, stochastic, seed)
    pq, ps = qm.quantize_int8_plain(w, stochastic, seed)
    if q.dtype != torch.int8 or s.shape != (1, w.shape[1]):
        raise AssertionError(f"quantize_int8 gave {q.dtype} {tuple(s.shape)}")
    err = float((q.int() - pq.int()).abs().max())
    if not (torch.equal(q, pq)
            and torch.equal(s.view(torch.int32), ps.view(torch.int32))):
        raise AssertionError(
            f"quantize_int8 {list(w.shape)} stochastic={stochastic} "
            f"seed={seed}: {int((q != pq).sum())} payload values and "
            f"{int((s != ps).sum())} scales differ from plain")
    return err


def qmm_limit(x, qw, scales) -> torch.Tensor:
    """Elementwise limit for ``quant_matmul`` against its plain version:
    ``2 k 2^-24 (|x| @ |q|) s``, in float64."""
    k = x.shape[1]
    mag = (x.double().abs() @ qw.double().abs()) * scales.double().abs()
    return 2.0 * k * 2.0 ** -24 * mag.reshape(x.shape[0], -1)


# the bf16 section of ``csrc/quant_matmul.cu`` and the faults that
# :func:`plant_qmm_fault` plants there, by route: (the loop's text, its
# start, the start planted). In the k loop of the wgmma kernel (m > 64)
# the first k-step skips its first k16 product (16 of the k terms of every
# output); in the reduction of the cluster kernel (m <= 64) rank 0's
# partial sums are left out (the first eighth of k)
QMM_BF16_SECTION = "// ------------------------------------------------------- bf16 activations"
QMM_BF16_FAULTS = {
    "wgmma": ("for (int ks = 0; ks < kK16; ++ks) {", "ks = 0",
              "ks = (kt == 0)"),
    "cluster": ("for (int r = 0; r < kCluster; ++r) {", "r = 0", "r = (1)")}


def plant_qmm_fault(src: str) -> str:
    """``csrc/quant_matmul.cu``'s text ``src`` with every fault of
    ``QMM_BF16_FAULTS`` planted in its bf16 kernels (each route's launches
    see their own); raises unless each anchor occurs exactly once in the
    bf16 section."""
    head, sep, bf16 = src.partition(QMM_BF16_SECTION)
    for route, (loop, start, fault) in QMM_BF16_FAULTS.items():
        if not sep or bf16.count(loop) != 1:
            raise AssertionError(f"{bf16.count(loop)} copies of the {route} "
                                 f"fault anchor {loop!r} in quant_matmul.cu's "
                                 f"bf16 section")
        bf16 = bf16.replace(loop, loop.replace(start, fault))
    return head + sep + bf16


def qmm_bf16_limit(x, qw, scales, plain) -> torch.Tensor:
    """Elementwise limit for ``quant_matmul`` on bf16 ``x`` against its
    plain version ``plain`` (bf16): the fp32 accumulation limit
    :func:`qmm_limit` plus one bf16 ulp of the plain element (two fp32
    values that close may round to neighbouring bf16 values), in
    float64."""
    return qmm_limit(x, qw, scales) + bf16_ulp(plain).double()


def qmm_fp16_limit(x, qw, scales, plain) -> torch.Tensor:
    """Elementwise limit for ``quant_matmul`` on fp16 ``x`` against its
    plain version ``plain`` (fp16): :func:`qmm_limit` plus one fp16 ulp
    of the plain element, in float64."""
    return qmm_limit(x, qw, scales) + fp16_ulp(plain).double()


def qmm16_vs_plain(x, qw, scales, out_dtype=None):
    """``quant_matmul`` on 16-bit ``x`` (the ``quant_matmul_16`` kernels)
    against its plain version on the same operands, the output in
    ``out_dtype`` (None: x's dtype; fp32 from the same accumulator).
    Returns ``(max abs diff, largest diff / limit)``; raises when the
    output's dtype or shape is not the plain one's or an element is over
    its limit: :func:`qmm_bf16_limit` or :func:`qmm_fp16_limit` for a
    16-bit output, :func:`qmm_limit` for fp32. An element that both
    round to the same infinity (fp16 past 65,504) counts as equal."""
    out = qm.quant_matmul(x, qw, scales, out_dtype=out_dtype)
    ref = qm.quant_matmul_plain(x, qw, scales, out_dtype=out_dtype)
    if out.dtype != ref.dtype or out.shape != ref.shape:
        raise AssertionError(f"quant_matmul on {x.dtype} x gave "
                             f"{tuple(out.shape)} {out.dtype}, plain "
                             f"{tuple(ref.shape)} {ref.dtype}")
    same = out == ref
    diff = torch.where(same, 0.0, (out.double() - ref.double()).abs())
    if ref.dtype == torch.float32:
        limit = qmm_limit(x, qw, scales)
    elif ref.dtype == torch.float16:
        limit = qmm_fp16_limit(x, qw, scales, ref)
    else:
        limit = qmm_bf16_limit(x, qw, scales, ref)
    limit = limit.clamp_min(1e-300)
    ratio = float((diff / limit).max())
    if not bool((diff <= limit).all()):
        raise AssertionError(
            f"quant_matmul {x.dtype} {list(x.shape)} @ {list(qw.shape)} -> "
            f"{ref.dtype}: {int((diff > limit).sum())} elements over the "
            f"limit (max diff / limit {ratio:.3f})")
    return float(diff.max()), ratio


def qmm_bf16_vs_plain(x, qw, scales):
    """``quant_matmul`` on bf16 ``x`` (the ``quant_matmul_bf16`` kernel)
    against its plain version on the same operands. Returns ``(max abs
    diff, largest diff / limit)``; raises when the output is not bf16 or
    an element is over :func:`qmm_bf16_limit`."""
    out = qm.quant_matmul(x, qw, scales)
    ref = qm.quant_matmul_plain(x, qw, scales)
    if out.dtype != torch.bfloat16 or out.shape != ref.shape:
        raise AssertionError(f"quant_matmul on bf16 x gave "
                             f"{tuple(out.shape)} {out.dtype}")
    diff = (out.double() - ref.double()).abs()
    limit = qmm_bf16_limit(x, qw, scales, ref)
    ratio = float((diff / limit).max())
    if not bool((diff <= limit).all()):
        raise AssertionError(
            f"quant_matmul bf16 {list(x.shape)} @ {list(qw.shape)}: "
            f"{int((diff > limit).sum())} elements over 2 k 2^-24 "
            f"(|x| @ |q|) s + one bf16 ulp (max diff / limit {ratio:.3f})")
    return float(diff.max()), ratio


def qmm_vs_plain(x, qw, scales):
    """``quant_matmul`` against its plain version on the same operands.
    Returns ``(max abs diff, largest diff / limit)``; raises when an
    element is over its limit, or when at k >= ``QMM_SPLIT_MIN_K`` the
    ratio is over ``QMM_SPLIT_CEILING`` (a product less precise than the
    split)."""
    out = qm.quant_matmul(x, qw, scales)
    ref = qm.quant_matmul_plain(x, qw, scales)
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"quant_matmul gave {tuple(out.shape)} "
                             f"{out.dtype}, plain {tuple(ref.shape)}")
    diff = (out.double() - ref.double()).abs()
    limit = qmm_limit(x, qw, scales)
    ratio = float((diff / limit.clamp_min(1e-300)).max())
    if not bool((diff <= limit).all()):
        raise AssertionError(
            f"quant_matmul {list(x.shape)} @ {list(qw.shape)}: "
            f"{int((diff > limit).sum())} elements over 2 k 2^-24 "
            f"(|x| @ |q|) s (max diff / limit {ratio:.3f})")
    if x.shape[1] >= QMM_SPLIT_MIN_K and ratio > QMM_SPLIT_CEILING:
        raise AssertionError(
            f"quant_matmul {list(x.shape)} @ {list(qw.shape)}: max diff / "
            f"limit {ratio:.4f} over the split-TF32 ceiling "
            f"{QMM_SPLIT_CEILING}")
    return float(diff.max()), ratio


def fused_inputs(kind, n, gen, lr):
    """Seeded ``(p, g, slots, lr)`` for one ``kind`` update of ``n``
    elements on ``gen``'s device: unit-scale weights and gradients,
    moments of 1e-2 and, for Adam, the beta powers of step 3."""
    dev = gen.device
    p = torch.randn(n, device=dev, generator=gen)
    g = torch.randn(n, device=dev, generator=gen)
    slots = {nm: torch.randn(n, device=dev, generator=gen).abs() * 1e-2
             for nm in fu.slot_names(kind)}
    if kind in ("adam", "adamw"):
        slots["beta1_pow"] = torch.full((), 0.9 ** 3, device=dev)
        slots["beta2_pow"] = torch.full((), 0.999 ** 3, device=dev)
    return p, g, slots, torch.full((), lr, device=dev)


def fused_vs_plain(p, g, slots, lr, *, kind, hyper, wd) -> float:
    """``fused_update_flat`` on copies of ``p`` and ``slots`` against
    ``reference_update_flat`` on the originals. Returns the max abs
    difference over the parameters and every slot; raises unless they
    are bit-identical."""
    ref_p, ref_s = fu.reference_update_flat(p, g, slots, lr, kind=kind,
                                            hyper=hyper, wd=wd)
    kp = p.clone()
    _, ks = fu.fused_update_flat(kp, g, {k: v.clone() for k, v in
                                         slots.items()},
                                 lr, kind=kind, hyper=hyper, wd=wd)
    pairs = [("p", kp, ref_p)] + [(k, ks[k], v) for k, v in ref_s.items()]
    err = max(_max_abs(a, b) for _, a, b in pairs)
    differ = [n for n, a, b in pairs if not same_bits(a, b)]
    if differ:
        raise AssertionError(f"fused_update {kind} wd={wd} n={p.numel()}: "
                             f"{differ} differ from plain (max abs diff "
                             f"{err:.3e})")
    return err


def _wire_grads(codec, n, block_size, world, gen, grad_scale,
                dtype=torch.float32):
    """``world`` ranks' seeded gradients (in ``dtype``) on ``gen``'s
    device and the shared scales of their summed per-block abs-max."""
    from paddle_tpu_torch.distributed import grad_comm as gc

    gs = [(torch.randn(n, device=gen.device, generator=gen)
           * grad_scale).to(dtype) for _ in range(world)]
    scales = gc.block_scales(sum(gc.block_absmax(g, block_size) for g in gs),
                             codec)
    return gs, scales


def dequant_inputs(codec, n, block_size, world, gen, *, grad_scale=1e-3,
                   dtype=torch.float32):
    """A seeded summed gradient-wire payload on ``gen``'s device:
    ``world`` ranks' gradients (randn * ``grad_scale``, in ``dtype``)
    encoded with the shared scales of their summed per-block abs-max, the
    carriers summed. Returns ``(q_sum [nb, block_size], scales [nb])``."""
    from paddle_tpu_torch.distributed import grad_comm as gc

    gs, scales = _wire_grads(codec, n, block_size, world, gen, grad_scale,
                             dtype)
    q = sum(gc.block_encode(g, scales, block_size, codec, carrier=True)
            for g in gs)
    return q, scales


def encoded_inputs(codec, n, block_size, world, gen, *, grad_scale=1e-3,
                   dtype=torch.float32):
    """:func:`dequant_inputs` with every rank's carrier written by the
    ``codec_encode`` kernel (``ops/codec.py`` ``block_encode(...,
    carrier=True)``) from gradients in ``dtype`` (fp32, or bf16 read in
    place), as the gradient wire writes it, each held bit for bit
    against the plain encode of the same gradient. Returns ``(q_sum,
    scales, max abs difference)``; raises unless every carrier is
    bit-identical."""
    from paddle_tpu_torch.distributed import grad_comm as gc
    from paddle_tpu_torch.ops import codec as ops_codec

    gs, scales = _wire_grads(codec, n, block_size, world, gen, grad_scale,
                             dtype)
    q, err = 0, 0.0
    for g in gs:
        k = ops_codec.block_encode(g, scales, block_size, codec, carrier=True)
        ref = gc.block_encode(g, scales, block_size, codec, carrier=True)
        if k.dtype != ref.dtype or k.shape != ref.shape:
            raise AssertionError(
                f"codec_encode {codec} carrier: {k.dtype} {tuple(k.shape)}, "
                f"plain {ref.dtype} {tuple(ref.shape)}")
        err = max(err, _max_abs(k.float(), ref.float()))
        differ = int((k.view(torch.int32) != ref.view(torch.int32)).sum())
        if differ:
            raise AssertionError(
                f"codec_encode {codec} carrier {dtype} n={n} "
                f"block={block_size}: "
                f"{differ} values differ from plain (max abs diff "
                f"{err:.3e})")
        q = q + k
    return q, scales, err


def dequant_vs_plain(p, q, scales, slots, lr, *, world, block_size, kind,
                     hyper, wd, residual=None, bucket_dtype=None) -> float:
    """``fused_dequant_update_flat`` on copies of ``p`` and ``slots``
    against ``reference_dequant_update_flat`` on the originals. Returns
    the max abs difference over the parameters and every slot; raises
    unless they are bit-identical."""
    kw = dict(kind=kind, hyper=hyper, block_size=block_size, wd=wd,
              residual=residual, bucket_dtype=bucket_dtype)
    ref_p, ref_s = fu.reference_dequant_update_flat(p, q, scales, world,
                                                    slots, lr, **kw)
    kp = p.clone()
    _, ks = fu.fused_dequant_update_flat(
        kp, q, scales, world, {k: v.clone() for k, v in slots.items()}, lr,
        **kw)
    pairs = [("p", kp, ref_p)] + [(k, ks[k], v) for k, v in ref_s.items()]
    err = max(_max_abs(a, b) for _, a, b in pairs)
    differ = [n for n, a, b in pairs if not same_bits(a, b)]
    if differ:
        raise AssertionError(
            f"fused_dequant_update {kind} {q.dtype} n={p.numel()} "
            f"block={block_size} residual={residual is not None}: {differ} "
            f"differ from plain (max abs diff {err:.3e})")
    return err


def adam_step_parity(card, cpu, lr, grad_rtol=1e-4, update_rtol=1e-2,
                     eps=1e-8):
    """Hold one Adam(W) first step on the card against one on the CPU.

    ``card`` and ``cpu`` map each parameter's name to ``(before, after,
    grad)`` on the CPU. Adam's first step moves a weight by
    ``lr * g / (|g| + eps)``: about ``lr`` whatever the size of ``g``, so
    a gradient at fp32 noise level becomes a step of up to ``lr`` set by
    the noise. Hence two checks:

    - every gradient within ``grad_rtol`` of its tensor's largest one;
    - every *clear* element (``|g| >= 100 eps``, so its step is within 1%
      of ``lr``, and ``|g|`` at least 10 times the tensor's largest
      card-vs-CPU gradient difference, so its sign is the same on both
      devices) moved on the card by the CPU's step within
      ``update_rtol * lr``, and by at least ``0.9 lr``; every parameter
      with a nonzero gradient has clear elements, so a bucket the card
      skipped would be caught.

    Returns the worst gradient ratio, the worst clear-element step
    difference over ``lr``, the share of clear elements and the largest
    parameter difference over all elements."""
    worst_g, worst_u, worst_p, clear_n, total = 0.0, 0.0, 0.0, 0, 0
    bad = []
    for name, (b0, b1, bg) in cpu.items():
        c0, c1, cg = card[name]
        if not torch.equal(c0, b0):
            bad.append(f"{name}: the devices started from other weights")
        gmax = float(bg.abs().max())
        gerr = _max_abs(cg, bg)
        total += bg.numel()
        worst_p = max(worst_p, _max_abs(c1, b1))
        if gmax == 0.0:
            if gerr:
                bad.append(f"{name}: gradient {gerr:.3e} on the card, 0 on "
                           f"the CPU")
            continue
        worst_g = max(worst_g, gerr / gmax)
        if gerr > grad_rtol * gmax:
            bad.append(f"{name}: gradients differ by {gerr / gmax:.3e} of "
                       f"the largest")
        clear = (bg.abs() >= 100 * eps) & (bg.abs() >= 10 * gerr)
        if not bool(clear.any()):
            bad.append(f"{name}: no gradient above the noise")
            continue
        clear_n += int(clear.sum())
        du_card, du_cpu = (c1 - c0)[clear], (b1 - b0)[clear]
        derr = _max_abs(du_card, du_cpu) / lr
        worst_u = max(worst_u, derr)
        if derr > update_rtol:
            bad.append(f"{name}: steps differ by {derr:.3e} lr")
        moved = float(du_card.abs().min()) / lr
        if moved < 0.9:
            bad.append(f"{name}: a clear element moved {moved:.3e} lr on "
                       f"the card")
    if bad:
        raise AssertionError("Adam step, card vs CPU: " + "; ".join(bad))
    return {"grad_rtol": worst_g, "clear_step_diff_lr": worst_u,
            "clear_share": clear_n / total, "param_max_abs_diff": worst_p}


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element of ``x`` (as fp32): ``2^(e - 8)`` for
    ``|x| = m 2^e``, ``m`` in [0.5, 1); the least subnormal at 0."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       e - 8).clamp_min(2.0 ** -133)


def fp16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One fp16 ulp at each element of ``x`` (as fp32): ``2^(e - 11)``,
    at least fp16's subnormal step 2^-24."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       e - 11).clamp_min(2.0 ** -24)


def bf16_step_parity(card, cpu, lr, grad_rtol=2e-2, update_rtol=1e-2,
                     eps=1e-8):
    """Hold one Adam(W) first step of a bf16 model on the card against one
    on the CPU; ``card`` and ``cpu`` as for :func:`adam_step_parity`. An
    fp16 model is held the same way, its ulps fp16's (:func:`fp16_ulp`).

    The two devices round bf16 products in other places (the card's
    flash kernels round p and ds to bf16, its GEMMs sum on the tensor
    cores), so the gradients agree to bf16 precision, not fp32's:

    - every gradient within ``grad_rtol`` (the reference's bf16
      tolerance) of its tensor's largest one;
    - on every *clear* element (as in :func:`adam_step_parity`: ``|g| >=
      100 eps`` and at least 10 times the tensor's largest card-vs-CPU
      gradient difference, so both devices step it by about ``lr`` the
      same way) a bf16 parameter lands within one bf16 ulp of the CPU's
      (the two fp32 updates are ~equal, so they round to the same or to
      neighbouring bf16 values), and an fp32 one (the final norm) within
      ``update_rtol * lr`` of it;
    - a tensor the CPU changed is changed on the card too (a bucket the
      card skipped would be caught; a bf16 weight whose step is under
      half its ulp rounds back and stays, on both devices).

    Returns the worst gradient ratio, the share of clear elements, the
    share of all elements whose bf16 result differs, and the largest
    difference over all elements."""
    worst_g, worst_p, clear_n, differ, total = 0.0, 0.0, 0, 0, 0
    bad = []
    for name, (b0, b1, bg) in cpu.items():
        c0, c1, cg = card[name]
        if not same_bits(c0, b0):
            bad.append(f"{name}: the devices started from other weights")
        gmax = float(bg.float().abs().max())
        gerr = _max_abs(cg, bg)
        total += bg.numel()
        worst_p = max(worst_p, _max_abs(c1, b1))
        differ += int((c1.float() != b1.float()).sum())
        if gmax == 0.0:
            if gerr:
                bad.append(f"{name}: gradient {gerr:.3e} on the card, 0 on "
                           f"the CPU")
            continue
        worst_g = max(worst_g, gerr / gmax)
        if gerr > grad_rtol * gmax:
            bad.append(f"{name}: gradients differ by {gerr / gmax:.3e} of "
                       f"the largest")
        if not same_bits(b1, b0) and same_bits(c1, c0):
            bad.append(f"{name}: the CPU's step moved it, the card's did "
                       f"not")
        clear = (bg.float().abs() >= 100 * eps) & (bg.float().abs()
                                                   >= 10 * gerr)
        clear_n += int(clear.sum())
        if not bool(clear.any()):
            continue
        a_card, a_cpu = c1.float()[clear], b1.float()[clear]
        if b1.dtype in (torch.bfloat16, torch.float16):
            ulp = bf16_ulp if b1.dtype == torch.bfloat16 else fp16_ulp
            lim = ulp(torch.maximum(a_card.abs(), a_cpu.abs()))
            over = int(((a_card - a_cpu).abs() > lim).sum())
            if over:
                bad.append(f"{name}: {over} clear elements more than one "
                           f"{b1.dtype} ulp from the CPU's")
        else:
            derr = _max_abs(a_card, a_cpu) / lr
            if derr > update_rtol:
                bad.append(f"{name}: steps differ by {derr:.3e} lr")
    if bad:
        raise AssertionError("bf16 Adam step, card vs CPU: "
                             + "; ".join(bad))
    return {"grad_rtol": worst_g, "clear_share": clear_n / total,
            "differ_share": differ / total, "param_max_abs_diff": worst_p}


def dp_step_parity(card, cpu, lr, grad_rtol=1e-4, flip_share=1e-2,
                   dec_rtol=1e-4, update_rtol=1e-2, eps=1e-8):
    """Hold two data-parallel AdamW steps on the quantized gradient wire
    on the card against the same on the CPU (world 2 each).

    ``card`` and ``cpu`` map each parameter's name to a dict of CPU
    tensors: ``d1``, ``d2`` (the parameter's change in steps 1 and 2),
    ``local`` (this rank's gradient in step 1) and ``dec1``, ``dec2``
    (the averaged gradient each step's update decoded from the summed
    payload). The scales are the summed abs-max of the local gradients,
    which differ by ulps between the devices, so every decoded value
    carries that noise (~1e-6 relative); and a local gradient at fp32
    noise level from a rounding edge of the quantizer lands one step
    apart in the payload, which moves its decoded value by at least
    1/254 of itself, and Adam turns that into a different step. Two
    decoded values *agree* when they are within ``dec_rtol`` of each
    other. Hence:

    - every local gradient within ``grad_rtol`` of its tensor's largest
      (the forward and backward agree);
    - at most ``flip_share`` of the elements decode apart in either
      step (measured and reported);
    - step 1 on the elements whose decoded gradients agree:
      :func:`adam_step_parity` with the decoded gradient (every clear
      element moved by the CPU's step within ``update_rtol`` lr and by at
      least 0.9 lr);
    - step 2 on the elements whose decoded gradients agree in both steps:
      within ``update_rtol`` lr;
    - every element's step 1 within 2.1 lr of the CPU's (two Adam first
      steps of at most lr each, plus weight decay).

    Returns the worst local-gradient ratio, the flip share, the step-1
    numbers of :func:`adam_step_parity` and the worst step-2 difference
    over ``lr``."""
    bad = []
    worst_g, flips1, flips, total, worst_2, worst_any = 0.0, 0, 0, 0, 0.0, 0.0
    sub_card, sub_cpu = {}, {}
    for name, b in cpu.items():
        c = card[name]
        gmax = float(b["local"].abs().max())
        gerr = _max_abs(c["local"], b["local"])
        if gmax:
            worst_g = max(worst_g, gerr / gmax)
            if gerr > grad_rtol * gmax:
                bad.append(f"{name}: local gradients differ by "
                           f"{gerr / gmax:.3e} of the largest")
        same1 = ((c["dec1"] - b["dec1"]).abs()
                 <= dec_rtol * b["dec1"].abs())
        same2 = same1 & ((c["dec2"] - b["dec2"]).abs()
                         <= dec_rtol * b["dec2"].abs())
        flips1 += int((~same1).sum())
        flips += int((~same2).sum())
        total += same2.numel()
        worst_any = max(worst_any, _max_abs(c["d1"], b["d1"]) / lr)
        if bool(same1.any()):
            z = torch.zeros(int(same1.sum()))
            sub_card[name] = (z, c["d1"][same1], c["dec1"][same1])
            sub_cpu[name] = (z, b["d1"][same1], b["dec1"][same1])
        if bool(same2.any()):
            worst_2 = max(worst_2,
                          _max_abs(c["d2"][same2], b["d2"][same2]) / lr)
    share = flips / total
    if share > flip_share:
        bad.append(f"{share:.3e} of the elements decode apart in step 1 "
                   f"or 2 ({flips1 / total:.3e} in step 1; limit "
                   f"{flip_share})")
    if worst_2 > update_rtol:
        bad.append(f"step 2 differs by {worst_2:.3e} lr where both steps' "
                   f"gradients agree")
    if worst_any > 2.1:
        bad.append(f"a step 1 differs by {worst_any:.3e} lr")
    try:
        step1 = adam_step_parity(sub_card, sub_cpu, lr, grad_rtol,
                                 update_rtol, eps)
    except AssertionError as e:
        bad.append(str(e))
        step1 = None
    if bad:
        raise AssertionError("data-parallel steps, card vs CPU: "
                             + "; ".join(bad))
    return {"local_grad_rtol": worst_g, "flip_share": share,
            "step1": step1, "step2_diff_lr": worst_2,
            "step1_max_diff_lr": worst_any}


def bucket_entries(kind, sizes, gen, wds=(0.0,), lms=(1.0,),
                   dtypes=(torch.float32,)):
    """Seeded ``(p, g, slot tensors, wd, lm)`` a bucket of ``sizes`` on
    ``gen``'s device (unit-scale weights and gradients, moments of
    1e-2), bucket ``i`` taking ``wds[i % len(wds)]``,
    ``lms[i % len(lms)]`` and parameters and gradients in
    ``dtypes[i % len(dtypes)]`` (the moments fp32)."""
    dev = gen.device
    out = []
    for i, n in enumerate(sizes):
        dt = dtypes[i % len(dtypes)]
        p = torch.randn(n, device=dev, generator=gen).to(dt)
        g = torch.randn(n, device=dev, generator=gen).to(dt)
        arrs = [torch.randn(n, device=dev, generator=gen).abs() * 1e-2
                for _ in fu.slot_names(kind)]
        out.append((p, g, arrs, wds[i % len(wds)], lms[i % len(lms)]))
    return out


def buckets_vs_plain(kind, hyper, entries, lr, *, steps=3, gen=None,
                     world=None, block_size=None):
    """``fused_update_buckets`` on one table against ``buckets_plain`` on
    a table of clones, ``steps`` consecutive steps from the beta powers of
    step 3, each step with fresh gradients (from ``gen``) on both. With
    ``block_size`` the entries carry ``WirePayload``s (shared by both
    tables, read only) and the kernel is ``fused_dequant_update_buckets``
    at ``world``, every step on the same payloads. Returns the launches
    the kernel side counted; raises unless parameters, slots and stepped
    powers are bit-identical after every step."""
    dequant = block_size is not None
    clones = [(p.clone(), g if dequant else g.clone(),
               [s.clone() for s in arrs], wd, lm)
              for p, g, arrs, wd, lm in entries]
    ktab = fu.BucketTable(kind, hyper, entries, block_size=block_size)
    ptab = fu.BucketTable(kind, hyper, clones, block_size=block_size)
    run = (fu.fused_dequant_update_buckets if dequant
           else fu.fused_update_buckets)
    args = (world,) if dequant else ()
    if ktab.adam:
        start = [(torch.tensor(0.9 ** 3), torch.tensor(0.999 ** 3))] * len(
            entries)
        ktab.load_powers([(a.to(lr.device), b.to(lr.device))
                          for a, b in start])
        ptab.load_powers([(a.to(lr.device), b.to(lr.device))
                          for a, b in start])
    launches = 0
    for step in range(steps):
        if step and gen is not None and not dequant:
            for (_, g, *_), (_, gc, *_) in zip(entries, clones):
                g.copy_(torch.randn(g.shape, device=g.device, generator=gen))
                gc.copy_(g)
        before = run.launches
        run(ktab, lr, *args)
        launches += run.launches - before
        fu.buckets_plain(ptab, lr, *args)
        pairs = []
        for b, (ke, pe) in enumerate(zip(entries, clones)):
            pairs.append((f"bucket {b} p", ke[0], pe[0]))
            pairs += [(f"bucket {b} {nm}", a, c) for nm, a, c in
                      zip(fu.slot_names(kind), ke[2], pe[2])]
        if ktab.adam:
            pairs += [(f"bucket {b} beta{j + 1}_pow", a, c)
                      for b, (kp, pp) in enumerate(zip(ktab.powers(),
                                                       ptab.powers()))
                      for j, (a, c) in enumerate(zip(kp, pp))]
        differ = [n for n, a, c in pairs if not same_bits(a, c)]
        if differ:
            raise AssertionError(
                f"{run.__name__} {kind} step {step + 1}: {differ[:6]} "
                f"differ from plain ({len(differ)} of {len(pairs)})")
    return launches


def table_step_vs_plain(table, lr, run) -> float:
    """``run()``, which launches ``fused_update_buckets`` on ``table``
    (a ZeRO shard table: views of the flat buffers), against
    ``buckets_plain`` on a table of clones of its entries and powers
    taken before it. Returns the max abs difference; raises unless
    parameters, slots and stepped powers are bit-identical."""
    clones = [(p.clone(), g.clone(), [s.clone() for s in arrs], wd, lm)
              for p, g, arrs, wd, lm in table.entries]
    ptab = fu.BucketTable(table.kind, table.hyper, clones)
    if table.adam:
        ptab.load_powers([(a.clone(), b.clone())
                          for a, b in table.powers()])
    before = fu.fused_update_buckets.launches
    run()
    if fu.fused_update_buckets.launches != before + 1:
        raise AssertionError("the step made "
                             f"{fu.fused_update_buckets.launches - before} "
                             f"fused_update_buckets launches, not 1")
    fu.buckets_plain(ptab, lr)
    pairs = []
    for b, (ke, pe) in enumerate(zip(table.entries, clones)):
        pairs.append((f"shard {b} p", ke[0], pe[0]))
        pairs += [(f"shard {b} {nm}", a, c) for nm, a, c in
                  zip(fu.slot_names(table.kind), ke[2], pe[2])]
    if table.adam:
        pairs += [(f"shard {b} beta{j + 1}_pow", a, c)
                  for b, (kp, pp) in enumerate(zip(table.powers(),
                                                   ptab.powers()))
                  for j, (a, c) in enumerate(zip(kp, pp))]
    differ = [n for n, a, c in pairs if not same_bits(a, c)]
    if differ:
        raise AssertionError(f"shard table: {differ[:6]} differ from plain "
                             f"({len(differ)} of {len(pairs)})")
    return max(_max_abs(a, c) for _, a, c in pairs)


# ------------------------------------------------------------- ResNet
def resnet_stages(model, flatten):
    """The stages of a ResNet (the port's or the reference's: the same
    attribute names) in order: ``(name, fn, prefixes)``, ``fn`` the
    stage's forward and ``prefixes`` the modules whose parameters and
    buffers it holds. The stem (conv1, bn1, relu, maxpool), every block
    of layer1-4, and the head (avgpool, ``flatten(x, 1)``, fc)."""
    m = model
    out = [("stem", lambda x: m.maxpool(m.relu(m.bn1(m.conv1(x)))),
            ("conv1", "bn1"))]
    for layer in ("layer1", "layer2", "layer3", "layer4"):
        seq = getattr(m, layer)
        for i in range(len(seq)):
            out.append((f"{layer}.{i}", seq[i], (f"{layer}.{i}",)))
    out.append(("head", lambda x: m.fc(flatten(m.avgpool(x), 1)), ("fc",)))
    return out


def mobilenet_stages(model):
    """The stages of a MobileNetV2 (the port's or the reference's: the
    same attribute names) in order, as :func:`resnet_stages` gives a
    ResNet's: each of ``features`` (the stem, the 17 inverted residual
    blocks, the last 1 x 1 convolution), then the head (the average
    pool, ``flatten(1)``, the classifier)."""
    m = model
    out = [(f"features.{i}", m.features[i], (f"features.{i}",))
           for i in range(len(m.features))]
    out.append(("head", lambda x: m.classifier(m.pool2d_avg(x).flatten(1)),
                ("classifier",)))
    return out


def _in_stage(name: str, prefixes) -> bool:
    return any(name == p or name.startswith(p + ".") for p in prefixes)


def stage_run(model, stage, x, seed, level=None) -> dict:
    """One stage of a port ResNet on its parameters' device, in training
    mode, under ``auto_cast(level=level, dtype="bfloat16")`` when
    ``level`` is given: the forward of the CPU fp32 input ``x``, then the
    backward of ``sum(out * ct)``, ``ct`` drawn on the CPU from ``seed``
    in the output's shape. Returns CPU fp32 tensors: ``out``, ``ct``,
    ``dx``, the stage's parameter gradients ``grads`` and its running
    buffers ``buffers`` after the forward."""
    from paddle_tpu_torch.amp import auto_cast

    _, fn, prefixes = stage
    # PyTorch's accessors: a port ``Layer``'s own return eager views
    params = dict(torch.nn.Module.named_parameters(model))
    dev = next(iter(params.values())).device
    model.train()
    for p in params.values():
        p.grad = None
    xd = x.detach().clone().to(dev).requires_grad_()
    with (auto_cast(level=level, dtype="bfloat16") if level
          else contextlib.nullcontext()):
        out = fn(xd)
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        seed))
    (out.float() * ct.to(dev)).sum().backward()
    return {"out": out.detach().float().cpu(), "ct": ct,
            "dx": xd.grad.float().cpu(),
            "grads": {n: p.grad.float().cpu()
                      for n, p in params.items()
                      if _in_stage(n, prefixes)},
            "buffers": {n: b.float().cpu()
                        for n, b in torch.nn.Module.named_buffers(model)
                        if _in_stage(n, prefixes)}}


def norm_rel(a, b) -> float:
    """``||a - b|| / ||b||`` (2-norms, fp64): a ReLU network's gradients
    on two devices differ wholly at the few elements whose pre-activation
    the rounding moved across zero, so a largest-element criterion reads
    the flips, the norm the rest."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def stage_errors(got: dict, want: dict) -> dict:
    """:func:`stage_run`'s results on two sides: ``out`` as its largest
    difference over its largest magnitude, ``dx`` and the worst
    parameter gradient by :func:`norm_rel`, the worst buffer as the
    largest absolute difference."""
    out = got["out"] - want["out"]
    return {"out": float(out.abs().max()
                         / want["out"].abs().max().clamp_min(1e-30)),
            "dx": norm_rel(got["dx"], want["dx"]),
            "grads": max(norm_rel(got["grads"][n], g)
                         for n, g in want["grads"].items()),
            "buffers": max([float((got["buffers"][n] - b).abs().max())
                            for n, b in want["buffers"].items()] or [0.0])}


def bench_eager_loops(paddle, xs, w, k):
    """``chain(t, k)`` and ``train_iter()`` of ``bench.py``'s
    ``measure_eager``, compiled from bench.py's text (read, not imported:
    bench.py imports the JAX package) over ``paddle`` and the grad
    loop's ``xs``, ``w`` and ``k``."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench.py")
    src = open(path).read()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "measure_eager")
    ns = {"paddle": paddle, "xs": xs, "w": w, "k": k}
    for node in fn.body:
        if isinstance(node, ast.FunctionDef) and node.name in ("chain",
                                                               "train_iter"):
            seg = textwrap.dedent(ast.get_source_segment(src, node))
            exec(compile(seg, path, "exec"), ns)
    return ns["chain"], ns["train_iter"]
