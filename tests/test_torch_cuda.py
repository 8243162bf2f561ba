"""The port's CUDA path held against its own plain PyTorch path.

The test here needs the card (``requires_cuda``) and skips, with its
reason, where ``torch.cuda.is_available()`` is False. The module imports
neither JAX nor ``paddle_tpu``, so it runs on the GPU machine, which has
no JAX; the repository's ``tests/conftest.py`` imports JAX, so run it
there with ``python -m pytest --noconftest tests/test_torch_cuda.py``.

Tolerances: codec payloads and decoded values bit-identical; pool bytes
identical; greedy engine tokens identical to the CPU engine's, with every
step's top-2 logit gap asserted above 1e-3 (card and CPU fp32 logits
differ by ~1e-5 at this size). A speculative engine on the card
(``draft_model=dm.truncated(1)``, ``spec_k=4``) against the plain engine
on the card, greedy and top_p, under ``tests/torch_serving_checks.py``
``spec_rule`` (equal tokens, or a decision margin below 1e-3 at a
request's first differing position: the k+1-row ``extend`` and the
one-row ``decode`` reach cuBLAS with different ``m``), no block leaked,
one encode a prompt and one a plain or speculative tick; a two-thread
``ReplicaSet`` on the card completing every request, the codec launches
of its two threads summed exactly equal to the pools' codec calls and
the engines' appends. Flash kernels and ``fused_update``
against their plain versions on the card by ``tests/torch_checks.py``'s
criteria, which ``chip_smoke.py`` shares: out and lse within 2e-5 max
abs, dq/dk/dv within 1e-4 of the larger of 1 and the largest gradient
magnitude (the forward's online softmax rounds differently from the
plain [s, s] softmax, and the inputs are unit-scale); the backward
kernels' two launches on the same inputs bit-identical; the update
bit-identical; ``fused_update_buckets`` over the 18 GPT-125M bucket
sizes and over ragged ones (n % 4 != 0, n = 1, mixed weight decay and
lr_mult), every rule, three steps, parameters, slots and stepped beta
powers bit-identical to its plain walk, one launch a step; the
updater's table kept while its pointers stay and rebuilt after the
``torch.cat`` gradient fallback. ZeRO's shard table (every rank's
``[r * chunk, (r + 1) * chunk)`` of padded flat buffers, views) bit for
bit against its plain walk over three steps, ``step_sharded`` on the card
bit for bit against the CPU, and the codecs on shard views whose length
is off the block. The bf16 forms: the flash kernels on
bf16 inputs element by element within ``flash_bf16_limit`` (2e-2 of the
plain value's magnitude plus 1.6e-2 of its row's RMS plus 1e-5; lse
1e-4), their backward deterministic, each launch counted under its
dtype; the same check fails the kernels built with a fault planted (one
16-wide chunk skipped in each kernel's second product) on every output
and on every long row of out and dq; ``fused_update_buckets`` over bf16 buckets
(bf16 parameters and gradients, fp32 moments) and fp32 ones in one
table, bit-identical to its plain walk. The fp16 forms: the flash
kernels on fp16 inputs at the bf16 shapes within ``flash_fp16_limit``
(2.5e-3 of the plain value's magnitude plus 1.95e-3 of its row's RMS
plus max(1e-5 s, 2^-23), s dO's scale), and at dO 2^-16 (the backward's
dS scaling), deterministic, each launch counted under ``*_fp16``, the
planted fault over the limit as for bf16; ``fused_update_buckets`` over
GPT-125M's fp16 plan and over fp16, fp32 and bf16 buckets in one table,
bit-identical to its plain walk; ``F.flash_attention`` on fp16. One gpt-test ``TrainStep`` on the card
against one on the CPU: loss within 1e-5 relative, then
``adam_step_parity`` (gradients within 1e-4 of each tensor's largest;
the step on every element whose
gradient is clear of the card-vs-CPU gradient noise within 1e-2 lr of
the CPU's and at least 0.9 lr); the same in bf16: loss within ``BF16_LOSS_RTOL`` (1e-4)
relative, then ``bf16_step_parity``, and the step through the planted
flash fault over that loss limit (the control); a bf16 backward that
raises leaves the caller's GEMM flags as they were. ``quantize_int8`` bit-identical to its
plain version, nearest and stochastic; ``quant_matmul`` within
``2 k 2^-24 (|x| @ |q|) s`` of its plain version elementwise (two fp32
dot products of length k summed in different orders), at every row-tile
size of the kernel, ragged n and k, the BERT-base shapes, and two
launches of a shape whose k is split over slices giving identical bits. A converted
bert-test on the card against the same on the CPU: int8 payloads
identical, logits within 1e-4 (card and CPU differ by ~1e-6 at this
size), and the launches of one conversion and one forward counted.
Ragged inputs (n % bs != 0, n % 4 != 0) are encoded where they lie, at
starts on and off the 16-byte grid, with ``F.pad`` made to raise during
the card's calls: payload, carrier, abs-max and decode bit-identical to
the plain versions, one launch a call.
The gradient wire: the codec kernels' int32/fp32 carriers (encode, and
the decode of two ranks' summed carriers) bit-identical to the plain
versions; their bf16 forms (a bf16 input read in place, ragged and off
the 8-byte grid, to the wire dtype and the carrier; two ranks' summed
carriers decoded to bf16 at world 2 and 3) bit-identical to the plain
versions, each launch counted under its dtype;
``fused_dequant_update_buckets`` bit-identical to its plain walk on a
table of one (``tests/torch_checks.py`` ``dequant_vs_plain``, fp32 and
bf16 parameters) for both carriers, the four rules, with and without a
residual, at ragged sizes and blocks, each launch counted in total and
its buckets by size and dtype, and over mixed bf16 and fp32 tables
(a bf16 bucket over fp32 parameters among them), three steps, one
launch a step (``buckets_vs_plain``); ``step_dequant`` keeps one table
while the payload buffers stay.
The fused loss: ``ce_chunk_fwd`` and ``ce_chunk_bwd`` against their
plain versions by ``tests/torch_checks.py``'s criteria (the running max
and the picked logit bit-identical, the running sum within 1e-5
relative; each dlogit element within 1e-6 of its magnitude, and of
``|g|`` at the label's column; rows with ``g = 0`` exactly 0) at the
bench step's two chunk shapes ([8192, 8192], [8192, 1152]) with and
without bias, with ignored rows and a label in the chunk's last column,
and at shapes off the vector path or over one segment; the backward at
widths that are not a multiple of 4 (BERT's 5946, c % 4 = 1, 2, 3) on a
logit 0, 4, 8 and 12 bytes off the 16-byte grid, with and without a
bias; their wrappers' refusals; ``fused_linear_cross_entropy`` on the
card against the CPU (loss 1e-5 relative, gradients 1e-5 of their largest); one bf16
gpt-test step in ``bench.py``'s fused form with ``recompute`` against
the CPU's (``BF16_LOSS_RTOL``, ``bf16_step_parity``), its launches
counted, its gradients bit-identical to the same step without
recompute.
BERT under amp: ``quant_matmul`` on bf16 ``x`` (the
``quant_matmul_bf16`` kernel) within ``qmm_bf16_limit`` (the fp32 limit
above plus one bf16 ulp of the plain element) at every row-tile size,
ragged n and k and BERT-base's shapes, on all three routes (cluster for
every m <= 64: m in 1, 2, 7, 8, 15, 16, 17, 32, 33, 63, 64 at BERT's
(k, n), the NSP head's n = 2 and ragged (100, 37), (37, 100), an x 2 or
8 bytes off the 16-byte grid, each bit-identical on a second run; wgmma
at m > 64 where TMA takes both operands: m, n and k off its tiles, k %
64 != 0; mma.sync for the other m > 64 shapes: k % 8 != 0, n = 2, x off
the grid), each launch counted under the bf16 form and its route, the
route switching at m = 64 / 65; the same check fails the kernels built
with faults planted (the wgmma kernel dropping 16 of the k products,
the cluster kernel leaving rank 0's partial sums out; ``-s`` prints
both readings); fp16 refused by ``quant_matmul``, naming "other
dtypes"; an int8 bert-test forward under O2 at 2 x 32
and 1 x 16 tokens (9 bf16 launches, all on the cluster route, and 6
fp32, as the reference's, its logits within 1e-2 mean relative error
of the CPU's on the flash route); one bert-test O2 step on the
card against the CPU's (flash route): loss within ``BF16_LOSS_RTOL``,
``bf16_step_parity`` (the query and key projections at 5e-2, the key
biases left out), the bf16 flash trio in full mode once a layer.

The eager training surface: ``Optimizer.step()`` on card parameters
(SGD, Momentum, Adam, AdamW over a table of mixed fp32 and bf16
parameters, ragged, with a per-parameter lr_mult and regularizer): one
``fused_update_buckets`` launch a step, ``update_math`` never called,
parameters, moments and beta powers bit-identical to the plain
per-parameter step, one table while no pointer moves; an fp64 parameter
and a rule without a fused form refused, naming their ROADMAP items;
LeNet at batch 8 on eager Tensors, one Adam step, card against CPU
within 1e-5.

The feed-forward ``nn``: every case of ``tests/torch_nn_checks.py``
``NN_CASES`` (each new functional and every layer that holds state) on
the card against the CPU, outputs and gradients within 1e-5 relative,
masks and one-hot rows bit for bit, every output on the card; the
dropout family's properties on the card's generator
(``dropout_properties``); ``F.flash_attention`` on card tensors, fp32
and bf16: one launch of each flash kernel through the entry, out and
the three gradients against the kernels' plain versions
(``flash_err``'s limits), none with dropout > 0, and
``flash_attn_unpadded`` at equal lengths through the same kernel.

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import contextlib
from collections import Counter
import functools
import importlib
from unittest import mock

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import grad_comm as plain
from paddle_tpu_torch.distributed.grad_comm import build_buckets
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (BertForPretraining, GPTForCausalLM,
                                     GPTPretrainingCriterion, bert_presets,
                                     gpt_presets)
from paddle_tpu_torch.models.convert import expected_dtypes, expected_shapes
from paddle_tpu_torch.observability.metrics import get_registry
from paddle_tpu_torch.ops import codec
from paddle_tpu_torch.incubate.nn.functional import fused_linear_cross_entropy
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_ce as fce
from paddle_tpu_torch.ops import fused_update as fu
from paddle_tpu_torch.optimizer import AdamW, FusedFlatUpdater
from paddle_tpu_torch.quantization import Int8Linear, convert_to_int8
from paddle_tpu_torch.serving import (BatchSampler, GPTDecodeModel,
                                      KVBlockPool, RequestQueue,
                                      ServeRequest, ServingEngine)
from torch_checks import (BF16_LOSS_RTOL, FUSED_HYPER, adam_step_parity,
                          bf16_step_parity, bucket_entries, buckets_vs_plain,
                          ce_bwd_vs_plain, ce_fwd_vs_plain, ce_inputs,
                          dequant_inputs, dequant_vs_plain, flash_bf16_limit,
                          flash_err, flash_fp16_limit, flash_vs_plain,
                          fused_inputs,
                          fused_vs_plain, plant_flash_fault, plant_qmm_fault,
                          qmm16_vs_plain, qmm_bf16_limit, qmm_bf16_vs_plain,
                          qmm_vs_plain,
                          quantize_vs_plain, run_checks, same_bits)
from torch_nn_checks import NN_CASES, dropout_properties, nn_case_vs_cpu
from torch_serving_checks import drive, spec_rule

torch.set_num_threads(2)

qm = importlib.import_module("paddle_tpu_torch.ops.quant_matmul")

CODECS = ("int8_block", "fp8_block")
CASES = [(5000, 1024), (777, 128), (2 * 256 + 3, 256), (18432 * 3, 1024)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the codec kernels run only on "
                    "the card (no interpret mode)")
    return torch.device("cuda", 0)


def _x(n, bs, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(n).astype(np.float32) * 4
    x[:bs] = 0.0                               # all-zero block
    x[bs:bs + 8] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -127.0]
    return torch.from_numpy(x)


def check_kernels_match_plain_bit_for_bit(dev, codec_name, n, bs, world):
    x = _x(n, bs, seed=n + bs)
    s = plain.block_scales(plain.block_absmax(x, bs), codec_name)
    q_ref = plain.block_encode(x, s, bs, codec_name)
    d_ref = plain.block_decode(q_ref, s, world, n)
    before = codec.launch_counts()
    q = codec.block_encode(x.to(dev), s.to(dev), bs, codec_name)
    d = codec.block_decode(q, s.to(dev), world, n)
    torch.cuda.synchronize()
    assert q.dtype == q_ref.dtype and q.shape == q_ref.shape
    assert torch.equal(q.cpu().view(torch.uint8), q_ref.view(torch.uint8))
    assert torch.equal(d.cpu(), d_ref)
    # the plain version on the card agrees too
    assert torch.equal(plain.block_decode(q, s.to(dev), world, n).cpu(),
                       d_ref)
    after = codec.launch_counts()
    assert after == {"codec_encode": before["codec_encode"] + 1,
                     "codec_decode": before["codec_decode"] + 1}


def check_wrappers_raise_on_what_the_kernel_does_not_take(dev):
    x = torch.randn(4097, device=dev)
    s = torch.ones(4, device=dev)
    with pytest.raises(ValueError, match="block_size"):
        codec.block_encode(x[:4094], torch.ones(2, device=dev), 2047,
                           "int8_block")
    with pytest.raises(TypeError):
        codec.block_encode(x[:4096].double(), s, 1024, "int8_block")
    with pytest.raises(TypeError):   # fp32 and int32 are the carriers
        codec.block_decode(torch.zeros(4, 1024, dtype=torch.float64,
                                       device=dev), s, 1, 4096)
    with pytest.raises(ValueError, match="numel"):
        codec.block_decode(torch.zeros(4, 1024, dtype=torch.int8,
                                       device=dev), s, 1, 5000)


def _no_pad(*args, **kwargs):
    raise AssertionError("F.pad called: the CUDA path copies no padded "
                         "buffer")


def check_ragged_read_in_place(dev, codec_name, carrier, n, bs, offset):
    """A ragged input (n % bs != 0) read where it lies: ``offset``
    elements into a larger buffer (a start off the 16-byte grid when
    offset % 4 != 0). The payload or carrier is bit for bit the plain
    encode's (the plain version zero-pads), the card's abs-max the CPU's,
    the decode the plain decode's over numel, also from a payload that
    starts one element off the 16-byte grid; F.pad raises during the
    card's calls, and each call launches once."""
    rs = np.random.RandomState(n + offset)
    base = torch.from_numpy(rs.randn(n + offset).astype(np.float32) * 4)
    base[offset:offset + bs] = 0.0           # an all-zero block, if whole
    x, xd = base[offset:], base.to(dev)[offset:]
    s = plain.block_scales(plain.block_absmax(x, bs), codec_name)
    world = 2 if carrier else 1
    q_ref = plain.block_encode(x, s, bs, codec_name, carrier=carrier)
    d_ref = plain.block_decode(q_ref, s, world, n)
    buf = torch.zeros(q_ref.numel() + 1, dtype=q_ref.dtype, device=dev)
    pad, torch.nn.functional.pad = torch.nn.functional.pad, _no_pad
    try:
        before = codec.launch_counts()
        absmax = plain.block_absmax(xd, bs)
        q = codec.block_encode(xd, s.to(dev), bs, codec_name,
                               carrier=carrier)
        d = codec.block_decode(q, s.to(dev), world, n)
        buf[1:] = q.reshape(-1)
        d_off = codec.block_decode(buf[1:].view(q.shape), s.to(dev), world,
                                   n)
        torch.cuda.synchronize()
    finally:
        torch.nn.functional.pad = pad
    assert codec.launch_counts() == {
        "codec_encode": before["codec_encode"] + 1,
        "codec_decode": before["codec_decode"] + 2}
    assert torch.equal(absmax.cpu(), plain.block_absmax(x, bs))
    assert q.dtype == q_ref.dtype and q.shape == q_ref.shape
    bits = torch.int32 if carrier else torch.uint8
    assert torch.equal(q.cpu().view(bits), q_ref.view(bits))
    assert torch.equal(d.cpu(), d_ref) and torch.equal(d_off.cpu(), d_ref)


def check_carrier_kernels_match_plain(dev, codec_name, n, bs):
    """The gradient wire's forms: the carrier written by the encode
    kernel, and two ranks' carriers summed, decoded by the kernel at
    world 2 and 3: bit-identical to the plain versions."""
    x, y = _x(n, bs, seed=n), _x(n, bs, seed=n + 1) * 0.5
    s = plain.block_scales(plain.block_absmax(x, bs)
                           + plain.block_absmax(y, bs), codec_name)
    qx = plain.block_encode(x, s, bs, codec_name, carrier=True)
    qy = plain.block_encode(y, s, bs, codec_name, carrier=True)
    before = codec.launch_counts()
    kx = codec.block_encode(x.to(dev), s.to(dev), bs, codec_name,
                            carrier=True)
    ky = codec.block_encode(y.to(dev), s.to(dev), bs, codec_name,
                            carrier=True)
    assert kx.dtype == qx.dtype and torch.equal(kx.cpu(), qx)
    assert torch.equal(ky.cpu(), qy)
    for world in (2, 3):
        d = codec.block_decode(kx + ky, s.to(dev), world, n)
        assert torch.equal(d.cpu(), plain.block_decode(qx + qy, s, world, n))
    assert codec.launch_counts() == {
        "codec_encode": before["codec_encode"] + 2,
        "codec_decode": before["codec_decode"] + 2}


def check_dequant_update_bit_identical(dev, codec_name, kind, n, bs,
                                       residual, dtype=torch.float32):
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + bs)
    p, _, slots, lr = fused_inputs(kind, n, gen, 1e-3)
    p = p.to(dtype)
    q, scales = dequant_inputs(codec_name, n, bs, 2, gen, dtype=dtype)
    res = torch.randn(n, device=dev, generator=gen) * 1e-5 if residual \
        else None
    before = fu.dequant_launch_counts()
    assert dequant_vs_plain(p, q, scales, slots, lr, world=2, block_size=bs,
                            kind=kind, hyper=FUSED_HYPER[kind], wd=0.01,
                            residual=res) == 0.0
    after = fu.dequant_launch_counts()
    assert after["fused_dequant_update"] == \
        before["fused_dequant_update"] + 1
    key = (n, str(dtype).split(".")[-1])
    assert after["sizes"][key] == before["sizes"].get(key, 0) + 1


def check_dequant_buckets_bit_identical(dev, codec_name, kind, sizes,
                                        dtypes, bs, residual):
    """One fused_dequant_update_buckets launch a step over a mixed table,
    three steps on the same payloads, bit for bit against the plain walk.
    ``dtypes`` pairs (parameters, bucket): a bf16 bucket over fp32
    parameters rounds its gradient to bf16 too."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(len(sizes) + bs)
    entries = []
    for i, n in enumerate(sizes):
        p_dt, b_dt = dtypes[i % len(dtypes)]
        q, scales = dequant_inputs(codec_name, n, bs, 2, gen, dtype=b_dt)
        res = (torch.randn(n, device=dev, generator=gen) * 1e-5
               if residual else None)
        p = torch.randn(n, device=dev, generator=gen).to(p_dt)
        arrs = [torch.randn(n, device=dev, generator=gen).abs() * 1e-2
                for _ in fu.slot_names(kind)]
        entries.append((p, fu.WirePayload(q, scales, res, b_dt), arrs,
                        (0.01, 0.0)[i % 2], (1.0, 0.5)[i % 2]))
    lr = torch.full((), 1e-3, device=dev)
    assert buckets_vs_plain(kind, FUSED_HYPER[kind], entries, lr, steps=3,
                            world=2, block_size=bs) == 3


def check_step_dequant_keeps_its_table(dev):
    """``step_dequant`` on payloads in the same buffers each step (as the
    communicator keeps them): one table, one launch a step, and the same
    parameters and slots as an updater on the CPU (the plain walk) fed
    the same payloads."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    vals = [(torch.randn(n, device=dev, generator=gen) * 0.02).to(dt)
            for n, dt in ((4097, torch.bfloat16), (100, torch.float32),
                          (3000, torch.bfloat16))]

    def updater(device):
        ps = [torch.nn.Parameter(v.to(device)) for v in vals]
        return FusedFlatUpdater(AdamW(learning_rate=1e-3, weight_decay=0.01,
                                      parameters=ps), ps)

    u, cpu = updater(dev), updater("cpu")
    pay = [dequant_inputs("int8_block", b.size, 1024, 2, gen, dtype=b.dtype)
           for b in u.buckets]
    for _ in range(3):
        before = fu.fused_dequant_update_buckets.launches
        u.step_dequant(pay, 2, 1024)
        assert fu.fused_dequant_update_buckets.launches == before + 1
        cpu.step_dequant([(q.cpu(), sc.cpu()) for q, sc in pay], 2, 1024)
        for q, _ in pay:              # the next step's payload, in place
            q.copy_(q.flip(0))
    assert u.table_builds == 1
    for b in u.buckets:
        assert same_bits(u._flat_p[b.index].cpu(), cpu._flat_p[b.index])
        for k, v in u._slots[b.index].items():
            assert same_bits(v.cpu(), cpu._slots[b.index][k]), k


def check_dequant_wrapper_raises(dev):
    p = torch.zeros(64, device=dev)
    q = torch.zeros(64, dtype=torch.int32, device=dev)
    s = torch.ones(1, device=dev)

    def table(p, q, s=s, kind="sgd", arrs=(), res=None, dtype=None):
        return fu.BucketTable(kind, FUSED_HYPER[kind],
                              [(p, fu.WirePayload(q, s, res, dtype),
                                list(arrs), 0.0, 1.0)], block_size=64)

    with pytest.raises(TypeError, match="carrier"):
        table(p, q.to(torch.int8))
    with pytest.raises(ValueError, match="aligned"):
        table(p[1:], q)
    with pytest.raises(ValueError, match="flat"):
        table(p, q[:32])
    with pytest.raises(ValueError, match="is on"):
        table(p, q.cpu())
    with pytest.raises(TypeError, match="bucket dtype"):
        table(p, q, dtype=torch.float64)
    with pytest.raises(TypeError, match="bucket dtype"):
        table(p.bfloat16(), q, dtype=torch.float16)
    with pytest.raises(ValueError, match="residual.*aligned"):
        table(p[:63], q, res=torch.zeros(64, device=dev)[1:])
    with pytest.raises(TypeError, match="one carrier dtype"):
        fu.BucketTable("sgd", {}, [
            (p, fu.WirePayload(q, s), [], 0.0, 1.0),
            (p.clone(), fu.WirePayload(q.float(), s), [], 0.0, 1.0)],
            block_size=64)
    with pytest.raises(TypeError, match="WirePayload"):
        fu.BucketTable("sgd", {}, [(p, p.clone(), [], 0.0, 1.0)],
                       block_size=64)
    lr = torch.ones((), device=dev)
    with pytest.raises(ValueError, match="fused_dequant_update_buckets"):
        fu.fused_update_buckets(table(p, q), lr)
    with pytest.raises(ValueError, match="world"):
        fu.fused_dequant_update_buckets(table(p, q), lr, 0)


def check_bf16_codec_kernels_match_plain(dev, codec_name, n, bs, offset,
                                         dtype=torch.bfloat16):
    """A bf16 (or ``dtype``: fp16) input read in place, ``offset``
    elements into a larger buffer (off the 8-byte grid when offset % 4 !=
    0): the wire payload and the carrier bit for bit the plain encode's
    (which lifts to fp32 and zero-pads); two ranks' summed carriers
    decoded to ``dtype`` at world 2 and 3, also into an output off the
    grid, bit for bit the plain decode's; each launch counted under its
    dtype. An fp16 input holds subnormals (a block of 1e-7 .. 6e-5) and
    values near 65,504, whose decode keeps the subnormals and may round
    to inf."""
    rs = np.random.RandomState(n + offset)
    vals = rs.randn(n + offset) * 4
    if dtype == torch.float16:
        k = min(bs, n + offset)
        vals[:k] = rs.choice([-1, 1], k) * np.exp(
            rs.uniform(np.log(1e-7), np.log(6e-5), k))
        vals[k:k + 4] = [65504.0, -65504.0, 65488.0, 6e4][:len(vals[k:k + 4])]
    base = torch.from_numpy(vals.astype(np.float32)).to(dtype)
    x, xd = base[offset:], base.to(dev)[offset:]
    y = (x.float() * 0.5).to(dtype)
    s = plain.block_scales(plain.block_absmax(x, bs)
                           + plain.block_absmax(y, bs), codec_name)
    before = codec.launch_counts()
    enc_b = codec.block_encode.dtypes[dtype]
    dec_b = codec.block_decode.dtypes[dtype]
    sd = s.to(dev)
    for carrier in (False, True):
        q = codec.block_encode(xd, sd, bs, codec_name, carrier=carrier)
        q_ref = plain.block_encode(x, s, bs, codec_name, carrier=carrier)
        bits = torch.int32 if carrier else torch.uint8
        assert q.dtype == q_ref.dtype and q.shape == q_ref.shape
        assert torch.equal(q.cpu().view(bits), q_ref.view(bits))
    qy = codec.block_encode(y.to(dev), sd, bs, codec_name, carrier=True)
    total = q + qy
    total_ref = q_ref + plain.block_encode(y, s, bs, codec_name,
                                           carrier=True)
    assert torch.equal(total.cpu().view(torch.int32),
                       total_ref.view(torch.int32))
    for world in (2, 3):
        d = codec.block_decode(total, sd, world, n, dtype=dtype)
        d_ref = plain.block_decode(total_ref, s, world, n, dtype=dtype)
        assert d.dtype == dtype and d.shape == (n,)
        assert torch.equal(d.cpu().view(torch.int16),
                           d_ref.view(torch.int16))
    out = torch.empty(n + 1, dtype=dtype, device=dev)
    out[1:] = codec.block_decode(total, sd, 2, n, dtype=dtype)
    assert torch.equal(out[1:].cpu().view(torch.int16),
                       plain.block_decode(total_ref, s, 2, n, dtype=dtype)
                       .view(torch.int16))
    assert codec.launch_counts() == {
        "codec_encode": before["codec_encode"] + 3,
        "codec_decode": before["codec_decode"] + 3}
    assert codec.block_encode.dtypes[dtype] == enc_b + 3
    assert codec.block_decode.dtypes[dtype] == dec_b + 3


def check_pool_on_card_matches_pool_on_cpu(dev, codec_name):
    ept = 256
    rs = np.random.RandomState(3)
    pools = [KVBlockPool(16, 4, ept, codec=codec_name, quant_block=128,
                         device=d) for d in ("cpu", dev)]
    tables = [[p.alloc_table(12), p.alloc_table(6)] for p in pools]
    for which, n in ((0, 3), (1, 2), (0, 5), (1, 4), (0, 4)):
        kv = rs.randn(n, ept).astype(np.float32)
        outs = [p.append(t[which], kv) for p, t in zip(pools, tables)]
        assert torch.equal(outs[0], outs[1].cpu())
    assert torch.equal(pools[0]._payload.view(torch.uint8),
                       pools[1]._payload.cpu().view(torch.uint8))
    assert torch.equal(pools[0]._scales, pools[1]._scales.cpu())
    for i in (0, 1):
        assert torch.equal(pools[0].gather(tables[0][i]),
                           pools[1].gather(tables[1][i]).cpu())


class _GapSampler(BatchSampler):
    min_gap = float("inf")

    def sample(self, logits, params, identities, positions):
        top2 = logits.topk(2, dim=-1).values
        self.min_gap = min(self.min_gap,
                           float((top2[:, 0] - top2[:, 1]).min()))
        return super().sample(logits, params, identities, positions)


def _serve(device, prompts):
    dm = GPTDecodeModel(GPTForCausalLM(gpt_presets("gpt-test"), seed=0,
                                       device=device))
    pool = KVBlockPool(64, 8, dm.elems_per_token, codec="int8_block",
                       device=device)
    q = RequestQueue()
    gaps = _GapSampler()
    eng = ServingEngine(dm, pool, q, max_batch=4, sampler=gaps)
    reqs = [ServeRequest(prompt_ids=p, max_new_tokens=16) for p in prompts]
    for r in reqs:
        q.submit(r)
    while eng.step():
        pass
    assert all(r.outcome == "completed" for r in reqs)
    assert pool.blocks_in_use == 0
    return [r.generated for r in reqs], gaps.min_gap, pool


def check_engine_on_card_token_identical_to_cpu(dev):
    rs = np.random.RandomState(0)
    shared = rs.randint(0, 256, 20)
    prompts = [np.concatenate([shared, rs.randint(0, 256, 3)]),
               rs.randint(0, 256, 11),
               np.concatenate([shared, rs.randint(0, 256, 9)]),
               shared.copy(), rs.randint(0, 256, 29)]
    steps = get_registry().get("serve_decode_step_ms")
    before, steps_before = codec.launch_counts(), steps.get()["count"]
    card, gap, pool = _serve(dev, prompts)
    after = codec.launch_counts()
    decode_steps = steps.get()["count"] - steps_before
    cpu, cpu_gap, _ = _serve("cpu", prompts)
    assert min(gap, cpu_gap) > 1e-3
    assert card == cpu
    assert pool.cached_blocks > 0
    # one append per prompt, then one batched append per decode step;
    # each reads back once, and each prefix-cache admission gathers once
    encodes = after["codec_encode"] - before["codec_encode"]
    assert encodes == len(prompts) + decode_steps
    assert after["codec_decode"] - before["codec_decode"] > encodes


def _spec_prompts():
    rs = np.random.RandomState(1)
    shared = rs.randint(0, 256, 20)
    return [np.concatenate([shared, rs.randint(0, 256, 3 + 4 * i)])
            if i % 2 else rs.randint(0, 256, 9 + 5 * i) for i in range(6)]


def check_spec_engine_on_card_against_plain(dev, sampling):
    from paddle_tpu_torch.serving import ReplicaSet, SamplingParams

    dm = GPTDecodeModel(GPTForCausalLM(gpt_presets("gpt-test"), seed=0,
                                       device=dev))
    pool_kw = dict(n_blocks=64, block_tokens=8,
                   elems_per_token=dm.elems_per_token, codec="int8_block",
                   device=dev)
    sp = (SamplingParams(temperature=0.8, top_p=0.95) if sampling
          else SamplingParams())
    runs = {}
    reg = get_registry()
    for name, ekw in (("plain", {}),
                      ("spec", dict(draft_model=dm.truncated(1), spec_k=4))):
        q = RequestQueue()
        eng = ServingEngine(dm, KVBlockPool(**pool_kw), q, max_batch=4,
                            **ekw)
        reqs = [ServeRequest(prompt_ids=p, max_new_tokens=24,
                             request_id=f"c{i}", sampling=sp)
                for i, p in enumerate(_spec_prompts())]
        ticks0 = (reg.get("serve_decode_step_ms").get()["count"]
                  + reg.get("serve_spec_step_ms").get()["count"])
        before = codec.launch_counts()
        drive(eng, q, reqs)
        after = codec.launch_counts()
        ticks = (reg.get("serve_decode_step_ms").get()["count"]
                 + reg.get("serve_spec_step_ms").get()["count"] - ticks0)
        enc = after["codec_encode"] - before["codec_encode"]
        assert enc == len(reqs) + ticks
        assert enc == eng.pool.codec_calls["encode"]
        assert (after["codec_decode"] - before["codec_decode"]
                == eng.pool.codec_calls["decode"])
        runs[name] = (eng, reqs)
    eng, spec = runs["spec"]
    assert eng.spec_steps > 0
    differ = spec_rule(dm, runs["plain"][1], spec, pool_kw)
    print(f"speculative on the card: {len(differ)} of {len(spec)} requests "
          f"differ from plain, each at a near-tie: {differ}")
    # two replica threads on one card: every count kept
    rset = ReplicaSet(dm, n_replicas=2, n_blocks=64, block_tokens=8,
                      codec="int8_block", max_batch=2,
                      draft_model=dm.truncated(1), spec_k=4)
    ticks0 = (reg.get("serve_decode_step_ms").get()["count"]
              + reg.get("serve_spec_step_ms").get()["count"])
    before = codec.launch_counts()
    with rset:
        ids = []
        for i, p in enumerate(_spec_prompts() * 2):
            r = ServeRequest(prompt_ids=p, max_new_tokens=24,
                             request_id=f"t{i}", sampling=sp)
            assert rset.submit(r)
            ids.append(r.request_id)
        res = rset.wait(ids, timeout=120)
    after = codec.launch_counts()
    ticks = (reg.get("serve_decode_step_ms").get()["count"]
             + reg.get("serve_spec_step_ms").get()["count"] - ticks0)
    assert len(res) == len(ids)
    assert all(r.outcome == "completed" for r in res.values())
    assert all(e.completed > 0 for e in rset.engines)
    assert (after["codec_encode"] - before["codec_encode"]
            == sum(e.pool.codec_calls["encode"] for e in rset.engines)
            == len(ids) + ticks)
    assert (after["codec_decode"] - before["codec_decode"]
            == sum(e.pool.codec_calls["decode"] for e in rset.engines))
    assert all(e.pool.blocks_in_use == 0 for e in rset.engines)


_SFX = {torch.float32: "", torch.bfloat16: "_bf16", torch.float16: "_fp16"}


def check_flash_kernels_match_plain(dev, s, d, causal, dtype=torch.float32,
                                    do_scale=1.0):
    """The three kernels against their plain versions, each launched
    once under its dtype's count; ``do_scale`` scales dO (fp16: a
    ``GradScaler``'s unscaled gradients at 2^-16)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(s * d + causal)
    q, k, v, do = (torch.randn(2, 3, s, d, device=dev, generator=gen)
                   .to(dtype) for _ in range(4))
    do = (do.float() * do_scale).to(dtype)
    before = fa.launch_counts()
    flash_vs_plain(q, k, v, do, causal, do_scale)
    sfx = _SFX[dtype]
    ran = {n + sfx for n in ("flash_fwd", "flash_dq", "flash_dkv")}
    assert fa.launch_counts() == {n: c + (n in ran)
                                  for n, c in before.items()}


@functools.lru_cache(maxsize=None)
def _faulty_flash_library():
    """The flash library built from ``csrc/flash_attention.cu`` with
    ``torch_checks.FLASH_FAULTS`` planted in its bf16 kernels (a copy
    under the build directory; the source stays as it is)."""
    import ctypes

    from paddle_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    mutant = _build.build_dir() / "fault" / "flash_attention_fault.cu"
    mutant.parent.mkdir(parents=True, exist_ok=True)
    mutant.write_text(plant_flash_fault(src))
    return ctypes.CDLL(str(_build.compile_file(
        mutant, mutant.with_suffix(".so"))))


@contextlib.contextmanager
def _planted_fault():
    """The flash wrappers launch the faulty library's kernels inside."""
    faulty = _faulty_flash_library()
    fa._lib.cache_clear()
    try:
        with mock.patch.object(fa, "load_library", lambda name: faulty):
            yield
    finally:
        fa._lib.cache_clear()


def check_bf16_flash_check_sees_a_planted_fault(dev, causal):
    """``flash_vs_plain`` passes the bf16 kernels and fails the same
    kernels with a fault planted (``torch_checks.FLASH_FAULTS``), at b1
    n4 s1024 d64; each faulty kernel, on the sound run's lse and delta,
    is over the limit on every output, and out and dq on every long row
    (queries 512 and on). Prints both readings (largest diff / limit)."""
    _flash_fault_case(dev, causal, torch.bfloat16)


def check_fp16_flash_check_sees_a_planted_fault(dev, causal):
    """The same for the fp16 kernels (the faults sit in the templates
    both dtypes instance) against ``flash_fp16_limit``."""
    _flash_fault_case(dev, causal, torch.float16)


def _flash_fault_case(dev, causal, dtype):
    limit = (flash_bf16_limit if dtype == torch.bfloat16
             else flash_fp16_limit)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1024 + causal)
    q, k, v, do = (torch.randn(1, 4, 1024, 64, device=dev, generator=gen)
                   .to(dtype) for _ in range(4))
    sound, lse, delta = flash_vs_plain(q, k, v, do, causal)
    plain = dict(zip(("dq", "dk", "dv"), fa.flash_bwd_plain(
        q, k, v, do, lse, delta, causal)),
        out=fa.flash_fwd_plain(q, k, v, causal)[0])
    with _planted_fault():
        with pytest.raises(AssertionError):
            flash_vs_plain(q, k, v, do, causal)
        got = dict(zip(("dk", "dv"), fa.flash_dkv(q, k, v, do, lse, delta,
                                                  causal)),
                   out=fa.flash_fwd(q, k, v, causal)[0],
                   dq=fa.flash_dq(q, k, v, do, lse, delta, causal))
    fault = {n: flash_err(n, dtype, got[n], plain[n]) for n in plain}
    assert all(r > 1.0 for _, r in fault.values()), fault
    for name in ("out", "dq"):
        flagged = ((got[name].float() - plain[name].float()).abs()
                   > limit(plain[name])).any(-1)[..., 512:]
        assert bool(flagged.all()), (name, float(flagged.float().mean()))
    print(f"{dtype} flash causal={causal}, largest diff / limit: sound "
          + ", ".join(f"{n} {r:.3f}" for n, (_, r) in sound.items())
          + "; planted fault "
          + ", ".join(f"{n} {r:.1f}" for n, (_, r) in fault.items()))


def check_flash_backward_deterministic(dev, s, d, causal,
                                       dtype=torch.float32):
    """Every dq, dk and dv element has one owner (no atomics): two
    launches on the same inputs give the same bits."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(s + d + causal)
    q, k, v, do = (torch.randn(2, 3, s, d, device=dev, generator=gen)
                   .to(dtype) for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    first = (fa.flash_dq(q, k, v, do, lse, delta, causal),
             *fa.flash_dkv(q, k, v, do, lse, delta, causal))
    second = (fa.flash_dq(q, k, v, do, lse, delta, causal),
              *fa.flash_dkv(q, k, v, do, lse, delta, causal))
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert same_bits(a, b), name


def check_fused_update_bit_identical(dev, kind, wd, n):
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    p, g, slots, lr = fused_inputs(kind, n, gen, 1e-3)
    before = fu.fused_update_buckets.launches
    assert fused_vs_plain(p, g, slots, lr, kind=kind,
                          hyper=FUSED_HYPER[kind], wd=wd) == 0.0
    assert fu.fused_update_buckets.launches == before + 1


def _gpt125m_bucket_sizes():
    shapes = expected_shapes(gpt_presets("gpt-125m")).values()
    return [b.size for b in build_buckets(
        [torch.empty(sh, device="meta") for sh in shapes])]


def check_buckets_bit_identical(dev, kind, sizes, wds, lms,
                                dtypes=(torch.float32,)):
    gen = torch.Generator(device=dev)
    gen.manual_seed(len(sizes) + len(wds))
    entries = bucket_entries(kind, sizes, gen, wds, lms, dtypes)
    lr = torch.full((), 1e-3, device=dev)
    # one launch a step, whatever the number of buckets
    assert buckets_vs_plain(kind, FUSED_HYPER[kind], entries, lr, steps=3,
                            gen=gen) == 3


def check_shard_table_matches_plain(dev, sizes, world):
    """ZeRO's shard table: each bucket's flat buffers padded to ``world *
    chunk``, every rank's ``[r * chunk, (r + 1) * chunk)`` an entry (a
    view), AdamW, three steps against the plain walk on clones; then
    ``FusedFlatUpdater.step_sharded`` at stage 2 in one process (the
    table holds every rank's shard) bit for bit against the same on the
    CPU, one launch a step."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(sum(sizes) + world)
    entries = []
    for n in sizes:
        chunk = -(-n // world)
        flats = [torch.zeros(world * chunk, device=dev) for _ in range(4)]
        for f in flats:
            f[:n] = torch.randn(n, device=dev, generator=gen)
        flats[2].abs_().mul_(1e-2)
        flats[3].abs_().mul_(1e-2)
        entries += [(flats[0][r * chunk:(r + 1) * chunk],
                     flats[1][r * chunk:(r + 1) * chunk],
                     [f[r * chunk:(r + 1) * chunk] for f in flats[2:]],
                     0.01, 1.0) for r in range(world)]
    lr = torch.full((), 1e-3, device=dev)
    assert buckets_vs_plain("adamw", FUSED_HYPER["adamw"], entries, lr,
                            steps=3, gen=gen) == 3
    runs = []
    for device in (dev, torch.device("cpu")):
        rs = np.random.RandomState(len(sizes))
        params = [torch.nn.Parameter(torch.from_numpy(
            rs.randn(n).astype(np.float32)).to(device)) for n in sizes]
        opt = AdamW(learning_rate=1e-3, parameters=params)
        upd = FusedFlatUpdater(opt, params, world=world)
        before = fu.fused_update_buckets.launches
        for k in range(2):
            upd.zero_grad()
            for p in params:
                p.grad.copy_(torch.from_numpy(
                    rs.randn(p.numel()).astype(np.float32)))
            upd.step_sharded(0, world)
        runs.append(([p.detach().cpu() for p in params],
                     fu.fused_update_buckets.launches - before))
    (card, launches), (cpu, _) = runs
    assert launches == 2
    for a, b in zip(card, cpu):
        assert torch.equal(a, b)


def check_codec_on_shard_lengths(dev, codec_name, n, bs, world):
    """The codecs on a rank's shard of a bucket padded to ``world *
    chunk``: a view at the shard's offset, its length not a multiple of
    the block, read in place; payload and decode bit for bit."""
    chunk = -(-n // world)
    x = _x(world * chunk, bs, seed=n + world)
    for r in range(world):
        view = x.to(dev)[r * chunk:(r + 1) * chunk]
        ref = x[r * chunk:(r + 1) * chunk]
        s = plain.block_scales(plain.block_absmax(ref, bs), codec_name)
        q_ref = plain.block_encode(ref, s, bs, codec_name, carrier=True)
        q = codec.block_encode(view, s.to(dev), bs, codec_name,
                               carrier=True)
        assert torch.equal(q.cpu(), q_ref)
        d = codec.block_decode(q, s.to(dev), world, chunk)
        assert torch.equal(d.cpu(), plain.block_decode(q_ref, s, world,
                                                       chunk))


def check_updater_table_rebuilt_after_cat_fallback(dev):
    shapes = [(40, 30), (30,), (7, 5, 3), (200, 8), (3,)]
    rs = np.random.RandomState(4)
    vals = [torch.from_numpy(rs.randn(*sh).astype(np.float32))
            for sh in shapes]
    grads = [[torch.from_numpy(rs.randn(*sh).astype(np.float32)).to(dev)
              for sh in shapes] for _ in range(3)]
    ps = [torch.nn.Parameter(v.to(dev)) for v in vals]
    o = AdamW(learning_rate=1e-2, weight_decay=0.01, parameters=ps)
    u = FusedFlatUpdater(o, ps, buckets=build_buckets(ps, 0.004, 0.002))
    assert len(u.buckets) >= 3
    refs = [torch.nn.Parameter(v.to(dev)) for v in vals]
    ro = AdamW(learning_rate=1e-2, weight_decay=0.01, parameters=refs)
    tables = []
    for step in range(3):
        if step < 2:        # backward into the flat gradient buffers
            u.zero_grad()
            for p, g in zip(ps, grads[step]):
                p.grad.copy_(g)
        else:               # gradients the updater does not own: torch.cat
            for p, g in zip(ps, grads[step]):
                p.grad = g.clone()
        before = fu.fused_update_buckets.launches
        u.step()
        assert fu.fused_update_buckets.launches == before + 1
        tables.append(u._table)
        for r, g in zip(refs, grads[step]):
            r.grad = g.clone()
        ro.step()                        # per parameter, plain PyTorch
    assert tables[1] is tables[0] and tables[2] is not tables[1]
    for p, r in zip(ps, refs):
        assert torch.equal(p.detach().view(torch.int32),
                           r.detach().view(torch.int32))
    for b in u.buckets:
        pi = b.param_indices[0]
        for nm in ("beta1_pow", "beta2_pow"):
            assert torch.equal(u._slots[b.index][nm],
                               ro._slots[id(refs[pi])][nm]), nm


def check_bucket_wrappers_raise(dev):
    p = torch.zeros(64, device=dev)
    hyper = FUSED_HYPER["adam"]
    with pytest.raises(TypeError):
        fu.BucketTable("sgd", {}, [(p.double(), p.double(), [], 0.0, 1.0)])
    with pytest.raises(TypeError, match="g in torch.bfloat16"):
        fu.BucketTable("sgd", {}, [(p.bfloat16(), p, [], 0.0, 1.0)])
    with pytest.raises(TypeError, match="moment1 in torch.float32"):
        fu.BucketTable("adam", hyper, [(p.bfloat16(), p.bfloat16(),
                                        [p.bfloat16(), p.clone()], 0.0,
                                        1.0)])
    with pytest.raises(ValueError, match="aligned"):
        fu.BucketTable("sgd", {}, [(p[1:], p[1:], [], 0.0, 1.0)])
    with pytest.raises(ValueError, match="is on"):
        fu.BucketTable("sgd", {}, [(p, p.cpu(), [], 0.0, 1.0)])
    with pytest.raises(ValueError, match="slots"):
        fu.BucketTable("adam", hyper, [(p, p, [p.clone()], 0.0, 1.0)])
    table = fu.BucketTable("adam", hyper,
                           [(p, p.clone(), [p.clone(), p.clone()], 0.0, 1.0)])
    with pytest.raises(ValueError, match="lr"):
        fu.fused_update_buckets(table, torch.ones(()))


def _gpt125m_bf16_plan(dtype="bfloat16"):
    cfg = gpt_presets("gpt-125m", dtype=dtype)
    dtypes = expected_dtypes(cfg)
    plan = build_buckets([torch.empty(sh, device="meta", dtype=dtypes[n])
                          for n, sh in expected_shapes(cfg).items()])
    return [b.size for b in plan], [b.dtype for b in plan]


def _train_one_step(device, dtype="float32"):
    cfg = gpt_presets("gpt-test", dtype=dtype)
    m = GPTForCausalLM(cfg, seed=0, device=device)
    o = AdamW(learning_rate=1e-3, weight_decay=0.01,
              parameters=m.parameters())
    step = TrainStep(m, GPTPretrainingCriterion(), o)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 256, (2, 37))
    labels = rs.randint(0, 256, (2, 37))
    before = {n: p.detach().cpu().clone() for n, p in m.named_parameters()}
    loss = float(step(inputs=(ids,), labels=(labels,)))
    return loss, {n: (before[n], p.detach().cpu(), p.grad.cpu())
                  for n, p in m.named_parameters()}


def check_train_step_on_card_matches_cpu(dev):
    before = {**fa.launch_counts(), **fu.launch_counts()}
    card_loss, card = _train_one_step(dev)
    after = {**fa.launch_counts(), **fu.launch_counts()}
    cpu_loss, cpu = _train_one_step("cpu")
    assert abs(card_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    adam_step_parity(card, cpu, 1e-3)
    # 2 layers: 2 launches of each flash kernel; gpt-test is one bucket
    assert {k: after[k] - before[k] for k in after} == {
        "flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2, "flash_fwd_bf16": 0,
        "flash_dq_bf16": 0, "flash_dkv_bf16": 0, "flash_fwd_fp16": 0,
        "flash_dq_fp16": 0, "flash_dkv_fp16": 0, "fused_update": 1}


def check_bf16_train_step_on_card_matches_cpu(dev):
    before = {**fa.launch_counts(), **fu.launch_counts()}
    card_loss, card = _train_one_step(dev, "bfloat16")
    after = {**fa.launch_counts(), **fu.launch_counts()}
    cpu_loss, cpu = _train_one_step("cpu", "bfloat16")
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    assert rel <= BF16_LOSS_RTOL, rel
    r = bf16_step_parity(card, cpu, 1e-3)
    # the control: the same step through the planted flash fault
    with _planted_fault():
        fault_loss, _ = _train_one_step(dev, "bfloat16")
    fault_rel = abs(fault_loss - cpu_loss) / abs(cpu_loss)
    print(f"bf16 train step, card vs CPU: loss {rel:.3e} relative (limit "
          f"{BF16_LOSS_RTOL:.0e}; planted flash fault {fault_rel:.3e}), "
          f"gradients within {r['grad_rtol']:.3e} of each tensor's largest")
    assert fault_rel > BF16_LOSS_RTOL, fault_rel
    # the bf16 kernels only; one launch for the fp32 and bf16 buckets
    assert {k: after[k] - before[k] for k in after} == {
        "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_fwd_bf16": 2,
        "flash_dq_bf16": 2, "flash_dkv_bf16": 2, "flash_fwd_fp16": 0,
        "flash_dq_fp16": 0, "flash_dkv_fp16": 0, "fused_update": 1}


class _PlantedError(RuntimeError):
    pass


def check_bf16_failed_backward_restores_flags(dev):
    """A bf16 GPT backward on the card that raises (a hook on the
    word-embedding gradient, a node after the logits' node entered bf16's
    GEMM settings) leaves the caller's three flags as they were, on each
    of 20 runs: the engine frees the failed pass, on its device thread or
    the caller's, before ``backward()`` raises."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn

    def flags():
        return (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
                dnn.allow_tf32)

    def fail(grad):
        raise _PlantedError("planted")

    saved = flags()
    caller = (False, True, True)    # bf16's: (True, False, False)
    model = GPTForCausalLM(gpt_presets("gpt-test", dtype="bfloat16"),
                           seed=0, device=dev)
    model.gpt.embeddings.word_embeddings.register_hook(fail)
    ids = torch.randint(0, 256, (2, 32), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
    try:
        (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
         dnn.allow_tf32) = caller
        for _ in range(20):
            loss = GPTPretrainingCriterion()(model(ids), ids)
            with pytest.raises(_PlantedError):
                loss.backward()
            assert flags() == caller, flags()
    finally:
        (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction,
         dnn.allow_tf32) = saved


def check_new_wrappers_raise(dev):
    q = torch.randn(1, 2, 8, 16, device=dev)
    for bad in (torch.randn(1, 2, 8, 8, device=dev),
                torch.randn(1, 2, 8, 144, device=dev)):
        with pytest.raises(ValueError, match="d % 16"):
            fa.flash_fwd(bad, bad, bad, True)
    with pytest.raises(TypeError):
        fa.flash_fwd(q.double(), q.double(), q.double(), True)
    with pytest.raises(TypeError, match="k in torch.float16"):
        fa.flash_fwd(q.half(), q.bfloat16(), q.half(), False)
    qb = q.bfloat16()
    with pytest.raises(TypeError, match="k in torch.bfloat16"):
        fa.flash_fwd(qb, q, qb, True)
    _, lse = fa.flash_fwd(qb, qb, qb, True)
    with pytest.raises(TypeError, match="lse in torch.float32"):
        fa.flash_dq(qb, qb, qb, qb, lse.bfloat16(), lse, True)
    with pytest.raises(ValueError, match="is on"):
        fa.flash_fwd(q, q.cpu(), q, True)
    lse = torch.zeros(1, 2, 8, 1, device=dev)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_dq(q, q, q, q, lse[..., :4, :], lse, True)
    buf = torch.randn(q.numel() + 1, device=dev)
    odd = buf[1:].view(q.shape)                  # 4 bytes past 16
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_dq(q, q, q, odd, lse, lse, True)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_dkv(q, q, q, odd, lse, lse, True)
    p = torch.zeros(64, device=dev)
    lr = torch.ones((), device=dev)
    with pytest.raises(TypeError):
        fu.fused_update_flat(p.double(), p.double(), {}, lr, kind="sgd",
                             hyper={})
    with pytest.raises(ValueError, match="aligned"):
        fu.fused_update_flat(p[1:], p[1:], {}, lr, kind="sgd", hyper={})
    with pytest.raises(ValueError, match="lr"):
        fu.fused_update_flat(p, p.clone(), {}, lr.cpu(), kind="sgd",
                             hyper={})


def check_quantize_kernel_bit_identical(dev, shape, stochastic, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(sum(shape) + seed)
    w = torch.randn(*shape, device=dev, generator=gen) * 0.05
    if shape[1] > 3:
        w[:, 3] = 0.0                          # scale floor 1e-12, q = 0
    if shape[0] >= 9 and shape[1] >= 2:
        # amax 127 gives scale 1.0: w / scale lands half-way between
        # integers, where rint rounds to even
        w[:9, 1] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                                 126.5, -126.5])
        w[9:, 1] = 0.0
    before = qm.quantize_int8.launches
    assert quantize_vs_plain(w, stochastic, seed) == 0.0
    assert qm.quantize_int8.launches == before + 1


def check_quant_matmul_within_bound(dev, m, k, n):
    gen = torch.Generator(device=dev)
    gen.manual_seed(m * k + n)
    x = torch.randn(m, k, device=dev, generator=gen)
    q, s = qm.quantize_int8_plain(torch.randn(k, n, device=dev,
                                              generator=gen))
    before = qm.quant_matmul.launches
    qmm_vs_plain(x, q, s)
    assert qm.quant_matmul.launches == before + 1


def check_quant_matmul_deterministic(dev, m, k, n):
    """Shapes whose k is split over slices add the slices in a fixed
    order: two launches give the same bits."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(m + k + n)
    x = torch.randn(m, k, device=dev, generator=gen)
    q, s = qm.quantize_int8(torch.randn(k, n, device=dev, generator=gen)
                            * 0.02)
    a, b = qm.quant_matmul(x, q, s), qm.quant_matmul(x, q, s)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_quant_wrappers_raise(dev):
    x = torch.randn(8, 16, device=dev)
    q = torch.zeros(16, 12, dtype=torch.int8, device=dev)
    s = torch.ones(1, 12, device=dev)
    with pytest.raises(TypeError):
        qm.quantize_int8(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        qm.quantize_int8(x.t())
    with pytest.raises(TypeError):
        qm.quant_matmul(x.double(), q, s)
    with pytest.raises(TypeError):
        qm.quant_matmul(x, q.float(), s)
    with pytest.raises(ValueError, match="contiguous"):
        qm.quant_matmul(x.t().contiguous().t(), q, s)
    with pytest.raises(ValueError, match="aligned"):
        buf = torch.zeros(16 * 12 + 1, dtype=torch.int8, device=dev)
        qm.quant_matmul(x, buf[1:].view(16, 12), s)
    with pytest.raises(ValueError, match="is on"):
        qm.quant_matmul(x, q.cpu(), s)
    with pytest.raises(TypeError):
        qm.quant_matmul(x, q, s, out_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float16"):
        qm.quant_matmul(x.half(), q, s, out_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        qm.quant_matmul(x.double(), q, s)


def check_quant_matmul_bf16_within_bound(dev, m, k, n, offset=0,
                                         dtype=torch.bfloat16,
                                         out_dtype=None):
    """The bf16 form (or ``dtype``'s: fp16), x's dtype out (or
    ``out_dtype``: fp32 from the same accumulator) within
    ``torch_checks.qmm16_vs_plain``'s limit of its plain version, one
    launch counted under the form, its shape and its route ("cluster" for
    m <= 64, "wgmma" for m > 64 where TMA takes both operands, else
    "mma_sync"); ``x`` starts ``offset`` elements past a 16-byte
    boundary. Returns the operands."""
    sfx = {torch.bfloat16: "_bf16", torch.float16: "_fp16"}[dtype]
    gen = torch.Generator(device=dev)
    gen.manual_seed(m * k + n + 1)
    buf = torch.randn(m * k + offset, device=dev, generator=gen).to(dtype)
    x = buf[offset:].view(m, k)
    q, s = qm.quantize_int8_plain(torch.randn(k, n, device=dev,
                                              generator=gen))
    route = ("cluster" if m <= 64 else
             "wgmma" if n % 16 == 0 and k % 8 == 0 and offset % 8 == 0
             else "mma_sync")
    assert qm.route16(x, q) == route
    before, shapes = qm.launch_counts(), qm.shape_counts()
    routes = qm.route_counts(dtype)
    qmm16_vs_plain(x, q, s, out_dtype)
    after = qm.launch_counts()
    assert {k_: after[k_] - before[k_] for k_ in after} == {
        "quantize_int8": 0, "quant_matmul": 0, "quant_matmul_bf16": 0,
        "quant_matmul_fp16": 0, "quant_matmul" + sfx: 1}
    assert (qm.shape_counts()["quant_matmul" + sfx][(m, k, n)]
            == shapes["quant_matmul" + sfx][(m, k, n)] + 1)
    assert qm.route_counts(dtype) - routes == {route: 1}
    return x, q, s


def check_quant_matmul_bf16_cluster(dev, m, k, n, offset=0,
                                    dtype=torch.bfloat16):
    """The cluster route (m <= 64): the checks above, then a second run
    bit-identical to the first (the rank-ordered reduction)."""
    x, q, s = check_quant_matmul_bf16_within_bound(dev, m, k, n, offset,
                                                   dtype)
    a, b = qm.quant_matmul(x, q, s), qm.quant_matmul(x, q, s)
    assert torch.equal(a, b), f"({m}, {k}, {n}): two runs differ"


def check_bf16_route_switches_at_m_64(dev):
    """``route16`` on card tensors: the cluster route up to m = 64,
    then wgmma where TMA takes both operands, else mma.sync."""
    q = torch.zeros(768, 768, dtype=torch.int8, device=dev)
    head = torch.zeros(768, 2, dtype=torch.int8, device=dev)
    for m, w, want in ((64, q, "cluster"), (65, q, "wgmma"),
                       (64, head, "cluster"), (65, head, "mma_sync"),
                       (1, q, "cluster")):
        x = torch.zeros(m, 768, dtype=torch.bfloat16, device=dev)
        assert qm.route16(x, w) == want, (m, w.shape, want)


@functools.lru_cache(maxsize=None)
def _faulty_qmm_library():
    """The quant_matmul library built with ``torch_checks.QMM_BF16_FAULTS``
    planted in its bf16 kernels (a copy under the build directory)."""
    import ctypes

    from paddle_tpu_torch.ops import _build

    src = (_build.CSRC / "quant_matmul.cu").read_text()
    mutant = _build.build_dir() / "fault" / "quant_matmul_fault.cu"
    mutant.parent.mkdir(parents=True, exist_ok=True)
    mutant.write_text(plant_qmm_fault(src))
    return ctypes.CDLL(str(_build.compile_file(
        mutant, mutant.with_suffix(".so"))))


def check_qmm_bf16_check_sees_a_planted_fault(dev, m, k, n):
    """``qmm_bf16_vs_plain`` passes the bf16 kernels and fails the same
    kernels with their faults planted (``plant_qmm_fault``: at m > 64 the
    wgmma route's k loop drops 16 of the k products, at m <= 64 the
    cluster route's reduction leaves rank 0's partial sums out), at phase
    27's shapes of each route. Prints both readings (largest diff /
    limit)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(m + k + n)
    x = torch.randn(m, k, device=dev, generator=gen).bfloat16()
    q, s = qm.quantize_int8(torch.randn(k, n, device=dev, generator=gen)
                            * 0.02)
    _, sound = qmm_bf16_vs_plain(x, q, s)
    faulty = _faulty_qmm_library()
    qm._lib.cache_clear()
    try:
        with mock.patch.object(qm, "load_library", lambda name: faulty):
            with pytest.raises(AssertionError):
                qmm_bf16_vs_plain(x, q, s)
            bad = qm.quant_matmul(x, q, s)
    finally:
        qm._lib.cache_clear()
    ref = qm.quant_matmul_plain(x, q, s)
    fault = float(((bad.double() - ref.double()).abs()
                   / qmm_bf16_limit(x, q, s, ref)).max())
    print(f"quant_matmul_bf16 ({m}, {k}, {n}), largest diff / limit: sound "
          f"{sound:.3f}; planted fault {fault:.1f}")
    assert fault > 1.0


def _bert_amp_step(device, seed=0):
    """One bert-test step of ``measure_bert``'s form under O2 (b2 s64):
    the loss and, per parameter, (before, after, gradient) on the CPU;
    the CPU takes the flash route's plain versions, as the card runs
    the flash kernels."""
    from paddle_tpu_torch import tensor as T
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.nn import functional as F

    cfg = bert_presets("bert-test")
    m = BertForPretraining(cfg, seed=seed, device=device)
    step = TrainStep(m, lambda a, n, lbl: T.add(a, F.cross_entropy(n, lbl)),
                     AdamW(learning_rate=1e-3, parameters=m.parameters()))
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size, (2, 64))
    mlm = np.where(rs.rand(2, 64) < 0.15, ids, -1)
    nsp = rs.randint(0, 2, (2,))
    before = {n: p.detach().cpu().clone() for n, p in m.named_parameters()}
    with auto_cast(level="O2"), F.flash_route(device == "cpu"):
        loss = float(step(inputs=(ids, None, None, None, mlm),
                          labels=(nsp,)))
    return loss, {n: (before[n], p.detach().cpu(), p.grad.cpu())
                  for n, p in m.named_parameters()}


def check_bert_amp_step_on_card_matches_cpu(dev):
    """BERT training under O2 on the card against the CPU: the loss
    within ``BF16_LOSS_RTOL``, ``bf16_step_parity`` (the query and key
    projections, whose gradient comes only through the kernels' bf16
    dS, within 5e-2 of each tensor's largest, as ``chip_smoke.py`` phase
    26 holds them; the key biases left out: their gradient is zero in
    exact arithmetic, rounding noise on both devices), the bf16 flash
    kernels in full mode once a layer each and one update launch."""
    before = {**fa.launch_counts(), **fu.launch_counts()}
    card_loss, card = _bert_amp_step(dev)
    after = {**fa.launch_counts(), **fu.launch_counts()}
    cpu_loss, cpu = _bert_amp_step("cpu")
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    assert rel <= BF16_LOSS_RTOL, (card_loss, cpu_loss)
    qk = [n for n in cpu if ".q_proj." in n or ".k_proj.weight" in n]
    rest = [n for n in cpu if n not in qk and not n.endswith("k_proj.bias")]
    r = bf16_step_parity({n: card[n] for n in rest},
                         {n: cpu[n] for n in rest}, 1e-3)
    r_qk = bf16_step_parity({n: card[n] for n in qk},
                            {n: cpu[n] for n in qk}, 1e-3, grad_rtol=5e-2)
    print(f"bert O2 train step, card vs CPU: loss {rel:.3e} relative, "
          f"gradients within {r['grad_rtol']:.3e} of each tensor's largest, "
          f"the query and key projections' {r_qk['grad_rtol']:.3e}")
    assert {k: after[k] - before[k] for k in after} == {
        "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_fwd_bf16": 2,
        "flash_dq_bf16": 2, "flash_dkv_bf16": 2, "flash_fwd_fp16": 0,
        "flash_dq_fp16": 0, "flash_dkv_fp16": 0, "fused_update": 1}


def check_bert_int8_amp_on_card(dev, b=2, s=32):
    """An int8 bert-test forward under O2 on the card at b x s tokens: 9
    launches of the bf16 form, all on the cluster route (b s <= 64), and
    6 of the fp32 one (the reference's pattern), 2 of
    ``flash_fwd_bf16``; MLM logits bf16 within 1e-2 mean relative error
    of the CPU's (flash route), NSP logits fp32."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.nn.functional import flash_route

    rs = np.random.RandomState(1)
    ids = rs.randint(0, 256, (b, s))
    card, cpu = _bert(dev), _bert("cpu")
    convert_to_int8(card)
    convert_to_int8(cpu)
    routes = qm.route_counts()
    before = {**qm.launch_counts(), **fa.launch_counts()}
    with torch.inference_mode(), auto_cast(level="O2"):
        logits, nsp = card(ids)
        torch.cuda.synchronize()
        after = {**qm.launch_counts(), **fa.launch_counts()}
        card_routes = qm.route_counts() - routes
        with flash_route():
            want, want_nsp = cpu(ids)
    assert {k: after[k] - before[k] for k in
            ("quant_matmul", "quant_matmul_bf16", "flash_fwd",
             "flash_fwd_bf16")} == {"quant_matmul": 6,
                                    "quant_matmul_bf16": 9, "flash_fwd": 0,
                                    "flash_fwd_bf16": 2}
    assert card_routes == {"cluster": 9}, card_routes
    assert logits.dtype == torch.bfloat16 and nsp.dtype == torch.float32
    rel = float((logits.cpu().float() - want.float()).abs().mean()
                / want.float().abs().mean())
    assert rel <= 1e-2, rel
    assert float((nsp.cpu() - want_nsp).abs().max()) <= 5e-2


def check_bert_int8_amp_fp16_on_card(dev, b=2, s=32):
    """An int8 bert-test forward decorated and run under O2 in float16 on
    the card at b x s tokens: 9 launches of the fp16 form (on the cluster
    route at b s <= 64, else wgmma, the pooler and the NSP head on the
    cluster route), 6 of the fp32 one, 2 of ``flash_fwd_fp16``; MLM and
    NSP logits fp16 within 1e-2 mean relative error of the CPU's (flash
    route)."""
    from paddle_tpu_torch.amp import auto_cast, decorate
    from paddle_tpu_torch.nn.functional import flash_route

    rs = np.random.RandomState(2)
    ids = rs.randint(0, 256, (b, s))
    card, cpu = (decorate(_bert(d), level="O2", dtype="float16")
                 for d in (dev, "cpu"))
    convert_to_int8(card)
    convert_to_int8(cpu)
    routes = qm.route_counts(torch.float16)
    before = {**qm.launch_counts(), **fa.launch_counts()}
    with torch.inference_mode(), auto_cast(level="O2", dtype="float16"):
        logits, nsp = card(ids)
        torch.cuda.synchronize()
        after = {**qm.launch_counts(), **fa.launch_counts()}
        card_routes = qm.route_counts(torch.float16) - routes
        with flash_route():
            want, want_nsp = cpu(ids)
    assert {k: after[k] - before[k] for k in
            ("quant_matmul", "quant_matmul_bf16", "quant_matmul_fp16",
             "flash_fwd_bf16", "flash_fwd_fp16")} == {
        "quant_matmul": 6, "quant_matmul_bf16": 0, "quant_matmul_fp16": 9,
        "flash_fwd_bf16": 0, "flash_fwd_fp16": 2}
    big = "cluster" if b * s <= 64 else "wgmma"
    assert card_routes == Counter({big: 7}) + Counter({"cluster": 2}), \
        card_routes
    assert logits.dtype == nsp.dtype == torch.float16
    for got, ref in ((logits, want), (nsp, want_nsp)):
        rel = float((got.cpu().float() - ref.float()).abs().mean()
                    / ref.float().abs().mean())
        assert rel <= 1e-2, rel


def _bert(device):
    return BertForPretraining(bert_presets("bert-test"), seed=0,
                              device=device).eval()


def check_bert_int8_on_card_matches_cpu(dev):
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 256, (2, 32))
    card, cpu = _bert(dev), _bert("cpu")
    before = {**qm.launch_counts(), **fa.launch_counts()}
    convert_to_int8(card)
    mid = qm.launch_counts()
    with torch.inference_mode():
        logits, nsp = card(ids)
    torch.cuda.synchronize()
    after = {**qm.launch_counts(), **fa.launch_counts()}
    convert_to_int8(cpu)
    with torch.inference_mode():
        want, want_nsp = cpu(ids)
    # 2 layers: 6 Linear each, then pooler, transform and nsp
    assert mid["quantize_int8"] - before["quantize_int8"] == 15
    assert {k: after[k] - mid.get(k, before[k]) for k in
            ("quant_matmul", "flash_fwd")} == {"quant_matmul": 15,
                                               "flash_fwd": 2}
    cards = dict(card.named_modules())
    for name, mod in cpu.named_modules():
        if isinstance(mod, Int8Linear):
            assert torch.equal(cards[name].qweight.cpu(), mod.qweight), name
            assert torch.equal(cards[name].scales.cpu(), mod.scales), name
    assert float((logits.cpu() - want).abs().max()) <= 1e-4
    assert float((nsp.cpu() - want_nsp).abs().max()) <= 1e-4


def check_fused_ce_kernels_match_plain(dev, n, c, start, vocab, bias,
                                       ignored):
    gen = torch.Generator(device=dev).manual_seed(c + start)
    logit, b, labels, state, lse, g = ce_inputs(n, c, start, vocab, gen, dev,
                                                bias, ignored)
    before = dict(fce.launch_counts())
    ce_fwd_vs_plain(logit, b, labels, start, vocab, state)
    ce_bwd_vs_plain(logit, b, lse, labels, g, start)
    assert {k: v - before[k] for k, v in fce.launch_counts().items()} == {
        "ce_chunk_fwd": 1, "ce_chunk_bwd": 1}


def check_ce_bwd_on_its_own_alignment(dev, c, bias, offset):
    """``ce_chunk_bwd`` at a width that is not a multiple of 4 (rows
    start at every alignment) on a logit ``offset`` floats past a
    16-byte boundary: within ``ce_bwd_vs_plain``'s limit, with and
    without a bias (BERT's 5946 columns among the widths)."""
    gen = torch.Generator(device=dev).manual_seed(c + offset)
    start = 24576
    logit, b, labels, _, lse, g = ce_inputs(64, c, start, start + c, gen,
                                            dev, bias, 3)
    before = fce.launch_counts()["ce_chunk_bwd"]
    ce_bwd_vs_plain(logit, b, lse, labels, g, start, offset)
    assert fce.launch_counts()["ce_chunk_bwd"] == before + 1


def check_fused_ce_wrappers_raise(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    logit, b, labels, (m, s, p), lse, g = ce_inputs(8, 64, 0, 64, gen, dev)
    with pytest.raises(TypeError):
        fce.ce_chunk_fwd(logit.bfloat16(), b, labels, 0, 64, m, s, p)
    with pytest.raises(TypeError):
        fce.ce_chunk_fwd(logit, b, labels.long(), 0, 64, m, s, p)
    with pytest.raises(ValueError, match="contiguous"):
        fce.ce_chunk_bwd(logit.t().contiguous().t(), b, lse, labels, g, 0)
    with pytest.raises(ValueError, match="is on"):
        fce.ce_chunk_bwd(logit, b, lse.cpu(), labels, g, 0)
    with pytest.raises(ValueError, match="vocabulary"):
        fce.ce_chunk_fwd(logit, b, labels, 10, 64, m, s, p)
    with pytest.raises(ValueError, match="shape"):
        fce.ce_chunk_fwd(logit, b[:10], labels, 0, 64, m, s, p)


def _fused_loss(device, transposed, chunk):
    rs = np.random.RandomState(1)
    n, h, v = 300, 64, 1000
    x = torch.from_numpy(rs.randn(n, h).astype(np.float32)).to(device)
    w = torch.from_numpy((rs.randn(*((v, h) if transposed else (h, v)))
                          * 0.2).astype(np.float32)).to(device)
    b = torch.from_numpy((rs.randn(v) * 0.2).astype(np.float32)).to(device)
    lbl = rs.randint(0, v, (n,))
    lbl[:9], lbl[9] = -100, v - 1
    x.requires_grad_()
    w.requires_grad_()
    b.requires_grad_()
    loss = fused_linear_cross_entropy(x, w, torch.from_numpy(lbl).to(device),
                                      bias=b, vocab_chunk=chunk,
                                      transposed_weight=transposed)
    loss.backward()
    return [t.detach().cpu() for t in (loss, x.grad, w.grad, b.grad)]


def check_fused_loss_on_card_matches_cpu(dev, transposed):
    """``fused_linear_cross_entropy`` (chunk 256 of V 1000: a ragged last
    chunk of 232) on the card against the CPU: the fp32 GEMMs with TF32
    off on both, so the loss within 1e-5 relative and every gradient
    within 1e-5 of its tensor's largest; 4 launches of each kernel."""
    before = dict(fce.launch_counts())
    card = _fused_loss(dev, transposed, 256)
    assert {k: v - before[k] for k, v in fce.launch_counts().items()} == {
        "ce_chunk_fwd": 4, "ce_chunk_bwd": 4}
    cpu = _fused_loss("cpu", transposed, 256)
    assert abs(float(card[0] - cpu[0])) <= 1e-5 * abs(float(cpu[0]))
    for name, a, c in zip(("dx", "dW", "db"), card[1:], cpu[1:]):
        err = float((a - c).abs().max())
        assert err <= 1e-5 * float(c.abs().max()), (name, err)


def _options_step(device, **over):
    cfg = gpt_presets("gpt-test", dtype="bfloat16", **over)
    m = GPTForCausalLM(cfg, seed=0, device=device)
    o = AdamW(learning_rate=1e-3, weight_decay=0.01,
              parameters=m.parameters())
    step = TrainStep(m, lambda loss: loss, o)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 256, (2, 37))
    labels = rs.randint(0, 256, (2, 37))
    before = {n: p.detach().cpu().clone() for n, p in m.named_parameters()}
    loss = float(step(inputs=(ids, None, labels), labels=()))
    return loss, {n: (before[n], p.detach().cpu(), p.grad.cpu())
                  for n, p in m.named_parameters()}


def check_fused_recompute_step_on_card_matches_cpu(dev):
    """One bf16 gpt-test step in ``bench.py``'s fused form with
    ``recompute`` (chunk 64 of V 256) on the card against the CPU: the
    loss within ``BF16_LOSS_RTOL``, then ``bf16_step_parity``; 4 launches
    of each loss kernel, the flash forward twice a layer; the card's
    gradients with recompute bit-identical to its own without."""
    counts = {**fa.launch_counts(), **fu.launch_counts(),
              **fce.launch_counts()}
    card_loss, card = _options_step(dev, fused_loss_chunk=64, recompute=True)
    after = {**fa.launch_counts(), **fu.launch_counts(),
             **fce.launch_counts()}
    assert {k: after[k] - counts[k] for k in after} == {
        "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_fwd_bf16": 4,
        "flash_dq_bf16": 2, "flash_dkv_bf16": 2, "flash_fwd_fp16": 0,
        "flash_dq_fp16": 0, "flash_dkv_fp16": 0, "fused_update": 1,
        "ce_chunk_fwd": 4, "ce_chunk_bwd": 4}
    cpu_loss, cpu = _options_step("cpu", fused_loss_chunk=64, recompute=True)
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    assert rel <= BF16_LOSS_RTOL, rel
    bf16_step_parity(card, cpu, 1e-3)
    _, plain = _options_step(dev, fused_loss_chunk=64)
    for n, (_, _, g) in card.items():
        assert torch.equal(g, plain[n][2]), f"{n}: recompute changed bits"


def check_eager_api_on_card(dev):
    """The eager API places new tensors on the card by default, its ops
    keep them there (no fallback to the CPU), ``.numpy()`` copies from
    the card, and ``bench.py``'s eager loops on the card give the CPU's
    chain bit for bit and its ``w.grad`` within ``EAGER_GRAD_RTOL``."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as port_device
    from torch_checks import EAGER_GRAD, EAGER_GRAD_RTOL, bench_eager_loops

    prev = list(port_device._CURRENT)
    port_device._CURRENT[:] = []
    try:
        x = paddle.ones([8, 8])
        assert x.place == paddle.CUDAPlace(0) and x._value.is_cuda
        y = paddle.exp(x @ x * 0.5 + 1).sum(axis=1)
        assert y._value.is_cuda and y.numpy().shape == (8,)
        assert isinstance(y.numpy(), np.ndarray)
        idx = paddle.argmax(y)
        assert idx._value.is_cuda and idx.dtype == paddle.int32
        outs = {}
        for place in ("gpu", "cpu"):
            paddle.set_device(place)
            chain, _ = bench_eager_loops(paddle, None, None, 20)
            c = chain(paddle.ones([256, 256]), 20)
            xs, w = paddle.ones(EAGER_GRAD[0]), paddle.ones(EAGER_GRAD[0])
            w.stop_gradient = False
            _, train_iter = bench_eager_loops(paddle, xs, w, EAGER_GRAD[1])
            g = train_iter()
            assert c._value.device.type == ("cuda" if place == "gpu"
                                            else "cpu")
            assert g._value.device == c._value.device
            outs[place] = (c.numpy(), g.numpy())
        assert np.array_equal(outs["gpu"][0], outs["cpu"][0])
        np.testing.assert_allclose(outs["gpu"][1], outs["cpu"][1],
                                   rtol=EAGER_GRAD_RTOL)
    finally:
        port_device._CURRENT[:] = prev


def _eager_params(dev, sizes_dtypes, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    ps = []
    for n, dt in sizes_dtypes:
        p = torch.nn.Parameter(torch.randn(n, device=dev, generator=gen)
                               .to(dt))
        p.grad = torch.randn(n, device=dev, generator=gen).to(dt)
        ps.append(p)
    return ps


def check_eager_step_on_card(dev, kind):
    """``Optimizer.step()`` over a table of mixed fp32 and bf16 parameters
    (ragged sizes, a per-parameter lr_mult and regularizer): one
    ``fused_update_buckets`` launch a step, no ``update_math``, and the
    parameters, moments and beta powers bit-identical to the plain
    per-parameter step on clones, over 3 steps with fresh gradients; the
    table kept while no pointer moves."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import regularizer

    layout = [(1, torch.float32), (4097, torch.bfloat16),
              (100003, torch.float32), (5, torch.bfloat16),
              (64, torch.float32), (3, torch.bfloat16)]
    mine = _eager_params(dev, layout, 0)
    ref = [torch.nn.Parameter(p.detach().clone()) for p in mine]
    for ps in (mine, ref):
        ps[2].optimize_attr = {"learning_rate": 0.5}
        ps[4].regularizer = regularizer.L2Decay(0.02)
    make = {"sgd": lambda ps: popt.SGD(learning_rate=0.1, parameters=ps,
                                       weight_decay=0.01),
            "momentum": lambda ps: popt.Momentum(
                learning_rate=0.1, momentum=0.9, parameters=ps,
                weight_decay=0.01, use_nesterov=True),
            "adam": lambda ps: popt.Adam(learning_rate=1e-3, parameters=ps,
                                         weight_decay=0.01),
            "adamw": lambda ps: popt.AdamW(learning_rate=1e-3,
                                           parameters=ps)}[kind]
    opt, plain_opt = make(mine), make(ref)
    calls = []
    real = popt.update_math

    def spy(p, *a, **k):
        calls.append(p.device.type)
        return real(p, *a, **k)

    gen = torch.Generator(device=dev).manual_seed(1)
    tables = set()
    with mock.patch.object(popt, "update_math", spy):
        for step in range(3):
            if step:
                for p, q in zip(mine, ref):
                    g = torch.randn(p.numel(), device=dev, generator=gen)
                    p.grad.copy_(g.to(p.dtype))
                    q.grad.copy_(p.grad)
            for q, p in zip(ref, mine):
                q.grad = p.grad.clone()
            before = fu.fused_update_buckets.launches
            opt.step()
            assert fu.fused_update_buckets.launches - before == 1
            tables.add(id(opt._table))
            assert not calls, f"update_math ran on the card: {calls}"
            with torch.no_grad():
                plain_opt._step_plain(list(ref), [q.grad for q in ref])
            calls.clear()
            for i, (p, q) in enumerate(zip(mine, ref)):
                assert same_bits(p.detach(), q.detach()), (kind, step, i)
                a, b = opt._slots[id(p)], plain_opt._slots[id(q)]
                for nm in b:
                    assert same_bits(a[nm].float(), b[nm].float()), (
                        kind, step, i, nm)
    assert len(tables) == 1, f"{len(tables)} tables for fixed pointers"


def check_eager_step_refuses_on_card(dev):
    from paddle_tpu_torch import optimizer as popt

    (p,) = _eager_params(dev, [(8, torch.float64)], 2)
    with pytest.raises(NotImplementedError, match="no form of the update"):
        popt.Adam(parameters=[p]).step()

    class Plain(popt.Optimizer):
        def _update(self, p, g, s, lr, lm, wd):
            return p - lr * g, s

    (q,) = _eager_params(dev, [(8, torch.float32)], 3)
    with pytest.raises(NotImplementedError, match="training options"):
        Plain(parameters=[q]).step()


def check_lenet_on_card_matches_cpu(dev):
    """LeNet at batch 8 on eager Tensors, one Adam step, card against CPU
    from the same weights: the loss and every gradient within 1e-5
    relative (by norm), then the stepped parameters within 1e-5."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as port_device

    prev = list(port_device._CURRENT)
    rs = np.random.RandomState(0)
    x = rs.rand(8, 1, 28, 28).astype(np.float32)
    y = rs.randint(0, 10, (8,))
    out = {}
    try:
        paddle.seed(0)
        for place in ("gpu", "cpu"):
            paddle.set_device(place)
            model = paddle.vision.models.LeNet()
            if place == "cpu":
                model.set_state_dict(start)
            else:
                start = {n: t.numpy() for n, t in model.state_dict().items()}
            opt = paddle.optimizer.Adam(parameters=model.parameters())
            loss = paddle.nn.functional.cross_entropy(
                model(paddle.to_tensor(x)),
                paddle.to_tensor(y, dtype="int64"))
            loss.backward()
            grads = [p.grad.numpy() for p in model.parameters()]
            opt.step()
            opt.clear_grad()
            out[place] = ({n: t.numpy() for n, t in
                           model.state_dict().items()}, float(loss), grads)
    finally:
        port_device._CURRENT[:] = prev

    def rel(a, b):
        return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                     / max(np.linalg.norm(b), 1e-30))

    (sg, lg, gg), (sc, lc, gc) = out["gpu"], out["cpu"]
    assert rel(lg, lc) <= 1e-5, (lg, lc)
    assert max(rel(a, b) for a, b in zip(gg, gc)) <= 1e-5
    assert max(rel(sg[n], sc[n]) for n in sc) <= 1e-5


def check_nn_on_card_matches_cpu(dev, k):
    """One case of ``tests/torch_nn_checks.py`` ``NN_CASES`` on the card
    against the CPU."""
    nn_case_vs_cpu(dev, NN_CASES[k])


def check_dropout_on_card(dev):
    """The dropout family's properties on the card's generator."""
    dropout_properties(dev)


def check_flash_attention_entry_on_card(dev, dtype):
    """``F.flash_attention`` on card tensors reaches the flash kernels
    (one forward, one dq and one dkv launch), held against their plain
    versions; with dropout > 0 it launches none; ``flash_attn_unpadded``
    at equal lengths launches the forward."""
    import paddle_tpu_torch as paddle

    F = paddle.nn.functional
    sfx = _SFX[dtype]
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(2, 256, 4, 64, device=dev, generator=g)
                   .to(dtype) for _ in range(4))
    qt, kt, vt = (x.detach().requires_grad_() for x in (q, k, v))
    fa.reset_launch_counts()
    out, sm = F.flash_attention(qt, kt, vt, causal=True)
    dq, dk, dv = torch.autograd.grad(out, (qt, kt, vt), do)
    counts = fa.launch_counts()
    assert sm is None
    assert (counts[f"flash_fwd{sfx}"], counts[f"flash_dq{sfx}"],
            counts[f"flash_dkv{sfx}"]) == (1, 1, 1), counts
    b = [x.transpose(1, 2).contiguous() for x in (q, k, v, do)]
    p_out, _ = fa.flash_fwd_plain(*b[:3], True)
    k_out, lse = fa.flash_fwd(*b[:3], True)      # the backward's inputs
    delta = (b[3].float() * k_out.float()).sum(-1, keepdim=True)
    plain = dict(zip(("dq", "dk", "dv"), fa.flash_bwd_plain(
        *b, lse, delta, True)))
    errs = {"out": flash_err("out", dtype, out.detach().transpose(1, 2),
                             p_out)}
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        errs[name] = flash_err(name, dtype, got.transpose(1, 2), plain[name])
    assert all(r <= 1.0 for _, r in errs.values()), errs
    fa.reset_launch_counts()
    F.flash_attention(qt, kt, vt, dropout=0.1, causal=True)[0].sum(
        ).backward()
    assert not any(fa.launch_counts().values()), fa.launch_counts()
    cu = torch.tensor([0, 256, 512], dtype=torch.int32)
    packed = [x.reshape(512, 4, 64) for x in (q, k, v)]
    got, _ = F.flash_attn_unpadded(*packed, cu, cu, 256, 256, 0.5,
                                   causal=True)
    assert fa.launch_counts()[f"flash_fwd{sfx}"] == 1
    assert torch.equal(got, out.detach().reshape(512, 4, 64))


@pytest.mark.requires_cuda
def test_cuda_path_matches_plain(dev):
    run_checks(
        [(check_kernels_match_plain_bit_for_bit, (dev, c, n, bs, w))
         for c in CODECS for n, bs in CASES for w in (1, 3)]
        + [(check_ragged_read_in_place, (dev, c, carrier, n, bs, off))
           for c in CODECS for carrier in (False, True)
           for n, bs, off in ((1_000_003, 1024, 0), (1_000_003, 1024, 1),
                              (4_725_505, 1024, 3), (5001, 1024, 2),
                              (777, 128, 0), (5, 1024, 1), (1, 1024, 0),
                              # bs not a multiple of the quad stride
                              (1001, 100, 0),
                              # more rows than one grid pass covers
                              (2_400_003, 4, 0), (9_600_013, 16, 0))]
        + [(check_wrappers_raise_on_what_the_kernel_does_not_take, (dev,))]
        + [(check_pool_on_card_matches_pool_on_cpu, (dev, c)) for c in CODECS]
        + [(check_engine_on_card_token_identical_to_cpu, (dev,))]
        + [(check_spec_engine_on_card_against_plain, (dev, sampled))
           for sampled in (False, True)]
        + [(check_flash_kernels_match_plain, (dev, s, d, c))
           for s, d in ((1, 16), (37, 16), (64, 64), (130, 64), (100, 128),
                        (256, 128), (77, 96),
                        *((s, d) for s in (1, 63, 1000)
                          for d in (16, 64, 128)))
           for c in (True, False)]
        + [(check_flash_kernels_match_plain, (dev, s, d, c, torch.bfloat16))
           for s, d in ((1, 16), (37, 16), (64, 64), (130, 64), (77, 96),
                        # TMA boxes of 64 columns: part of the first (d =
                        # 48) or the second (d = 112) past the end
                        (100, 48), (50, 32), (77, 112), (1000, 112),
                        (200, 80),
                        *((s, d) for s in (1, 63, 1000, 1024)
                          for d in (16, 64, 128)))
           for c in (True, False)]
        + [(check_bf16_flash_check_sees_a_planted_fault, (dev, c))
           for c in (True, False)]
        # the fp16 forms: the bf16 shapes, and dO at 2^-16
        + [(check_flash_kernels_match_plain, (dev, s, d, c, torch.float16))
           for s, d in ((1, 16), (37, 16), (64, 64), (130, 64), (77, 96),
                        (100, 48), (50, 32), (77, 112), (1000, 112),
                        (200, 80),
                        *((s, d) for s in (1, 63, 1000, 1024)
                          for d in (16, 64, 128)))
           for c in (True, False)]
        + [(check_flash_kernels_match_plain,
            (dev, s, d, c, torch.float16, 2.0 ** -16))
           for s, d in ((1024, 64), (1000, 128), (512, 64))
           for c in (True, False)]
        + [(check_fp16_flash_check_sees_a_planted_fault, (dev, c))
           for c in (True, False)]
        + [(check_flash_backward_deterministic, (dev, s, d, c, dt))
           for s, d in ((1000, 64), (1024, 128)) for c in (True, False)
           for dt in (torch.float32, torch.bfloat16, torch.float16)]
        + [(check_fused_update_bit_identical, (dev, k, wd, n))
           for k in ("sgd", "momentum", "adam", "adamw")
           for wd in (0.0, 0.01) for n in (1, 4097, 100003)]
        + [(check_train_step_on_card_matches_cpu, (dev,)),
           (check_bf16_train_step_on_card_matches_cpu, (dev,)),
           (check_bf16_failed_backward_restores_flags, (dev,)),
           (check_new_wrappers_raise, (dev,))]
        + [(check_buckets_bit_identical, (dev, k, sizes, wds, lms))
           for k in ("sgd", "momentum", "adam", "adamw")
           for sizes, wds, lms in (
               (_gpt125m_bucket_sizes(), (0.0,), (1.0,)),
               (_gpt125m_bucket_sizes(), (0.01,), (1.0,)),
               ((1, 4097, 100003, 5, 64, 3), (0.01, 0.0), (1.0, 0.5)))]
        + [(check_buckets_bit_identical, (dev, k, sizes, wds, lms, dts))
           for k in ("sgd", "momentum", "adam", "adamw")
           for sizes, wds, lms, dts in (
               (_gpt125m_bf16_plan()[0], (0.01,), (1.0,),
                _gpt125m_bf16_plan()[1]),
               ((1, 4097, 100003, 5, 64, 3, 9, 17), (0.01, 0.0),
                (1.0, 0.5), (torch.bfloat16, torch.float32,
                             torch.bfloat16)),
               # fp16 buckets: GPT-125M's fp16 plan, and all three dtypes
               # in one table
               (_gpt125m_bf16_plan("float16")[0], (0.01,), (1.0,),
                _gpt125m_bf16_plan("float16")[1]),
               ((1, 4097, 100003, 5, 64, 3, 9, 17, 8), (0.01, 0.0),
                (1.0, 0.5), (torch.float16, torch.float32,
                             torch.bfloat16)))]
        + [(check_updater_table_rebuilt_after_cat_fallback, (dev,)),
           (check_bucket_wrappers_raise, (dev,))]
        # ZeRO: the shard table (GPT-125M's plan halved, and ragged
        # buckets whose shards start 16-byte aligned), and the codecs on
        # shard lengths off the block
        + [(check_shard_table_matches_plain, (dev, sizes, world))
           for sizes, world in ((_gpt125m_bucket_sizes(), 2),
                                ((8, 4104, 100008, 24), 2),
                                ((16, 4096, 96), 4))]
        + [(check_codec_on_shard_lengths, (dev, c, n, bs, w))
           for c in CODECS for n, bs, w in ((10_002, 1024, 2),
                                            (38_633_472, 1024, 2),
                                            (777, 128, 3))]
        + [(check_quantize_kernel_bit_identical, (dev, shape, st, seed))
           for shape in ((1, 1), (7, 2), (768, 2), (100, 37), (1000, 37),
                         (64, 128), (769, 770), (768, 768), (3072, 768),
                         (768, 3072), (6152, 64))
           for st, seed in ((False, 0), (True, 0), (True, 2 ** 31 - 1))]
        + [(check_quant_matmul_within_bound, (dev, m, k, n))
           for m, k, n in ((1, 1, 1), (16, 768, 2), (10, 48, 24),
                           (257, 300, 130), (512, 768, 768), (64, 3072, 64),
                           # every row tile: m <= 32, <= 64, > 64
                           (1, 768, 768), (16, 768, 768), (64, 768, 768),
                           (65, 768, 768),
                           (100, 64, 30),     # n % 4 != 0
                           (100, 37, 64),     # k % 4 != 0
                           (100, 100, 64),    # k not a multiple of 32
                           (8192, 768, 768), (8192, 768, 3072),
                           (8192, 3072, 768))]
        + [(check_quant_matmul_deterministic, (dev, m, k, n))
           for m, k, n in ((16, 768, 768), (16, 768, 2), (1000, 37, 100))]
        + [(check_quant_matmul_bf16_within_bound, (dev, m, k, n))
           for m, k, n in ((1, 1, 1), (16, 768, 2), (10, 48, 24),
                           (257, 300, 130), (1, 768, 768), (16, 768, 768),
                           (64, 768, 768), (65, 768, 768),
                           (100, 64, 30),     # n % 8 != 0
                           (100, 37, 64),     # k % 8 != 0
                           (100, 100, 64),    # k not a multiple of 32
                           (8192, 768, 768), (8192, 3072, 768),
                           # the wgmma route: m, n and k off its tiles
                           # (m 192, n 128, k 64), k % 64 != 0
                           (65, 8, 16), (200, 136, 48), (1000, 776, 208),
                           (8193, 200, 784), (300, 3072, 80),
                           (8192, 768, 3072),
                           # k % 8 != 0 and n = 2 at m > 64: mma.sync
                           (300, 100, 64), (8192, 768, 2))]
        + [(check_quant_matmul_bf16_within_bound, (dev, m, k, n, off))
           for m, k, n in ((300, 768, 768), (8192, 768, 768))
           for off in (1, 4)]      # x 2 and 8 bytes off the 16-byte grid
        # the cluster route: every m <= 64 slot count at BERT's (k, n),
        # the NSP head, ragged n and k; x off the 16-byte grid
        + [(check_quant_matmul_bf16_cluster, (dev, m, k, n))
           for m in (1, 2, 7, 8, 15, 16, 17, 32, 33, 63, 64)
           for k, n in ((768, 768), (3072, 768), (768, 3072), (768, 2),
                        (100, 37), (37, 100))]
        + [(check_quant_matmul_bf16_cluster, (dev, m, k, n, off))
           for m, k, n in ((1, 768, 768), (16, 768, 768), (64, 3072, 768),
                           (33, 100, 37))
           for off in (1, 4)]
        # k past one 512-row chunk a block (k / 8 > 512)
        + [(check_quant_matmul_bf16_cluster, (dev, m, k, n, off))
           for m, k, n, off in ((64, 4104, 768, 0), (5, 9000, 20, 3))]
        + [(check_bf16_route_switches_at_m_64, (dev,))]
        # fp16 x: the three routes at BERT's shapes and off their tiles,
        # x off the 16-byte grid, the cluster route's slot counts; and
        # fp32 out from 16-bit x on each route
        + [(check_quant_matmul_bf16_within_bound,
            (dev, m, k, n, 0, torch.float16))
           for m, k, n in ((1, 1, 1), (16, 768, 2), (257, 300, 130),
                           (8192, 768, 768), (8192, 3072, 768),
                           (8192, 768, 3072), (65, 8, 16), (1000, 776, 208),
                           (300, 100, 64), (8192, 768, 2), (100, 37, 64))]
        + [(check_quant_matmul_bf16_within_bound,
            (dev, m, k, n, off, torch.float16))
           for m, k, n in ((300, 768, 768), (8192, 768, 768))
           for off in (1, 4)]
        + [(check_quant_matmul_bf16_cluster, (dev, m, k, n, off,
                                              torch.float16))
           for m in (1, 8, 9, 16, 17, 33, 64)
           for k, n, off in ((768, 768, 0), (3072, 768, 0), (768, 2, 0),
                             (100, 37, 1))]
        + [(check_quant_matmul_bf16_within_bound,
            (dev, m, k, n, 0, dt, torch.float32))
           for dt in (torch.bfloat16, torch.float16)
           for m, k, n in ((16, 768, 768), (8192, 768, 768),
                           (300, 100, 64), (33, 100, 37))]
        + [(check_qmm_bf16_check_sees_a_planted_fault, (dev, m, k, n))
           for m, k, n in ((8192, 768, 768), (8192, 3072, 768),
                           (16, 768, 768), (64, 3072, 768))]
        + [(check_quant_wrappers_raise, (dev,)),
           (check_bert_int8_on_card_matches_cpu, (dev,)),
           (check_bert_int8_amp_on_card, (dev,)),
           (check_bert_int8_amp_on_card, (dev, 1, 16)),
           (check_bert_int8_amp_fp16_on_card, (dev,)),
           (check_bert_int8_amp_fp16_on_card, (dev, 4, 32)),
           (check_bert_amp_step_on_card_matches_cpu, (dev,))]
        + [(check_carrier_kernels_match_plain, (dev, c, n, bs))
           for c in CODECS for n, bs in CASES]
        + [(check_dequant_update_bit_identical, (dev, c, k, n, bs, r))
           for c in CODECS for k in ("sgd", "momentum", "adam", "adamw")
           for n, bs in ((5000, 1024), (4999, 96), (100003, 1024))
           for r in (False, True)]
        + [(check_dequant_update_bit_identical,
            (dev, c, k, n, bs, r, torch.bfloat16))
           for c in CODECS for k in ("sgd", "momentum", "adamw")
           for n, bs in ((4999, 96), (100003, 1024)) for r in (False, True)]
        + [(check_dequant_update_bit_identical,
            (dev, c, k, n, bs, r, torch.float16))
           for c in CODECS for k in ("sgd", "momentum", "adamw")
           for n, bs in ((4999, 96), (100003, 1024)) for r in (False, True)]
        + [(check_dequant_buckets_bit_identical,
            (dev, c, k, sizes, dts, bs, r))
           for c in CODECS for k in ("sgd", "momentum", "adam", "adamw")
           for sizes, dts, bs in (
               (_gpt125m_bf16_plan()[0],
                list(zip(_gpt125m_bf16_plan()[1],
                         _gpt125m_bf16_plan()[1])), 1024),
               ((1, 4097, 100003, 5, 64, 3, 9, 17),
                ((torch.bfloat16, torch.bfloat16),
                 (torch.float32, torch.float32),
                 (torch.float32, torch.bfloat16)), 96),
               # fp16: GPT-125M's fp16 plan; fp16 buckets over fp16 and
               # fp32 parameters beside the other dtypes in one table
               (_gpt125m_bf16_plan("float16")[0],
                list(zip(_gpt125m_bf16_plan("float16")[1],
                         _gpt125m_bf16_plan("float16")[1])), 1024),
               ((1, 4097, 100003, 5, 64, 3, 9, 17, 8, 33),
                ((torch.float16, torch.float16),
                 (torch.float32, torch.float16),
                 (torch.bfloat16, torch.bfloat16),
                 (torch.float32, torch.float32),
                 (torch.float32, torch.bfloat16)), 96))
           for r in (False, True)]
        + [(check_bf16_codec_kernels_match_plain, (dev, c, n, bs, off, dt))
           for c in CODECS
           for n, bs, off in ((5000, 1024, 0), (1_000_003, 1024, 1),
                              (4_725_505, 1024, 3), (777, 128, 2),
                              (1, 1024, 0), (1001, 100, 0))
           for dt in (torch.bfloat16, torch.float16)]
        + [(check_eager_api_on_card, (dev,))]
        + [(check_eager_step_on_card, (dev, k))
           for k in ("sgd", "momentum", "adam", "adamw")]
        + [(check_eager_step_refuses_on_card, (dev,)),
           (check_lenet_on_card_matches_cpu, (dev,))]
        + [(check_nn_on_card_matches_cpu, (dev, k))
           for k in range(len(NN_CASES))]
        + [(check_dropout_on_card, (dev,))]
        + [(check_flash_attention_entry_on_card, (dev, dt))
           for dt in (torch.float32, torch.bfloat16, torch.float16)]
        + [(check_step_dequant_keeps_its_table, (dev,)),
           (check_dequant_wrapper_raises, (dev,))]
        + [(check_fused_ce_kernels_match_plain, (dev, n, c, st, v, b, ig))
           for n, c, st, v, b, ig in (
               # the bench step's chunks: 6 of 8192, the last of 1152
               (8192, 8192, 0, 50304, True, 0),
               (8192, 8192, 40960, 50304, False, 100),
               (8192, 1152, 49152, 50304, True, 100),
               (8192, 1152, 49152, 50304, False, 0),
               # C % 4 != 0 (element-wise accesses), C over one segment
               (100, 1001, 3, 1004, True, 5),
               (64, 20000, 0, 20000, False, 3),
               (1, 1, 0, 1, True, 0))]
        + [(check_ce_bwd_on_its_own_alignment, (dev, c, b, off))
           for c in (5946, 1001, 1002, 1003, 3, 7) for b in (True, False)
           for off in (0, 1, 2, 3)]
        + [(check_fused_ce_wrappers_raise, (dev,)),
           (check_fused_loss_on_card_matches_cpu, (dev, True)),
           (check_fused_loss_on_card_matches_cpu, (dev, False)),
           (check_fused_recompute_step_on_card_matches_cpu, (dev,))])
