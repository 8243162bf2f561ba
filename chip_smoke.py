#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; the last stdout line is printed only
when every phase passed):

  1. device   card name and power limit (nvidia-smi), torch/CUDA
              versions, the kernel build from csrc/ and its seconds;
  2. kernels  each CUDA codec kernel against its plain PyTorch version on
              the card, at the rows x 18,432 shapes the serve phase
              launches (see ``serve_shapes``): the decode step's batched
              append (8 rows), the prefix gather (128), the longest
              uncached prompt, and (labelled as launched by no path here)
              the 512-token prompt cap and the 1024-token context cap,
              for int8_block and fp8_block — payload and
              decode bit-identical; median ms over 30 launches (L2
              flushed before each) for the kernel, the plain version and,
              for int8, the one-call yardsticks torch.quantize_per_channel
              and torch.mul; the bound from bytes and operations at
              3.35 TB/s / 67 TFLOP/s fp32; the launch floor, a
              one-element torch.add timed the same way, beside each row;
              and for each codec a ragged input (RAGGED_CODEC elements,
              n % 1024 != 0 and n % 4 != 0) read where it lies, starting
              4 bytes off the 16-byte grid: payload and decode
              bit-identical to plain, both timed beside their bounds;
  3. serve    GPT-125M (full width and depth, random weights from seed 0)
              behind ServingEngine(max_batch=8) on an int8_block paged KV
              pool of 512 x 16-token blocks: 16 requests, prompts 32..512
              tokens, 4 sharing a 128-token prefix, 64 new tokens each,
              14 greedy + 2 sampled; launch counts reset just before and
              read just after; every request completes, no block leaks,
              both kernels launched;
  4. parity   prefill + 4 greedy decode steps of 2 prompts on the card and
              on the CPU (plain codecs), teacher-forced with the card's
              tokens: logits within 1e-3, equal argmax wherever the
              top-2 gap exceeds 1e-3.
  5. profile  torch.profiler over 8 decode-only steps at batch 8: device
              busy/idle share and device time by kernel.
  6. train-kernels
              the flash attention kernels (flash_fwd, flash_dq, flash_dkv)
              against their plain versions on the card at the train
              step's shape (b8 n12 s1024 d64, causal), a tail shape
              (s = 1000, not a multiple of the 64-row tile) and d = 128,
              causal and full: out and lse within 2e-5 max abs, dq/dk/dv
              within 1e-4 of the larger of 1 and the largest gradient
              (inputs are unit-scale randn); fused_update against its
              plain version bit for bit for sgd/momentum/adam/adamw,
              weight decay on and off, a ragged n, and on each of the
              train step's AdamW buckets; fused_update_buckets over all
              18 buckets at once, three steps, parameters, moments and
              stepped beta powers bit for bit against its plain walk;
              median ms over 30 launches (L2 flushed) for kernel, plain
              version and the one-call yardsticks
              (scaled_dot_product_attention forward; its autograd
              backward, which computes dq, dk and dv at once, against
              the sum of flash_dq and flash_dkv; torch._fused_adamw_
              over the same buckets); the step's update timed three
              ways in one call: as FusedFlatUpdater.step() calls it
              (table, scalar prep and launch), the kernel alone, and
              torch._fused_adamw_, each also from an idle card (events
              with nothing queued ahead, so the host's enqueue shows);
              and the bound:
              for the flash kernels, which run in 3xTF32 on the tensor
              cores, 3 TF32 passes at 495 TFLOP/s with the fp32 SIMT
              bound beside it in the log. The criteria are
              tests/torch_checks.py's, shared with tests/test_torch_cuda.py;
              the card's clocks (nvidia-smi clocks.sm, clocks.max.sm,
              power.draw, temperature.gpu) are sampled before and after,
              as in phases 11 and 13, and every timed row's ratio to its
              yardstick is printed;
  7. train    TrainStep on GPT-125M (full width and depth, random weights
              from seed 0), batch 8 x 1024 tokens fp32, AdamW lr 1e-4
              wd 0.01, one seeded batch: 2 warm-up steps, then 5 timed
              steps with launch counts reset just before and read just
              after (12 per step for each flash kernel, one
              fused_update launch per step for all 18 buckets); every
              loss finite, the last below the first;
  8. train-profile
              torch.profiler over one train step: device busy/idle share,
              kernels per step, device time by kernel, each new kernel's
              share of the step, and the time by kind (cuBLAS GEMMs in
              TF32 and the others, the port's kernels, the rest);
  9. train-parity
              one TrainStep on the card and one on the CPU from the same
              weights and batch, GPT-125M width with 2 layers, b2 s128:
              loss within 1e-5 relative; every gradient within 1e-4 of its
              tensor's largest; on every element whose gradient is 100
              eps or more and 10 times the tensor's largest card-vs-CPU
              gradient difference or more, the card's step equals the
              CPU's within 1e-2 lr and is at least 0.9 lr (Adam's first step moves a
              weight by about lr whatever its gradient's size, so steps
              from noise-level gradients are set by the noise and are
              reported, not held).
 10. infer    BertForPretraining at bert-base (full width and depth,
              random weights from seed 0), convert_to_int8, then eval
              forwards at batch 16 x 512 under torch.inference_mode: 2
              warm-up and 5 timed, launch counts (total and by shape)
              reset just before the conversion and again just before the
              timed forwards: one quantize_int8 per Linear at its weight
              shape; one quant_matmul per Linear per forward, at the same
              (k, n) and m = 16 x 512 or 16; 12 flash_fwd per forward; no
              Linear left, every weight int8; logits finite and of the
              reference's shapes; forward ms, samples/s, peak memory,
              weight bytes at rest before and after; then torch.profiler
              over one forward: device busy share and device time by
              kernel;
 11. int8-kernels
              at every shape phase 10 counted: quantize_int8 against its
              plain version on the card, nearest and stochastic, bit for
              bit (and a ragged [1000, 37]); quant_matmul against its
              plain version, every element within 2 k 2^-24 (|x| @ |q|) s
              (and a ragged (1000, 100, 37)); flash_fwd in full
              (non-causal) mode at b16 n12 s512 d64 against plain (out and
              lse within 2e-5); median ms over 30 launches (L2 flushed)
              for kernel, plain version, bound and a one-call yardstick:
              torch.matmul on the dequantized fp32 weight (TF32 off) for
              quant_matmul, torch.quantize_per_channel given the scales
              (no amax pass) for quantize_int8, SDPA for flash_fwd;
              quant_matmul's bound at its 2 split-TF32 passes on the
              tensor cores, flash_fwd's at 3, each with the fp32 SIMT
              bound beside it; a conversion's quantize_int8 time, the
              sum over its shapes of launches x ms; clocks before and
              after, ratios;
 12. infer-parity
              bert-base width with 2 layers on the card and on the CPU
              from the same seed, converted, b2 s128: int8 payloads and
              scales identical; MLM and NSP logits within 1e-4 max abs;
              int8 against fp32 logits on the card within 0.05 mean
              relative error (the reference's int8 criterion).
 13. dp-kernels
              at every bucket of the GPT-125M plan, int8_block and
              fp8_block: two ranks' gradients encoded to their carriers
              by codec_encode, bit for bit against the plain encode
              (tests/torch_checks.py encoded_inputs), and their sum fed
              to fused_dequant_update_flat (a table of one), bit for bit
              against its plain version (dequant_vs_plain), with and
              without a residual, AdamW; SGD and Momentum at a ragged
              size; all 18 buckets in one fused_dequant_update_buckets
              launch a step, bit for bit against the plain walk over two
              steps from non-zero moments, residual off and on;
              codec_encode's carrier timed at each bucket size as the
              wrapper takes it (a ragged bucket read in place, its bound
              the bucket read once and the padded carrier written once);
              the one launch over the 18 buckets timed (as step_dequant
              calls it, the kernel alone, the plain walk, the decode
              followed by torch._fused_adamw_) against the bound, the
              table built once. The same at the bf16 plan of phase 17
              (9 bf16 buckets and the fp32 final norm): codec_encode
              from each bucket's dtype, bf16 read in place, and
              codec_decode to it, both codecs, bit for bit at every
              bucket, each timed at each bucket size against its bound
              and yardstick (torch.quantize_per_channel on the bucket
              lifted to fp32, which takes no bf16; torch.mul into bf16);
              the plan's one dequant launch bit for bit and timed (the
              yardstick's moments bf16). Clocks before and after,
              ratios. (tools/torch_dequant_ab.py times an earlier
              per-bucket kernel's 18-launch loop beside the one launch.)
 14. dp-train TrainStep(grad_comm=GradCommConfig("int8_block")) on
              GPT-125M (full width and depth, seed 0, fp32, AdamW as in
              phase 7) on two ranks that share the card, started by the
              port's spawn and init_parallel_env (gloo: the all-reduces
              are staged through host memory), 4 x 1024 tokens a rank
              (the global batch is phase 7's 8 x 1024): 2 warm-up steps,
              5 timed steps with launch counts reset just before and read
              just after in each rank (a step: one
              fused_dequant_update_buckets launch for the 18 buckets, 18
              codec_encode, no fused_update, no codec_decode, 12 of each
              flash kernel; codec_encode's launches by bucket shape; the
              first step's counts apart; the update table built once),
              then 2 steps with each all-reduce timed alone between two
              waits for the card; every loss finite, falling and equal
              across the ranks; the ranks' parameters identical at the
              end; the wire bytes the plan's;
 15. dp-parity
              the same at GPT-125M width with 2 layers, global batch
              4 x 128, two steps, world 2 on the card against world 2 on
              the CPU: losses within 1e-4 relative; the parameters by
              tests/torch_checks.py dp_step_parity (local gradients within
              1e-4 of each tensor's largest; at most 1% of the elements
              decoding to another gradient; Adam's step where the decoded
              gradients agree, by adam_step_parity).

 16. train-kernels bf16
              the bf16 forms of the flash kernels (flash_fwd_bf16,
              flash_dq_bf16, flash_dkv_bf16) against their plain
              versions on bf16 inputs at the bf16 train step's shape (b8
              n12 s1024 d64, causal) and at the tail, d = 128 and full
              shapes of phase 6: every element of out, dq, dk and dv
              within 2e-2 of its plain value's magnitude plus 1.6e-2 of
              the RMS of its row plus 1e-5, lse within 1e-4
              (tests/torch_checks.py flash_bf16_limit; each row's
              err_over_limit is the largest diff / limit); fused_update_buckets
              over every bucket of the bf16 plan (bf16 parameters and
              gradients, fp32 moments, the fp32 final-norm bucket in the
              same table) bit for bit against its plain walk over steps
              4-6 from non-zero moments; timed as in phase 6 against
              their bounds (bf16 tensor cores at 989 TFLOP/s; the update
              22 bytes a bf16 element) and yardsticks (bf16
              scaled_dot_product_attention forward, its backward against
              the pair; torch._fused_adamw_ with bf16 moments, its
              nearest form), in the same call as phase 6's fp32 rows;
              clocks before and after, ratios;
 17. train bf16
              phase 7 at bench.py's own configuration (measure_gpt,
              bench.py:155-224): GPT-125M with dtype="bfloat16", seed 0,
              batch 8 x 1024, AdamW lr 1e-4 wd 0.01: 2 warm-up and 5
              timed steps, launch counts (12 a step of each bf16 flash
              kernel, none of the fp32 ones, one fused_update a step for
              every bucket of both dtypes), losses finite and falling,
              peak memory; then the phase 8 profile of one step and the
              LM head's fp32 GEMMs (forward and both backward products)
              timed in TF32, as the step runs them, and in full fp32;
 18. train-parity bf16
              phase 9 for the bf16 model (GPT-125M width, 2 layers, b2
              s128): loss within 1e-4 relative (tests/torch_checks.py
              BF16_LOSS_RTOL), then
              tests/torch_checks.py bf16_step_parity (gradients within
              2e-2 of each tensor's largest; every clear element of a
              bf16 weight within one bf16 ulp of the CPU's after the
              step, of the fp32 final norm within 1e-2 lr).
 19. dp-train bf16
              phase 14 at phase 17's configuration (bench.py's): 2 ranks
              of 4 x 1024 sharing the card, 2 warm-up and DP16_STEPS
              timed steps, then 2 steps with each all-reduce timed
              alone: launch counts a step (one
              fused_dequant_update_buckets over the 10 buckets, 10
              codec_encode, from fp32 once the residuals exist, no
              codec_decode, no fused_update, 12 of each bf16 flash
              kernel, no fp32 one), the first step's apart (9 encodes
              from bf16), the table built once, losses finite, falling
              and equal, parameters identical (sha256), step ms, global
              tokens/s, all-reduce ms, the plan's wire bytes
              (124,962,152), peak memory; then DataParallel on a fresh
              replica, 2 rounds on both ranks (bf16 buckets encoded from
              bf16 in the first round, every bucket decoded to its
              dtype by codec_decode, the port's eager AdamW): launch
              counts, losses finite, replicas identical;
 20. dp-parity bf16
              the bf16 model at GPT-125M width with 2 layers, world 2,
              global batch 4 x 128, two steps; on the card each step
              replayed on the CPU from the card's own local gradients,
              parameters, moments, beta powers and residuals, through the
              plain versions over the same gloo group: parameters,
              moments, powers, residuals, payloads, scales and (each
              bucket reduced again on the card) the bf16 decode bit for
              bit on both ranks; then the same two steps on the CPU end
              to end, losses within 1e-4 relative (BF16_LOSS_RTOL).
 21. fused-ce kernels
              the fused loss's chunk kernels (ce_chunk_fwd, ce_chunk_bwd)
              against their plain versions at the fused step's two chunk
              shapes ([8192, 8192] and the ragged last [8192, 1152] of
              GPT-125M's 50,304 columns at chunk 8192), with and without
              a bias, with ignored rows and labels in a chunk's first and
              last column (tests/torch_checks.py ce_fwd_vs_plain,
              ce_bwd_vs_plain: the running max and the picked logit
              bit-identical, the running sum within 1e-5 relative, each
              dlogit within 1e-6 of its magnitude); each timed beside its
              plain version, its byte bound and a one-call yardstick
              (torch.logsumexp over the chunk, torch.softmax), the
              backward with a bias too; clocks before and after, ratios;
 22. train bf16, fused_loss_chunk=8192
              phase 17 in bench.py's BENCH_FUSED_CE form (the model's own
              chunked loss, TrainStep(model, lambda loss: loss, opt),
              inputs=(ids, None, labels)): launch counts (7 of each chunk
              kernel a step, 12 of each bf16 flash kernel, one
              fused_update), step ms, tokens/s and peak memory beside
              phase 17's of this call, the first loss within
              BF16_LOSS_RTOL of phase 17's (same weights and batch); the
              phase 8 profile, then "the rest" of the step split by
              PyTorch op and input shape (record_shapes; phase 17's too);
              then phase 18's card-vs-CPU step at 2 layers;
 23. train bf16, recompute
              phase 17 with bench.py's BENCH_GPT_REMAT=1 (recompute):
              flash_fwd_bf16 24 launches a step (the backward recomputes
              each block), step ms and peak memory beside phase 17's; one
              step's gradients bit-identical to the same step without
              recompute (2 layers, b8 s1024); the phase 8 profile;
 24. train bf16, schedule + clip
              phase 17's configuration with LinearWarmup(
              CosineAnnealingDecay) from lr 0 and ClipGradByGlobalNorm(1.0),
              5 steps: the lr each update launch read equals the
              schedule's, the step at lr 0 leaves every weight as it was
              and every later one moves each bucket, the clipped global
              norm at most 1, step ms beside phase 17's, the phase 8
              profile of a step; then two steps
              card against CPU at 2 layers, b2 s128: each loss within
              BF16_LOSS_RTOL, the lr-0 step still on both, the second
              within bf16_step_parity.
 25. bert train O2
              bench.py's bert mode (measure_bert, bench.py:701-765,
              BASELINE.md config 3): BERT-base (full width and depth,
              random weights from seed 0), batch 16 x 512 from
              RandomState(seed) with 15% of the positions masked,
              AdamW(1e-4), TrainStep(model, MLM loss + NSP
              cross-entropy) under auto_cast(level="O2",
              dtype="bfloat16") with inputs (ids, None, None, None,
              mlm), 3 warm-up and 10 timed steps; once unfused and once
              with fused_loss_chunk=8192 (BENCH_FUSED_CE): step ms,
              samples/s, peak memory, losses finite and falling, launch
              counts a step (flash_fwd_bf16, flash_dq_bf16 and
              flash_dkv_bf16 12 each in full mode, one fused_update over
              the 18 fp32 buckets, 4 of each chunk kernel in the fused
              form: 30,522 = 3 x 8192 + 5946), the phase 8 profile of
              each form with the rest by op and shape; then the path's
              kernels at its shapes: the bf16 flash trio at [16, 12,
              512, 64] full (phase 16's criteria, timed beside bf16
              SDPA), the update over BERT's plan bit for bit and timed,
              the chunk kernels at 8192 and 5946 columns (phase 21's);
 26. bert train-parity O2
              one O2 step at BERT-base width with 2 layers, b2 s128, on
              the card and on the CPU, the CPU through the flash route's
              plain versions (flash_route: the card's attention is the
              flash kernels, fp32 softmax inside): loss within
              BF16_LOSS_RTOL (not widened), its fp32 terms logged; then
              bf16_step_parity (the query and key projections'
              gradients within QK_GRAD_RTOL, the key biases' gradient,
              zero in exact arithmetic, held under 1e-2 of its key
              weight's);
 27. infer O2
              phase 10 under auto_cast(level="O2"), in the same call:
              int8 BERT-base at 16 x 512, 2 + 5 forwards, launches by
              kernel and shape (per forward 29 quant_matmul_bf16, where
              the reference's int8 layers get bf16 x, and 46 fp32
              quant_matmul, where a layer_norm feeds them; 12
              flash_fwd_bf16), MLM logits bf16 and NSP logits fp32,
              forward ms beside phase 10's, the profile; then the same
              forward at batch 1 x 64 tokens (INFER_B1, 2 + 5 forwards),
              where every bf16 launch has m <= 64: forward ms, launches
              by route (29 a forward on the cluster route, 46 fp32), the
              profile with the cluster route's and qmm_kernel's shares;
              then quant_matmul_bf16 at each shape either forward
              launched (and a ragged one a route) against its plain
              version (tests/torch_checks.py qmm_bf16_vs_plain: 2 k 2^-24
              (|x| @ |q|) s plus one bf16 ulp), timed beside bf16
              torch.matmul on the dequantized bf16 weight, bounds from
              bytes at 3.35 TB/s and operations at 989 TFLOP/s bf16; its
              launches by route (at 16 x 512: 27 a forward on the wgmma
              route at m = 8192, 2 on the cluster route at m = 16, the
              pooler and the NSP head).
 28. gpt O2 parity
              one TrainStep of the fp32 GPT at GPT-125M width with 2
              layers, b2 s128, under auto_cast(level="O2") on the card
              and on the CPU from the same weights and batch: the
              card's launches (each bf16 flash kernel once a layer, no
              fp32 one, one fused_update), the loss within
              BF16_LOSS_RTOL, the gradients' difference logged.
 29. resnet50 train O2
              bench.py's resnet50 mode (measure_resnet50,
              bench.py:643-695, BASELINE.md config 2), not cut:
              resnet50(num_classes=1000) from seed 0, batch 256 of 3 x
              224 x 224 and labels from RandomState(seed), Momentum(0.01,
              0.9), TrainStep with F.cross_entropy under
              auto_cast(level="O2", dtype="bfloat16"), NCHW, cuDNN's
              benchmark mode as PyTorch leaves it (logged): 3 warm-up and
              8 timed steps, launch counts reset just before them and
              read just after (one fused_update a step, its table's rule
              momentum over the plan's fp32 buckets, no other kernel of
              the port), step ms, samples/s, peak memory, losses finite,
              MFU by bench.py's formula (3 x 4.09 GFLOP x (img/224)^2 a
              sample) against 989 TFLOP/s bf16 dense; a profiled step's
              device time by kind (cuDNN convolutions, their backward,
              amp's casts, the max pool, the update kernel, the batch
              norms' and the other elementwise work); then the update
              over ResNet-50's plan bit for bit against its plain walk
              and timed as step() calls it, alone, as the plain walk and
              as torch._fused_sgd_ (momentum 0.9, no dampening: the same
              function), beside its bound (20 bytes an element);
 30. resnet50 parity
              resnet50(num_classes=10) at 4 x 64 x 64, the card's
              weights carried from the CPU model by
              dense_state_dict_from_numpy: two fp32 convolutions (the
              stem's, a 3 x 3 of layer1) on the card and the CPU within
              1e-5 of their fp64 value's largest, and the card's with
              cuDNN's TF32 on at least 1e-4 off (TF32 shows if it is
              on); every stage (stem, 16 blocks, head) in fp32 and under
              O2, fed the CPU's previous output and one cotangent on both
              devices (tests/torch_checks.py stage_run, stage_errors):
              output, input gradient, parameter gradients and running
              buffers within RESNET_STAGE_TOL; one TrainStep in fp32 and
              one under O2 on each device: the loss within 1e-4 in fp32,
              under O2 within twice the CPU's own move when its input
              moves by half a bf16 ulp (three draws), one fused_update
              launch, every weight on
              the card moved by exactly fp32 lr times its gradient
              (Momentum's first step). The whole step's gradients are
              not compared: a ReLU network under batch-4 batch norms
              moves them by more than their size at half a bf16 ulp of
              input noise.
 31. widedeep
              bench.py's widedeep mode (measure_widedeep,
              bench.py:767-862, BASELINE.md config 5) at its accelerator
              sizes, not cut: models/wide_deep.py WideDeepBench.run(),
              batch 512 x 16 slots, 60 steps in passes of 10 (a warm
              pass of 2 first), vocab 10,000, the host Adagrad table
              (dim 8, lr 0.1) behind LocalPs, TheOnePSRuntime and an
              AsyncCommunicator, the DevicePassCache slab padded to
              10,000 rows, CompiledPassStep (the device Adagrad at lr
              0.1, the deep MLP Linear(128, 64), ReLU, Linear(64, 1) on
              Adam(1e-3) through fused_update_buckets); launch counts
              reset just before run() and read just after (one
              fused_update a step, 62; no other kernel of the port);
              examples/s, the held-out AUC over 4096 rows (above 0.5),
              the last loss, the table's rows (10,000), peak memory;
              torch.profiler over one more pass (busy and idle share,
              device time by kernel); 6 more passes of 10 with the
              cache's begin_pass and end_pass and each step wrapped in
              host times and CUDA events (no step waits): the median
              step ms and each pass split into begin_pass, the steps and
              end_pass (host and device); 10 eager steps
              (distributed_lookup_table, the MLP, backward() pushing
              through the communicator, Adam.step()) and their
              examples/s; then the update over Wide&Deep's plan (one
              fp32 bucket of 8,321) bit for bit against its plain walk
              over 3 steps and timed as step() calls it, alone, as the
              plain walk and as torch._fused_adam_, beside its bound
              (28 bytes an element);
 32. widedeep parity
              WideDeepBench.run() at bench.py's CPU sizes (128 x 8,
              30 steps, vocab 2000) on the card and on the CPU in this
              process (one host table library), the same batches and
              seeded weights: the first step's loss within 1e-6, its
              dense gradients and slab gradient within 1e-6 of each
              tensor's largest, but the output bias's (one float, a sum
              of 128 near-cancelling terms) within 1e-6 of the sum of
              its terms' sizes, Adam's step by adam_step_parity,
              the card's Adagrad update equal bit for bit to the rule
              applied in numpy's fp32 to its own slab gradient; every
              loss, the table's rows and the AUC within the larger of 4
              times the CPU's own move under one ulp of the deep arm's
              weights (3 draws) and the CPU test's bounds; two card
              runs bit-identical, or where they part printed; fresh
              keys pulled bit-identical in every run.

Output: a JSON line of per-kernel numbers, then the device summary as the
last line. Exits non-zero without output when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12     # H100 SXM, TF32 on the tensor cores (dense)
BF16_OPS_PER_S = 989e12     # H100 SXM, bf16 on the tensor cores (dense)
CLOCK_QUERY = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
EPT = 12 * 2 * 768          # GPT-125M KV elements per token
QB = 1024                   # KV quant block
MAIN_SHAPE = "decode_step_8"  # the shape behind most serve-phase launches
SOURCES = ("codec", "flash_attention", "fused_update", "quant_matmul",
           "fused_ce")
TRAIN_B, TRAIN_S = 8, 1024          # the train phase's batch
FLASH_MAIN = (8, 12, 1024, 64)      # [b, n, s, d] of every train launch
# the other flash shapes held against plain: a tail (s = 1000, not a
# multiple of the 64-row tile), d = 128, and full (non-causal) attention
FLASH_CHECKS = (((2, 12, 1000, 64), True), ((2, 12, 1000, 64), False),
                ((2, 8, 1024, 128), True), ((2, 8, 1024, 128), False),
                ((8, 12, 1024, 64), False))
LR, WD = 1e-4, 0.01
INFER_B, INFER_S = 16, 512          # the infer phase's batch (bench.py)
FLASH_BERT = (16, 12, 512, 64)      # [b, n, s, d] of every infer launch
RAGGED_CODEC = 4 * EPT + 1001      # n % 1024 != 0 and n % 4 != 0
RAGGED_QUANT = (1000, 37)
RAGGED_QMM = (1000, 100, 37)
RAGGED_QMM_SMALL = (33, 100, 37)    # the cluster route's element loads
INFER_B1 = (1, 64)                  # phase 27's batch-1 forward
INFER_TOL = 1e-4                    # card vs CPU logits, max abs
BF16_KERNELS = ("fwd_bf16_kernel", "dq_bf16_kernel", "dkv_bf16_kernel",
                "update_kernel")
CE_KERNELS = ("ce_fwd_kernel", "ce_bwd_kernel")


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ timing
def median_ms(fn, flush: torch.Tensor, runs: int = 30) -> float:
    """Device time of ``fn`` (median of ``runs``), L2 cold. A spin kernel
    ahead of each run keeps the card busy while the host enqueues the
    run's launches, so no host launch gap falls between the events."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(runs):
        flush.zero_()                      # evict the 50 MB L2
        torch.cuda._sleep(2_000_000)       # ~1 ms of spinning
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def span_ms(fn, flush: torch.Tensor, runs: int = 30) -> float:
    """Time of ``fn`` from an idle card (median of ``runs``): L2 flushed,
    synchronised, then events around ``fn`` with nothing queued ahead, so
    a host enqueue slower than the card shows."""
    for _ in range(3):
        fn()
    out = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def bound(n: int, nb: int, direction: str, padded: int | None = None):
    """Least time (ms) for n elements: each input read once, each output
    written once, against the operations at the fp32 peak. An encode
    writes ``padded`` elements (default n): a ragged input's last block
    in full."""
    out = n if padded is None else padded
    if direction == "encode":   # read x fp32 + scales, write 1-byte q
        nbytes, ops = 4 * n + 4 * nb + out, 4 * out  # div, round, 2 clamps
    elif direction == "carrier":  # the same, writing the 4-byte carrier
        nbytes, ops = 4 * n + 4 * nb + 4 * out, 4 * out
    else:                       # read 1-byte q + scales, write fp32
        nbytes, ops = n + 4 * nb + 4 * n, 2 * n   # mul, div
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def clocks(tag: str) -> str:
    """The card's SM clock, its maximum, power draw and temperature now
    (nvidia-smi), logged under ``tag``."""
    smi = subprocess.run(
        ["nvidia-smi", f"--query-gpu={CLOCK_QUERY}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip()
    log(f"clocks {tag} ({CLOCK_QUERY}): {line}")
    return line


def _timed(rows):
    """(label, kernel ms, yardstick ms) of every row, codec rows by
    direction, that has both times."""
    for key, r in rows.items():
        for p in ("", "enc_", "dec_"):
            ms, lib = r.get(f"{p}ms"), r.get(f"{p}library_ms")
            if ms is not None and lib:
                yield f"{p}{key} {r['shape']}", ms, lib


def log_ratios(phase: str, rows) -> None:
    """Each timed row's kernel time over its one-call yardstick's, both
    from this call."""
    for label, ms, lib in _timed(rows):
        log(f"ratio {phase}: {label}: {ms:.4f} / {lib:.4f} ms = "
            f"{ms / lib:.3f}x the yardstick")


def stamp(rows, before: str, after: str) -> None:
    """Add the clock samples taken around a phase to each of its rows."""
    for r in rows:
        r["clocks"] = {"before": before, "after": after}


# ------------------------------------------------------------------ phases
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    from paddle_tpu_torch import core
    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    # one nvcc per source and g++ for the host table, all started together
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES) + 1) as ex:
        host = ex.submit(core.compile_library)
        paths = list(ex.map(_build.compile_source, SOURCES))
        paths.append(host.result())
    for name in SOURCES:
        _build.load_library(name)
    core.load_library()
    log(f"built {', '.join(os.path.relpath(p) for p in paths)} in "
        f"{time.perf_counter() - t0:.2f} s")


def serve_shapes(reqs) -> dict:
    """Rows (tokens x EPT) of the codec launches the serve phase makes:
    name -> (tokens, kernels launched at that shape). A decode step
    appends one row per running sequence in one batched append (8 rows
    at a full batch; 1-7 while the batch fills and drains); a
    prefix-cache admission gathers its 128 shared tokens (read-back
    only); a prompt without a cache hit appends all its rows at once
    (the longest such prompt of the traffic)."""
    prompt = max(r.n_prompt for r in reqs[4:])   # no shared prefix
    both = ("codec_encode", "codec_decode")
    return {"decode_step_8": (8, both),
            "prefix_gather_128": (128, ("codec_decode",)),
            f"prefill_{prompt}": (prompt, both)}


# the largest a 512-token prompt's append and a full 1024-token context's
# gather can be at this configuration; this traffic launches neither
CAP_SHAPES = {"prompt_cap_512": (512, ()), "context_cap_1024": (1024, ())}


def phase_kernels(dev, gen, shapes):
    from paddle_tpu_torch.distributed import grad_comm as plain
    from paddle_tpu_torch.ops import codec

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    one = torch.ones(1, device=dev)
    # the launch floor: a one-element kernel timed the same way
    floor = median_ms(lambda: torch.add(one, one), flush)
    rows = {}
    for codec_name in ("int8_block", "fp8_block"):
        for shape, (tokens, on_path) in shapes.items():
            n = tokens * EPT
            nb = n // QB
            x = torch.randn(n, device=dev, generator=gen) * 3.0
            x[:QB] = 0.0                                   # scale floor
            s = plain.block_scales(plain.block_absmax(x, QB), codec_name)
            q = codec.block_encode(x, s, QB, codec_name)
            q_plain = plain.block_encode(x, s, QB, codec_name)
            d = codec.block_decode(q, s, 1, n)
            d_plain = plain.block_decode(q_plain, s, 1, n)
            torch.cuda.synchronize()
            if not torch.equal(q.view(torch.uint8), q_plain.view(torch.uint8)):
                raise AssertionError(f"codec_encode {codec_name} {shape}: "
                                     f"payload differs from plain")
            if not torch.equal(d, d_plain):
                raise AssertionError(f"codec_decode {codec_name} {shape}: "
                                     f"differs from plain")
            r = {
                "shape": f"{tokens}x{EPT} {codec_name}", "on_path": on_path,
                "enc_err": float((q.float() - q_plain.float()).abs().max()),
                "dec_err": float((d - d_plain).abs().max()),
                "enc_ms": median_ms(
                    lambda: codec.block_encode(x, s, QB, codec_name), flush),
                "enc_plain_ms": median_ms(
                    lambda: plain.block_encode(x, s, QB, codec_name), flush),
                "dec_ms": median_ms(
                    lambda: codec.block_decode(q, s, 1, n), flush),
                "dec_plain_ms": median_ms(
                    lambda: plain.block_decode(q, s, 1, n), flush),
                "enc_library_ms": None, "dec_library_ms": None,
            }
            lib = ""
            if codec_name == "int8_block":
                # one-call yardsticks, timed here and used nowhere in the
                # port: per-block quantize (divides in double) and the
                # int8 x fp32 product (world = 1)
                zp = torch.zeros(nb, dtype=torch.long, device=dev)
                xq = torch.quantize_per_channel(x.view(nb, QB), s, zp, 0,
                                                torch.qint8).int_repr()
                differ = int((xq != q).sum())
                r["enc_library_ms"] = median_ms(
                    lambda: torch.quantize_per_channel(
                        x.view(nb, QB), s, zp, 0, torch.qint8), flush)
                r["dec_library_ms"] = median_ms(
                    lambda: torch.mul(q, s[:, None]), flush)
                lib = (f" | quantize_per_channel {r['enc_library_ms']:.4f} "
                       f"ms ({differ} of {n} values differ from the "
                       f"kernel's), torch.mul {r['dec_library_ms']:.4f} ms")
            r["enc_bound_ms"], r["enc_bound_by"] = bound(n, nb, "encode")
            r["dec_bound_ms"], r["dec_bound_by"] = bound(n, nb, "decode")
            r["launch_floor_ms"] = floor
            rows[(codec_name, shape)] = r
            path = "+".join(on_path) or "none in this traffic"
            log(f"{codec_name:10s} {shape:17s} [path: {path}] "
                f"encode {r['enc_ms']:.4f} ms (plain "
                f"{r['enc_plain_ms']:.4f}, bound {r['enc_bound_ms']:.4f} "
                f"{r['enc_bound_by']}) | decode {r['dec_ms']:.4f} ms (plain "
                f"{r['dec_plain_ms']:.4f}, bound {r['dec_bound_ms']:.4f} "
                f"{r['dec_bound_by']}){lib} | launch floor {floor:.4f} ms "
                f"| bit-identical")
        _ragged_codec_case(dev, gen, codec_name, flush)
    del flush
    return rows


def _ragged_codec_case(dev, gen, codec_name, flush):
    """Both kernels on a ragged input read where it lies: n = RAGGED_CODEC
    (n % 1024 != 0, n % 4 != 0), starting one element into a larger
    buffer (off the 16-byte grid). The payload bit for bit the plain
    encode's (which zero-pads), the decode the plain decode's over numel;
    timed beside the bound, logged only (no path launches it)."""
    from paddle_tpu_torch.distributed import grad_comm as plain
    from paddle_tpu_torch.ops import codec

    n = RAGGED_CODEC
    nb = -(-n // QB)
    x = (torch.randn(n + 1, device=dev, generator=gen) * 3.0)[1:]
    s = plain.block_scales(plain.block_absmax(x, QB), codec_name)
    q = codec.block_encode(x, s, QB, codec_name)
    d = codec.block_decode(q, s, 1, n)
    q_plain = plain.block_encode(x, s, QB, codec_name)
    if not torch.equal(q.view(torch.uint8), q_plain.view(torch.uint8)):
        raise AssertionError(f"codec_encode {codec_name} ragged n={n}, "
                             f"unaligned start: payload differs from plain")
    if not torch.equal(d, plain.block_decode(q_plain, s, 1, n)):
        raise AssertionError(f"codec_decode {codec_name} ragged n={n}: "
                             f"differs from plain")
    enc = median_ms(lambda: codec.block_encode(x, s, QB, codec_name), flush)
    dec = median_ms(lambda: codec.block_decode(q, s, 1, n), flush)
    log(f"{codec_name:10s} ragged n={n} ({nb} blocks, start 4 bytes off "
        f"the 16-byte grid): encode {enc:.4f} ms (bound "
        f"{bound(n, nb, 'encode', nb * QB)[0]:.4f}) | decode {dec:.4f} ms "
        f"(bound {bound(n, nb, 'decode')[0]:.4f}) | bit-identical")


def _traffic(seed: int, vocab: int):
    from paddle_tpu_torch.serving import SamplingParams, ServeRequest

    rs = np.random.RandomState(seed)
    shared = rs.randint(0, vocab, 128)
    lengths = rs.randint(32, 513, 16)
    lengths[:4] = np.maximum(lengths[:4], 160)   # prefix + a tail
    sampled = SamplingParams(temperature=0.8, top_p=0.95)
    reqs = []
    for i, n in enumerate(lengths):
        prompt = rs.randint(0, vocab, int(n))
        if i < 4:
            prompt[:128] = shared
        reqs.append(ServeRequest(
            prompt_ids=prompt, max_new_tokens=64, request_id=f"smoke-{i}",
            sampling=sampled if i in (5, 11) else SamplingParams()))
    return reqs


def phase_serve(dm, seed: int):
    from paddle_tpu_torch.observability.metrics import get_registry
    from paddle_tpu_torch.ops import codec
    from paddle_tpu_torch.serving import (KVBlockPool, RequestQueue,
                                          ServeRequest, ServingEngine)

    pool = KVBlockPool(512, 16, dm.elems_per_token, codec="int8_block",
                       device=dm.device)
    queue = RequestQueue()
    engine = ServingEngine(dm, pool, queue, max_batch=8)
    log(f"pool: {pool.n_blocks} x {pool.block_tokens} tokens, "
        f"{pool._payload.numel() / 1e6:.1f} MB int8 payload")
    # warm-up (cuBLAS handles, allocator): one short request, off the books
    queue.submit(ServeRequest(prompt_ids=np.arange(32), max_new_tokens=4))
    while engine.step():
        pass
    reqs = _traffic(seed, dm.vocab_size)
    get_registry().reset()
    codec.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        if not queue.submit(r):
            raise AssertionError("queue rejected a request")
    steps = 0
    while engine.step():
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = codec.launch_counts()
    snap = get_registry().snapshot()

    bad = [r.request_id for r in reqs
           if r.outcome != "completed" or len(r.generated) != 64]
    if bad:
        raise AssertionError(f"requests not completed: {bad}")
    if pool.blocks_in_use:
        raise AssertionError(f"{pool.blocks_in_use} KV blocks leaked")
    for r in reqs:
        if not all(0 <= t < dm.vocab_size for t in r.generated):
            raise AssertionError(f"{r.request_id}: token out of range")
    hit = snap["serve_prefix_cache_hit_tokens_total"]
    if hit <= 0:
        raise AssertionError("the shared prefix never hit the cache")
    # every KV append encodes once and reads back once: one per prompt
    # (its rows, or its tail after a prefix hit), then one batched
    # append per decode step; each prefix-cache admission also gathers
    # its prefix once
    dstep = snap["serve_decode_step_ms"]
    appends = len(reqs) + dstep["count"]
    if counts["codec_encode"] <= 0 or counts["codec_decode"] <= 0:
        raise AssertionError(f"a kernel was not launched: {counts}")
    gathers = counts["codec_decode"] - counts["codec_encode"]
    log(f"launches {counts}: {len(reqs)} prompt appends + "
        f"{dstep['count']} decode-step appends, {gathers} prefix gathers")
    if counts["codec_encode"] != appends or gathers < 1:
        raise AssertionError("launch counts disagree with the KV appends")
    ttft = np.array([r.ttft_ms for r in reqs])
    gen = sum(len(r.generated) for r in reqs)
    summary = {
        "requests": len(reqs), "generated_tokens": gen,
        "prompt_tokens": int(sum(r.n_prompt for r in reqs)),
        "wall_s": wall, "tokens_per_s": gen / wall, "steps": steps,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "decode_step_ms_mean": dstep["mean"],
        "decode_steps": dstep["count"],
        "prefix_hit_tokens": hit,
        "prefill_tokens": snap["serve_prefill_tokens_total"],
        "launches": counts,
    }
    log("serve " + json.dumps(summary))
    return counts


def phase_parity(cuda_dm, cpu_dm):
    from paddle_tpu_torch.serving import KVBlockPool, bucket_pow2

    prompts = [np.arange(40) % 997, (np.arange(77) * 31) % 50000]
    runs = {}
    forced = None
    for name, dm in (("cuda", cuda_dm), ("cpu", cpu_dm)):
        pool = KVBlockPool(64, 16, dm.elems_per_token, codec="int8_block",
                           device=dm.device)
        tables = [pool.alloc_table(len(p) + 4) for p in prompts]
        last, kvs = dm.prefill(prompts)
        mirrors = [pool.append(t, kv) for t, kv in zip(tables, kvs)]
        logits = [last.cpu()]
        toks = forced[0] if forced else last.argmax(-1).cpu().tolist()
        trail = [toks]
        for step in range(4):
            n_past = [m.shape[0] for m in mirrors]
            S = bucket_pow2(max(n_past), minimum=16)
            past = torch.zeros(2, S, dm.elems_per_token, device=dm.device)
            for i, m in enumerate(mirrors):
                past[i, :m.shape[0]] = m
            lg, kv = dm.decode(toks, n_past, past, n_past)
            mirrors = [torch.cat([m, pool.append(t, kv[i:i + 1])])
                       for i, (m, t) in enumerate(zip(mirrors, tables))]
            logits.append(lg.cpu())
            toks = (forced[step + 1] if forced
                    else lg.argmax(-1).cpu().tolist())
            trail.append(toks)
        runs[name] = torch.stack(logits)
        forced = forced or trail       # the CPU run replays the card's tokens
    err = float((runs["cuda"] - runs["cpu"]).abs().max())
    top2 = runs["cpu"].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3
    same = runs["cuda"].argmax(-1) == runs["cpu"].argmax(-1)
    log(f"card vs CPU: max |logit diff| {err:.3e} over prefill + 4 decode "
        f"steps; argmax equal at {int(same[clear].sum())}/{int(clear.sum())}"
        f" clear positions")
    if not (err <= 1e-3 and bool(same[clear].all())):
        raise AssertionError("card and CPU disagree beyond 1e-3")
    if not torch.isfinite(runs["cuda"]).all():
        raise AssertionError("non-finite logits on the card")


def phase_profile(dm, seed: int, steps: int = 8):
    """A torch.profiler window over ``steps`` decode-only
    engine steps at full batch (8 x 256-token prompts): device busy share
    of the window and device time by kernel."""
    from paddle_tpu_torch.serving import (KVBlockPool, RequestQueue,
                                          ServeRequest, ServingEngine)
    from torch.profiler import ProfilerActivity, profile

    rs = np.random.RandomState(seed + 1)
    pool = KVBlockPool(512, 16, dm.elems_per_token, codec="int8_block",
                       device=dm.device)
    queue = RequestQueue()
    engine = ServingEngine(dm, pool, queue, max_batch=8)
    for i in range(8):
        queue.submit(ServeRequest(prompt_ids=rs.randint(0, dm.vocab_size,
                                                        256),
                                  max_new_tokens=steps + 16))
    while queue.depth or len(engine.running) < 8:
        engine.step()
    for _ in range(4):                 # settle into decode-only steps
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    log(f"profile: {steps} decode steps at batch 8, wall "
        f"{wall_us / steps / 1e3:.3f} ms/step, device busy "
        f"{busy_us / steps / 1e3:.3f} ms/step "
        f"({100 * busy_us / wall_us:.1f}% busy, "
        f"{100 * (1 - busy_us / wall_us):.1f}% idle), "
        f"{launches / steps:.0f} kernels/step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / steps:9.1f} us/step "
            f"{e.count / steps:6.1f}x  {e.key[:90]}")
    while engine.step():
        pass


# ------------------------------------------------------------ training
def flash_work(shape, causal: bool, kernel: str, itemsize: int = 4):
    """(bytes, operations) one flash kernel needs for ``shape`` with
    ``itemsize``-byte q, k, v, dO and outputs (lse and delta fp32): each
    input read once, each output written once; 2d operations per visible
    (query, key) pair and product (causal: s(s+1)/2 pairs)."""
    b, n, s, d = shape
    pairs = b * n * (s * (s + 1) // 2 if causal else s * s)
    mat, row = itemsize * b * n * s * d, 4 * b * n * s
    if kernel == "flash_fwd":     # q, k, v -> out, lse; QK^T and PV
        return 4 * mat + row, 2 * 2 * d * pairs
    if kernel == "flash_dq":      # q, k, v, dO, lse, delta -> dq
        return 5 * mat + 2 * row, 3 * 2 * d * pairs
    return 6 * mat + 2 * row, 4 * 2 * d * pairs   # ... -> dk, dv


def work_bound(nbytes: float, ops: float, tf32_passes: int = 0,
               bf16: bool = False):
    """Least time (ms) for the bytes at 3.35 TB/s and the operations at
    the fp32 SIMT peak, or, with ``tf32_passes``, that many TF32 passes
    over them at the tensor cores' peak (split-TF32 kernels), or with
    ``bf16`` at the bf16 tensor cores' peak."""
    rate = (BF16_OPS_PER_S if bf16 else TF32_OPS_PER_S if tf32_passes
            else FP32_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops * max(tf32_passes, 1) / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def both_bounds(nbytes: float, ops: float, tf32_passes: int) -> dict:
    """The bound at the arithmetic a tensor-core kernel uses and, beside
    it, the fp32 SIMT bound of the same work."""
    b, by = work_bound(nbytes, ops, tf32_passes)
    simt, simt_by = work_bound(nbytes, ops)
    return {"bound_ms": b, "bound_by": by, "bound_simt_ms": simt,
            "bound_simt_by": simt_by}


# split-TF32 passes of the tensor-core kernels (csrc/quant_matmul.cu,
# csrc/flash_attention.cu); the others run on the SIMT cores
TF32_PASSES = {"flash_fwd": 3, "flash_dq": 3, "flash_dkv": 3,
               "quant_matmul": 2}
PAIR = "flash_dq + flash_dkv"   # the backward pair, against SDPA's backward


def _flash_case(dev, gen, shape, causal, timed: bool, flush,
                dtype=torch.float32):
    """The three flash kernels on ``dtype`` inputs of ``shape`` against
    their plain versions (``torch_checks.flash_vs_plain``) and, when
    ``timed``, each timed beside its plain version, its bound and the
    one-call yardstick in the same dtype."""
    from paddle_tpu_torch.ops import flash_attention as fa
    import torch.nn.functional as F
    from torch_checks import flash_vs_plain

    q, k, v, do = (torch.randn(*shape, device=dev, generator=gen).to(dtype)
                   for _ in range(4))
    errs, lse, delta = flash_vs_plain(q, k, v, do, causal)
    outputs = {"flash_fwd": ("out", "lse"), "flash_dq": ("dq",),
               "flash_dkv": ("dk", "dv")}
    kernel_err = {n: max(errs[o][0] for o in outs)
                  for n, outs in outputs.items()}
    kernel_ratio = {n: max(errs[o][1] for o in outs)
                    for n, outs in outputs.items()}
    bf16 = dtype == torch.bfloat16
    rows = {}
    if timed:
        # one-call yardsticks, timed here and used nowhere in the port:
        # SDPA's forward for flash_fwd; its backward computes dq, dk and
        # dv in one call, so it is the yardstick of the pair, not of
        # either kernel alone
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        ref = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)
        lib_fwd = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), flush)
        lib_bwd = median_ms(lambda: torch.autograd.grad(
            ref, (qr, kr, vr), do, retain_graph=True), flush)
        calls = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal),
                          lambda: fa.flash_fwd_plain(q, k, v, causal),
                          lib_fwd),
            "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, causal),
                         lambda: fa.flash_dq_plain(q, k, v, do, lse, delta,
                                                   causal), None),
            "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta,
                                               causal),
                          lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta,
                                                     causal), None)}
        label = (f"{list(shape)} {'causal' if causal else 'full'}"
                 + (" bf16" if bf16 else ""))
        for name, (kern, plain, lib) in calls.items():
            work = flash_work(shape, causal, name, q.element_size())
            bounds = (dict(zip(("bound_ms", "bound_by"),
                               work_bound(*work, bf16=True)))
                      if bf16 else both_bounds(*work, TF32_PASSES[name]))
            rows[name] = {"shape": label, "max_abs_err": kernel_err[name],
                          "err_over_limit": kernel_ratio[name],
                          "ms": median_ms(kern, flush),
                          "plain_ms": median_ms(plain, flush),
                          **bounds, "library_ms": lib}
        rows[PAIR] = {"shape": label, "ms": rows["flash_dq"]["ms"]
                      + rows["flash_dkv"]["ms"], "library_ms": lib_bwd}

    def at(name, r):
        if bf16:
            return "bf16 tensor cores"
        return (f"{TF32_PASSES[name]} TF32 passes, fp32 SIMT bound "
                f"{r['bound_simt_ms']:.4f}")

    log(f"flash {list(shape)} {dtype} causal={causal}: max abs diff "
        + ", ".join(f"{n} {e:.2e} ({r:.3f} of its limit)"
                    for n, (e, r) in errs.items())
        + "".join(f" | {n} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
                  f"bound {r['bound_ms']:.4f} {r['bound_by']} at "
                  f"{at(n, r)})"
                  for n, r in rows.items() if n != PAIR)
        + "".join(f" | {n} {r['ms']:.4f} ms, library {r['library_ms']:.4f}"
                  for n, r in rows.items() if r.get("library_ms")))
    return rows


def _fused_case(gen, kind, wd, n):
    from torch_checks import FUSED_HYPER, fused_inputs, fused_vs_plain

    p, g, slots, lr = fused_inputs(kind, n, gen, LR)
    return fused_vs_plain(p, g, slots, lr, kind=kind,
                          hyper=FUSED_HYPER[kind], wd=wd)


def bucket_updater(sizes, gen, dtypes=None, make_opt=None):
    """A FusedFlatUpdater over one parameter a bucket of ``sizes`` (in
    ``dtypes``, fp32 by default; ``make_opt(params)``'s Adam rule, by
    default AdamW with the train phase's lr and wd) on ``gen``'s device,
    its gradients in place, stepped once, then moments set to the train
    phase's scales: weights 0.02, gradients 1e-3, moment1 1e-4, moment2
    1e-6 (squared randn)."""
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.distributed import grad_comm

    dev = gen.device
    dtypes = dtypes or [torch.float32] * len(sizes)
    params = [torch.nn.Parameter(
        (torch.randn(n, device=dev, generator=gen) * 0.02).to(dt))
        for n, dt in zip(sizes, dtypes)]
    buckets = []
    for i, (n, dt) in enumerate(zip(sizes, dtypes)):
        b = grad_comm.GradBucket(i, dt)
        b.add(i, (n,))
        buckets.append(b)
    opt = (optim.AdamW(learning_rate=LR, weight_decay=WD, parameters=params)
           if make_opt is None else make_opt(params))
    upd = optim.FusedFlatUpdater(opt, params, buckets=buckets)
    upd.zero_grad()
    for p in params:
        p.grad.copy_(torch.randn(p.shape, device=dev, generator=gen) * 1e-3)
    upd.step()
    for b in buckets:
        s = upd._slots[b.index]
        s["moment1"].copy_(torch.randn(b.size, device=dev, generator=gen)
                           * 1e-4)
        s["moment2"].copy_(torch.randn(b.size, device=dev, generator=gen)
                           ** 2 * 1e-6)
    return upd


def _fused_timing(dev, gen, buckets, flush):
    """One train step's fused updates (every bucket of the GPT-125M plan,
    AdamW, weights, gradients and moments at the scales of the train
    phase): each bucket's single-bucket kernel and the one launch over
    all of them held bit for bit against their plain versions (the
    latter three steps, stepped beta powers included); then, in one
    call, the update as FusedFlatUpdater.step() calls it, the kernel
    alone, the plain walk and torch._fused_adamw_ over the same buckets
    timed, and the bound for the whole set. Each bucket takes its plan's
    dtype (fp32, or bf16 parameters and gradients with fp32 moments);
    torch._fused_adamw_ keeps the moments in the parameters' dtype, so
    its bf16 buckets run with bf16 copies of the moments (its nearest
    form), one call a dtype."""
    from torch_checks import FUSED_HYPER, buckets_vs_plain, fused_vs_plain

    from paddle_tpu_torch.ops import fused_update as fu

    hyper = FUSED_HYPER["adamw"]
    sizes = [b.size for b in buckets]
    dtypes = [b.dtype for b in buckets]
    upd = bucket_updater(sizes, gen, dtypes)
    ps = [upd._flat_p[i] for i in range(len(sizes))]
    gs = [upd._flat_g[i] for i in range(len(sizes))]
    m1 = [upd._slots[i]["moment1"] for i in range(len(sizes))]
    m2 = [upd._slots[i]["moment2"] for i in range(len(sizes))]
    scal = {"beta1_pow": torch.full((), 0.9 ** 3, device=dev),
            "beta2_pow": torch.full((), 0.999 ** 3, device=dev)}
    lr = torch.full((), LR, device=dev)
    err = max(fused_vs_plain(p, g, {"moment1": a, "moment2": b, **scal}, lr,
                             kind="adamw", hyper=hyper, wd=WD)
              for p, g, a, b in zip(ps, gs, m1, m2))
    entries = [(p.clone(), g.clone(), [a.clone(), b.clone()], WD, 1.0)
               for p, g, a, b in zip(ps, gs, m1, m2)]
    launches = buckets_vs_plain("adamw", hyper, entries, lr, steps=3,
                                gen=gen)
    del entries
    if launches != 3:
        raise AssertionError(f"fused_update_buckets: {launches} launches "
                             f"for 3 steps of {len(sizes)} buckets")
    log(f"fused_update: bit-identical to plain on each of the {len(sizes)} "
        f"AdamW buckets of the train step ({min(sizes)}..{max(sizes)} "
        f"elements); fused_update_buckets over all {len(sizes)} at once "
        f"bit-identical to its plain walk over 3 steps, beta powers "
        f"included, in {launches} launches")
    table = upd._table

    def kernel():   # the same powers each time: the updater's state holds
        fu.fused_update_buckets(table, lr)
        table.parity = 1 - table.parity

    def plain():
        fu.buckets_plain(table, lr)

    groups = {}     # dtype -> the library's (params, grads, m1, m2, steps)
    for p, g, a, b in zip(ps, gs, m1, m2):
        grp = groups.setdefault(p.dtype, ([], [], [], [], []))
        for lst, t in zip(grp, (p, g, a.to(p.dtype), b.to(p.dtype),
                                torch.full((), 4.0, device=dev))):
            lst.append(t)

    def library():
        for grp in groups.values():
            torch._fused_adamw_(*grp[:4], [], grp[4], lr=LR, beta1=0.9,
                                beta2=0.999, weight_decay=WD, eps=1e-8,
                                amsgrad=False, maximize=False)

    n = sum(sizes)
    # read p, g, m1, m2; write p, m1, m2 (the moments fp32); ~20
    # operations an element
    nbytes = sum(nb * (3 * torch.empty((), dtype=dt).element_size() + 16)
                 for nb, dt in zip(sizes, dtypes))
    bound_ms, bound_by = work_bound(nbytes, 20 * n)
    kinds = sorted({str(dt).split(".")[-1] for dt in dtypes})
    row = {"shape": f"{len(sizes)} buckets, {n} elements (one step, "
                    f"{'/'.join(kinds)})",
           "library_form": ", ".join(
               f"{len(g[0])} {str(dt).split('.')[-1]} buckets, moments "
               f"{str(dt).split('.')[-1]}" for dt, g in groups.items()),
           "max_abs_err": err, "step_ms": median_ms(upd.step, flush),
           "ms": median_ms(kernel, flush),
           "library_ms": median_ms(library, flush),
           "step_span_ms": span_ms(upd.step, flush),
           "span_ms": span_ms(kernel, flush),
           "library_span_ms": span_ms(library, flush),
           "plain_ms": median_ms(plain, flush), "bound_ms": bound_ms,
           "bound_by": bound_by, "largest_bucket": max(sizes),
           "smallest_bucket": min(sizes)}
    return row


def phase_train_kernels(dev, gen, buckets):
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows = _flash_case(dev, gen, FLASH_MAIN, True, True, flush)
    for shape, causal in FLASH_CHECKS:
        _flash_case(dev, gen, shape, causal, False, flush)
    for kind in ("sgd", "momentum", "adam", "adamw"):
        for wd in (0.0, WD):
            _fused_case(gen, kind, wd, 1_000_003)
    log("fused_update: bit-identical to plain for sgd/momentum/adam/adamw, "
        "wd 0 and 0.01, n = 1,000,003")
    fused = _fused_timing(dev, gen, buckets, flush)
    rows["fused_update"] = fused
    log(f"fused_update, one step's {fused['shape']}, one launch, device "
        f"time (from an idle card): as FusedFlatUpdater.step() calls it "
        f"{fused['step_ms']:.4f} ms ({fused['step_span_ms']:.4f}), the "
        f"kernel alone {fused['ms']:.4f} ({fused['span_ms']:.4f}), "
        f"torch._fused_adamw_ {fused['library_ms']:.4f} "
        f"({fused['library_span_ms']:.4f}); plain {fused['plain_ms']:.4f}; "
        f"bound {fused['bound_ms']:.4f} {fused['bound_by']}, the kernel at "
        f"{100 * fused['bound_ms'] / fused['ms']:.1f}% of it")
    del flush
    return rows


def phase_train_kernels_bf16(dev, gen, buckets):
    """Phase 16: the bf16 forms of the train step's kernels, checked and
    timed as phase 6 times the fp32 ones (``buckets``: the bf16 plan)."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    bf16 = torch.bfloat16
    rows = _flash_case(dev, gen, FLASH_MAIN, True, True, flush, bf16)
    for shape, causal in FLASH_CHECKS:
        _flash_case(dev, gen, shape, causal, False, flush, bf16)
    fused = _fused_timing(dev, gen, buckets, flush)
    rows["fused_update"] = fused
    log(f"fused_update bf16 plan, one step's {fused['shape']}, one launch, "
        f"device time (from an idle card): as FusedFlatUpdater.step() calls "
        f"it {fused['step_ms']:.4f} ms ({fused['step_span_ms']:.4f}), the "
        f"kernel alone {fused['ms']:.4f} ({fused['span_ms']:.4f}), "
        f"torch._fused_adamw_ ({fused['library_form']}) "
        f"{fused['library_ms']:.4f} ({fused['library_span_ms']:.4f}); plain "
        f"{fused['plain_ms']:.4f}; bound {fused['bound_ms']:.4f} "
        f"{fused['bound_by']}, the kernel at "
        f"{100 * fused['bound_ms'] / fused['ms']:.1f}% of it")
    del flush
    return rows


def bucket_plan(cfg):
    """The bucket plan of ``cfg``'s parameters in their dtypes (for bf16:
    bf16 blocks and tables, the fp32 final norm), from their shapes."""
    from paddle_tpu_torch.distributed.grad_comm import build_buckets
    from paddle_tpu_torch.models.convert import (expected_dtypes,
                                                 expected_shapes)

    dtypes = expected_dtypes(cfg)
    return build_buckets([torch.empty(shape, device="meta",
                                      dtype=dtypes[name])
                          for name, shape in expected_shapes(cfg).items()])


def _train_setup(cfg, device, b, s, seed, lr=LR, grad_clip=None):
    """GPT from seed 0, AdamW and the TrainStep of ``bench.py``'s
    ``measure_gpt`` for ``cfg`` (the criterion, or with
    ``fused_loss_chunk`` the model's own loss), and a batch from
    ``RandomState(seed)``."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(cfg, seed=0, device=device)
    opt = AdamW(learning_rate=lr, weight_decay=WD,
                parameters=model.parameters(), grad_clip=grad_clip)
    loss_fn = ((lambda loss: loss) if cfg.fused_loss_chunk > 0
               else GPTPretrainingCriterion())
    step = TrainStep(model, loss_fn, opt)
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size, (b, s))
    labels = rs.randint(0, cfg.vocab_size, (b, s))
    return model, step, ids, labels


def bench_step(step, cfg, ids, labels):
    """One step as ``bench.py``'s ``one_step`` calls it: the fused loss
    takes the labels as the model's third input (``bench.py:192-196``)."""
    if cfg.fused_loss_chunk > 0:
        return step(inputs=(ids, None, labels), labels=())
    return step(inputs=(ids,), labels=(labels,))


def _variant(cfg) -> str:
    """The training options of ``cfg`` that phase 17 leaves off."""
    return "".join((f", fused_loss_chunk={cfg.fused_loss_chunk}"
                    if cfg.fused_loss_chunk else "",
                    ", recompute" if getattr(cfg, "recompute", False)
                    else ""))


def loss_chunks(cfg) -> int:
    """Chunks of the fused loss a step (0 without it)."""
    c = cfg.fused_loss_chunk
    return -(-cfg.vocab_size // c) if c > 0 else 0


def train_launch_counts() -> dict:
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fce
    from paddle_tpu_torch.ops import fused_update as fu

    return {**fa.launch_counts(), **fu.launch_counts(),
            **fce.launch_counts()}


def reset_train_launch_counts() -> None:
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fce
    from paddle_tpu_torch.ops import fused_update as fu

    fa.reset_launch_counts()
    fu.reset_launch_counts()
    fce.reset_launch_counts()


def phase_train(cfg, dev, seed, warmup=2, steps=5, b=TRAIN_B, s=TRAIN_S):
    """``bench.py``'s training step for ``cfg``: ``warmup`` then ``steps``
    timed steps, launch counts reset just before them and read just
    after. Returns the counts, the step, the batch and the summary."""
    _, step, ids, labels = _train_setup(cfg, dev, b, s, seed)
    n_params = sum(b.size for b in step.buckets)
    log(f"train: {n_params} parameters in {len(step.buckets)} buckets, "
        f"{cfg.num_layers} layers, {cfg.dtype}{_variant(cfg)}, batch {b} x "
        f"{s}, AdamW lr {LR} wd {WD}")
    losses = []
    for _ in range(warmup):
        losses.append(float(bench_step(step, cfg, ids, labels)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_launch_counts()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = bench_step(step, cfg, ids, labels)
        losses.append(float(loss))        # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = train_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = b * s
    summary = {"losses": losses, "step_ms": step_ms,
               "step_ms_median": statistics.median(step_ms),
               "tokens_per_s": tokens / (statistics.median(step_ms) / 1e3),
               "peak_memory_gib": peak, "buckets": len(step.buckets),
               "launches": counts}
    log(f"train {cfg.dtype}{_variant(cfg)} " + json.dumps(summary))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    ran = "_bf16" if cfg.dtype == "bfloat16" else ""
    want = {name + sfx: cfg.num_layers * steps * (sfx == ran)
            for sfx in ("", "_bf16")
            for name in ("flash_fwd", "flash_dq", "flash_dkv")}
    if cfg.recompute:      # the backward runs each block's forward again
        want["flash_fwd" + ran] *= 2
    want["fused_update"] = steps
    want["ce_chunk_fwd"] = want["ce_chunk_bwd"] = loss_chunks(cfg) * steps
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    return counts, step, ids, labels, summary


def _one_step(cfg, device, b, s, seed, level=None):
    """One TrainStep from the seeded weights (under ``auto_cast`` at
    ``level``, when given): the loss and, per parameter, (before, after,
    gradient) on the CPU."""
    from paddle_tpu_torch.amp import auto_cast

    model, step, ids, labels = _train_setup(cfg, device, b, s, seed)
    before = {n: p.detach().cpu().clone()
              for n, p in model.named_parameters()}
    with auto_cast(enable=level is not None, level=level or "O1"):
        loss = float(bench_step(step, cfg, ids, labels))
    return loss, {n: (before[n], p.detach().cpu(), p.grad.cpu())
                  for n, p in model.named_parameters()}


def phase_train_parity(cfg, dev, seed):
    """One step on the card and one on the CPU, same weights and batch:
    the loss, the gradients and the step itself compared (see
    ``tests/torch_checks.py`` ``adam_step_parity``; a bf16 ``cfg``,
    ``bf16_step_parity``)."""
    import dataclasses

    from torch_checks import (BF16_LOSS_RTOL, adam_step_parity,
                              bf16_step_parity)

    small = dataclasses.replace(cfg, num_layers=2)
    card_loss, card = _one_step(small, dev, 2, 128, seed + 2)
    cpu_loss, cpu = _one_step(small, "cpu", 2, 128, seed + 2)
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    tol = BF16_LOSS_RTOL if cfg.dtype == "bfloat16" else 1e-5
    log(f"train {cfg.dtype}{_variant(cfg)} card vs CPU (gpt-125m width, 2 "
        f"layers, b2 s128): loss {card_loss:.7f} vs {cpu_loss:.7f} (rel "
        f"{rel:.2e}, limit {tol:.0e})")
    if not rel <= tol:
        raise AssertionError(f"card and CPU losses differ beyond {tol:.0e}")
    if cfg.dtype == "bfloat16":
        r = bf16_step_parity(card, cpu, LR)
        log(f"train bf16 card vs CPU after one AdamW step: gradients "
            f"within {r['grad_rtol']:.2e} of each tensor's largest (limit "
            f"2e-2); on the {100 * r['clear_share']:.1f}% of elements whose "
            f"gradient is clear of the noise, every bf16 weight within one "
            f"bf16 ulp of the CPU's, the fp32 ones within 1e-2 lr; "
            f"{100 * r['differ_share']:.3f}% of all elements differ, max "
            f"|param diff| {r['param_max_abs_diff']:.3e}")
        return
    r = adam_step_parity(card, cpu, LR)
    log(f"train card vs CPU after one AdamW step: gradients within "
        f"{r['grad_rtol']:.2e} of each tensor's largest (limit 1e-4); on "
        f"the {100 * r['clear_share']:.1f}% of elements whose gradient is "
        f"clear of the noise, steps within {r['clear_step_diff_lr']:.2e} "
        f"lr (limit 1e-2) and every one >= 0.9 lr; over all elements "
        f"max |param diff| {r['param_max_abs_diff']:.3e}")


def phase_gpt_o2_parity(dev, seed, b=2, s=128):
    """Phase 28: one TrainStep of the fp32 GPT (GPT-125M width, 2 layers)
    under ``auto_cast(level="O2")`` on the card and on the CPU, same
    weights and batch: the card's launches (each bf16 flash kernel once a
    layer, no fp32 one, one fused_update), the loss within
    ``BF16_LOSS_RTOL``, the gradients' largest difference logged."""
    from torch_checks import BF16_LOSS_RTOL

    from paddle_tpu_torch.models import gpt_presets

    cfg = gpt_presets("gpt-125m", num_layers=2)
    reset_train_launch_counts()
    card_loss, card = _one_step(cfg, dev, b, s, seed + 2, level="O2")
    counts = train_launch_counts()
    cpu_loss, cpu = _one_step(cfg, "cpu", b, s, seed + 2, level="O2")
    want = {name + sfx: cfg.num_layers * (sfx == "_bf16")
            for sfx in ("", "_bf16")
            for name in ("flash_fwd", "flash_dq", "flash_dkv")}
    want.update(fused_update=1, ce_chunk_fwd=0, ce_chunk_bwd=0)
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    grad = max(float((card[n][2] - cpu[n][2]).abs().max())
               / max(float(cpu[n][2].abs().max()), 1e-30) for n in cpu)
    log(f"gpt O2 card vs CPU (gpt-125m width, fp32 parameters, 2 layers, "
        f"b{b} s{s}): loss {card_loss:.7f} vs {cpu_loss:.7f} (rel "
        f"{rel:.2e}, limit {BF16_LOSS_RTOL:.0e}); gradients within "
        f"{grad:.2e} of each tensor's largest; card launches {counts}")
    if counts != want:
        raise AssertionError(f"gpt O2 launch counts {counts}, expected "
                             f"{want}")
    if not rel <= BF16_LOSS_RTOL:
        raise AssertionError(f"gpt O2: card and CPU losses differ beyond "
                             f"{BF16_LOSS_RTOL:.0e}")


# PyTorch ops whose kernels are cuBLAS GEMMs (the profile's "GEMMs")
GEMM_OPS = ("aten::mm", "aten::addmm", "aten::addmm_", "aten::bmm",
            "aten::baddbmm", "aten::matmul", "aten::linear",
            "aten::_scaled_mm")


def phase_train_profile(one, names=("fwd_kernel", "dq_kernel", "dkv_kernel",
                                   "update_kernel"), tag="", top=10):
    """torch.profiler over one step (the call ``one()``): busy and idle
    share, kernels, device time by kernel and by kind; then a second
    profiled step with ``record_shapes`` (kept apart: recording shapes
    slows the host) splits "the rest" by PyTorch op and input shape, its
    ``top`` largest entries logged."""
    from torch.profiler import ProfilerActivity, profile

    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"train profile{tag}: one step, wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}% busy, "
        f"{100 * (1 - busy_us / wall_us):.1f}% idle), "
        f"{sum(e.count for e in kernels)} kernels per step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
            f"{100 * e.self_device_time_total / busy_us:5.1f}% "
            f"{e.count:5d}x  {e.key[:90]}")
    for name in names:
        t = sum(e.self_device_time_total for e in kernels if name in e.key)
        log(f"  share of the step's device time, {name}: "
            f"{100 * t / busy_us:.1f}% ({t / 1e3:.3f} ms)")
    # by kind: cuBLAS's GEMMs (TF32 ones apart), the port's kernels, the
    # rest (PyTorch's elementwise, reduction and copy kernels)
    kinds = {"GEMMs, TF32": 0.0, "GEMMs, other": 0.0, "port kernels": 0.0,
             "the rest": 0.0}
    gemm_words = ("gemm", "nvjet", "gemv", "splitkreduce")
    for e in kernels:
        key = e.key.lower()
        if any(n in e.key for n in names):
            kind = "port kernels"
        elif any(w in key for w in gemm_words):
            kind = "GEMMs, TF32" if "tf32" in key else "GEMMs, other"
        else:
            kind = "the rest"
        kinds[kind] += e.self_device_time_total
    log("  by kind: " + ", ".join(f"{k} {t / 1e3:.3f} ms "
                                  f"({100 * t / busy_us:.1f}%)"
                                  for k, t in kinds.items()))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        one()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::") and e.key not in GEMM_OPS
           and e.self_device_time_total > 0]
    rest = sum(e.self_device_time_total for e in ops)
    log(f"  the rest by PyTorch op and input shape{tag} (the device time "
        f"of the kernels each op launched itself; {rest / 1e3:.3f} ms in "
        f"{len(ops)} entries), the {top} largest:")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  "
            f"{e.key} {str(e.input_shapes)[:110]}")
    return kinds


def lm_head_gemms(dev, gen, cfg, tokens=TRAIN_B * TRAIN_S):
    """The bf16 step's LM head in fp32 (``models/gpt.py``: the fp32
    final-norm output times the bf16 table promoted to fp32): its forward
    GEMM and both backward GEMMs, timed in TF32, as the step runs them,
    and in full fp32 (median of 10, L2 flushed), beside their bounds at
    495 TFLOP/s TF32 and 67 TFLOP/s fp32."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    h = torch.randn(tokens, cfg.hidden_size, device=dev, generator=gen)
    w = torch.randn(cfg.vocab_size, cfg.hidden_size, device=dev,
                    generator=gen).to(torch.bfloat16)
    dlogits = torch.randn(tokens, cfg.vocab_size, device=dev, generator=gen)

    def gemms():
        w32 = w.float()
        h @ w32.T
        dlogits @ w32
        dlogits.T @ h

    mm = torch.backends.cuda.matmul
    saved = mm.allow_tf32
    out = {}
    try:
        for name, tf32 in (("tf32_ms", True), ("fp32_ms", False)):
            mm.allow_tf32 = tf32
            out[name] = median_ms(gemms, flush, runs=10)
    finally:
        mm.allow_tf32 = saved
    ops = 3 * 2 * tokens * cfg.hidden_size * cfg.vocab_size
    out["tf32_bound_ms"] = ops / TF32_OPS_PER_S * 1e3
    out["fp32_bound_ms"] = ops / FP32_OPS_PER_S * 1e3
    log(f"LM head fp32 GEMMs of a bf16 step ([{tokens}, {cfg.hidden_size}] "
        f"x [{cfg.hidden_size}, {cfg.vocab_size}], forward and both "
        f"backward products, {ops / 1e12:.2f} TFLOP): TF32 (as the step "
        f"runs them) {out['tf32_ms']:.3f} ms (bound "
        f"{out['tf32_bound_ms']:.3f}), full fp32 {out['fp32_ms']:.3f} ms "
        f"(bound {out['fp32_bound_ms']:.3f})")
    del flush, dlogits
    return out


# ------------------------------------------------- training options
CE_CHUNK = 8192                     # bench.py's BENCH_FUSED_CE chunk
SCHED_WARMUP, SCHED_T_MAX = 2, 100  # phase 24's LinearWarmup, cosine


def ce_chunk_shapes(cfg, chunk=CE_CHUNK):
    """(start, columns) of the fused loss's chunks at ``chunk``: the full
    ones, then the ragged last (GPT-125M: 6 of 8192 and one of 1152)."""
    v = cfg.vocab_size
    return [(st, min(chunk, v - st)) for st in range(0, v, chunk)]


def phase_fused_ce_kernels(dev, gen, cfg, tokens=TRAIN_B * TRAIN_S):
    """Phase 21: ``ce_chunk_fwd`` and ``ce_chunk_bwd`` against their plain
    versions (``tests/torch_checks.py`` ``ce_fwd_vs_plain``,
    ``ce_bwd_vs_plain``) at each chunk shape of the fused step (no bias,
    as GPT's tied head; and with a bias and 100 ignored rows), then each
    timed at both shapes beside its plain version, its byte bound and a
    one-call yardstick (``torch.logsumexp`` over the chunk for the
    forward, which neither merges nor picks; ``torch.softmax`` for the
    backward)."""
    from torch_checks import ce_bwd_vs_plain, ce_fwd_vs_plain, ce_inputs

    from paddle_tpu_torch.ops import fused_ce as fce

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    v = cfg.vocab_size
    shapes = {c: st for st, c in ce_chunk_shapes(cfg)}   # one start a width
    rows = {}
    for c, start in shapes.items():
        logit, bias, labels, state, lse, g = ce_inputs(
            tokens, c, start, v, gen, dev, bias=True, ignored=100)
        checks = {"fwd bias": ce_fwd_vs_plain(logit, bias, labels, start, v,
                                              state),
                  "bwd bias": ce_bwd_vs_plain(logit, bias, lse, labels, g,
                                              start)}
        g[:100] = torch.rand(100, device=dev, generator=gen) / tokens
        fwd = ce_fwd_vs_plain(logit, None, labels, start, v, state)
        bwd = ce_bwd_vs_plain(logit, None, lse, labels, g, start)
        m, s_, picked = (t.clone() for t in state)
        work = logit.clone()
        n = tokens * c
        # forward: read the chunk once (and the rows' state and labels);
        # backward: read and write it once; ~4 fp32 operations an element
        # (max, subtract, exp, add; subtract, exp, subtract, multiply)
        row_bytes = 4 * tokens * 7
        fb, fby = work_bound(4 * n + row_bytes, 4 * n)
        bb, bby = work_bound(8 * n + 4 * tokens * 3, 4 * n)
        label = f"[{tokens}, {c}] fp32 (chunk at {start})"
        rows[("ce_chunk_fwd", c)] = {
            "shape": label, "max_abs_err": max(fwd["m"], fwd["s"],
                                               fwd["picked"]),
            "s_rel": fwd["s_rel"],
            "ms": median_ms(lambda: fce.ce_chunk_fwd(
                logit, None, labels, start, v, m, s_, picked), flush),
            "plain_ms": median_ms(lambda: fce.ce_chunk_fwd_plain(
                logit, None, labels, start, m, s_, picked), flush),
            "bound_ms": fb, "bound_by": fby,
            "library_ms": median_ms(lambda: torch.logsumexp(logit, -1),
                                    flush),
            "library_form": "torch.logsumexp(chunk, -1)"}
        rows[("ce_chunk_bwd", c)] = {
            "shape": label, "max_abs_err": bwd["dlogit"],
            "err_over_limit": bwd["over_limit"],
            "ms": median_ms(lambda: fce.ce_chunk_bwd(
                work, None, lse, labels, g, start), flush),
            "bias_ms": median_ms(lambda: fce.ce_chunk_bwd(
                work, bias, lse, labels, g, start), flush),
            "plain_ms": median_ms(lambda: fce.ce_chunk_bwd_plain(
                work, None, lse, labels, g, start), flush),
            "bound_ms": bb, "bound_by": bby,
            "library_ms": median_ms(lambda: torch.softmax(logit, -1),
                                    flush),
            "library_form": "torch.softmax(chunk, -1)"}
        log(f"fused-ce kernels {label}: against plain, forward {fwd} "
            f"(with bias and 100 ignored rows {checks['fwd bias']}), "
            f"backward {bwd} ({checks['bwd bias']})")
        for name in ("ce_chunk_fwd", "ce_chunk_bwd"):
            r = rows[(name, c)]
            biased = (f", with the bias {r['bias_ms']:.4f} ms"
                      if "bias_ms" in r else "")
            log(f"  {name} {label}: {r['ms']:.4f} ms{biased}, plain "
                f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
                f"{r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}% of "
                f"it), {r['library_form']} {r['library_ms']:.4f}")
        del logit, work
    per_step = {name: sum(rows[(name, c)]["ms"] for _, c in
                          ce_chunk_shapes(cfg))
                for name in ("ce_chunk_fwd", "ce_chunk_bwd")}
    log(f"fused-ce kernels, one step's {len(ce_chunk_shapes(cfg))} chunks: "
        + ", ".join(f"{k} {t:.4f} ms" for k, t in per_step.items()))
    del flush
    return rows


def _grads_of_one_step(cfg, dev, b, s, seed):
    """The gradients of one TrainStep from the seeded weights."""
    model, step, ids, labels = _train_setup(cfg, dev, b, s, seed)
    bench_step(step, cfg, ids, labels)
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def phase_recompute_bits(cfg, dev, seed, b=TRAIN_B, s=TRAIN_S):
    """Phase 23's check: one step's gradients with ``recompute`` on the
    card bit-identical to the same step without it (GPT-125M width, 2
    layers, bench's batch)."""
    import dataclasses

    small = dataclasses.replace(cfg, num_layers=2, recompute=False)
    plain = _grads_of_one_step(small, dev, b, s, seed)
    remat = _grads_of_one_step(dataclasses.replace(small, recompute=True),
                               dev, b, s, seed)
    differ = [n for n, g in plain.items() if not torch.equal(g, remat[n])]
    log(f"train {cfg.dtype} recompute, 2 layers, b{b} s{s}: gradients of "
        f"{len(plain) - len(differ)} of {len(plain)} parameters "
        f"bit-identical to the step without recompute")
    if differ:
        raise AssertionError(f"recompute changed the gradients of {differ}")


def _schedule():
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)

    return LinearWarmup(CosineAnnealingDecay(LR, T_max=SCHED_T_MAX),
                        SCHED_WARMUP, 0.0, LR)


def _scheduled_setup(cfg, device, b, s, seed):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    sched = _schedule()
    model, step, ids, labels = _train_setup(
        cfg, device, b, s, seed, lr=sched,
        grad_clip=ClipGradByGlobalNorm(1.0))
    return sched, model, step, ids, labels


def phase_train_schedule_clip(cfg, dev, seed, steps=5, b=TRAIN_B,
                              s=TRAIN_S):
    """Phase 24: ``cfg`` with ``LinearWarmup(CosineAnnealingDecay)`` from
    lr 0 and ``ClipGradByGlobalNorm(1.0)``, ``steps`` steps: the lr each
    launch read is the schedule's (fp32) and the step at lr 0 leaves
    every weight as it was while every later one moves them; the
    clipped gradients' global norm; step ms (the steps after the first),
    peak memory, launch counts."""
    sched, _, step, ids, labels = _scheduled_setup(cfg, dev, b, s, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_launch_counts()
    out = {"losses": [], "step_ms": [], "lr": [], "lr_read": [],
           "clipped_norm": [], "moved": []}
    for _ in range(steps):
        before = [p.clone() for p in step.updater._flat_p.values()]
        t0 = time.perf_counter()
        loss = float(bench_step(step, cfg, ids, labels))
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(loss)
        out["lr"].append(float(torch.tensor(sched(), dtype=torch.float32)))
        out["lr_read"].append(float(step.updater._lr[2]))
        out["clipped_norm"].append(float(torch.sqrt(sum(
            g.float().square().sum() for g in step.updater.flat_grads()))))
        out["moved"].append(sum(not torch.equal(a, p) for a, p in zip(
            before, step.updater._flat_p.values())))
        del before
        sched.step()
    counts = train_launch_counts()
    out.update(step_ms_median=statistics.median(out["step_ms"][1:]),
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               buckets=len(step.buckets), launches=counts)
    log(f"train {cfg.dtype}{_variant(cfg)}, schedule + clip "
        + json.dumps(out))
    if out["lr_read"] != out["lr"]:
        raise AssertionError(f"the update read lr {out['lr_read']}, the "
                             f"schedule gave {out['lr']}")
    want_moved = [0 if lr == 0.0 else len(step.buckets) for lr in out["lr"]]
    if out["moved"] != want_moved or out["lr"][0] != 0.0:
        raise AssertionError(f"buckets moved {out['moved']} at lr "
                             f"{out['lr']}, expected {want_moved}")
    # at most 1, but for the scale's rounding to bf16 (2^-9 relative)
    if not all(n <= 1.0 + 2.0 ** -8 for n in out["clipped_norm"]):
        raise AssertionError(f"clipped global norms {out['clipped_norm']}")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"non-finite loss: {out['losses']}")
    want = {k: 0 for k in counts}
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        want[name + "_bf16"] = cfg.num_layers * steps
    want["fused_update"] = steps
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    phase_train_profile(lambda: bench_step(step, cfg, ids, labels),
                        names=BF16_KERNELS, tag=_variant(cfg), top=5)
    return out


def _scheduled_two_steps(cfg, device, b, s, seed):
    """Two scheduled, clipped steps from the seeded weights: per step the
    loss, the lr and, per parameter, (before, after, gradient) on the
    CPU."""
    sched, model, step, ids, labels = _scheduled_setup(cfg, device, b, s,
                                                       seed)
    out = []
    for _ in range(2):
        before = {n: p.detach().cpu().clone()
                  for n, p in model.named_parameters()}
        loss = float(bench_step(step, cfg, ids, labels))
        # copies: on the CPU .cpu() is the live parameter and gradient
        out.append((loss, sched(), {n: (before[n], p.detach().cpu().clone(),
                                        p.grad.cpu().clone())
                                    for n, p in model.named_parameters()}))
        sched.step()
    return out


def phase_schedule_clip_parity(cfg, dev, seed):
    """Phase 24's parity: two scheduled, clipped steps on the card and on
    the CPU (GPT-125M width, 2 layers, b2 s128): each loss within
    ``BF16_LOSS_RTOL``; the first step, at lr 0, leaves every weight as
    it was on both; the second, from the same weights and (as the batch
    and weights are the same) the same gradients, within
    ``bf16_step_parity`` at its lr."""
    import dataclasses

    from torch_checks import BF16_LOSS_RTOL, bf16_step_parity, same_bits

    small = dataclasses.replace(cfg, num_layers=2)
    card = _scheduled_two_steps(small, dev, 2, 128, seed + 2)
    cpu = _scheduled_two_steps(small, "cpu", 2, 128, seed + 2)
    for i, ((cl, lr, cs), (pl, _, ps)) in enumerate(zip(card, cpu)):
        rel = abs(cl - pl) / abs(pl)
        log(f"train {cfg.dtype} schedule + clip card vs CPU, step {i} (lr "
            f"{lr:.3e}): loss {cl:.7f} vs {pl:.7f} (rel {rel:.2e}, limit "
            f"{BF16_LOSS_RTOL:.0e})")
        if not rel <= BF16_LOSS_RTOL:
            raise AssertionError("card and CPU losses differ")
        if lr == 0.0:
            still = all(same_bits(b0, b1) for side in (cs, ps)
                        for b0, b1, _ in side.values())
            if not still:
                raise AssertionError("a weight moved at lr 0")
            continue
        r = bf16_step_parity(cs, ps, lr)
        log(f"  bf16_step_parity: gradients within {r['grad_rtol']:.2e} of "
            f"each tensor's largest, {100 * r['clear_share']:.1f}% clear, "
            f"{100 * r['differ_share']:.3f}% of elements differ")


# ------------------------------------------------ BERT under amp
BERT_B, BERT_S = 16, 512            # measure_bert's batch on the accelerator
BERT_LR = 1e-4
BERT_WARMUP, BERT_STEPS = 3, 10     # measure_bert's warm-up and timed steps
# the query and key projections' gradients, card vs CPU, of each tensor's
# largest (phase 26): read 2.9e-2 at BERT-base width, 2 layers, b2 s128,
# on an NVIDIA H100 80GB HBM3 at 700 W
QK_GRAD_RTOL = 5e-2


def _bert_train_setup(cfg, device, b, s, seed, terms=None):
    """``bench.py``'s ``measure_bert`` (``bench.py:701-765``) for ``cfg``:
    BertForPretraining from seed 0, AdamW(1e-4), TrainStep with the MLM
    loss plus the NSP cross-entropy (the reference's op "add"), and a
    batch from ``RandomState(seed)``: ids, 15% of the positions masked
    (the MLM labels, -1 elsewhere), NSP labels; on ``device``. With a
    list ``terms``, each step's loss terms (MLM, NSP) are appended."""
    from paddle_tpu_torch import tensor as T
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import BertForPretraining
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    def loss_fn(mlm_loss, nsp_logits, nsp_lbl):
        nsp = F.cross_entropy(nsp_logits, nsp_lbl)
        if terms is not None:
            terms.append((mlm_loss.detach(), nsp.detach()))
        return T.add(mlm_loss, nsp)

    model = BertForPretraining(cfg, seed=0, device=device)
    step = TrainStep(model, loss_fn,
                     AdamW(learning_rate=BERT_LR,
                           parameters=model.parameters()))
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size, (b, s))
    mlm = np.where(rs.rand(b, s) < 0.15, ids, -1)
    nsp = rs.randint(0, 2, (b,))
    batch = tuple(torch.as_tensor(a, dtype=torch.long, device=device)
                  for a in (ids, mlm, nsp))
    return model, step, batch


def bert_step(step, batch):
    """One step as ``measure_bert``'s ``one_step`` calls it: under
    ``auto_cast(level="O2", dtype="bfloat16")``, inputs ``(ids, None,
    None, None, mlm)``, labels ``(nsp,)``."""
    from paddle_tpu_torch.amp import auto_cast

    ids, mlm, nsp = batch
    with auto_cast(level="O2", dtype="bfloat16"):
        return step(inputs=(ids, None, None, None, mlm), labels=(nsp,))


def phase_bert_train(cfg, dev, seed, warmup=BERT_WARMUP, steps=BERT_STEPS,
                     b=BERT_B, s=BERT_S):
    """Phase 25: ``measure_bert``'s step for ``cfg``: ``warmup`` then
    ``steps`` timed steps, launch counts reset just before them and read
    just after (each bf16 flash kernel once a layer, one fused update,
    the chunk kernels once a chunk with ``fused_loss_chunk``). Returns
    the counts, the step, the batch and the summary."""
    _, step, batch = _bert_train_setup(cfg, dev, b, s, seed)
    tag = _variant(cfg)
    log(f"bert train: {sum(bk.size for bk in step.buckets)} parameters in "
        f"{len(step.buckets)} buckets, {cfg.num_layers} layers, O2 "
        f"bfloat16{tag}, batch {b} x {s}, AdamW lr {BERT_LR}")
    losses = [float(bert_step(step, batch)) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_launch_counts()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(bert_step(step, batch)))   # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = train_launch_counts()
    med = statistics.median(step_ms)
    summary = {"losses": losses, "step_ms": step_ms, "step_ms_median": med,
               "samples_per_s": b / (med / 1e3),
               "tokens_per_s": b * s / (med / 1e3),
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
               "buckets": len(step.buckets), "launches": counts}
    log(f"bert train O2{tag} " + json.dumps(summary))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite BERT loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"BERT loss did not fall: {losses}")
    want = {k: 0 for k in counts}
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        want[name + "_bf16"] = cfg.num_layers * steps
    want["fused_update"] = steps
    want["ce_chunk_fwd"] = want["ce_chunk_bwd"] = loss_chunks(cfg) * steps
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    return counts, step, batch, summary


def phase_bert_train_kernels(dev, gen, buckets, cfg_ce):
    """Phase 25's kernels at its shapes: the bf16 flash trio in full mode
    at [16, 12, 512, 64], checked and timed as phase 16 times them; the
    fused update over BERT's fp32 plan (``buckets``), as phase 6's; the
    chunk kernels at BERT's chunk widths (8192 and the ragged 5946 of
    30,522 at chunk 8192), as phase 21's."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows = _flash_case(dev, gen, FLASH_BERT, False, True, flush,
                       torch.bfloat16)
    fused = _fused_timing(dev, gen, buckets, flush)
    rows["fused_update"] = fused
    log(f"fused_update, BERT-base's {fused['shape']}, one launch: as "
        f"FusedFlatUpdater.step() calls it {fused['step_ms']:.4f} ms, the "
        f"kernel alone {fused['ms']:.4f}, torch._fused_adamw_ "
        f"{fused['library_ms']:.4f}; plain {fused['plain_ms']:.4f}; bound "
        f"{fused['bound_ms']:.4f} {fused['bound_by']}, the kernel at "
        f"{100 * fused['bound_ms'] / fused['ms']:.1f}% of it")
    del flush
    ce = phase_fused_ce_kernels(dev, gen, cfg_ce, tokens=BERT_B * BERT_S)
    return rows, ce


def phase_bert_train_parity(dev, seed, b=2, s=128):
    """Phase 26: one O2 step on the card and one on the CPU at BERT-base
    width with 2 layers, b2 s128, from the same weights and batch. The
    CPU side takes the flash route's plain versions (``flash_route``:
    the card's attention is the flash kernels, fp32 softmax inside; the
    CPU's default, the reference's plain route, runs its softmax in
    bf16 under O2). The loss (bf16 under O2: the final "add" casts)
    within ``BF16_LOSS_RTOL``, its fp32 terms logged; then
    ``bf16_step_parity``: the query and key projections, whose gradient
    comes only through dS (which the bf16 kernels round before dQ = dS K
    and dK = dS^T Q, and which at initialisation, near-uniform scores, is
    a small difference of larger terms), with gradients within
    ``QK_GRAD_RTOL`` of each tensor's largest, every other parameter at
    its default 2e-2; the key biases apart, their gradient zero in exact
    arithmetic (softmax is invariant to adding one value to a row of
    scores, and ``q . b_k`` is one value a row): on both devices it is
    rounding noise, held below 1e-2 of the gradient of its layer's key
    weight."""
    import dataclasses

    from torch_checks import BF16_LOSS_RTOL, bf16_step_parity

    from paddle_tpu_torch.models import bert_presets
    from paddle_tpu_torch.nn.functional import flash_route

    cfg = dataclasses.replace(bert_presets("bert-base"), num_layers=2)

    def one(device):
        terms = []
        model, step, batch = _bert_train_setup(cfg, device, b, s, seed + 4,
                                               terms)
        before = {n: p.detach().cpu().clone()
                  for n, p in model.named_parameters()}
        with flash_route(device == "cpu"):
            loss = float(bert_step(step, batch))
        return loss, [float(t) for t in terms[0]], {
            n: (before[n], p.detach().cpu().clone(), p.grad.cpu().clone())
            for n, p in model.named_parameters()}

    card_loss, card_terms, card = one(dev)
    cpu_loss, cpu_terms, cpu = one("cpu")
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    log(f"bert train O2 card vs CPU (bert-base width, 2 layers, b{b} "
        f"s{s}): loss {card_loss:.7f} vs {cpu_loss:.7f} (rel {rel:.2e}, "
        f"limit {BF16_LOSS_RTOL:.0e}); fp32 terms MLM "
        f"{card_terms[0]:.7f} vs {cpu_terms[0]:.7f}, NSP "
        f"{card_terms[1]:.7f} vs {cpu_terms[1]:.7f}")
    if not rel <= BF16_LOSS_RTOL:
        raise AssertionError("card and CPU BERT losses differ beyond "
                             f"{BF16_LOSS_RTOL:.0e}")
    keys = [n for n in cpu if n.endswith("k_proj.bias")]
    noise = {}
    for n in keys:
        w = n[:-len("bias")] + "weight"
        for side, d in (("card", card), ("cpu", cpu)):
            noise[f"{n} {side}"] = float(d[n][2].abs().max()
                                         / d[w][2].abs().max())
    qk = [n for n in cpu if n not in keys
          and (".q_proj." in n or ".k_proj." in n)]
    rest = [n for n in cpu if n not in keys and n not in qk]
    r = bf16_step_parity({n: card[n] for n in rest},
                         {n: cpu[n] for n in rest}, BERT_LR)
    r_qk = bf16_step_parity({n: card[n] for n in qk},
                            {n: cpu[n] for n in qk}, BERT_LR,
                            grad_rtol=QK_GRAD_RTOL)
    log(f"bert train O2 card vs CPU after one AdamW step: gradients within "
        f"{r['grad_rtol']:.2e} of each tensor's largest (limit 2e-2), the "
        f"query and key projections' within {r_qk['grad_rtol']:.2e} (limit "
        f"{QK_GRAD_RTOL:.0e}); on the "
        f"{100 * r['clear_share']:.1f}% and {100 * r_qk['clear_share']:.1f}% "
        f"of elements whose gradient is clear of the noise, every step "
        f"within 1e-2 lr of the CPU's; max |param diff| "
        f"{max(r['param_max_abs_diff'], r_qk['param_max_abs_diff']):.3e}; "
        f"key-bias gradient over its key weight's: "
        + ", ".join(f"{k} {v:.2e}" for k, v in noise.items()))
    if not all(v < 1e-2 for v in noise.values()):
        raise AssertionError(f"key-bias gradients above the noise: {noise}")


# ------------------------------------------------------------ inference
def _quant_module():
    # ``paddle_tpu_torch.ops`` exports the function ``quant_matmul`` under
    # the module's name
    import importlib

    return importlib.import_module("paddle_tpu_torch.ops.quant_matmul")


def _quant_case(dev, gen, shape, launches, flush):
    from torch_checks import quantize_vs_plain

    qm = _quant_module()
    k, n = shape
    w = torch.randn(k, n, device=dev, generator=gen) * 0.02
    w[:, n // 2] = 0.0                                 # scale floor
    err = max(quantize_vs_plain(w, st, seed)
              for st, seed in ((False, 0), (True, 0), (True, 12345)))
    q, sc = qm.quantize_int8(w)
    zp = torch.zeros(n, dtype=torch.long, device=dev)
    lib = torch.quantize_per_channel(w, sc[0], zp, 1, torch.qint8)
    differ = int((lib.int_repr() != q).sum())
    # read w once, write q and the scales; abs, max, divide, round, clamp
    bound_ms, bound_by = work_bound(5 * k * n + 4 * n, 6 * k * n)
    r = {"shape": f"[{k}, {n}]", "launches_at_shape": launches,
         "max_abs_err": err,
         "ms": median_ms(lambda: qm.quantize_int8(w), flush),
         "plain_ms": median_ms(lambda: qm.quantize_int8_plain(w), flush),
         "library_ms": median_ms(lambda: torch.quantize_per_channel(
             w, sc[0], zp, 1, torch.qint8), flush),
         "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"quantize_int8 [{k}, {n}] ({launches} at conversion): "
        f"bit-identical to plain, nearest and stochastic | {r['ms']:.4f} ms "
        f"(plain {r['plain_ms']:.4f}, quantize_per_channel without the amax "
        f"pass {r['library_ms']:.4f} with {differ} of {k * n} values "
        f"differing, bound {bound_ms:.4f} {bound_by})")
    return r


def _qmm_case(dev, gen, mkn, launches, flush):
    from torch_checks import (QMM_SPLIT_CEILING, QMM_SPLIT_MIN_K, qmm_limit,
                              qmm_vs_plain)
    from paddle_tpu_torch.ops.tf32 import tf32_rna

    qm = _quant_module()
    m, k, n = mkn
    x = torch.randn(m, k, device=dev, generator=gen)
    q, sc = qm.quantize_int8(torch.randn(k, n, device=dev, generator=gen)
                             * 0.02)
    err, ratio = qmm_vs_plain(x, q, sc)
    control = ""
    if k >= QMM_SPLIT_MIN_K:    # what the ceiling tells the split from
        ref = qm.quant_matmul_plain(x, q, sc).double()
        one = ((tf32_rna(x) @ q.float()) * sc).double()
        over = (one - ref).abs() / qmm_limit(x, q, sc)
        control = (f" (ceiling {QMM_SPLIT_CEILING}; 1xTF32 x reads "
                   f"{float(over.max()):.4f})")
        del ref, one, over
    w = q.float() * sc                      # the fp32 weight it replaces
    # read x, q and the scales once, write the output; 2 m n k
    bounds = both_bounds(4 * m * k + k * n + 4 * n + 4 * m * n,
                         2 * m * n * k, TF32_PASSES["quant_matmul"])
    r = {"shape": f"({m}, {k}, {n})", "launches_at_shape": launches,
         "max_abs_err": err, "err_over_limit": ratio,
         "ms": median_ms(lambda: qm.quant_matmul(x, q, sc), flush),
         "plain_ms": median_ms(lambda: qm.quant_matmul_plain(x, q, sc),
                               flush),
         "library_ms": median_ms(lambda: torch.matmul(x, w), flush),
         **bounds}
    log(f"quant_matmul {r['shape']} ({launches} in the timed forwards): "
        f"max abs diff "
        f"{err:.3e}, at most {ratio:.4f} of the limit{control} | "
        f"{r['ms']:.4f} ms "
        f"({2 * m * n * k / r['ms'] / 1e9:.2f} fp32-equivalent TFLOP/s; "
        f"plain {r['plain_ms']:.4f}, fp32 torch.matmul "
        f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
        f"{r['bound_by']} at 2 TF32 passes, fp32 SIMT bound "
        f"{r['bound_simt_ms']:.4f} {r['bound_simt_by']})")
    return r


def phase_infer_kernels(dev, gen, shapes):
    """Each int8 kernel at every shape that phase 10 counted (``shapes``,
    most launched first) and at a ragged one."""
    import torch.nn.functional as F
    from torch_checks import flash_fwd_vs_plain

    from paddle_tpu_torch.ops import flash_attention as fa

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    quant = [*shapes["quantize_int8"].most_common(), (RAGGED_QUANT, 0)]
    qmm = [*shapes["quant_matmul"].most_common(), (RAGGED_QMM, 0)]
    rows = {"quantize_int8": [_quant_case(dev, gen, shape, n, flush)
                              for shape, n in quant],
            "quant_matmul": [_qmm_case(dev, gen, mkn, n, flush)
                             for mkn, n in qmm]}
    conv = [r for r in rows["quantize_int8"] if r["launches_at_shape"]]
    log(f"quantize_int8, one conversion: "
        f"{sum(r['launches_at_shape'] * r['ms'] for r in conv):.4f} ms over "
        f"{sum(r['launches_at_shape'] for r in conv)} launches ("
        + ", ".join(f"{r['launches_at_shape']} x {r['ms']:.4f} at "
                    f"{r['shape']}" for r in conv)
        + f"), bound {sum(r['launches_at_shape'] * r['bound_ms'] for r in conv):.4f} ms")
    q, k, v = (torch.randn(*FLASH_BERT, device=dev, generator=gen)
               for _ in range(3))
    errs, _, _ = flash_fwd_vs_plain(q, k, v, False)
    r = {"shape": f"{list(FLASH_BERT)} full",
         "max_abs_err": max(e for e, _ in errs.values()),
         "ms": median_ms(lambda: fa.flash_fwd(q, k, v, False), flush),
         "plain_ms": median_ms(lambda: fa.flash_fwd_plain(q, k, v, False),
                               flush),
         "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
             q, k, v), flush),
         **both_bounds(*flash_work(FLASH_BERT, False, "flash_fwd"),
                       TF32_PASSES["flash_fwd"])}
    rows["flash_fwd"] = r
    log(f"flash_fwd {r['shape']}: max abs diff "
        + ", ".join(f"{n} {e:.2e} ({r:.3f} of its limit)"
                    for n, (e, r) in errs.items())
        + f" | {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, SDPA "
          f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
          f"{r['bound_by']} at 3 TF32 passes, fp32 SIMT bound "
          f"{r['bound_simt_ms']:.4f})")
    del flush
    return rows


def _qmm_bf16_case(dev, gen, mkn, launches, flush):
    """``quant_matmul`` on bf16 ``x`` (the ``quant_matmul_bf16`` kernel)
    at ``mkn`` against its plain version, timed beside it, its bound
    (bytes at 3.35 TB/s, operations at 989 TFLOP/s bf16) and a like
    yardstick: ``torch.matmul`` on the bf16 ``x`` and the weight
    dequantized to bf16, at the port's GEMM settings (no reduced-precision
    reduction)."""
    from torch_checks import qmm_bf16_vs_plain

    from paddle_tpu_torch.framework.precision import matmul_precision

    qm = _quant_module()
    m, k, n = mkn
    x = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
    q, sc = qm.quantize_int8(torch.randn(k, n, device=dev, generator=gen)
                             * 0.02)
    err, ratio = qmm_bf16_vs_plain(x, q, sc)
    w = (q.float() * sc).to(torch.bfloat16)
    # read x (bf16), q and the scales once, write the bf16 output; 2 m n k
    bound_ms, bound_by = work_bound(2 * m * k + k * n + 4 * n + 2 * m * n,
                                    2 * m * n * k, bf16=True)
    with matmul_precision("float32"):
        library_ms = median_ms(lambda: torch.matmul(x, w), flush)
    r = {"shape": f"({m}, {k}, {n}) bf16", "launches_at_shape": launches,
         "bf16_route": qm.bf16_route(x, q),
         "max_abs_err": err, "err_over_limit": ratio,
         "ms": median_ms(lambda: qm.quant_matmul(x, q, sc), flush),
         "plain_ms": median_ms(lambda: qm.quant_matmul_plain(x, q, sc),
                               flush),
         "library_ms": library_ms, "library_form":
         "torch.matmul(x bf16, dequantized weight bf16)",
         "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"quant_matmul_bf16 {r['shape']} ({launches} in the timed "
        f"forwards, {r['bf16_route']} route): max abs diff {err:.3e}, at most {ratio:.4f} of the "
        f"limit | {r['ms']:.4f} ms ({2 * m * n * k / r['ms'] / 1e9:.2f} "
        f"TFLOP/s; plain {r['plain_ms']:.4f}, bf16 torch.matmul "
        f"{library_ms:.4f}, bound {bound_ms:.4f} {bound_by}, the kernel at "
        f"{100 * bound_ms / r['ms']:.1f}% of it)")
    return r


def phase_infer_kernels_bf16(dev, gen, shapes):
    """Phase 27's kernel rows: ``quant_matmul_bf16`` at every shape the
    O2 forwards launched it at (``shapes``, most launched first) and at a
    ragged one a route (k % 8 != 0, n % 16 != 0: element loads; at m > 64
    the mma.sync route)."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows = [_qmm_bf16_case(dev, gen, mkn, n, flush)
            for mkn, n in [*shapes.most_common(), (RAGGED_QMM, 0),
                           (RAGGED_QMM_SMALL, 0)]]
    del flush
    return rows


def _at_rest_bytes(model) -> int:
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))


def infer_launch_counts() -> dict:
    """Launches since the last reset: totals, and the int8 kernels' by
    shape (``"shapes"``)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    qm = _quant_module()
    flash = fa.launch_counts()
    return {**qm.launch_counts(), "flash_fwd": flash["flash_fwd"],
            "flash_fwd_bf16": flash["flash_fwd_bf16"],
            "shapes": qm.shape_counts(), "routes": qm.route_counts()}


def reset_infer_launch_counts() -> None:
    from paddle_tpu_torch.ops import flash_attention as fa

    _quant_module().reset_launch_counts()
    fa.reset_launch_counts()


def _converted(model) -> None:
    """No Linear left; every Int8Linear holds an int8 weight."""
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.quantization import Int8Linear

    mods = list(model.modules())
    if any(isinstance(m, Linear) for m in mods):
        raise AssertionError("a Linear with an fp32 weight is left")
    if any(m.qweight.dtype != torch.int8 for m in mods
           if isinstance(m, Int8Linear)):
        raise AssertionError("an Int8Linear holds a non-int8 weight")


def _bert_batch(cfg, b, s, seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size, (b, s))
    types = np.repeat((np.arange(s)[None] >= s // 2).astype(np.int64), b, 0)
    return ids, types


def amp_int8_split(num_layers: int):
    """(bf16, fp32) ``quant_matmul`` launches of one int8 BERT forward
    under O2, as the reference gives them: bf16 ``x`` for the first
    layer's q/k/v (fed by the embeddings' dropout, a cast point), every
    out_proj and linear2 (fed by a reshape or gelu, cast points), the
    pooler and the NSP head; fp32 for the layers fed by a ``layer_norm``
    (the later q/k/v, every linear1, the transform)."""
    return 2 * num_layers + 5, 4 * num_layers - 2


def phase_infer(dev, seed, warmup=2, iters=5, b=INFER_B, s=INFER_S,
                cfg=None, level=None):
    """Phase 10 (``level`` None) and phase 27 (``level="O2"``: the
    forwards under ``auto_cast(level="O2")``)."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.models import BertForPretraining, bert_presets
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.quantization import convert_to_int8

    cfg = cfg or bert_presets("bert-base")
    t0 = time.perf_counter()
    model = BertForPretraining(cfg, seed=0, device=dev).eval()
    build_s = time.perf_counter() - t0
    before = _at_rest_bytes(model)
    linears = [m for m in model.modules() if isinstance(m, Linear)]
    linear_bytes = sum(_at_rest_bytes(m) for m in linears)
    weights = Counter(tuple(m.weight.shape) for m in linears)
    torch.cuda.synchronize()
    reset_infer_launch_counts()
    t0 = time.perf_counter()
    convert_to_int8(model)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    conversion = infer_launch_counts()
    _converted(model)
    after = _at_rest_bytes(model)
    torch.cuda.empty_cache()
    if conversion["shapes"]["quantize_int8"] != weights:
        raise AssertionError(f"conversion launched {conversion} for Linear "
                             f"weights {dict(weights)}")
    ids, types = _bert_batch(cfg, b, s, seed)
    ids = torch.as_tensor(ids, device=dev)
    types = torch.as_tensor(types, device=dev)
    with torch.inference_mode(), auto_cast(enable=level is not None,
                                           level=level or "O1"):
        for _ in range(warmup):
            model(ids, types)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_infer_launch_counts()
        fwd_ms = []
        for _ in range(iters):
            t0 = time.perf_counter()
            logits, nsp = model(ids, types)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
        counts = infer_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(fwd_ms)
    per_forward = Counter()            # (k, n) -> launches per forward
    for (m, k, n), c in (counts["shapes"]["quant_matmul"]
                         + counts["shapes"]["quant_matmul_bf16"]).items():
        per_forward[(k, n)] += c / iters
        if m not in (b * s, b):
            per_forward["m not b * s or b"] += c
    summary = {"build_s": build_s, "convert_s": convert_s,
               "forward_ms": fwd_ms, "forward_ms_median": med,
               "samples_per_s": b / (med / 1e3),
               "tokens_per_s": b * s / (med / 1e3),
               "peak_memory_gib": peak, "weight_bytes_fp32": before,
               "weight_bytes_int8": after,
               "linear_weight_bytes_fp32": linear_bytes,
               "conversion_launches": _named(conversion),
               "launches": _named(counts)}
    tag = f" {level}" if level else ""
    log(f"infer{tag} " + json.dumps(summary))
    # under O2 the MLM logits are bf16 ("mlm_logits" casts) and the NSP
    # head's fp32 (the int8 layer adds its fp32 bias by promotion)
    want_dt = torch.bfloat16 if level == "O2" else torch.float32
    if tuple(logits.shape) != (b, s, cfg.vocab_size) or \
            tuple(nsp.shape) != (b, 2) or logits.dtype != want_dt or \
            nsp.dtype != torch.float32:
        raise AssertionError(f"logits {tuple(logits.shape)} {logits.dtype}, "
                             f"nsp {tuple(nsp.shape)} {nsp.dtype}")
    if not (torch.isfinite(logits).all() and torch.isfinite(nsp).all()):
        raise AssertionError("non-finite logits")
    if level == "O2":
        n16, n32 = amp_int8_split(cfg.num_layers)
        want = {"quantize_int8": 0, "quant_matmul": n32 * iters,
                "quant_matmul_bf16": n16 * iters, "flash_fwd": 0,
                "flash_fwd_bf16": cfg.num_layers * iters}
    else:
        want = {"quantize_int8": 0, "quant_matmul": len(linears) * iters,
                "quant_matmul_bf16": 0, "flash_fwd": cfg.num_layers * iters,
                "flash_fwd_bf16": 0}
    # the bf16 form's routes by m: the cluster route for the pooler and the
    # NSP head at m = b, and at m = b * s where that is at most 64; else
    # wgmma
    want_routes = Counter()
    if level == "O2":
        want_routes["cluster" if b * s <= 64 else "wgmma"] += (n16 - 2) * iters
        want_routes["cluster"] += 2 * iters
    got = {k: counts[k] for k in want}
    if got != want or per_forward != weights or \
            counts["routes"] != want_routes:
        raise AssertionError(f"launch counts {got}, expected {want}; per "
                             f"forward by weight {dict(per_forward)}, "
                             f"expected {dict(weights)}; routes "
                             f"{dict(counts['routes'])}, expected "
                             f"{dict(want_routes)}")
    del logits, nsp
    return conversion, counts, model, (ids, types), summary


def _named(counts) -> dict:
    """Launch counts with the by-shape keys as strings, for JSON."""
    return {**counts, "shapes": {name: {str(k): n for k, n in c.items()}
                                 for name, c in counts["shapes"].items()}}


def phase_infer_profile(model, batch, level=None, tag=""):
    """One forward profiled: device busy and idle shares, the top kernels
    and the int8 and flash kernels' shares. Returns (busy us, {kernel
    name: device us})."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.amp import auto_cast

    with torch.inference_mode(), auto_cast(enable=level is not None,
                                           level=level or "O1"):
        model(*batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(*batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    tag = "".join(f" {t}" for t in (level, tag) if t)
    log(f"infer profile{tag}: one forward, wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}% busy, "
        f"{100 * (1 - busy_us / wall_us):.1f}% idle), "
        f"{sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
            f"{100 * e.self_device_time_total / busy_us:5.1f}% "
            f"{e.count:5d}x  {e.key[:90]}")
    split = {}
    for name in ("qmm_kernel", "qmm_wgmma_kernel", "qmm_bf16_kernel",
                 "qmm_cluster_kernel", "fwd_kernel", "fwd_bf16_kernel"):
        t = sum(e.self_device_time_total for e in kernels if name in e.key)
        split[name] = t
        log(f"  share of the forward's device time, {name}: "
            f"{100 * t / busy_us:.1f}% ({t / 1e3:.3f} ms)")
    return busy_us, split


def _parity_run(cfg, device, ids, types):
    from paddle_tpu_torch.models import BertForPretraining
    from paddle_tpu_torch.quantization import Int8Linear, convert_to_int8

    model = BertForPretraining(cfg, seed=0, device=device).eval()
    with torch.inference_mode():
        fp32 = model(ids, types)[0].cpu()
        convert_to_int8(model)
        logits, nsp = (t.cpu() for t in model(ids, types))
    payloads = {n: (m.qweight.cpu(), m.scales.cpu())
                for n, m in model.named_modules() if isinstance(m, Int8Linear)}
    return fp32, logits, nsp, payloads


def phase_infer_parity(dev, seed):
    import dataclasses

    from paddle_tpu_torch.models import bert_presets

    cfg = dataclasses.replace(bert_presets("bert-base"), num_layers=2)
    ids, types = _bert_batch(cfg, 2, 128, seed + 3)
    card_fp32, card, card_nsp, card_q = _parity_run(cfg, dev, ids, types)
    _, cpu, cpu_nsp, cpu_q = _parity_run(cfg, "cpu", ids, types)
    if list(card_q) != list(cpu_q) or len(cpu_q) != 15:
        raise AssertionError("card and CPU converted other layers")
    differ = [n for n, (q, s) in cpu_q.items()
              if not (torch.equal(card_q[n][0], q)
                      and torch.equal(card_q[n][1], s))]
    err = float((card - cpu).abs().max())
    nsp_err = float((card_nsp - cpu_nsp).abs().max())
    rel = float((card - card_fp32).abs().mean() / card_fp32.abs().mean())
    log(f"infer card vs CPU (bert-base width, 2 layers, b2 s128): int8 "
        f"payloads of {len(cpu_q)} layers identical: {not differ}; max "
        f"|logit diff| MLM {err:.3e} NSP {nsp_err:.3e} (limit {INFER_TOL}, "
        f"largest |logit| {float(cpu.abs().max()):.3f}); int8 vs fp32 on "
        f"the card {rel:.4f} mean relative error (limit 0.05)")
    if differ:
        raise AssertionError(f"int8 payloads differ: {differ}")
    if not (err <= INFER_TOL and nsp_err <= INFER_TOL):
        raise AssertionError("card and CPU logits differ beyond 1e-4")
    if not rel < 0.05:
        raise AssertionError(f"int8 logits {rel:.4f} from fp32")


# ---------------------------------------------------- data parallel
DP_B, DP_S = 4, 1024                # per rank: global 8 x 1024 at world 2
DP_WORLD = 2
DP_RANK_TIMEOUT = 480               # seconds for a spawned phase's ranks
DP_BLOCK = 1024                     # GradCommConfig's default block_size
DP16_STEPS = 5                      # timed steps of the dp-train bf16 phase


def _dequant_case(gen, q, scales, kind, n, residual: bool):
    from torch_checks import FUSED_HYPER, dequant_vs_plain, fused_inputs

    p, _, slots, lr = fused_inputs(kind, n, gen, LR)
    res = (torch.randn(n, device=gen.device, generator=gen) * 1e-5
           if residual else None)
    return dequant_vs_plain(p, q, scales, slots, lr, world=DP_WORLD,
                            block_size=DP_BLOCK, kind=kind,
                            hyper=FUSED_HYPER[kind], wd=WD, residual=res)


def _carrier_rows(dev, gen, sizes, flush):
    """codec_encode's carrier form (the gradient wire's encode) timed at
    each bucket size of the plan, int8_block: kernel, plain version and
    the one-call yardstick, torch.quantize_per_channel (the same int8
    values, written one byte wide)."""
    from paddle_tpu_torch.distributed import grad_comm as plain
    from paddle_tpu_torch.ops import codec

    rows = {}
    for n in sorted(set(sizes)):
        nb = -(-n // DP_BLOCK)
        x = torch.randn(n, device=dev, generator=gen) * 1e-3
        s = plain.block_scales(plain.block_absmax(x, DP_BLOCK), "int8_block")
        xb = plain.as_blocks(x, DP_BLOCK)
        zp = torch.zeros(nb, dtype=torch.long, device=dev)
        bound_ms, bound_by = bound(n, nb, "carrier", nb * DP_BLOCK)
        rows[nb] = {
            "shape": f"{nb}x{DP_BLOCK} int8_block carrier (bucket {n})",
            "ms": median_ms(lambda: codec.block_encode(
                x, s, DP_BLOCK, "int8_block", carrier=True), flush),
            "plain_ms": median_ms(lambda: plain.block_encode(
                x, s, DP_BLOCK, "int8_block", carrier=True), flush),
            "library_ms": median_ms(lambda: torch.quantize_per_channel(
                xb, s, zp, 0, torch.qint8), flush),
            "bound_ms": bound_ms, "bound_by": bound_by}
        r = rows[nb]
        log(f"codec_encode carrier {r['shape']}: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, quantize_per_channel "
            f"{r['library_ms']:.4f}, bound {bound_ms:.4f} {bound_by})")
    return rows


def _dequant_table_check(gen, buckets, residual: bool) -> int:
    """One step's ``fused_dequant_update_buckets`` over every bucket of a
    plan (AdamW, its dtypes), each bucket's payload two ranks' gradients
    in the bucket's dtype encoded by codec_encode and summed, two steps
    from non-zero moments, with or without a residual: bit for bit
    against the plain walk. Returns the launches (one a step)."""
    from torch_checks import FUSED_HYPER, buckets_vs_plain, encoded_inputs

    from paddle_tpu_torch.ops import fused_update as fu

    dev = gen.device
    entries = []
    for b in buckets:
        n = b.size
        q, scales, _ = encoded_inputs("int8_block", n, DP_BLOCK, DP_WORLD,
                                      gen, dtype=b.dtype)
        res = (torch.randn(n, device=dev, generator=gen) * 1e-5
               if residual else None)
        p = (torch.randn(n, device=dev, generator=gen) * 0.02).to(b.dtype)
        m1 = torch.randn(n, device=dev, generator=gen) * 1e-4
        m2 = torch.randn(n, device=dev, generator=gen) ** 2 * 1e-6
        entries.append((p, fu.WirePayload(q, scales, res, b.dtype),
                        [m1, m2], WD, 1.0))
    lr = torch.full((), LR, device=dev)
    launches = buckets_vs_plain("adamw", FUSED_HYPER["adamw"], entries, lr,
                                steps=2, world=DP_WORLD,
                                block_size=DP_BLOCK)
    if launches != 2:
        raise AssertionError(f"fused_dequant_update_buckets: {launches} "
                             f"launches for 2 steps of {len(buckets)} "
                             f"buckets")
    return launches


def _dequant_table_row(dev, gen, buckets, flush):
    """One step's dequantizing update over every bucket of a plan, timed:
    as FusedFlatUpdater.step_dequant calls it (table lookup and launch),
    the kernel alone (one fused_dequant_update_buckets launch), the plain
    walk, and the nearest PyTorch composition (each bucket decoded by
    torch.mul into its dtype and divided by the world, then
    torch._fused_adamw_ per dtype, the moments in the parameters' dtype
    as it keeps them); the bound from bytes (q 4, p read and written, the
    moments read and written: 24 bytes a bf16 element, 28 an fp32 one,
    and the scales) and ~22 operations an element."""
    from torch_checks import dequant_inputs

    from paddle_tpu_torch.ops import fused_update as fu

    sizes = [b.size for b in buckets]
    dtypes = [b.dtype for b in buckets]
    upd = bucket_updater(sizes, gen, dtypes)
    pay = [dequant_inputs("int8_block", n, DP_BLOCK, DP_WORLD, gen,
                          dtype=dt) for n, dt in zip(sizes, dtypes)]
    lr = torch.full((), LR, device=dev)
    upd.step_dequant(pay, DP_WORLD, DP_BLOCK)
    table = upd._dequant_table
    builds = upd.table_builds

    def step():
        upd.step_dequant(pay, DP_WORLD, DP_BLOCK)

    def kernel():   # the same powers each time: the updater's state holds
        fu.fused_dequant_update_buckets(table, lr, DP_WORLD)
        table.parity = 1 - table.parity

    def plain():
        fu.buckets_plain(table, lr, DP_WORLD)

    ps = [upd._flat_p[i] for i in range(len(sizes))]
    groups = {}     # dtype -> (params, moments1, moments2, steps, payloads)
    for i, (p, (q, sc)) in enumerate(zip(ps, pay)):
        s = upd._slots[i]
        grp = groups.setdefault(p.dtype, ([], [], [], [], []))
        for lst, t in zip(grp, (p, s["moment1"].to(p.dtype),
                                s["moment2"].to(p.dtype),
                                torch.full((), 4.0, device=dev), (q, sc))):
            lst.append(t)
    world = torch.full((), float(DP_WORLD), device=dev)

    def library():
        for dt, (p_, a_, b_, st_, pq) in groups.items():
            gs = [torch.mul(q, sc[:, None], out=torch.empty(
                q.shape, dtype=dt, device=dev)).view(-1)[:p.numel()]
                .div_(world) for p, (q, sc) in zip(p_, pq)]
            torch._fused_adamw_(p_, gs, a_, b_, [], st_, lr=LR, beta1=0.9,
                                beta2=0.999, weight_decay=WD, eps=1e-8,
                                amsgrad=False, maximize=False)

    n = sum(sizes)
    nb = sum(-(-k // DP_BLOCK) for k in sizes)
    nbytes = sum(k * (4 + 2 * torch.empty((), dtype=dt).element_size() + 16)
                 for k, dt in zip(sizes, dtypes)) + 4 * nb
    bound_ms, bound_by = work_bound(nbytes, 22 * n)
    kinds = sorted({str(dt).split(".")[-1] for dt in dtypes})
    row = {"shape": f"{len(sizes)} buckets, {n} elements (one step, "
                    f"{'/'.join(kinds)})",
           "library_form": "decode by torch.mul, then torch._fused_adamw_ "
                           "per dtype, moments in the parameters' dtype",
           "step_ms": median_ms(step, flush), "ms": median_ms(kernel, flush),
           "plain_ms": median_ms(plain, flush),
           "library_ms": median_ms(library, flush),
           "step_span_ms": span_ms(step, flush),
           "span_ms": span_ms(kernel, flush),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "largest_bucket": max(sizes), "smallest_bucket": min(sizes)}
    if upd.table_builds != builds:
        raise AssertionError(f"step_dequant rebuilt its table "
                             f"{upd.table_builds - builds} times on the "
                             f"same payload buffers")
    log(f"fused_dequant_update_buckets, one step's {row['shape']}, one "
        f"launch, device time (from an idle card): as step_dequant calls "
        f"it {row['step_ms']:.4f} ms ({row['step_span_ms']:.4f}), the "
        f"kernel alone {row['ms']:.4f} ({row['span_ms']:.4f}); plain "
        f"{row['plain_ms']:.4f}; {row['library_form']} "
        f"{row['library_ms']:.4f}; bound {bound_ms:.4f} {bound_by}, the "
        f"kernel at {100 * bound_ms / row['ms']:.1f}% of it; the table "
        f"built once")
    return row


def phase_dp_kernels(dev, gen, buckets):
    """The gradient wire's kernels at every bucket of the GPT-125M plan,
    int8_block and fp8_block: each of two ranks' gradients encoded to
    its carrier by codec_encode, bit for bit against the plain encode;
    their sum fed to fused_dequant_update_flat (a table of one), bit for
    bit against its plain version (AdamW, with and without a residual;
    SGD and Momentum at a ragged size); one step's 18 buckets in one
    fused_dequant_update_buckets launch, bit for bit against the plain
    walk over two steps, residual off and on. Then codec_encode's
    carrier timed at each bucket size, and the one launch over the 18
    buckets timed (``_dequant_table_row``). Returns (the dequant row,
    the carrier rows by block count, each with its largest encode
    error)."""
    from torch_checks import encoded_inputs

    sizes = [b.size for b in buckets]
    err, enc_err = 0.0, {}
    for codec in ("int8_block", "fp8_block"):
        for n in sizes:
            q, scales, e = encoded_inputs(codec, n, DP_BLOCK, DP_WORLD, gen)
            nb = -(-n // DP_BLOCK)
            if codec == "int8_block":
                enc_err[nb] = max(enc_err.get(nb, 0.0), e)
            for residual in (False, True):
                err = max(err, _dequant_case(gen, q, scales, "adamw", n,
                                             residual))
            del q, scales
    for kind in ("sgd", "momentum"):
        q, scales, _ = encoded_inputs("int8_block", 1_000_003, DP_BLOCK,
                                      DP_WORLD, gen)
        err = max(err, _dequant_case(gen, q, scales, kind, 1_000_003, True))
    for residual in (False, True):
        _dequant_table_check(gen, buckets, residual)
    log(f"codec_encode carriers and fused_dequant_update: bit-identical to "
        f"plain on each of the {len(sizes)} AdamW buckets "
        f"({min(sizes)}..{max(sizes)} elements), int8_block and fp8_block, "
        f"two ranks' kernel-encoded carriers summed, residual off and on; "
        f"sgd and momentum at n = 1,000,003; all {len(sizes)} buckets in "
        f"one fused_dequant_update_buckets launch a step, bit-identical to "
        f"the plain walk over 2 steps, residual off and on")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    carrier = _carrier_rows(dev, gen, sizes, flush)
    for nb, r in carrier.items():
        r["max_abs_err"] = enc_err[nb]
    row = _dequant_table_row(dev, gen, buckets, flush)
    row["max_abs_err"] = err
    return row, carrier


def phase_dp_kernels_bf16(dev, gen, buckets):
    """Phase 13's bf16 forms at every bucket of the bf16 plan (9 bf16
    buckets and the fp32 final norm): two ranks' gradients encoded from
    their own dtype by codec_encode, int8_block and fp8_block, bit for
    bit against the plain encode; their summed carriers decoded to the
    bucket's dtype by codec_decode, bit for bit; the plan's one
    fused_dequant_update_buckets launch, bit for bit against the plain
    walk over two steps, residual off and on. Timed: at each bucket the
    carrier encode (against torch.quantize_per_channel on the bucket
    lifted to fp32, which takes no bf16) and the decode (against
    torch.mul into the bucket's dtype); the table as phase 13 times it.
    Returns (encode rows, decode rows, the table row), the rows by block
    count."""
    from torch_checks import encoded_inputs, same_bits

    from paddle_tpu_torch.distributed import grad_comm as plain
    from paddle_tpu_torch.ops import codec

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    enc_rows, dec_rows = {}, {}
    for b in buckets:
        n, dt = b.size, b.dtype
        nb = -(-n // DP_BLOCK)
        isz = torch.empty((), dtype=dt).element_size()
        for codec_name in ("int8_block", "fp8_block"):
            q, scales, e = encoded_inputs(codec_name, n, DP_BLOCK, DP_WORLD,
                                          gen, dtype=dt)
            d = codec.block_decode(q, scales, DP_WORLD, n, dtype=dt)
            d_plain = plain.block_decode(q, scales, DP_WORLD, n, dtype=dt)
            if d.dtype != dt or not same_bits(d, d_plain):
                raise AssertionError(f"codec_decode {codec_name} to {dt} "
                                     f"at {n}: differs from plain")
            if codec_name != "int8_block" or nb in enc_rows:
                continue
            x = (torch.randn(n, device=dev, generator=gen) * 1e-3).to(dt)
            s = plain.block_scales(plain.block_absmax(x, DP_BLOCK),
                                   codec_name)
            xb = plain.as_blocks(x, DP_BLOCK)        # fp32, for the library
            zp = torch.zeros(nb, dtype=torch.long, device=dev)
            enc_bound = work_bound(isz * n + 4 * nb + 4 * nb * DP_BLOCK,
                                   4 * nb * DP_BLOCK)
            dec_bound = work_bound(4 * n + 4 * nb + isz * n, 2 * n)
            out = torch.empty(q.shape, dtype=dt, device=dev)
            shape = f"{nb}x{DP_BLOCK} int8_block carrier ({dt}, bucket {n})"
            enc_rows[nb] = {
                "shape": shape, "max_abs_err": e,
                "ms": median_ms(lambda: codec.block_encode(
                    x, s, DP_BLOCK, codec_name, carrier=True), flush),
                "plain_ms": median_ms(lambda: plain.block_encode(
                    x, s, DP_BLOCK, codec_name, carrier=True), flush),
                "library_ms": median_ms(lambda: torch.quantize_per_channel(
                    xb, s, zp, 0, torch.qint8), flush),
                "library_form": "torch.quantize_per_channel on the bucket "
                                "lifted to fp32 (it takes no bf16)",
                "bound_ms": enc_bound[0], "bound_by": enc_bound[1]}
            dec_rows[nb] = {
                "shape": shape, "max_abs_err": float(
                    (d.float() - d_plain.float()).abs().max()),
                "ms": median_ms(lambda: codec.block_decode(
                    q, scales, DP_WORLD, n, dtype=dt), flush),
                "plain_ms": median_ms(lambda: plain.block_decode(
                    q, scales, DP_WORLD, n, dtype=dt), flush),
                "library_ms": median_ms(lambda: torch.mul(
                    q, scales[:, None], out=out), flush),
                "library_form": f"torch.mul of the carrier by the scales "
                                f"into {dt} (no divide by the world)",
                "bound_ms": dec_bound[0], "bound_by": dec_bound[1]}
            er, dr = enc_rows[nb], dec_rows[nb]
            log(f"bf16 plan bucket {n} ({dt}): codec_encode carrier "
                f"{er['ms']:.4f} ms (plain {er['plain_ms']:.4f}, "
                f"quantize_per_channel on fp32 {er['library_ms']:.4f}, "
                f"bound {er['bound_ms']:.4f} {er['bound_by']}) | "
                f"codec_decode to {dt} {dr['ms']:.4f} ms (plain "
                f"{dr['plain_ms']:.4f}, torch.mul {dr['library_ms']:.4f}, "
                f"bound {dr['bound_ms']:.4f} {dr['bound_by']})")
            del x, xb, out
        del q, scales, d, d_plain
    for residual in (False, True):
        _dequant_table_check(gen, buckets, residual)
    log(f"bf16 plan: codec_encode from each bucket's dtype and codec_decode "
        f"to it bit-identical to plain at all {len(buckets)} buckets, "
        f"int8_block and fp8_block; fused_dequant_update_buckets over the "
        f"plan in one launch a step, bit-identical to the plain walk over "
        f"2 steps, residual off and on")
    row = _dequant_table_row(dev, gen, buckets, flush)
    row["max_abs_err"] = 0.0    # bit for bit: _dequant_table_check
    del flush
    return enc_rows, dec_rows, row


def dp_launch_counts() -> dict:
    """The train phase's counts, the codecs' (the bf16 forms apart: a
    launch from or to bf16 counts under ``codec_encode`` and again under
    ``codec_encode_bf16``) and the dequantizing update's."""
    from paddle_tpu_torch.ops import codec
    from paddle_tpu_torch.ops import fused_update as fu

    return {**train_launch_counts(), **codec.launch_counts(),
            "codec_encode_bf16": codec.block_encode.dtypes[torch.bfloat16],
            "codec_decode_bf16": codec.block_decode.dtypes[torch.bfloat16],
            "fused_dequant_update": fu.fused_dequant_update_buckets.launches}


def reset_dp_launch_counts() -> None:
    from paddle_tpu_torch.ops import codec

    reset_train_launch_counts()
    codec.reset_launch_counts()


def _param_checksum(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().view(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _dp_setup(cfg, device, seed, b, s, layers=None, threads=None):
    """One rank: the process group, ``cfg`` (``layers`` cut) from seed 0
    on ``device``, AdamW, TrainStep on the int8_block wire, and the
    global batch of ``b`` rows a rank from ``seed``."""
    import dataclasses

    from paddle_tpu_torch.distributed import (GradCommConfig, get_rank,
                                              init_parallel_env)
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    if threads:
        torch.set_num_threads(threads)
    env = init_parallel_env()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = GPTForCausalLM(cfg, seed=0, device=device)
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=model.parameters())
    step = TrainStep(model, GPTPretrainingCriterion(), opt,
                     grad_comm=GradCommConfig("int8_block"))
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size, (b * env.world_size, s))
    labels = rs.randint(0, cfg.vocab_size, (b * env.world_size, s))
    return env, get_rank(), cfg, model, step, ids, labels


def _data_parallel_rounds(cfg, device, ids, labels, rank, b, rounds):
    """``DataParallel(grad_comm="int8_block")`` on a fresh replica of
    ``cfg``: ``rounds`` forward and backward passes on this rank's rows,
    ``apply_collective_grads`` (a bf16 model's buckets encoded from bf16,
    then from the fp32 sum with the residual, and decoded to bf16) and
    the port's eager AdamW; launch counts reset just before and read just
    after. Returns the losses, the counts and the parameters' sha256."""
    from paddle_tpu_torch.distributed import DataParallel
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(cfg, seed=0, device=device)
    dp = DataParallel(model, grad_comm="int8_block")
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=model.parameters())
    crit = GPTPretrainingCriterion()
    x = torch.as_tensor(ids[rank * b:(rank + 1) * b], device=device)
    y = torch.as_tensor(labels[rank * b:(rank + 1) * b], device=device)
    reset_dp_launch_counts()
    losses = []
    for _ in range(rounds):
        opt.clear_grad()
        loss = dp.scale_loss(crit(dp(x), y))
        loss.backward()
        dp.apply_collective_grads()
        opt.step()
        losses.append(float(loss))
    return {"losses": losses, "counts": dp_launch_counts(),
            "checksum": _param_checksum(model)}


def dp_train_rank(cfg, seed, warmup, steps, wire_steps, b, s, device="cuda",
                  layers=None, dp_rounds=0):
    """One rank of a "dp train" phase (run by ``spawn``); with
    ``dp_rounds``, ``_data_parallel_rounds`` after it."""
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.ops import codec
    from paddle_tpu_torch.ops import fused_update as fu

    env, rank, cfg, model, step, ids, labels = _dp_setup(cfg, device, seed,
                                                         b, s, layers)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    reset_dp_launch_counts()
    losses = [float(step(inputs=(ids,), labels=(labels,)))]
    first = dp_launch_counts()       # the step with no residual yet
    losses += [float(step(inputs=(ids,), labels=(labels,)))
               for _ in range(warmup - 1)]
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_dp_launch_counts()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(inputs=(ids,), labels=(labels,))))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = dp_launch_counts()
    sizes = dict(fu.fused_dequant_update_buckets.sizes)
    encode_shapes = dict(codec.block_encode.shapes)
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    # the wire alone: every all-reduce (the step and the communicator
    # call it through the module) timed between two waits for the card
    wire = {"calls": 0, "seconds": 0.0}
    all_reduce = coll.all_reduce

    def timed_all_reduce(tensor, *args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = all_reduce(tensor, *args, **kwargs)
        sync()
        wire["calls"] += 1
        wire["seconds"] += time.perf_counter() - t0
        return out

    coll.all_reduce = timed_all_reduce
    try:
        for _ in range(wire_steps):
            losses.append(float(step(inputs=(ids,), labels=(labels,))))
    finally:
        coll.all_reduce = all_reduce
    out = {"rank": rank, "backend": env.backend, "losses": losses,
           "step_ms": step_ms, "counts": counts, "first_step_counts": first,
           "dequant_sizes": sizes, "encode_shapes": encode_shapes,
           "peak_memory_gib": peak, "comm_stats": step.comm_stats,
           "allreduce_ms_per_step": wire["seconds"] * 1e3 / wire_steps,
           "allreduces_per_step": wire["calls"] / wire_steps,
           "buckets": [b.size for b in step.buckets],
           "bucket_dtypes": [str(b.dtype) for b in step.buckets],
           "table_builds": step.updater.table_builds,
           "checksum": _param_checksum(model)}
    if dp_rounds:
        del step, model
        out["data_parallel"] = _data_parallel_rounds(cfg, device, ids, labels,
                                                     rank, b, dp_rounds)
    return out


def phase_dp_train(cfg, seed, warmup=2, steps=5, wire_steps=2, b=DP_B,
                   s=DP_S, device="cuda", layers=None, dp_rounds=0):
    """GPT-125M (``cfg``: fp32, or bf16 at bench.py's configuration) data
    parallel on the int8_block wire: two ranks on the one card (gloo,
    host-staged), each on its half of the global batch; with
    ``dp_rounds``, DataParallel after it (``_data_parallel_rounds``)."""
    from paddle_tpu_torch.distributed import spawn

    t0 = time.perf_counter()
    ranks = spawn(dp_train_rank,
                  args=(cfg, seed, warmup, steps, wire_steps, b, s, device,
                        layers, dp_rounds),
                  nprocs=DP_WORLD, timeout=DP_RANK_TIMEOUT)
    r0 = ranks[0]
    nb = len(r0["buckets"])
    med = statistics.median(r0["step_ms"])
    wire_bytes = sum(n + 4 * -(-n // DP_BLOCK) for n in r0["buckets"])
    summary = {
        "dtype": cfg.dtype, "backend": r0["backend"], "world": DP_WORLD,
        "batch_per_rank": [b, s], "buckets": nb,
        "losses": r0["losses"],
        "step_ms": [r["step_ms"] for r in ranks], "step_ms_median": med,
        "global_tokens_per_s": DP_WORLD * b * s / (med / 1e3),
        "allreduce_ms_per_step": [r["allreduce_ms_per_step"]
                                  for r in ranks],
        "allreduces_per_step": r0["allreduces_per_step"],
        "comm_stats": r0["comm_stats"],
        "peak_memory_gib": [r["peak_memory_gib"] for r in ranks],
        "launches_per_rank": [r["counts"] for r in ranks],
        "first_step_launches": r0["first_step_counts"],
        "table_builds": [r["table_builds"] for r in ranks],
        "checksums": [r["checksum"][:16] for r in ranks],
        "seconds": time.perf_counter() - t0}
    if dp_rounds:
        summary["data_parallel"] = [
            {**r["data_parallel"], "checksum":
             r["data_parallel"]["checksum"][:16]} for r in ranks]
    log(f"dp train {cfg.dtype} " + json.dumps(summary))
    losses = r0["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite dp training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"dp training loss did not fall: {losses}")
    if any(r["losses"] != losses for r in ranks):
        raise AssertionError("the ranks report different losses")
    if len({r["checksum"] for r in ranks}) != 1:
        raise AssertionError("the ranks' parameters differ after the last "
                             "step")
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError(f"backend {[r['backend'] for r in ranks]}, "
                             f"expected gloo (one card, two ranks)")
    if r0["comm_stats"]["comm_bytes"] != wire_bytes:
        raise AssertionError(f"{r0['comm_stats']['comm_bytes']} wire bytes "
                             f"a step, the plan gives {wire_bytes}")
    n_layers = layers or cfg.num_layers
    ran = "_bf16" if cfg.dtype == "bfloat16" else ""
    want = {name + sfx: n_layers * steps * (sfx == ran)
            for sfx in ("", "_bf16")
            for name in ("flash_fwd", "flash_dq", "flash_dkv")}
    want.update(fused_update=0, codec_encode=nb * steps,
                codec_encode_bf16=0, codec_decode=0, codec_decode_bf16=0,
                fused_dequant_update=steps, ce_chunk_fwd=0, ce_chunk_bwd=0)
    # the first step has no residual: each bf16 bucket encoded from bf16
    n_bf16 = r0["bucket_dtypes"].count("torch.bfloat16")
    want_first = {**{k: v // steps for k, v in want.items()},
                  "codec_encode_bf16": n_bf16}
    want_shapes = Counter()
    for n in r0["buckets"]:
        key = (-(-n // DP_BLOCK), DP_BLOCK, "int8_block", True)
        want_shapes[key] += steps
    for r in ranks:
        if r["counts"] != want:
            raise AssertionError(f"rank {r['rank']} launch counts "
                                 f"{r['counts']}, expected {want}")
        if r["first_step_counts"] != want_first:
            raise AssertionError(f"rank {r['rank']} first-step launch "
                                 f"counts {r['first_step_counts']}, "
                                 f"expected {want_first}")
        if r["encode_shapes"] != want_shapes:
            raise AssertionError(f"rank {r['rank']} codec_encode launches "
                                 f"by shape {r['encode_shapes']}, expected "
                                 f"{dict(want_shapes)}")
        if r["table_builds"] != 1:
            raise AssertionError(f"rank {r['rank']}: the update table was "
                                 f"built {r['table_builds']} times")
    if r0["allreduces_per_step"] != 2 * nb + 1:
        raise AssertionError(f"{r0['allreduces_per_step']} all-reduces a "
                             f"step, expected {2 * nb + 1}")
    if dp_rounds:
        _check_data_parallel([r["data_parallel"] for r in ranks], nb, n_bf16,
                             n_layers, dp_rounds, ran)
    return r0


def _check_data_parallel(runs, nb, n_bf16, n_layers, rounds, ran):
    """DataParallel's rounds on both ranks: losses finite, the replicas
    identical, every bucket encoded once a round (the bf16 ones from bf16
    in the first round) and decoded once a round to its dtype."""
    if not all(math.isfinite(x) for r in runs for x in r["losses"]):
        raise AssertionError(f"non-finite DataParallel loss: "
                             f"{[r['losses'] for r in runs]}")
    if len({r["checksum"] for r in runs}) != 1:
        raise AssertionError("the DataParallel replicas differ")
    want = {name + sfx: n_layers * rounds * (sfx == ran)
            for sfx in ("", "_bf16")
            for name in ("flash_fwd", "flash_dq", "flash_dkv")}
    want.update(fused_update=0, codec_encode=nb * rounds,
                codec_encode_bf16=n_bf16, codec_decode=nb * rounds,
                codec_decode_bf16=n_bf16 * rounds, fused_dequant_update=0,
                ce_chunk_fwd=0, ce_chunk_bwd=0)
    for rank, r in enumerate(runs):
        if r["counts"] != want:
            raise AssertionError(f"rank {rank} DataParallel launch counts "
                                 f"{r['counts']}, expected {want}")


def dp_parity_rank(seed, b, s, layers, device):
    """One rank of the "dp parity" phase: two steps; rank 0 returns, per
    parameter, both steps' changes, its step-1 local gradient and the
    gradient each step decoded (the bucket reduced again from the same
    local gradient and residual, which gives the same payload)."""
    from paddle_tpu_torch.models import gpt_presets

    env, rank, cfg, model, step, ids, labels = _dp_setup(
        gpt_presets("gpt-125m"), device, seed, b, s, layers,
        threads=4 if device == "cpu" else None)
    comm = step.grad_comm_communicator
    names = [n for n, _ in model.named_parameters()]
    params = step.updater.params
    out = {n: {} for n in names}
    losses = []
    before = [p.detach().clone() for p in params]
    for k in (1, 2):
        residuals = dict(comm._residuals)
        losses.append(float(step(inputs=(ids,), labels=(labels,))))
        flats = step.updater.flat_grads()
        with torch.no_grad():
            for bk in step.buckets:
                dec, *_ = comm.reduce_bucket(bk, flats[bk.index],
                                             env.world_size,
                                             residual=residuals.get(
                                                 bk.index))
                for pi, off, n in zip(bk.param_indices, bk.offsets,
                                      bk.numels):
                    # copies: on the CPU .cpu() would keep a view of a
                    # buffer that the next step overwrites
                    out[names[pi]][f"dec{k}"] = dec[off:off + n].cpu() \
                        .clone()
                    if k == 1:
                        out[names[pi]]["local"] = \
                            flats[bk.index][off:off + n].cpu().clone()
        for i, p in enumerate(params):
            out[names[i]][f"d{k}"] = (p.detach() - before[i]).reshape(-1) \
                .cpu()
            before[i] = p.detach().clone()
    result = {"losses": losses, "checksum": _param_checksum(model),
              "backend": env.backend}
    if rank == 0:
        result["params"] = out
    return result


def phase_dp_parity(seed, layers=2, b=2, s=128):
    """World 2 on the card against world 2 on the CPU, GPT-125M width
    with ``layers`` layers, global batch 2b x s, two int8_block steps:
    losses within 1e-4 relative, parameters by ``dp_step_parity``."""
    from torch_checks import dp_step_parity

    from paddle_tpu_torch.distributed import spawn

    runs = {}
    for device in ("cuda", "cpu"):
        ranks = spawn(dp_parity_rank, args=(seed + 3, b, s, layers, device),
                      nprocs=DP_WORLD, timeout=DP_RANK_TIMEOUT)
        if ranks[0]["checksum"] != ranks[1]["checksum"]:
            raise AssertionError(f"{device}: the ranks' parameters differ")
        runs[device] = ranks[0]
    card, cpu = runs["cuda"], runs["cpu"]
    rel = [abs(a - c) / abs(c) for a, c in zip(card["losses"],
                                                cpu["losses"])]
    log(f"dp card vs CPU (gpt-125m width, {layers} layers, world 2, "
        f"global b{DP_WORLD * b} s{s}): losses {card['losses']} vs "
        f"{cpu['losses']} (rel {max(rel):.2e})")
    if not max(rel) <= 1e-4:
        raise AssertionError("card and CPU dp losses differ beyond 1e-4")
    r = dp_step_parity(card["params"], cpu["params"], LR)
    log(f"dp card vs CPU after two AdamW steps: local gradients within "
        f"{r['local_grad_rtol']:.2e} of each tensor's largest (limit 1e-4); "
        f"{100 * r['flip_share']:.4f}% of elements decode to another "
        f"gradient (limit 1%); where they agree, step 1 within "
        f"{r['step1']['clear_step_diff_lr']:.2e} lr on the "
        f"{100 * r['step1']['clear_share']:.1f}% clear of the noise, each "
        f">= 0.9 lr; step 2 within {r['step2_diff_lr']:.2e} lr (limit "
        f"1e-2); every step 1 within {r['step1_max_diff_lr']:.3f} lr")
    return r


def _dp_state(step) -> dict:
    """What one data-parallel step starts from: CPU copies of the
    updater's flat parameters and slots (the slots a first step starts
    from when there are none yet) and of the communicator's residuals,
    and the residual tensors themselves."""
    upd, comm = step.updater, step.grad_comm_communicator
    slots = [upd._slots.get(b.index) or upd._init_flat_slots(b)
             for b in upd.buckets]
    return {"p": [upd._flat_p[b.index].detach().cpu().clone()
                  for b in upd.buckets],
            "slots": [{k: v.detach().cpu().clone() for k, v in sl.items()}
                      for sl in slots],
            "res": {i: r.cpu().clone() for i, r in comm._residuals.items()},
            "res_card": dict(comm._residuals)}


def _dp_replay(step, before, world) -> dict:
    """The step just taken, again on the CPU through the plain versions,
    from ``before`` (``_dp_state``) and this rank's local gradients (still
    in the updater's buffers): each bucket encoded, its scales and payload
    summed over the same gloo group, the dequantizing update walked;
    then each bucket reduced again on the card and decoded to its dtype
    by codec_decode, against the plain decode of the CPU's payload.
    Returns the elements that differ, by what."""
    from paddle_tpu_torch.distributed import GradCommunicator
    from paddle_tpu_torch.distributed import grad_comm as plain
    from paddle_tpu_torch.ops import fused_update as fu

    upd, comm = step.updater, step.grad_comm_communicator
    kind, hyper = upd._rule
    bs = comm.config.block_size
    cpu_comm = GradCommunicator(comm.config, group=comm.group)
    entries, payloads = [], []
    with torch.no_grad():
        for b in upd.buckets:
            local = upd._flat_g[b.index].detach().cpu().clone()
            q, scales, new_res, *_ = cpu_comm.reduce_bucket_payload(
                b, local, world, residual=before["res"].get(b.index))
            cpu_comm._residuals[b.index] = new_res
            payloads.append((q.clone(), scales.clone()))
            sl = before["slots"][b.index]
            lm, wd = upd._hypers[b.index]
            entries.append((before["p"][b.index].clone(),
                            fu.WirePayload(q, scales, None, b.dtype),
                            [sl["moment1"].clone(), sl["moment2"].clone()],
                            wd, lm))
        table = fu.BucketTable(kind, hyper, entries, block_size=bs)
        table.load_powers([(sl["beta1_pow"], sl["beta2_pow"])
                           for sl in before["slots"]])
        fu.fused_dequant_update_buckets(
            table, upd.optimizer._lr_tensor(torch.device("cpu")), world)
    differ = Counter()

    def held(what, card, cpu):
        card = card.detach().cpu()
        if card.dtype != cpu.dtype or card.shape != cpu.shape:
            differ[what] += cpu.numel()
        else:
            differ[what] += int((card.reshape(-1).view(torch.uint8)
                                 != cpu.reshape(-1).view(torch.uint8))
                                .sum())

    for b, (p, _, (m1, m2), *_), (b1, b2) in zip(upd.buckets, table.entries,
                                                 table.powers()):
        sl = upd._slots[b.index]
        held("params", upd._flat_p[b.index], p)
        held("moment1", sl["moment1"], m1)
        held("moment2", sl["moment2"], m2)
        held("beta_pows", torch.stack([sl["beta1_pow"], sl["beta2_pow"]]),
             torch.stack([b1, b2]))
        held("residuals", comm._residuals[b.index],
             cpu_comm._residuals[b.index])
    with torch.no_grad():     # the decode, on the card's re-reduction
        for b, (q, scales) in zip(upd.buckets, payloads):
            dec, *_ = comm.reduce_bucket(
                b, upd._flat_g[b.index], world,
                residual=before["res_card"].get(b.index))
            qc, sc = comm._wire[b.index]
            held("payload", qc, q)
            held("scales", sc, scales)
            held("decoded", dec, plain.block_decode(q, scales, world, b.size,
                                                    dtype=b.dtype))
    return dict(differ)


def dp_parity_bf16_rank(cfg, seed, b, s, layers, device):
    """One rank of the "dp parity bf16" phase: two int8_block steps of the
    bf16 model (``cfg`` cut to ``layers``); on the card each step is
    replayed on the CPU by ``_dp_replay``."""
    # 4 threads a rank: the card's ranks replay on the CPU too
    env, rank, cfg, model, step, ids, labels = _dp_setup(
        cfg, device, seed, b, s, layers, threads=4)
    on_card = torch.device(device).type == "cuda"
    losses, replays = [], []
    for _ in range(2):
        before = _dp_state(step) if on_card else None
        losses.append(float(step(inputs=(ids,), labels=(labels,))))
        if on_card:
            replays.append(_dp_replay(step, before, env.world_size))
    return {"losses": losses, "checksum": _param_checksum(model),
            "backend": env.backend, "replays": replays,
            "elements": sum(bk.size for bk in step.buckets)}


def phase_dp_parity_bf16(cfg, seed, layers=2, b=2, s=128):
    """The bf16 model (``cfg``) at ``layers`` layers, world 2, global
    batch 2b x s, two int8_block steps: on the card each step replayed on
    the CPU from the card's own local gradients and state, parameters,
    moments, beta powers, residuals, payloads, scales and the bf16 decode
    bit for bit (the wire, apart from the model's numerics); then the
    same two steps on the CPU end to end, losses within BF16_LOSS_RTOL of
    the card's."""
    from torch_checks import BF16_LOSS_RTOL

    from paddle_tpu_torch.distributed import spawn

    t0 = time.perf_counter()
    runs = {}
    for device in ("cuda", "cpu"):
        ranks = spawn(dp_parity_bf16_rank,
                      args=(cfg, seed + 5, b, s, layers, device),
                      nprocs=DP_WORLD, timeout=DP_RANK_TIMEOUT)
        if ranks[0]["checksum"] != ranks[1]["checksum"]:
            raise AssertionError(f"{device}: the ranks' parameters differ")
        runs[device] = ranks
    card, cpu = runs["cuda"][0], runs["cpu"][0]
    bad = [(r, k, d) for r, rank in enumerate(runs["cuda"])
           for k, rep in enumerate(rank["replays"]) for d in rep.items()
           if d[1]]
    log(f"dp bf16 wire, card vs its CPU replay ({cfg.dtype}, {layers} "
        f"layers, world 2, global b{DP_WORLD * b} s{s}, "
        f"{card['elements']} elements): "
        + ("parameters, moments, beta powers, residuals, payloads, scales "
           "and the bf16 decode bit-identical on both ranks in both steps"
           if not bad else f"differ: {bad}"))
    if bad:
        raise AssertionError(f"the card's dp step differs from its CPU "
                             f"replay: {bad}")
    rel = [abs(a - c) / abs(c) for a, c in zip(card["losses"],
                                                cpu["losses"])]
    log(f"dp bf16 card vs CPU end to end: losses {card['losses']} vs "
        f"{cpu['losses']} (rel {max(rel):.2e}, limit {BF16_LOSS_RTOL}); "
        f"the phase {time.perf_counter() - t0:.1f} s")
    if not max(rel) <= BF16_LOSS_RTOL:
        raise AssertionError("card and CPU bf16 dp losses differ beyond "
                             f"{BF16_LOSS_RTOL}")
    return {"loss_rel": max(rel), "elements": card["elements"]}


# ------------------------------------------------------------- ResNet-50
# bench.py's resnet50 mode (measure_resnet50, bench.py:643-695) on an
# accelerator: batch 256 of 3 x 224 x 224, Momentum(0.01, 0.9), O2 bf16
RESNET_B, RESNET_IMG = 256, 224
RESNET_WARMUP, RESNET_STEPS = 3, 8
RESNET_LR, RESNET_MOM = 0.01, 0.9
RESNET_FWD_FLOPS = 4.09e9           # bench.py's forward FLOPs a 224^2 sample
# phase 30: card against CPU at resnet50(num_classes=10), 4 x 64 x 64
RESNET_CHECK_B, RESNET_CHECK_IMG, RESNET_CHECK_CLASSES = 4, 64, 10
# a stage's output (largest difference over the largest value), input
# and parameter gradients (torch_checks.norm_rel) and buffers (absolute),
# card against CPU. fp32 as the reference's CPU test holds the port
# (tests/test_torch_resnet.py STAGE_TOL): read there 1.2e-6, 3.6e-3 in
# the one stage a ReLU flip moved (1e-6 in the others), 3.9e-7; on an
# NVIDIA H100 80GB HBM3 at 700 W 1.9e-6, 3.4e-3 (one stage), 1.3e-6.
# Under O2 the card's bf16 convolutions round apart from the CPU's more
# than the reference's do (5.4e-3, 4.3e-2 against 5.6e-3, 1.9e-2, on the
# same card): the gradients are held within a tenth of their norm, under
# what a batch norm that differentiated through its statistics would
# read (0.13-0.92 a stage, on the CPU)
RESNET_STAGE_TOL = {None: {"out": 1e-5, "dx": 3e-2, "grads": 3e-2,
                           "buffers": 1e-5},
                    "O2": {"out": 2.0 ** -7, "dx": 0.1, "grads": 0.1,
                           "buffers": 5e-3}}
RESNET_FP32_GRAD_CLEAN = 1e-4       # all fp32 stages but at most two
# one fp32 step's loss, card against CPU (the port's CPU loss moves by
# 6.4e-6 when every input moves one ulp; read 1.5e-5 on an NVIDIA H100
# 80GB HBM3 at 700 W). Under O2 the limit is measured in the phase:
# twice the largest move of the CPU's own loss when its input moves by
# half a bf16 ulp (RESNET_NOISE_DRAWS draws of random sign; ~4% here)
RESNET_FP32_LOSS_RTOL = 1e-4
RESNET_NOISE_DRAWS = 3
# an fp32 convolution against its fp64 value, of its largest: within
# fp32 rounding on the card, and a TF32 one far from it
CONV_FP32_RTOL, CONV_TF32_MIN = 1e-5, 1e-4


def _resnet_setup(device, b, img, seed, num_classes=1000, weights=None):
    """``measure_resnet50``'s step: resnet50 from seed 0 (or ``weights``,
    a ``dense_state_dict_from_numpy`` dict), Momentum(0.01, 0.9), a
    TrainStep with ``F.cross_entropy``, and a batch from
    ``RandomState(seed)``: ``randn`` images, labels ``randint(0,
    num_classes)``, on ``device``."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    model = resnet50(num_classes=num_classes, seed=0, device=device)
    if weights is not None:
        model.load_state_dict(weights)
    step = TrainStep(model, lambda logits, y: F.cross_entropy(logits, y),
                     Momentum(learning_rate=RESNET_LR, momentum=RESNET_MOM,
                              parameters=model.parameters()))
    rs = np.random.RandomState(seed)
    x = rs.randn(b, 3, img, img).astype(np.float32)
    y = rs.randint(0, num_classes, (b,))
    batch = (torch.as_tensor(x, device=device),
             torch.as_tensor(y, dtype=torch.long, device=device))
    return model, step, batch


def resnet_step(step, batch, level="O2"):
    """One step as ``measure_resnet50``'s ``one_step`` calls it on an
    accelerator: under ``auto_cast(level="O2", dtype="bfloat16")``."""
    from paddle_tpu_torch.amp import auto_cast

    x, y = batch
    with auto_cast(enable=level is not None, level=level or "O1",
                   dtype="bfloat16"):
        return step(inputs=(x,), labels=(y,))


# the device time of one step by PyTorch op: (kind, op-name words)
# (the backward first: "aten::convolution" is a prefix of its name)
RESNET_KINDS = (
    ("conv backward (cuDNN)", ("convolution_backward",)),
    ("conv forward (cuDNN)", ("cudnn_convolution", "aten::convolution",
                              "aten::_convolution", "aten::conv2d")),
    ("amp casts and copies", ("aten::_to_copy", "aten::copy_")),
    ("max pool", ("max_pool2d",)),
    ("fused_update", ()),
)


def resnet_profile(one):
    """torch.profiler over one step (``one()``): busy and idle share, the
    kernels, and the device time by kind, each op's own launches: the
    cuDNN convolutions, their backward, amp's casts (and the few other
    copies), the max pool, the port's update kernel, and the rest: the
    batch norms' and ReLUs' elementwise and reduction passes, the
    residual adds, the average pool, the classifier and the loss."""
    from torch.profiler import ProfilerActivity, profile

    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    kernels = [e for e in avgs
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    update = sum(e.self_device_time_total for e in kernels
                 if "update_kernel" in e.key)
    rest = "batch norm, ReLU and the other elementwise work"
    kinds = dict.fromkeys([k for k, _ in RESNET_KINDS] + [rest], 0.0)
    kinds["fused_update"] = update
    for e in avgs:
        if (e.device_type != torch.autograd.DeviceType.CPU
                or not e.self_device_time_total):
            continue
        kind = next((k for k, words in RESNET_KINDS
                     if any(w in e.key for w in words)), rest)
        kinds[kind] += e.self_device_time_total
    # the update kernel is launched from the wrapper, under no aten op
    kinds[rest] = busy - sum(v for k, v in kinds.items() if k != rest)
    log(f"resnet50 profile: one step, wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% busy, "
        f"{100 * (1 - busy / wall_us):.1f}% idle), "
        f"{sum(e.count for e in kernels)} kernels per step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
            f"{100 * e.self_device_time_total / busy:5.1f}% "
            f"{e.count:5d}x  {e.key[:90]}")
    log("  by kind: " + ", ".join(f"{k} {t / 1e3:.3f} ms "
                                  f"({100 * t / busy:.1f}%)"
                                  for k, t in kinds.items()))
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "by_kind_ms": {k: t / 1e3 for k, t in kinds.items()}}


def phase_resnet_train(dev, seed, warmup=RESNET_WARMUP, steps=RESNET_STEPS,
                       b=RESNET_B, img=RESNET_IMG):
    """Phase 29: ``measure_resnet50``'s step, not cut: ``warmup`` then
    ``steps`` timed steps, launch counts reset just before them and read
    just after (one fused_update a step, rule momentum, over the fp32
    buckets; no other kernel of the port), peak memory, MFU by
    ``bench.py``'s formula, then a profiled step. Returns the counts, the
    step and its batch, and the summary."""
    model, step, batch = _resnet_setup(dev, b, img, seed)
    n_params = sum(bk.size for bk in step.buckets)
    log(f"resnet50 train: {n_params} parameters in {len(step.buckets)} "
        f"buckets, O2 bfloat16, batch {b} x 3 x {img} x {img}, Momentum lr "
        f"{RESNET_LR} momentum {RESNET_MOM}, NCHW, "
        f"torch.backends.cudnn.benchmark={torch.backends.cudnn.benchmark}")
    losses = [float(resnet_step(step, batch)) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_launch_counts()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(resnet_step(step, batch)))   # waits for it
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = train_launch_counts()
    med = statistics.median(step_ms)
    table = step.updater._table
    flops = 3 * RESNET_FWD_FLOPS * (img * img) / (224 * 224)
    summary = {"losses": losses, "step_ms": step_ms, "step_ms_median": med,
               "samples_per_s": b / (med / 1e3),
               "mfu_bf16_dense": b / (med / 1e3) * flops / BF16_OPS_PER_S,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
               "parameters": n_params, "buckets": len(step.buckets),
               "rule": table.kind,
               "bucket_dtypes": sorted({str(e[0].dtype)
                                        for e in table.entries}),
               "launches": counts}
    log("resnet50 train O2 " + json.dumps(summary))
    log(f"resnet50 train O2: MFU {summary['mfu_bf16_dense']:.4f} (bench.py: "
        f"3 x 4.09 GFLOP x (img/224)^2 a sample against "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16 dense), "
        f"{summary['samples_per_s']:.1f} samples/s, step {med:.2f} ms, "
        f"peak {summary['peak_memory_gib']:.2f} GiB of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite ResNet-50 loss: {losses}")
    want = {k: 0 for k in counts}
    want["fused_update"] = steps
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    if table.kind != "momentum" or summary["bucket_dtypes"] != [
            "torch.float32"] or len(table.entries) != len(step.buckets):
        raise AssertionError(f"the update's table: rule {table.kind}, "
                             f"{len(table.entries)} buckets of "
                             f"{summary['bucket_dtypes']}")
    summary["profile"] = resnet_profile(lambda: resnet_step(step, batch))
    return counts, step, batch, summary


def _momentum_timing(dev, gen, buckets, flush):
    """ResNet-50's update (every bucket of its plan, Momentum(0.01, 0.9),
    weights, gradients and velocities at unit, 1e-3 and 1e-3 scales): the
    one launch held bit for bit against its plain walk over 3 steps;
    then, in one call, the update as FusedFlatUpdater.step() calls it,
    the kernel alone, the plain walk and ``torch._fused_sgd_`` (momentum
    0.9, no dampening: Paddle's ``v = mu v + g; p -= lr v``) over the same
    buckets, timed; the bound: p, g and v read, p and v written, 20 bytes
    an element."""
    from torch_checks import buckets_vs_plain

    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.distributed import grad_comm
    from paddle_tpu_torch.ops import fused_update as fu

    sizes = [b.size for b in buckets]
    params = [torch.nn.Parameter(torch.randn(n, device=dev, generator=gen))
              for n in sizes]
    plan = []
    for i, n in enumerate(sizes):
        bk = grad_comm.GradBucket(i, torch.float32)
        bk.add(i, (n,))
        plan.append(bk)
    opt = optim.Momentum(learning_rate=RESNET_LR, momentum=RESNET_MOM,
                         parameters=params)
    upd = optim.FusedFlatUpdater(opt, params, buckets=plan)
    upd.zero_grad()
    for p in params:
        p.grad.copy_(torch.randn(p.shape, device=dev, generator=gen) * 1e-3)
    upd.step()
    hyper = {"momentum": RESNET_MOM, "nesterov": False}
    lr = torch.full((), RESNET_LR, device=dev)
    ps = [upd._flat_p[i] for i in range(len(sizes))]
    gs = [upd._flat_g[i] for i in range(len(sizes))]
    vs = [upd._slots[i]["velocity"] for i in range(len(sizes))]
    entries = [(p.clone(), g.clone(), [v.clone()], 0.0, 1.0)
               for p, g, v in zip(ps, gs, vs)]
    launches = buckets_vs_plain("momentum", hyper, entries, lr, steps=3,
                                gen=gen)
    del entries
    if launches != 3:
        raise AssertionError(f"fused_update_buckets: {launches} launches "
                             f"for 3 momentum steps")
    log(f"fused_update, momentum over ResNet-50's {len(sizes)} fp32 buckets "
        f"({min(sizes)}..{max(sizes)} elements): bit-identical to its "
        f"plain walk over 3 steps, in {launches} launches")
    table = upd._table
    if table.kind != "momentum":
        raise AssertionError(f"the updater's rule is {table.kind}")

    def kernel():
        fu.fused_update_buckets(table, lr)

    def plain():
        fu.buckets_plain(table, lr)

    bufs = [v.clone() for v in vs]

    def library():
        torch._fused_sgd_(ps, gs, bufs, weight_decay=0.0,
                          momentum=RESNET_MOM, lr=RESNET_LR, dampening=0.0,
                          nesterov=False, maximize=False,
                          is_first_step=False)

    n = sum(sizes)
    # read p, g, v; write p, v (fp32); 3 operations an element
    bound_ms, bound_by = work_bound(20 * n, 3 * n)
    return {"shape": f"{len(sizes)} buckets, {n} elements (one step, "
                     f"float32, momentum)",
            "library_form": "torch._fused_sgd_, momentum 0.9, dampening "
                            "0, fp32 momentum buffers",
            "max_abs_err": 0.0, "step_ms": median_ms(upd.step, flush),
            "ms": median_ms(kernel, flush),
            "library_ms": median_ms(library, flush),
            "step_span_ms": span_ms(upd.step, flush),
            "span_ms": span_ms(kernel, flush),
            "library_span_ms": span_ms(library, flush),
            "plain_ms": median_ms(plain, flush), "bound_ms": bound_ms,
            "bound_by": bound_by, "largest_bucket": max(sizes),
            "smallest_bucket": min(sizes)}


def phase_resnet_update(dev, gen, buckets):
    """Row 6 at ResNet-50's plan (phase 29's buckets), timed three ways
    beside ``torch._fused_sgd_`` and the bound."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    row = _momentum_timing(dev, gen, buckets, flush)
    log(f"fused_update, ResNet-50's {row['shape']}, one launch, device "
        f"time (from an idle card): as FusedFlatUpdater.step() calls it "
        f"{row['step_ms']:.4f} ms ({row['step_span_ms']:.4f}), the kernel "
        f"alone {row['ms']:.4f} ({row['span_ms']:.4f}), torch._fused_sgd_ "
        f"{row['library_ms']:.4f} ({row['library_span_ms']:.4f}); plain "
        f"{row['plain_ms']:.4f}; bound {row['bound_ms']:.4f} "
        f"{row['bound_by']}, the kernel at "
        f"{100 * row['bound_ms'] / row['ms']:.1f}% of it")
    del flush
    return row


def _conv_precision(dev, gen):
    """The stem's convolution and a 3 x 3 one of layer1 in fp32 on the
    card and on the CPU through ``F.conv2d``, and on the card with cuDNN's
    TF32 on, each against its fp64 value on the CPU: the card's fp32
    within ``CONV_FP32_RTOL`` of the largest, as the CPU's, and the TF32
    one at least ``CONV_TF32_MIN`` off, so TF32 shows if it is on."""
    from paddle_tpu_torch.nn import functional as F

    out = {}
    for name, xs, ws, kw in (
            ("stem 7x7/2", (4, 3, 64, 64), (64, 3, 7, 7),
             dict(stride=2, padding=3)),
            ("layer1 3x3", (4, 64, 16, 16), (64, 64, 3, 3),
             dict(padding=1))):
        x = torch.randn(xs, device=dev, generator=gen)
        w = torch.randn(ws, device=dev, generator=gen) * 0.1
        want = torch.nn.functional.conv2d(x.cpu().double(),
                                          w.cpu().double(), **kw)
        scale = float(want.abs().max())
        card = F.conv2d(x, w, **kw).cpu().double()
        cpu = F.conv2d(x.cpu(), w.cpu(), **kw).double()
        dnn = torch.backends.cudnn
        saved = dnn.allow_tf32
        try:
            dnn.allow_tf32 = True
            tf32 = torch.nn.functional.conv2d(x, w, **kw).cpu().double()
        finally:
            dnn.allow_tf32 = saved
        errs = {k: float((v - want).abs().max()) / scale
                for k, v in (("card", card), ("cpu", cpu), ("tf32", tf32))}
        log(f"fp32 conv {name} against fp64, of the largest: card "
            f"{errs['card']:.2e}, CPU {errs['cpu']:.2e}, card with cuDNN "
            f"TF32 on {errs['tf32']:.2e}")
        if not (errs["card"] <= CONV_FP32_RTOL and errs["cpu"]
                <= CONV_FP32_RTOL and errs["tf32"] >= CONV_TF32_MIN):
            raise AssertionError(f"fp32 conv {name}: {errs}")
        out[name] = errs
    return out


def _resnet_stage_parity(card_model, cpu_model, level):
    """Every stage of resnet50 on the card and on the CPU, fed the CPU's
    previous output and the same cotangent (torch_checks.stage_run)."""
    from torch_checks import resnet_stages, stage_errors, stage_run

    from paddle_tpu_torch import tensor as T

    x = torch.from_numpy(np.random.RandomState(5).randn(
        RESNET_CHECK_B, 3, RESNET_CHECK_IMG, RESNET_CHECK_IMG).astype(
        np.float32))
    tol = RESNET_STAGE_TOL[level]
    worst, flipped = dict.fromkeys(tol, 0.0), []
    for i, (cs, ps) in enumerate(zip(resnet_stages(card_model, T.flatten),
                                     resnet_stages(cpu_model, T.flatten))):
        want = stage_run(cpu_model, ps, x, i, level)
        errs = stage_errors(stage_run(card_model, cs, x, i, level), want)
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
            if not v <= tol[k]:
                raise AssertionError(f"resnet50 {level or 'fp32'} stage "
                                     f"{cs[0]} {k}: {v:.2e} (limit "
                                     f"{tol[k]:.0e})")
        if max(errs["dx"], errs["grads"]) > RESNET_FP32_GRAD_CLEAN:
            flipped.append(cs[0])
        x = want["out"]
    if level is None and len(flipped) > 2:
        raise AssertionError(f"fp32 stages with gradients above "
                             f"{RESNET_FP32_GRAD_CLEAN:.0e}: {flipped}")
    log(f"resnet50 {level or 'fp32'} card vs CPU, stage by stage (stem, 16 "
        f"blocks, head): worst output {worst['out']:.2e}, input gradient "
        f"{worst['dx']:.2e}, parameter gradient {worst['grads']:.2e} "
        f"(norm), buffers {worst['buffers']:.2e}; stages above "
        f"{RESNET_FP32_GRAD_CLEAN:.0e}: {flipped}")
    return worst


def _resnet_one_step(device, weights, level, noise=None):
    """One TrainStep of resnet50(num_classes=10) at 4 x 64 x 64 on
    ``device`` from ``weights``, the input times ``1 + 2^-9 s`` with a
    random sign ``s`` from ``RandomState(noise)`` when ``noise`` is given
    (half a bf16 ulp): the loss and, per parameter, (before, after,
    gradient) on the CPU."""
    model, step, (x, y) = _resnet_setup(
        device, RESNET_CHECK_B, RESNET_CHECK_IMG, 7,
        num_classes=RESNET_CHECK_CLASSES, weights=weights)
    if noise is not None:
        s = np.random.RandomState(noise).choice([-1.0, 1.0], tuple(x.shape))
        x = x * (1 + 2.0 ** -9 * torch.as_tensor(s, dtype=x.dtype,
                                                 device=x.device))
    batch = (x, y)
    before = {n: p.detach().cpu().clone()
              for n, p in model.named_parameters()}
    loss = float(resnet_step(step, batch, level))
    return loss, {n: (before[n], p.detach().cpu().clone(),
                      p.grad.detach().cpu().clone())
                  for n, p in model.named_parameters()}


def phase_resnet_parity(dev, gen, seed):
    """Phase 30: resnet50(num_classes=10) at 4 x 64 x 64 on the card and
    on the CPU, the card's weights carried from the CPU model with
    ``dense_state_dict_from_numpy``. fp32 convolutions within fp32
    rounding and a TF32 one far from it; every stage, in fp32 and under
    O2, within ``RESNET_STAGE_TOL``; one TrainStep in fp32 and one under
    O2: the loss within ``RESNET_FP32_LOSS_RTOL``, or under O2 within
    twice the CPU's own move under half a bf16 ulp of input noise, and
    on the card, the update Momentum's first step bit for bit (each
    weight less fp32 lr times its gradient). A whole step's gradients are
    not compared: at this size a ReLU network under batch-4 batch norms
    moves them by more than their size when the input moves by half a
    bf16 ulp."""
    from paddle_tpu_torch.models import dense_state_dict_from_numpy
    from paddle_tpu_torch.vision.models import resnet50

    convs = _conv_precision(dev, gen)
    cpu_model = resnet50(num_classes=RESNET_CHECK_CLASSES, seed=seed,
                         device="cpu")
    state = {n: t.detach().numpy().copy() for n, t in
             [*cpu_model.named_parameters(), *cpu_model.named_buffers()]}
    weights = dense_state_dict_from_numpy(state, cpu_model)
    out = {"conv": convs}
    for level in (None, "O2"):
        card_model = resnet50(num_classes=RESNET_CHECK_CLASSES, seed=seed + 1,
                              device=dev)
        card_model.load_state_dict(weights)
        cpu_model.load_state_dict(weights)
        out[f"stages {level}"] = _resnet_stage_parity(card_model, cpu_model,
                                                      level)
        del card_model
        reset_train_launch_counts()
        card_loss, card = _resnet_one_step(dev, weights, level)
        counts = train_launch_counts()
        cpu_loss, _ = _resnet_one_step("cpu", weights, level)
        rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
        limit = RESNET_FP32_LOSS_RTOL
        if level is not None:
            moved = max(abs(_resnet_one_step("cpu", weights, level, k)[0]
                            - cpu_loss) / abs(cpu_loss)
                        for k in range(RESNET_NOISE_DRAWS))
            limit = 2 * moved
            log(f"resnet50 {level} TrainStep on the CPU, input moved by "
                f"half a bf16 ulp ({RESNET_NOISE_DRAWS} draws): the loss "
                f"moves by up to {moved:.2e}")
        lr = torch.tensor(RESNET_LR, dtype=torch.float32)
        not_momentum = [n for n, (b0, b1, g) in card.items()
                        if not torch.equal(b1, b0 - lr * g)]
        log(f"resnet50 {level or 'fp32'} TrainStep card vs CPU (4 x 64 x 64, "
            f"10 classes): loss {card_loss:.7f} vs {cpu_loss:.7f} (rel "
            f"{rel:.2e}, limit {limit:.2e}); card "
            f"launches {counts}; weights off Momentum's first step: "
            f"{len(not_momentum)}")
        if not rel <= limit:
            raise AssertionError(f"resnet50 {level}: card and CPU losses "
                                 f"differ by {rel:.2e}")
        if counts["fused_update"] != 1 or not_momentum:
            raise AssertionError(f"resnet50 {level}: launches {counts}, "
                                 f"off Momentum's step: {not_momentum[:5]}")
        out[f"loss {level}"] = {"rel": rel, "limit": limit}
    return out



# ------------------------------------------------------------ Wide&Deep
# bench.py's widedeep mode (measure_widedeep, bench.py:767-862) at its
# accelerator sizes (phase 31) and its CPU sizes (phase 32)
WD_EAGER_STEPS = 10
# phase 32: card against CPU within the larger of WD_NOISE_FACTOR times
# the CPU's own move when the deep arm's weights move by one ulp (the
# largest of WD_NOISE_DRAWS draws) and the bound the CPU test holds the
# port to against the reference (tests/test_torch_widedeep.py: losses
# 1e-6 relative, the table's rows 1e-5 of the largest, the AUC 1e-5)
WD_NOISE_FACTOR = 4
WD_NOISE_DRAWS = (("0.weight", 1), ("0.weight", -1), ("2.weight", 1))
WD_FLOORS = {"losses": 1e-6, "rows": 1e-5, "auc": 1e-5}
# the first step card vs CPU: the loss within WD_FIRST_RTOL relative;
# each dense gradient and the slab's gradient within WD_FIRST_RTOL of its
# tensor's largest; the output bias's gradient, one float that sums the
# batch's 128 near-cancelling dL/dlogit (cuBLAS and the CPU add them in
# other orders), within WD_FIRST_RTOL of the sum of their sizes
WD_FIRST_RTOL = 1e-6
WD_OUT_BIAS = "2.bias"


def widedeep_profile(one, steps):
    """torch.profiler over ``one()`` (a pass of ``steps`` steps): wall,
    device busy and idle share, kernels, the top kernels by device time
    and the update kernel's share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    update = sum(e.self_device_time_total for e in kernels
                 if "update_kernel" in e.key)
    log(f"widedeep profile: one pass of {steps} steps, wall "
        f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
        f"({100 * busy / wall_us:.1f}% busy, "
        f"{100 * (1 - busy / wall_us):.1f}% idle), "
        f"{sum(e.count for e in kernels)} kernels, update_kernel "
        f"{update / 1e3:.3f} ms ({100 * update / max(busy, 1e-9):.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
            f"{100 * e.self_device_time_total / busy:5.1f}% "
            f"{e.count:5d}x  {e.key[:90]}")
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    host_us = sum(e.self_cpu_time_total for e in host)
    log(f"widedeep profile, the host: {host_us / 1e3:.3f} ms in PyTorch "
        f"ops of the {wall_us / 1e3:.3f} ms wall; by op, self time:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:12]:
        log(f"  {e.self_cpu_time_total / 1e3:9.3f} ms {e.count:5d}x  "
            f"{e.key[:90]}")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "update_ms": update / 1e3, "host_ops_ms": host_us / 1e3,
            "kernels": sum(e.count for e in kernels)}


def _wd_eager(bench, steps=WD_EAGER_STEPS):
    """``steps`` eager steps on the same table: distributed_lookup_table
    (through the runtime's async communicator), a fresh deep MLP, the
    loss, ``backward()`` (its push through the communicator) and the
    port's per-parameter ``Adam.step()``; examples/s with the pushes
    flushed."""
    from paddle_tpu_torch import tensor as T
    from paddle_tpu_torch.distributed.ps import (TheOnePSRuntime,
                                                 distributed_lookup_table)
    from paddle_tpu_torch.models.wide_deep import deep_mlp
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Adam

    batch, slots = bench.sizes.batch, bench.sizes.slots
    model = deep_mlp(slots, device=bench.device, seed=1)
    opt = Adam(learning_rate=1e-3, parameters=model.parameters())
    data = [bench.make_batch(batch) for _ in range(steps)]
    comm = TheOnePSRuntime.current().comm()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ids, labels in data:
        rows = distributed_lookup_table(ids, table_id=0, device=bench.device)
        out = model(T.reshape(rows, [batch, -1]))
        loss = F.binary_cross_entropy_with_logits(
            T.getitem(out, (slice(None), 0)),
            torch.as_tensor(labels, device=bench.device))
        loss.backward()
        opt.step()
        opt.clear_grad()
    comm.flush()
    last = float(loss.detach())
    secs = time.perf_counter() - t0
    return {"examples_per_s": batch * steps / secs, "seconds": secs,
            "loss": last, "steps": steps}


class _PassMarks:
    """Host times and CUDA events around a ``WideDeepBench``'s passes:
    its cache's ``begin_pass`` and ``end_pass`` and each ``pass_step``
    call are wrapped on the instances, so the driver itself carries no
    instrumentation."""

    def __init__(self, bench):
        self.host, self.events, self.passes = [], [], []
        cache, step = bench.cache, bench.pass_step
        begin, end = cache.begin_pass, cache.end_pass

        def begin_pass(*args, **kwargs):
            rec = {"begin": self.mark()}
            begin(*args, **kwargs)
            rec["steps"] = [self.mark()]
            self.passes.append(rec)

        def pass_step(*args, **kwargs):
            loss = step(*args, **kwargs)
            self.passes[-1]["steps"].append(self.mark())
            return loss

        def end_pass(*args, **kwargs):
            end(*args, **kwargs)
            self.passes[-1]["end"] = self.mark()

        cache.begin_pass, cache.end_pass = begin_pass, end_pass
        bench.pass_step = pass_step

    def mark(self) -> int:
        self.host.append(time.perf_counter())
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        return len(self.host) - 1

    def split(self, rec: dict) -> dict:
        """A pass's parts in ms, host and device, and its steps' device ms
        (after a wait for the card)."""
        host = lambda a, b: (self.host[b] - self.host[a]) * 1e3
        dev = lambda a, b: self.events[a].elapsed_time(self.events[b])
        steps = rec["steps"]
        return {"host_begin_ms": host(rec["begin"], steps[0]),
                "host_steps_ms": host(steps[0], steps[-1]),
                "host_end_ms": host(steps[-1], rec["end"]),
                "device_begin_ms": dev(rec["begin"], steps[0]),
                "device_steps_ms": dev(steps[0], steps[-1]),
                "device_end_ms": dev(steps[-1], rec["end"]),
                "step_ms": [dev(a, b) for a, b in zip(steps, steps[1:])]}


def phase_widedeep(dev, seed):
    """Phase 31: ``measure_widedeep`` at bench.py's accelerator sizes,
    launch counts reset just before ``WideDeepBench.run()`` and read just
    after (one fused_update a step: the warm pass's 2 and the timed 60;
    no other kernel of the port), then a profiled pass, as many passes
    again with their parts marked (``_PassMarks``) and the eager path."""
    from paddle_tpu_torch.models.wide_deep import (ACCELERATOR_SIZES,
                                                   STEPS_PER_PASS,
                                                   WideDeepBench)

    sizes = ACCELERATOR_SIZES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with WideDeepBench(sizes, dev, seed=seed) as bench:
        updater = bench.pass_step.updater
        reset_train_launch_counts()
        run = bench.run()
        counts = train_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = {k: 0 for k in counts}
        want["fused_update"] = len(run["losses"])
        if counts != want:
            raise AssertionError(f"launch counts {counts}, expected {want}")
        if not all(math.isfinite(x) for x in run["losses"]):
            raise AssertionError(f"non-finite Wide&Deep loss: "
                                 f"{run['losses']}")
        if not (0.5 < run["auc"] <= 1.0
                and run["table_rows"] == sizes.vocab):
            raise AssertionError(f"AUC {run['auc']}, table "
                                 f"{run['table_rows']}")
        if len(updater.buckets) != 1 or updater.buckets[0].size != 8321:
            raise AssertionError(f"the dense plan: "
                                 f"{[b.size for b in updater.buckets]}")
        batches = [bench.make_batch(sizes.batch)
                   for _ in range(sizes.steps)]
        profile = widedeep_profile(
            lambda: bench.run_pass(batches[:STEPS_PER_PASS]),
            STEPS_PER_PASS)
        marks = _PassMarks(bench)
        for i in range(0, sizes.steps, STEPS_PER_PASS):
            bench.run_pass(batches[i:i + STEPS_PER_PASS])
        torch.cuda.synchronize()
        passes = [marks.split(r) for r in marks.passes]
        eager = _wd_eager(bench)
    step_ms = [ms for p in passes for ms in p["step_ms"]]
    split = {k: statistics.median(p[k] for p in passes)
             for k in passes[0] if k != "step_ms"}
    summary = {"sizes": dict(sizes._asdict()),
               "examples_per_s": run["examples_per_s"],
               "seconds": run["seconds"], "auc": run["auc"],
               "loss": run["loss"], "table_rows": run["table_rows"],
               "launches": counts,
               "update_launches_per_step": counts["fused_update"]
               / len(run["losses"]),
               "buckets": [b.size for b in updater.buckets],
               "peak_memory_gib": peak, "profile": profile,
               "marked_step_ms_median": statistics.median(step_ms),
               "marked_step_ms_min": min(step_ms),
               "marked_step_ms_max": max(step_ms),
               "marked_pass_split_median_ms": split, "eager": eager}
    log("widedeep " + json.dumps(summary))
    log(f"widedeep (bench.py's accelerator sizes: batch {sizes.batch} x "
        f"{sizes.slots} slots, {sizes.steps} steps in passes of "
        f"{STEPS_PER_PASS}, vocab {sizes.vocab}, dim 8): "
        f"{run['examples_per_s']:.1f} examples/s, AUC {run['auc']:.6f} "
        f"over 4096 held-out rows, last loss {run['loss']:.7f}, table "
        f"{run['table_rows']} rows; fused_update "
        f"{summary['update_launches_per_step']:.0f} a step; peak "
        f"{peak:.4f} GiB. Marked passes: step "
        f"{summary['marked_step_ms_median']:.4f} ms (device, median); a "
        f"pass (median, host | device ms): begin_pass "
        f"{split['host_begin_ms']:.3f} | {split['device_begin_ms']:.3f}, "
        f"steps {split['host_steps_ms']:.3f} | "
        f"{split['device_steps_ms']:.3f}, end_pass "
        f"{split['host_end_ms']:.3f} | {split['device_end_ms']:.3f}")
    log(f"widedeep eager ({eager['steps']} steps of distributed_lookup_table"
        f", the MLP, backward() pushing through the async communicator, "
        f"Adam.step()): {eager['examples_per_s']:.1f} examples/s against "
        f"the pass step's {run['examples_per_s']:.1f} in this call")
    if not math.isfinite(eager["loss"]):
        raise AssertionError(f"eager loss {eager['loss']}")
    return counts, updater.buckets, summary


def _adam_timing(dev, gen, buckets, flush):
    """Wide&Deep's dense update (its plan: one fp32 bucket of the MLP's
    8,321 elements, Adam(1e-3); ``bucket_updater``'s scales): the one
    launch held bit for bit against its plain walk over 3 steps; then, in
    one call, the update as FusedFlatUpdater.step() calls it, the kernel
    alone, the plain walk and ``torch._fused_adam_`` over the same
    bucket, timed; the bound: p, g, m1 and m2 read, p, m1 and m2
    written, 28 bytes an element."""
    from torch_checks import FUSED_HYPER, buckets_vs_plain

    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.ops import fused_update as fu

    sizes = [b.size for b in buckets]
    upd = bucket_updater(sizes, gen, make_opt=lambda ps: optim.Adam(
        learning_rate=1e-3, parameters=ps))
    lr = torch.full((), 1e-3, device=dev)
    ps = [upd._flat_p[i] for i in range(len(sizes))]
    gs = [upd._flat_g[i] for i in range(len(sizes))]
    m1 = [upd._slots[i]["moment1"] for i in range(len(sizes))]
    m2 = [upd._slots[i]["moment2"] for i in range(len(sizes))]
    entries = [(p.clone(), g.clone(), [a.clone(), c.clone()], 0.0, 1.0)
               for p, g, a, c in zip(ps, gs, m1, m2)]
    launches = buckets_vs_plain("adam", FUSED_HYPER["adam"], entries, lr,
                                steps=3, gen=gen)
    del entries
    if launches != 3:
        raise AssertionError(f"fused_update_buckets: {launches} launches "
                             f"for 3 adam steps")
    log(f"fused_update, adam over Wide&Deep's {len(sizes)} fp32 bucket(s) "
        f"({sizes} elements): bit-identical to its plain walk over 3 "
        f"steps, beta powers included, in {launches} launches")
    table = upd._table
    if table.kind != "adam":
        raise AssertionError(f"the updater's rule is {table.kind}")

    def kernel():   # the same powers each time
        fu.fused_update_buckets(table, lr)
        table.parity = 1 - table.parity

    def plain():
        fu.buckets_plain(table, lr)

    a1, a2 = [a.clone() for a in m1], [c.clone() for c in m2]
    steps = [torch.full((), 4.0, device=dev) for _ in sizes]

    def library():
        torch._fused_adam_(ps, gs, a1, a2, [], steps, lr=1e-3, beta1=0.9,
                           beta2=0.999, weight_decay=0.0, eps=1e-8,
                           amsgrad=False, maximize=False)

    n = sum(sizes)
    # read p, g, m1, m2; write p, m1, m2 (fp32); ~20 operations an element
    bound_ms, bound_by = work_bound(28 * n, 20 * n)
    return {"shape": f"{len(sizes)} bucket(s), {n} elements (one step, "
                     f"float32, adam)",
            "library_form": "torch._fused_adam_, fp32 moments",
            "max_abs_err": 0.0, "step_ms": median_ms(upd.step, flush),
            "ms": median_ms(kernel, flush),
            "library_ms": median_ms(library, flush),
            "step_span_ms": span_ms(upd.step, flush),
            "span_ms": span_ms(kernel, flush),
            "library_span_ms": span_ms(library, flush),
            "plain_ms": median_ms(plain, flush), "bound_ms": bound_ms,
            "bound_by": bound_by, "largest_bucket": max(sizes),
            "smallest_bucket": min(sizes)}


def phase_widedeep_update(dev, gen, buckets):
    """Row 6 at Wide&Deep's plan (phase 31's buckets), timed three ways
    beside ``torch._fused_adam_`` and the bound."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    row = _adam_timing(dev, gen, buckets, flush)
    log(f"fused_update, Wide&Deep's {row['shape']}, one launch, device "
        f"time (from an idle card): as FusedFlatUpdater.step() calls it "
        f"{row['step_ms']:.4f} ms ({row['step_span_ms']:.4f}), the kernel "
        f"alone {row['ms']:.4f} ({row['span_ms']:.4f}), torch._fused_adam_ "
        f"{row['library_ms']:.4f} ({row['library_span_ms']:.4f}); plain "
        f"{row['plain_ms']:.4f}; bound {row['bound_ms']:.5f} "
        f"{row['bound_by']}, the kernel at "
        f"{100 * row['bound_ms'] / row['ms']:.2f}% of it")
    del flush
    return row


def _wd_first_step(device, seed):
    """One pass step at bench.py's CPU sizes on ``device`` (the bench's
    set-up, its first batch and a second in the pass): the loss, the dense
    parameters before and after and their gradients, the slab before and
    after and the slab's gradient (caught in the table rule), all on the
    CPU, and ``dz_abs_sum``: the sum of the sizes of the batch's
    dL/dlogit, ``|sigmoid(z) - y| / batch``, which the output bias's
    gradient adds up."""
    from paddle_tpu_torch.models.wide_deep import CPU_SIZES, WideDeepBench

    with WideDeepBench(CPU_SIZES, device, seed=seed) as bench:
        b0, b1 = (bench.make_batch(CPU_SIZES.batch) for _ in range(2))
        cache, step = bench.cache, bench.pass_step
        cache.begin_pass(np.concatenate([b0[0].reshape(-1),
                                         b1[0].reshape(-1)]),
                         pad_to=CPU_SIZES.vocab)
        caught = {}
        rule = step._table_rule

        def spy(cache_, rows, g):
            caught["g_rows"] = g.detach().cpu().clone()
            rule(cache_, rows, g)

        step._table_rule = spy
        named = dict(bench.deep.named_parameters())
        before = {n: p.detach().cpu().clone() for n, p in named.items()}
        rows0 = cache._rows.detach().cpu().clone()
        with torch.no_grad():
            flat = cache.lookup(b0[0]).reshape(CPU_SIZES.batch, -1)
            z = bench.deep(flat)[:, 0].cpu()
        dz = (torch.sigmoid(z) - torch.as_tensor(b0[1])) / CPU_SIZES.batch
        loss = float(step(cache, b0))
        out = {"loss": loss, "rows0": rows0,
               "rows1": cache._rows.detach().cpu().clone(),
               "gacc": cache._gacc.detach().cpu().clone(), **caught,
               "dz_abs_sum": float(dz.abs().sum()),
               "params": {n: (before[n], p.detach().cpu().clone(),
                              p.grad.detach().cpu().clone())
                          for n, p in named.items()}}
        cache.end_pass(assign=True)
    return out


def _wd_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _wd_run(device, seed, weights=None):
    """``WideDeepBench.run()`` at bench.py's CPU sizes: losses, AUC, the
    table's rows and a pull of fresh keys (never seen in the run)."""
    from paddle_tpu_torch.models.wide_deep import CPU_SIZES, WideDeepBench

    with WideDeepBench(CPU_SIZES, device, weights=weights,
                       seed=seed) as bench:
        run = bench.run()
        table = bench.ps.tables[0]
        keys = np.sort(table.keys())
        fresh = np.arange(10 ** 9, 10 ** 9 + 64, dtype=np.uint64)
        run.update(rows=table.pull(keys, create_if_missing=False),
                   keys=keys, fresh=table.pull(fresh))
    return run


def phase_widedeep_parity(dev, seed):
    """Phase 32: ``WideDeepBench.run()`` at bench.py's CPU sizes (128 x
    8, 30 steps, vocab 2000) on the card and on the CPU in this process
    (one host table library), same batches, same seeded weights. The
    first step: loss, dense gradients and the slab's gradient within
    ``WD_FIRST_RTOL`` (of each tensor's largest; the output bias's of
    the sum of its terms' sizes), Adam's step by ``adam_step_parity``,
    and the card's
    Adagrad update equal bit for bit to the rule applied in numpy's fp32
    to the card's own slab gradient. The whole run: every loss, the
    table's rows and the AUC within the larger of ``WD_NOISE_FACTOR``
    times the CPU's own move under one ulp of the deep arm's weights and
    ``WD_FLOORS``. Two card runs bit-identical, or where they first part
    printed; fresh keys pulled bit-identical in every run."""
    from torch_checks import adam_step_parity

    from paddle_tpu_torch.models.convert import dense_state_dict_from_numpy
    from paddle_tpu_torch.models.wide_deep import CPU_SIZES, deep_mlp

    card, cpu = _wd_first_step(dev, seed), _wd_first_step("cpu", seed)
    first = {"loss": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
             "g_rows": _wd_rel(card["g_rows"], cpu["g_rows"]),
             "grads": {n: _wd_rel(card["params"][n][2], cpu["params"][n][2])
                       for n in cpu["params"]}}
    bias = WD_OUT_BIAS
    g_bias = cpu["params"][bias][2].abs().max()
    bias_rtol = WD_FIRST_RTOL * cpu["dz_abs_sum"] / float(g_bias)
    first["out_bias_of_terms"] = (first["grads"][bias] * float(g_bias)
                                  / cpu["dz_abs_sum"])
    log(f"widedeep first step card vs CPU, of each tensor's largest: "
        f"{first}; the output bias's gradient {float(g_bias):.3e}, its "
        f"terms' sizes sum to {cpu['dz_abs_sum']:.4f}")
    rest = [n for n in cpu["params"] if n != bias]
    adam = adam_step_parity({n: card["params"][n] for n in rest},
                            {n: cpu["params"][n] for n in rest}, 1e-3,
                            grad_rtol=WD_FIRST_RTOL)
    adam_bias = adam_step_parity({bias: card["params"][bias]},
                                 {bias: cpu["params"][bias]}, 1e-3,
                                 grad_rtol=bias_rtol)
    g, rows0 = card["g_rows"].numpy(), card["rows0"].numpy()
    gacc = g * g
    want = rows0 - np.float32(0.1) * g / np.sqrt(gacc + np.float32(1e-8))
    rule_bits = (np.array_equal(card["gacc"].numpy(), gacc)
                 and np.array_equal(card["rows1"].numpy().view(np.uint32),
                                    want.view(np.uint32)))
    log(f"widedeep first step card vs CPU: loss {card['loss']:.8f} vs "
        f"{cpu['loss']:.8f} (rel {first['loss']:.2e}), dense gradients "
        f"{adam['grad_rtol']:.2e} of the largest, the output bias's "
        f"{first['out_bias_of_terms']:.2e} of its terms' sizes, slab "
        f"gradient {first['g_rows']:.2e}, Adam's clear steps "
        f"{max(adam['clear_step_diff_lr'], adam_bias['clear_step_diff_lr']):.2e}"
        f" lr apart ({100 * adam['clear_share']:.1f}% clear, the output "
        f"bias apart); the card's Adagrad "
        f"update the rule on its own gradient bit for bit: {rule_bits}")
    if not (first["loss"] <= WD_FIRST_RTOL
            and first["g_rows"] <= WD_FIRST_RTOL and rule_bits):
        raise AssertionError(f"widedeep first step: {first}, rule "
                             f"{rule_bits}")
    runs = {"card": _wd_run(dev, seed), "card again": _wd_run(dev, seed),
            "cpu": _wd_run("cpu", seed)}
    proto = deep_mlp(CPU_SIZES.slots, device="cpu", seed=seed)
    arrays = {n: t.detach().numpy().copy()
              for n, t in proto.named_parameters()}
    noise = {"losses": 0.0, "rows": 0.0, "auc": 0.0}
    base = runs["cpu"]
    for name, way in WD_NOISE_DRAWS:
        moved = dict(arrays)
        moved[name] = np.nextafter(arrays[name],
                                   np.float32(way * np.inf))
        r = _wd_run("cpu", seed, dense_state_dict_from_numpy(moved, proto))
        noise["losses"] = max(noise["losses"],
                              _wd_rel(r["losses"], base["losses"]))
        noise["rows"] = max(noise["rows"], _wd_rel(r["rows"], base["rows"]))
        noise["auc"] = max(noise["auc"], abs(r["auc"] - base["auc"]))
    a, b = runs["card"], runs["cpu"]
    if not np.array_equal(a["keys"], b["keys"]):
        raise AssertionError("the card's and the CPU's tables hold other "
                             "keys")
    errs = {"losses": _wd_rel(a["losses"], b["losses"]),
            "rows": _wd_rel(a["rows"], b["rows"]),
            "auc": abs(a["auc"] - b["auc"])}
    limits = {k: max(WD_NOISE_FACTOR * noise[k], WD_FLOORS[k])
              for k in errs}
    log(f"widedeep at bench.py's CPU sizes, card vs CPU: {errs}; limits "
        f"{limits} (the CPU's own move at one ulp of the deep weights, "
        f"{len(WD_NOISE_DRAWS)} draws: {noise}); AUC card "
        f"{a['auc']:.7f}, CPU {b['auc']:.7f}; examples/s card "
        f"{a['examples_per_s']:.1f}, CPU {b['examples_per_s']:.1f}")
    bad = [k for k in errs if not errs[k] <= limits[k]]
    if bad:
        raise AssertionError(f"widedeep card vs CPU: {bad} over the limit")
    c2 = runs["card again"]
    same = {"losses": a["losses"] == c2["losses"],
            "rows": np.array_equal(a["rows"].view(np.uint32),
                                   c2["rows"].view(np.uint32)),
            "auc": a["auc"] == c2["auc"]}
    if all(same.values()):
        log("widedeep: two card runs bit-identical (losses, table rows, "
            "AUC)")
    else:
        again = _wd_first_step(dev, seed)
        part = next((i for i, (x, y) in enumerate(zip(a["losses"],
                                                      c2["losses"]))
                     if x != y), None)
        slab = torch.equal(again["g_rows"], card["g_rows"])
        dense = all(torch.equal(again["params"][n][2], card["params"][n][2])
                    for n in card["params"])
        log(f"widedeep: two card runs differ: {same}; the losses first at "
            f"step {part}; a second first step's slab gradient equal: "
            f"{slab} (the gather's backward), its dense gradients equal: "
            f"{dense} (cuBLAS)")
    fresh = [r["fresh"] for r in runs.values()]
    if not all(np.array_equal(f.view(np.uint32), fresh[0].view(np.uint32))
               for f in fresh):
        raise AssertionError("fresh-key pulls differ between the runs")
    log(f"widedeep: fresh-key pulls bit-identical in all {len(fresh)} runs "
        f"(one host table library in this process)")
    return {"first": {**first, **adam, "out_bias": adam_bias},
            "errs": errs, "limits": limits,
            "noise": noise, "card_runs_identical": same}

def kernels_line(rows, counts, train_rows, train_counts, infer_rows,
                 conversion, infer_counts, dp_row, carrier_rows, dp_rank,
                 bf16_rows, bf16_counts, dp16, ce_rows, ce_counts, bert_run,
                 resnet_run, widedeep_run):
    """One entry per kernel at the shape behind most of its launches on
    its path: the codecs at the int8 decode-step append (8 x EPT, with
    the serve phase's launches), the flash kernels and fused_update at
    the train step, quantize_int8 and quant_matmul at their most launched
    shape in the infer phase (``launches_at_shape``, counted there),
    fused_dequant_update at one step's buckets of the dp train phase (its
    launches those of rank 0 there, with the most launched bucket size);
    ``at_shapes`` holds the other shapes: the codecs' other serve shapes,
    codec_encode's gradient-wire carrier at each bucket shape (with rank
    0's launches there in the dp train phase as ``launches_at_shape``),
    flash_fwd's BERT-base shape with its infer-phase launches. SDPA's
    backward computes dq, dk and dv in one call: it stands as
    ``library_ms`` of flash_dkv beside ``pair_ms``, the two backward
    kernels' times summed, and flash_dq has none of its own. The bf16
    forms are entries of their own (``flash_fwd_bf16`` etc. at the bf16
    train step, ``fused_update_bf16``: the same kernel over the bf16
    plan), their launches those of the bf16 train phase. So are the
    gradient wire's bf16 forms (``dp16``: phase 13's bf16 rows and rank 0
    of the dp-train bf16 phase): ``codec_encode_bf16`` at the largest
    bf16 bucket (the others in ``at_shapes``), its launches those of the
    TrainStep's first step, the one that encodes from bf16, and of the
    DataParallel rounds; ``codec_decode_bf16`` likewise, its launches the
    DataParallel rounds'; ``fused_dequant_update_bf16``, the one launch
    over the bf16 plan, its launches the timed steps'. The fused loss's
    chunk kernels, beyond the TPU set (they replace jnp stages, not a
    Pallas kernel): ``ce_chunk_fwd`` and ``ce_chunk_bwd`` at the full
    chunk (phase 21), the ragged last chunk in ``at_shapes``, their
    launches those of phase 22's timed steps. BERT's shapes (``bert_run``,
    phases 25 and 27) are ``at_shapes`` of the kernels they share, with
    phase 25's launches (unfused, or fused for the chunk kernels): the
    bf16 flash trio in full mode at [16, 12, 512, 64], ``fused_update``
    over BERT-base's fp32 plan, the chunk kernels at 8192 and 5946
    columns; ``quant_matmul_bf16``, the bf16 form of ``_qmm_kernel``, is
    an entry of its own at the O2 int8 forward's most launched shape,
    its launches phase 27's timed forwards'. ResNet-50's update (phases
    29 and its row) is an ``at_shapes`` entry of ``fused_update``: the
    momentum rule over its fp32 plan, with phase 29's launches; so is
    Wide&Deep's (phase 31 and its row): the adam rule over its one fp32
    bucket, with phase 31's launches."""
    from paddle_tpu_torch.ops.codec import KERNEL_SOURCE

    def numbers(r, p):
        return {"shape": r["shape"], "max_abs_err": r[f"{p}_err"],
                "ms": r[f"{p}_ms"], "plain_ms": r[f"{p}_plain_ms"],
                "bound_ms": r[f"{p}_bound_ms"],
                "bound_by": r[f"{p}_bound_by"],
                "library_ms": r[f"{p}_library_ms"],
                "launch_floor_ms": r["launch_floor_ms"]}

    out = []
    for name, p, line in (("codec_encode", "enc", 93),
                          ("codec_decode", "dec", 138)):
        int8 = {shape: r for (c, shape), r in rows.items()
                if c == "int8_block" and name in r["on_path"]}
        out.append(dict(
            name=name, route="cuda", source=KERNEL_SOURCE,
            replaces=f"paddle_tpu/ops/pallas/codec.py:{line}",
            launches=counts[name], **numbers(int8.pop(MAIN_SHAPE), p),
            at_shapes=[numbers(r, p) for r in int8.values()]))
    enc = dp_rank["encode_shapes"]
    out[0]["at_shapes"] += [
        dict(_numbers(r), launches_at_shape=enc.get(
            (nb, DP_BLOCK, "int8_block", True), 0))
        for nb, r in carrier_rows.items()]
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_update as fu

    for name, source, replaces in (
            ("flash_fwd", fa.KERNEL_SOURCE,
             "paddle_tpu/ops/flash_attention.py:118"),
            ("flash_dq", fa.KERNEL_SOURCE,
             "paddle_tpu/ops/flash_attention.py:213"),
            ("flash_dkv", fa.KERNEL_SOURCE,
             "paddle_tpu/ops/flash_attention.py:251"),
            ("fused_update", fu.KERNEL_SOURCE,
             "paddle_tpu/ops/pallas/fused_update.py:122")):
        r = train_rows[name]
        out.append(dict(name=name, route="cuda", source=source,
                        replaces=replaces, launches=train_counts[name],
                        **_numbers(r)))
    bert = dict(_numbers(infer_rows["flash_fwd"]),
                launches=infer_counts["flash_fwd"])
    next(e for e in out if e["name"] == "flash_fwd")["at_shapes"] = [bert]
    pair = train_rows[PAIR]
    next(e for e in out if e["name"] == "flash_dkv").update(
        pair_ms=pair["ms"], library_ms=pair["library_ms"])
    for name, replaces in (
            ("flash_fwd", "paddle_tpu/ops/flash_attention.py:118"),
            ("flash_dq", "paddle_tpu/ops/flash_attention.py:213"),
            ("flash_dkv", "paddle_tpu/ops/flash_attention.py:251"),
            ("fused_update", "paddle_tpu/ops/pallas/fused_update.py:122")):
        update = name == "fused_update"
        out.append(dict(name=name + "_bf16", route="cuda",
                        source=(fu if update else fa).KERNEL_SOURCE,
                        replaces=replaces,
                        launches=bf16_counts[name if update
                                             else name + "_bf16"],
                        **_numbers(bf16_rows[name])))
    pair = bf16_rows[PAIR]
    next(e for e in out if e["name"] == "flash_dkv_bf16").update(
        pair_ms=pair["ms"], library_ms=pair["library_ms"])
    qm = _quant_module()
    for name, launches, line in (
            ("quantize_int8", conversion["quantize_int8"], 63),
            ("quant_matmul", infer_counts["quant_matmul"], 110)):
        main, *rest = infer_rows[name]
        out.append(dict(name=name, route="cuda", source=qm.KERNEL_SOURCE,
                        replaces=f"paddle_tpu/ops/quant_matmul.py:{line}",
                        launches=launches, **_numbers(main),
                        at_shapes=[_numbers(r) for r in rest]))
    for name, row, rank in (("fused_dequant_update", dp_row, dp_rank),
                            ("fused_dequant_update_bf16", dp16["table"],
                             dp16["rank"])):
        out.append(dict(name=name, route="cuda", source=fu.KERNEL_SOURCE,
                        replaces="paddle_tpu/ops/pallas/fused_update.py:134",
                        launches=rank["counts"]["fused_dequant_update"],
                        buckets_a_launch=len(rank["buckets"]),
                        **_numbers(row)))
    r16 = dp16["rank"]
    dp_counts = r16["data_parallel"]["counts"]
    for name, rows, launches, line in (
            ("codec_encode_bf16", dp16["encode"],
             r16["first_step_counts"]["codec_encode_bf16"]
             + dp_counts["codec_encode_bf16"], 93),
            ("codec_decode_bf16", dp16["decode"],
             dp_counts["codec_decode_bf16"], 138)):
        bf = {nb: r for nb, r in rows.items() if "bfloat16" in r["shape"]}
        main = max(bf)
        out.append(dict(name=name, route="cuda", source=KERNEL_SOURCE,
                        replaces=f"paddle_tpu/ops/pallas/codec.py:{line}",
                        launches=launches, **_numbers(bf.pop(main)),
                        at_shapes=[_numbers(r) for r in bf.values()]))
    from paddle_tpu_torch.ops import fused_ce as fce

    for name, line in (("ce_chunk_fwd", 231), ("ce_chunk_bwd", 266)):
        widths = sorted((c for n, c in ce_rows if n == name), reverse=True)
        out.append(dict(
            name=name, route="cuda", source=fce.KERNEL_SOURCE,
            replaces=f"paddle_tpu/incubate/nn/functional.py:{line}",
            beyond_tpu_set=True, launches=ce_counts[name],
            **_numbers(ce_rows[(name, widths[0])]),
            at_shapes=[_numbers(ce_rows[(name, c)]) for c in widths[1:]]))
    by_name = {e["name"]: e for e in out}
    run = bert_run
    counts25, counts_ce = run["counts"], run["counts_ce"]
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        by_name[name + "_bf16"].setdefault("at_shapes", []).append(dict(
            _numbers(run["rows"][name]),
            launches_at_shape=counts25[name + "_bf16"]))
    by_name["fused_update"].setdefault("at_shapes", []).append(dict(
        _numbers(run["rows"]["fused_update"]),
        launches_at_shape=counts25["fused_update"]))
    steps = counts25["fused_update"]
    for (name, c), r in run["ce_rows"].items():
        chunks = sum(1 for _, w in ce_chunk_shapes(run["cfg_ce"]) if w == c)
        by_name[name]["at_shapes"].append(dict(
            _numbers(r), launches_at_shape=chunks * steps))
    if counts_ce["ce_chunk_fwd"] != loss_chunks(run["cfg_ce"]) * steps:
        raise AssertionError("the fused BERT step's chunk launches are not "
                             "the timed steps'")
    for extra in (resnet_run, widedeep_run):
        by_name["fused_update"]["at_shapes"].append(dict(
            _numbers(extra["row"]),
            launches_at_shape=extra["counts"]["fused_update"]))
    routes = run["qmm_routes"]
    for name, cluster in (("quant_matmul_bf16", False),
                          ("quant_matmul_bf16_cluster", True)):
        main, *rest = [r for r in run["qmm_rows"]
                       if (r["bf16_route"] == "cluster") == cluster]
        out.append(dict(name=name, route="cuda", source=qm.KERNEL_SOURCE,
                        replaces="paddle_tpu/ops/quant_matmul.py:110",
                        launches=sum(n for r, n in routes.items()
                                     if (r == "cluster") == cluster),
                        routes=dict(routes), **_numbers(main),
                        at_shapes=[_numbers(r) for r in rest]))
    return {"kernels": out}


def phase_bert(dev, gen, seed, infer32):
    """Phases 25-27, ``bench.py``'s bert mode (``measure_bert``) and int8
    BERT under O2; ``infer32`` is phase 10's summary, for the int8
    forward's time beside it. Returns what the kernels line reads."""
    import dataclasses

    from paddle_tpu_torch.models import bert_presets

    cfg = bert_presets("bert-base")
    cfg_ce = dataclasses.replace(cfg, fused_loss_chunk=CE_CHUNK)
    counts, step, batch, unfused = phase_bert_train(cfg, dev, seed)
    plan = step.buckets
    phase_train_profile(lambda: bert_step(step, batch), names=BF16_KERNELS,
                        tag=" bert O2")
    del step, batch
    torch.cuda.empty_cache()
    counts_ce, step, batch, fused = phase_bert_train(cfg_ce, dev, seed)
    log(f"bert train O2, fused_loss_chunk={CE_CHUNK} against unfused in "
        f"this call: step {fused['step_ms_median']:.2f} ms against "
        f"{unfused['step_ms_median']:.2f}, {fused['samples_per_s']:.1f} "
        f"samples/s against {unfused['samples_per_s']:.1f}, peak "
        f"{fused['peak_memory_gib']:.2f} GiB against "
        f"{unfused['peak_memory_gib']:.2f}; first loss "
        f"{fused['losses'][0]:.7f} against {unfused['losses'][0]:.7f}")
    phase_train_profile(lambda: bert_step(step, batch),
                        names=BF16_KERNELS + CE_KERNELS,
                        tag=" bert O2" + _variant(cfg_ce))
    del step, batch
    torch.cuda.empty_cache()
    before = clocks("before bert train-kernels")
    rows, ce_rows = phase_bert_train_kernels(dev, gen, plan, cfg_ce)
    stamp([*rows.values(), *ce_rows.values()], before,
          clocks("after bert train-kernels"))
    log_ratios("bert train-kernels", {**rows, **{f"{n} {c}": r for (n, c), r
                                                 in ce_rows.items()}})
    torch.cuda.empty_cache()
    phase_bert_train_parity(dev, seed)
    torch.cuda.empty_cache()

    _, infer_counts, model, batch, infer16 = phase_infer(dev, seed,
                                                         level="O2")
    phase_infer_profile(model, batch, level="O2")
    del model, batch
    torch.cuda.empty_cache()
    log(f"infer O2 against phase 10 (fp32 activations) in this call: "
        f"forward {infer16['forward_ms_median']:.2f} ms against "
        f"{infer32['forward_ms_median']:.2f}, "
        f"{infer16['samples_per_s']:.1f} samples/s against "
        f"{infer32['samples_per_s']:.1f}, peak "
        f"{infer16['peak_memory_gib']:.2f} GiB against "
        f"{infer32['peak_memory_gib']:.2f}")
    counts_b1 = phase_infer_b1(dev, seed)
    before = clocks("before int8-kernels bf16")
    qmm_rows = phase_infer_kernels_bf16(
        dev, gen, infer_counts["shapes"]["quant_matmul_bf16"]
        + counts_b1["shapes"]["quant_matmul_bf16"])
    stamp(qmm_rows, before, clocks("after int8-kernels bf16"))
    log_ratios("int8-kernels bf16", {str(i): r
                                     for i, r in enumerate(qmm_rows)})
    return {"counts": counts, "counts_ce": counts_ce, "rows": rows,
            "ce_rows": ce_rows, "cfg_ce": cfg_ce, "qmm_rows": qmm_rows,
            "qmm_routes": infer_counts["routes"] + counts_b1["routes"]}


def phase_infer_b1(dev, seed, b=INFER_B1[0], s=INFER_B1[1]):
    """Phase 27's second shape: the same int8 BERT-base forward under O2
    at batch 1 x 64 tokens, where every bf16 launch has m <= 64 (the
    cluster route) and the fp32 ones take ``qmm_kernel`` (row 9): forward
    ms, launches by route, device time by kernel and the two routes'
    shares of it. Returns its launch counts."""
    _, counts, model, batch, summary = phase_infer(dev, seed, b=b, s=s,
                                                   level="O2")
    busy_us, split = phase_infer_profile(model, batch, level="O2",
                                         tag=f"{b} x {s}")
    del model, batch
    torch.cuda.empty_cache()
    iters = len(summary["forward_ms"])
    a_forward = {r: n // iters for r, n in counts["routes"].items()}
    log(f"infer O2 {b} x {s}: forward {summary['forward_ms_median']:.3f} "
        f"ms (median of {iters}), device busy {busy_us / 1e3:.3f} ms a "
        f"forward; quant_matmul_bf16 "
        f"{counts['quant_matmul_bf16'] // iters} launches a forward, by "
        f"route {a_forward}, the cluster route "
        f"{split['qmm_cluster_kernel'] / 1e3:.4f} ms "
        f"({100 * split['qmm_cluster_kernel'] / busy_us:.1f}% of the "
        f"device time); quant_matmul on fp32 x (row 9) "
        f"{counts['quant_matmul'] // iters} launches a forward, qmm_kernel "
        f"{split['qmm_kernel'] / 1e3:.4f} ms "
        f"({100 * split['qmm_kernel'] / busy_us:.1f}%)")
    return counts


def _numbers(r) -> dict:
    keys = ("shape", "max_abs_err", "ms", "bias_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_form", "launches_at_shape",
            "bf16_route",
            "err_over_limit", "step_ms", "step_span_ms", "clocks")
    return {k: r[k] for k in keys if k in r}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))   # torch_checks
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_presets
    from paddle_tpu_torch.serving import GPTDecodeModel

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    phase_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    cfg = gpt_presets("gpt-125m")
    rows = phase_kernels(dev, gen, {
        **serve_shapes(_traffic(args.seed, cfg.vocab_size)), **CAP_SHAPES})
    log_ratios("kernels", {f"{c} {sh}": r for (c, sh), r in rows.items()})

    t0 = time.perf_counter()
    cpu_model = GPTForCausalLM(cfg, seed=0, device="cpu")
    cuda_model = GPTForCausalLM(cfg, seed=0, device=dev)
    log(f"gpt-125m weights (seed 0) on cpu and {dev} in "
        f"{time.perf_counter() - t0:.1f} s")
    cuda_dm = GPTDecodeModel(cuda_model)
    counts = phase_serve(cuda_dm, args.seed)
    phase_parity(cuda_dm, GPTDecodeModel(cpu_model))
    phase_profile(cuda_dm, args.seed)
    del cuda_dm, cuda_model, cpu_model
    torch.cuda.empty_cache()

    plan = bucket_plan(cfg)
    before = clocks("before train-kernels")
    train_rows = phase_train_kernels(dev, gen, plan)
    stamp(train_rows.values(), before, clocks("after train-kernels"))
    log_ratios("train-kernels", train_rows)
    train_counts, step, ids, labels, _ = phase_train(cfg, dev, args.seed)
    if [b.size for b in step.buckets] != [b.size for b in plan]:
        raise AssertionError("the train step's bucket plan is not the "
                             "timed one")
    phase_train_profile(lambda: bench_step(step, cfg, ids, labels))
    del step
    torch.cuda.empty_cache()
    phase_train_parity(cfg, dev, args.seed)
    torch.cuda.empty_cache()

    conversion, infer_counts, bert, batch, infer32 = phase_infer(dev,
                                                                 args.seed)
    phase_infer_profile(bert, batch)
    del bert, batch
    torch.cuda.empty_cache()
    before = clocks("before int8-kernels")
    infer_rows = phase_infer_kernels(dev, gen, {
        "quantize_int8": conversion["shapes"]["quantize_int8"],
        "quant_matmul": infer_counts["shapes"]["quant_matmul"]})
    timed = {**{f"{name} {i}": r for name in ("quantize_int8", "quant_matmul")
                for i, r in enumerate(infer_rows[name])},
             "flash_fwd": infer_rows["flash_fwd"]}
    stamp(timed.values(), before, clocks("after int8-kernels"))
    log_ratios("int8-kernels", timed)
    phase_infer_parity(dev, args.seed)
    torch.cuda.empty_cache()

    # bench.py's own training configuration (measure_gpt, bench.py:166)
    cfg16 = gpt_presets("gpt-125m", max_position_embeddings=1024,
                        dtype="bfloat16")
    plan16 = bucket_plan(cfg16)
    before = clocks("before dp-kernels")
    dp_row, carrier_rows = phase_dp_kernels(dev, gen, plan)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    enc16, dec16, table16 = phase_dp_kernels_bf16(dev, gen, plan16)
    log(f"dp-kernels, the bf16 plan: {time.perf_counter() - t0:.1f} s")
    timed = {"fused_dequant_update": dp_row,
             "fused_dequant_update bf16 plan": table16,
             **{f"carrier {nb}": r for nb, r in carrier_rows.items()},
             **{f"carrier from bf16 plan {nb}": r for nb, r in enc16.items()},
             **{f"decode to bf16 plan {nb}": r for nb, r in dec16.items()}}
    stamp(timed.values(), before, clocks("after dp-kernels"))
    log_ratios("dp-kernels", timed)
    torch.cuda.empty_cache()
    dp_rank = phase_dp_train(cfg, args.seed)
    if dp_rank["buckets"] != [b.size for b in plan]:
        raise AssertionError("the dp train step's bucket plan is not the "
                             "timed one")
    phase_dp_parity(args.seed)
    torch.cuda.empty_cache()

    before = clocks("before train-kernels bf16")
    bf16_rows = phase_train_kernels_bf16(dev, gen, plan16)
    stamp(bf16_rows.values(), before, clocks("after train-kernels bf16"))
    log_ratios("train-kernels bf16", bf16_rows)
    bf16_counts, step, ids, labels, train16 = phase_train(cfg16, dev,
                                                          args.seed)
    if [(b.size, b.dtype) for b in step.buckets] != [(b.size, b.dtype)
                                                    for b in plan16]:
        raise AssertionError("the bf16 train step's bucket plan is not the "
                             "timed one")
    phase_train_profile(lambda: bench_step(step, cfg16, ids, labels),
                        names=BF16_KERNELS)
    del step
    torch.cuda.empty_cache()
    lm_head_gemms(dev, gen, cfg16)
    torch.cuda.empty_cache()
    phase_train_parity(cfg16, dev, args.seed)
    torch.cuda.empty_cache()

    dp16_rank = phase_dp_train(cfg16, args.seed, steps=DP16_STEPS,
                               dp_rounds=2)
    if [(n, dt) for n, dt in zip(dp16_rank["buckets"],
                                 dp16_rank["bucket_dtypes"])] != \
            [(b.size, str(b.dtype)) for b in plan16]:
        raise AssertionError("the bf16 dp train step's bucket plan is not "
                             "the timed one")
    torch.cuda.empty_cache()
    phase_dp_parity_bf16(cfg16, args.seed)
    torch.cuda.empty_cache()

    # bench.py's training options (measure_gpt: BENCH_FUSED_CE, and
    # BENCH_GPT_REMAT), then a schedule and a clip, each beside phase 17
    import dataclasses

    from torch_checks import BF16_LOSS_RTOL

    before = clocks("before fused-ce kernels")
    ce_rows = phase_fused_ce_kernels(dev, gen, cfg16)
    stamp(ce_rows.values(), before, clocks("after fused-ce kernels"))
    log_ratios("fused-ce kernels", {f"{n} {c}": r
                                    for (n, c), r in ce_rows.items()})
    torch.cuda.empty_cache()
    cfg_ce = dataclasses.replace(cfg16, fused_loss_chunk=CE_CHUNK)
    ce_counts, step, ids, labels, train_ce = phase_train(cfg_ce, dev,
                                                         args.seed)
    first = abs(train_ce["losses"][0] - train16["losses"][0]) / abs(
        train16["losses"][0])
    log(f"train bf16, fused_loss_chunk={CE_CHUNK} against phase 17 in this "
        f"call: step {train_ce['step_ms_median']:.2f} ms against "
        f"{train16['step_ms_median']:.2f}, "
        f"{train_ce['tokens_per_s']:.0f} tokens/s against "
        f"{train16['tokens_per_s']:.0f}, peak "
        f"{train_ce['peak_memory_gib']:.2f} GiB against "
        f"{train16['peak_memory_gib']:.2f}; first loss "
        f"{train_ce['losses'][0]:.7f} against {train16['losses'][0]:.7f} "
        f"(rel {first:.2e}, limit {BF16_LOSS_RTOL:.0e})")
    if not first <= BF16_LOSS_RTOL:
        raise AssertionError("the fused step's first loss is not phase "
                             "17's")
    phase_train_profile(lambda: bench_step(step, cfg_ce, ids, labels),
                        names=BF16_KERNELS + CE_KERNELS,
                        tag=_variant(cfg_ce))
    del step
    torch.cuda.empty_cache()
    phase_train_parity(cfg_ce, dev, args.seed)
    torch.cuda.empty_cache()

    cfg_remat = dataclasses.replace(cfg16, recompute=True)
    _, step, ids, labels, train_remat = phase_train(cfg_remat, dev,
                                                    args.seed)
    phase_train_profile(lambda: bench_step(step, cfg_remat, ids, labels),
                        names=BF16_KERNELS, tag=_variant(cfg_remat), top=5)
    del step
    log(f"train bf16, recompute against phase 17 in this call: step "
        f"{train_remat['step_ms_median']:.2f} ms against "
        f"{train16['step_ms_median']:.2f}, peak "
        f"{train_remat['peak_memory_gib']:.2f} GiB against "
        f"{train16['peak_memory_gib']:.2f}")
    torch.cuda.empty_cache()
    phase_recompute_bits(cfg16, dev, args.seed)
    torch.cuda.empty_cache()

    sched = phase_train_schedule_clip(cfg16, dev, args.seed)
    log(f"train bf16, schedule + clip against phase 17 in this call: step "
        f"{sched['step_ms_median']:.2f} ms against "
        f"{train16['step_ms_median']:.2f}, peak "
        f"{sched['peak_memory_gib']:.2f} GiB")
    torch.cuda.empty_cache()
    phase_schedule_clip_parity(cfg16, dev, args.seed)
    torch.cuda.empty_cache()

    bert = phase_bert(dev, gen, args.seed, infer32)
    torch.cuda.empty_cache()
    phase_gpt_o2_parity(dev, args.seed)
    torch.cuda.empty_cache()

    # bench.py's resnet50 mode (measure_resnet50), then card against CPU
    t0 = time.perf_counter()
    counts29, step, _, _ = phase_resnet_train(dev, args.seed)
    plan_r = step.buckets
    del step
    torch.cuda.empty_cache()
    before = clocks("before resnet update")
    row_r = phase_resnet_update(dev, gen, plan_r)
    stamp([row_r], before, clocks("after resnet update"))
    log_ratios("resnet update", {"fused_update resnet50": row_r})
    torch.cuda.empty_cache()
    phase_resnet_parity(dev, gen, args.seed)
    log(f"phases 29-30 (resnet50): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # bench.py's widedeep mode (measure_widedeep), then card against CPU
    t0 = time.perf_counter()
    counts31, plan_wd, _ = phase_widedeep(dev, args.seed)
    before = clocks("before widedeep update")
    row_wd = phase_widedeep_update(dev, gen, plan_wd)
    stamp([row_wd], before, clocks("after widedeep update"))
    log_ratios("widedeep update", {"fused_update widedeep": row_wd})
    phase_widedeep_parity(dev, args.seed)
    log(f"phases 31-32 (widedeep): {time.perf_counter() - t0:.1f} s")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    dp16 = {"encode": enc16, "decode": dec16, "table": table16,
            "rank": dp16_rank}
    print(json.dumps(kernels_line(rows, counts, train_rows, train_counts,
                                  infer_rows, conversion, infer_counts,
                                  dp_row, carrier_rows, dp_rank, bf16_rows,
                                  bf16_counts, dp16, ce_rows, ce_counts,
                                  bert, {"counts": counts29, "row": row_r},
                                  {"counts": counts31, "row": row_wd})))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
