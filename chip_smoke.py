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
              the same at GPT-125M width with 1 layer, global batch
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
              dtype by codec_decode, the port's eager AdamW, one
              fused_update launch a round): launch counts, losses
              finite, replicas identical;
 20. dp-parity bf16
              the bf16 model at GPT-125M width with 1 layer, world 2,
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
 33. eager    bench.py's eager mode (measure_eager) through
              ``import paddle_tpu_torch as paddle`` on the card, the two
              loops in bench.py's own text (torch_checks.
              bench_eager_loops): after bench.py's warm-up, the no-grad
              chain ``t = t * 1.0001 + 0.1`` on a [256, 256] ones
              tensor, 200 iterations, and the grad loop (``t = t @ w;
              t = t * 0.5``, k = 20, then sum, backward, ``w.grad``,
              ``clear_grad``) on [16, 16], 5 iterations; us/op as
              bench.py counts them (2 an iteration; 4k a grad
              iteration), beside the same loops in plain PyTorch in this
              call (the yardstick: PyTorch's dispatch without the port's
              Tensor and cast point); no kernel of the port is on this
              path (every launch count 0 over the run); every tensor
              made lives on the card; the chain bit for bit and
              ``w.grad`` within 1e-5 relative against the port on the
              CPU; torch.profiler over the grad loop (device busy and
              idle share).
 34. random   every random op of the reference's tensor/random.py and
              shuffle_batch through ``import paddle_tpu_torch as
              paddle`` on the card, at 2^20 elements (randperm and
              shuffle_batch 65,536; multinomial [64, 1000] x 20 without
              replacement): on the card, dtype and shape (the
              reference's narrowed names), range, mean and variance
              within 6 standard errors of the distribution's;
              ``seed(17)`` -> the same bits twice;
              ``get_cuda_rng_state`` -> draw -> ``set_cuda_rng_state``
              -> the same draw; ``uniform(seed=9)`` the same whatever the
              global stream did, and leaving it as it was; the CPU's
              seeded draw other than the card's (pinned in ROADMAP.md
              Queue C); no kernel of the port launched.
 35. lenet    LeNet trained as a Paddle user writes it:
              ``vision.models.LeNet()`` after ``paddle.seed(0)``,
              Paddle's MNIST quick-start size (batch 64 of 1 x 28 x 28,
              10 classes, synthetic data from --seed),
              ``Adam(learning_rate=1e-3, parameters=model.parameters())``,
              ``F.cross_entropy``, 5 steps of ``loss.backward();
              opt.step(); opt.clear_grad()`` on eager Tensors; the same
              on the CPU from the card's weights: the first loss and
              every gradient within 1e-5 relative (by norm), the 5
              losses within LENET_LOSS_RTOL; launch counts reset just
              before and read just after: one fused_update a step and
              no other kernel, update_math never called on the card;
              the second step's launch bit for bit against its plain
              version (parameters, moments, beta powers); ms a step
              (median of 30 after warm-up, host wall, synced) beside
              the same LeNet in plain PyTorch (torch.nn,
              torch.optim.Adam) from the same weights in this call;
              torch.profiler over 10 steps (busy and idle share); row 6
              at LeNet's table (10 entries, 61,610 fp32 elements) as
              Optimizer.step() calls it, alone, as the plain walk and
              as torch._fused_adam_ over the same tensors, beside its
              bound (28 bytes an element), its launch bit for bit
              against the plain walk on clones of the table.
 36. nn       every case of tests/torch_nn_checks.py NN_CASES (each
              functional of the feed-forward nn slice and every layer
              that holds state, 4k to 4M elements) on card tensors
              against the same call on the CPU: outputs and gradients
              within 1e-5 relative, masks and one-hot rows bit for bit,
              every output on the card; the dropout family's
              properties on the card's generator (share within 6
              standard errors, kept entries x / (1 - p) bit for bit,
              gradient the mask's scale, whole channels, alpha
              dropout's moments, repeats after paddle.seed,
              gumbel_softmax rows); no kernel of the port launched.
 37. flash    F.flash_attention at GPT-125M's [8, 1024, 12, 64] causal
     entry    and BERT-base's [16, 512, 12, 64] full, fp32 and bf16:
              one forward and backward through the entry, launch counts
              reset just before and read just after (one flash_fwd*,
              flash_dq*, flash_dkv* of the dtype), out and the three
              gradients against the kernels' plain versions
              (flash_err's limits); dropout 0.1 launching none;
              flash_attn_unpadded at equal lengths through the same
              kernel, bit for bit; the entry's forward and backward,
              each kernel alone, the plain versions and SDPA, timed.
 38. mobilenet MobileNetV2 trained as a Paddle user writes it, at
              ImageNet width, not cut: vision.models.mobilenet_v2()
              after paddle.seed(0) (scale 1.0, 1000 classes), batch 96
              x 3 x 224 x 224 (Sandler et al. 2018, section 6.1) from
              --seed, nn.CrossEntropyLoss(), Momentum(0.045, 0.9,
              weight_decay=L2Decay(4e-5)) (the paper's lr and decay;
              its RMSProp is not ported), Dropout(0.2) live, fp32
              NCHW; 2 + 5 steps, ms a step, images/s, peak memory;
              launch counts reset just before and read just after (one
              fused_update a step, update_math never on the card),
              tables built; torch.profiler over one step (idle share,
              device time by kind); the same network in plain PyTorch
              (torch.nn, torch.optim.SGD) from the same weights; row 6
              at MobileNetV2's eager table as Optimizer.step() calls
              it, alone, plain and as torch._fused_sgd_, beside its
              bound (20 bytes an element), its launch bit for bit
              against the plain walk on clones of the table; card
              against CPU at batch 2, dropout 0: the loss, every stage's
              output and gradients, the update; dropout live, two runs
              of 2 steps after paddle.seed bit for bit.
 39. rnn nn   every case of tests/torch_rnn_checks.py (each new name of
              the recurrent slice: SimpleRNN tanh and relu, LSTM and GRU
              forward, bidirectional and time_major, with
              sequence_length holding a 0 and full lengths; the cells,
              LSTMCell with proj_size; RNN/BiRNN over cells; the
              sequence ops; the fluid-era functionals and gather_tree;
              hsigmoid_loss, HSigmoidLoss, class_center_sample,
              margin_cross_entropy, center_loss; nn.utils) on card
              tensors against the same call on the CPU: outputs and
              gradients within 1e-5 relative, integers bit for bit;
              BeamSearchDecoder's ids on a small LSTMCell model (its
              logits scaled to a standard deviation of 4) equal outside
              near ties, the candidates' totals within 1e-4; no kernel
              of the port launched.
 40. ptb lm   the PTB word-level LSTM language model, medium (Zaremba,
              Sutskever & Vinyals 2014, as PaddleNLP's rnnlm trains it
              with paddle.nn.LSTM), at full width and depth, as a
              Paddle user writes it (tests/torch_rnn_checks.py ptb_lm):
              Embedding(10000, 650), Dropout(0.5), LSTM(650, 650, 2
              layers; its dropout stored, not applied), Dropout(0.5),
              Linear(650, 10000), every parameter from Uniform(-0.05,
              0.05) after paddle.seed(0); batch 20 x 35 ids from --seed,
              fp32, the states carried and detached (truncated BPTT),
              SGD(1.0, ClipGradByGlobalNorm(5.0)), CrossEntropyLoss;
              3 + 10 steps, ms a step, words/s, peak memory; launch
              counts reset just before and read just after (one
              fused_update a step, update_math never on the card), the
              SGD table built once; torch.profiler over one step (idle
              share, device time by kind); the dropout masks repeating
              after paddle.seed; the same network in plain PyTorch
              (torch.nn.LSTM, torch.optim.SGD, clip_grad_norm_, TF32
              off) from the same weights over the same batches, one
              median each; the LSTM stack's forward and backward by the
              port's whole-length route, by pack_padded_sequence and
              unpacked (device time), the LSTM weights still in one
              buffer with no cuDNN layout warning; jit.TrainStep over
              a small LM of this network on the card against the CPU
              (every parameter, the LSTM's too, changing as the CPU's,
              within 1e-3); row 6 at the LM's table
              (19,780,400 fp32 elements) as Optimizer.step() calls it,
              alone, plain and as torch._fused_sgd_, beside its bound
              (12 bytes an element), its launch bit for bit against the
              plain walk on clones of the table; card against CPU, one
              step from the same weights, dropout off: the loss within
              1e-5 relative, every parameter's gradient within 1e-5
              (norm_rel).
 41. ptb beam BeamSearchDecoder(beam_size=10) over a cell that runs the
              trained model's two LSTM layers one step (batch-first
              states, so the regather indexes the batch), its embedding
              and output layer (the logits scaled to a standard
              deviation of 4 at the contexts' ends, where near ties are
              rare), from the final states of 20 contexts of 35 tokens,
              dynamic_decode(max_step_num=35), on the card
              and on the CPU: ms a decode step and its split into the
              device's work, the logits' copy to the host and the host's
              bookkeeping; card and CPU choose the same beams step by
              step: until a row parts, each step's candidate totals
              (float64, from each device's own logits and float32
              running scores) within 1e-4 of max(1, |best|) over the
              best beam + 1 of either; a row parting only at a near tie,
              two of the CPU's best beam + 1 totals within the spread of
              that step's measured differences (counted and printed); a
              row that never parts finalizing the same ids.

 42. namespaces every case of tests/torch_namespace_checks.py (the new
              names of autograd, linalg, fft, signal, distribution,
              sparse, geometric: PyLayer with two outputs and an
              integer input, gradients included) on card tensors
              against the same call on the CPU, within 1e-5 of max(1,
              the CPU's largest magnitude), integers and sparse indices
              bit for bit; the seven optimizers without a kernel
              (Adagrad, Adadelta, Adamax, RMSProp, Lamb, Lars,
              DGCMomentum) 3 steps on the GCN's parameter shapes, card
              against CPU (1e-6; Lamb and Lars 1e-5: their norms reduce
              in another order); no port kernel launched;
              paddle.signal.stft/istft at a speech front end's size (16
              x 16,000 samples, n_fft 512, hop 160, Hann) card against
              CPU within 1e-5 of the largest magnitude, stft timed
              beside torch.stft; the distributions' draws on the card by
              their moments at 2^20 (6 standard errors) and repeating
              after paddle.seed and with sample(seed=k);
              paddle.device reporting the card: its name as nvidia-smi
              gives it, memory_allocated up by a 256 MiB tensor's bytes,
              cuDNN's version, synchronize; paddle.save of card tensors
              (fp32, bf16, int32, bool), paddle.load, bit for bit.
 43. gcn      a two-layer GCN (Kipf & Welling 2017) at Cora's widths as
              a Paddle user writes it (tests/torch_gcn_checks.py: 2,708
              nodes x 1,433 binary features -> 16 -> 7, 10,556 edges
              plus 2,708 self loops drawn from --seed with skewed
              degrees, D^-1/2 (A + I) D^-1/2 through
              geometric.send_u_recv, dropout 0.5, Adam(0.01) with
              L2Decay(5e-4) on the first weight, 140 labelled nodes),
              weights from paddle.seed(0): card against CPU from the
              same weights, dropout off, the first loss within 1e-5
              and the gradients; 200 full-batch steps with launch counts
              reset just before and read just after (exactly one
              fused_update a step, update_math never on the card), the
              last loss below the first; paddle.save at step 100 of the
              layer's and the optimizer's state and the card's RNG
              state, paddle.load into a fresh model and optimizer, the
              loaded moments and beta powers bit for bit, resumed to
              step 200 and held against the uninterrupted run (bit for
              bit, or within twice the spread of two uninterrupted
              runs); ms a step beside the same GCN in plain PyTorch
              (index_add_, torch.optim.Adam) over the same batch,
              medians from this call; torch.profiler over one step (idle
              share, device time by kind); row 6 at the GCN's table as
              Optimizer.step() calls it, alone, plain and as
              torch._fused_adam_, beside its bound (28 bytes an
              element), its launch bit for bit against the plain walk.
 44. fp16 kernels  the fp16 flash kernels at GPT's [8, 12, 1024, 64]
              causal and BERT's [16, 12, 512, 64] full against their
              plain versions (torch_checks.flash_fp16_limit), each timed
              beside its plain version, its bound (989 TFLOP/s fp16
              dense, 3.35 TB/s) and fp16 SDPA, the bf16 forms timed in
              the same call beside them; the check shapes, and both
              main shapes with dO at 2^-16 (the dS scaling); the update
              over GPT-125M's fp16 plan bit for bit over 3 steps, timed
              beside torch._fused_adamw_ over the same fp16 tensors;
 45. train fp16  GPT-125M, dtype float16, dropout 0.1, bench.py's batch
              8 x 1024, AdamW: 2 + 5 steps, launch counts (12 / 12 / 12
              fp16 flash and 1 update a step), losses finite and
              falling, step ms, peak memory and idle share beside phase
              17's bf16 step; one step card against CPU at 2 layers
              (dropout 0, BF16_LOSS_RTOL and the 16-bit step parity); a
              step at attn_dropout 0.1 makes no flash launch;
 46. gpt options  GPT-125M fp16, dropout 0: recompute_policy none,
              remat, offload and a mixed vector, the loss and every
              gradient of one step from the same weights equal to none's
              bit for bit (or, if two none runs differ, within twice
              their spread, the op named), then 1 + 3 steps each: peak
              memory, step ms, bytes parked in pinned host memory a
              step; Lamb, Lars and DGCMomentum under TrainStep, 3 steps
              each, no fused_update launch, finite losses, and 2 steps
              card against CPU at 2 layers in fp32 (the first loss within
              1e-5, the second within OPT_LOSS_RTOL);
 47. bert fp16  BERT-base pretraining at measure_bert's 16 x 512 under
              decorate and auto_cast(level="O2", dtype="float16"), the
              eager step with a GradScaler (scale, backward, step,
              update): warm-up until the scale settles, then 10 timed
              steps, 12 fp16 flash launches of each kernel a step, one
              fused_update a step not skipped, one host read of the
              finite flag a step; a planted inf gradient skips its step,
              leaves every parameter's bits and halves the scale; step ms
              and idle share beside phase 25's bf16 O2 step; every
              backward's gradients fp16, every unscaled one fp32 (the
              reference's unscale_), the eager table built once.
 48. fp16 wire kernels  phase 13's 16-bit rows at GPT-125M's fp16 plan
              (9 fp16 buckets, the fp32 final norm): two ranks' fp16
              gradients (fp16 subnormals among them) encoded by
              codec_encode, int8_block and fp8_block, bit for bit against
              the plain encode; the summed carriers decoded into fp16 by
              codec_decode, bit for bit; the plan's one
              fused_dequant_update_buckets launch over 2 steps, residual
              off and on, bit for bit; each timed beside its plain version,
              its bound and torch.quantize_per_channel / torch.mul /
              decode + torch._fused_adamw_ with fp16 moments;
 49. dp train fp16  phase 19 on GPT-125M in fp16 (fp16_config()): 2 ranks,
              b4 s1024 a rank, 2 + 5 steps, one fp16 dequant launch a step
              a rank, the first step's 9 encodes from fp16, 2 DataParallel
              rounds (9 encodes from fp16, 18 decodes into fp16 a rank),
              the ranks bit-identical, rank 0's idle share over one more
              step, beside phase 45's fp16 step and phase 19's bf16 dp
              step; then phase 20's 1-layer check on the fp16 model;
 50. int8 fp16  BERT-base decorated at O2 in fp16, converted to int8, run
              under auto_cast(level="O2", dtype="float16") at 16 x 512 and
              1 x 64: 29 fp16 quant_matmul launches a forward (27 wgmma
              and 2 cluster at 16 x 512, all cluster at 1 x 64), 46 fp32,
              12 fp16 flash; beside phase 27's bf16 forwards; the fp16
              form at every launched shape, a ragged one a route and fp32
              out on each route against quant_matmul_plain
              (torch_checks.qmm16_vs_plain); the logits card against CPU
              at 2 layers.
 51. zero-2     GPT-125M fp32 through
              sharding.group_sharded_parallel("os_g", overlap_comm=True,
              fuse_update=True): 2 ranks of 4 x 1024 on the card (gloo),
              each step forward, backward (the overlapped communicator's
              hooks launch each bucket's reduce_scatter -> all_gather),
              the flush, step_sharded. int8_block: 1 + 3 steps, then one
              step with every all_reduce / reduce_scatter / all_gather
              timed and one whose shard-table launch is held bit for bit
              against its plain walk on clones; launches a step a rank
              (18 encodes, 18 decodes, one fused_update_buckets over the
              shard table, 18 all_gathers in the update, no dequantizing
              update), comm_stats against comm_plan, the ranks' parameters
              bit-identical, peak and at-rest memory, the shard slots'
              bytes beside phase 14's replicated run and its AdamW slots;
              the fp32 wire 2 steps; the shard table timed beside its
              bound at the shard's bytes and torch._fused_adamw_;
 52. zero-3     phase 51 at "p_g_os": the parameters sharded at rest
              (the tied word table declared for the LM head), gathered a
              bucket ahead on the store's lane: the losses of both wires
              bit-identical to phase 51's, no all_gather in the update,
              at-rest parameter bytes half of phase 51's, gathers by mode
              and the exposed gather seconds;
 53. zero wire  traced_reduce_scatter_quantized at the word table's
              bucket (38,633,472 elements) and a ragged one, 2 ranks:
              full, shard and residual bit for bit against the same
              function on the plain codecs on the card, each timed
              after a warm run of both forms; the overlapped
              reduce_scatter sync bit-identical to the serial
              one over 2 backward passes of GPT-125M at 2 layers
              (int8_block, the residual carried), its overlap efficiency.

Output: a JSON line of per-kernel numbers, then the device summary as the
last line. Exits non-zero without output when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
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
# the 16-bit flash kernels are instances of one template a kernel
# (csrc/flash_attention.cu); the profiler's names carry the element type
BF16_KERNELS = ("fwd_wgmma_kernel<__nv_bfloat16",
                "dq_wgmma_kernel<__nv_bfloat16",
                "dkv_wgmma_kernel<__nv_bfloat16", "update_kernel")
FP16_KERNELS = ("fwd_wgmma_kernel<__half", "dq_wgmma_kernel<__half",
                "dkv_wgmma_kernel<__half", "update_kernel")
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
    ``bf16`` at the bf16 tensor cores' peak (fp16's is the same, 989
    TFLOP/s dense)."""
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
                dtype=torch.float32, do_scale=1.0):
    """The three flash kernels on ``dtype`` inputs of ``shape`` (dO times
    ``do_scale``) against their plain versions
    (``torch_checks.flash_vs_plain``) and, when ``timed``, each timed
    beside its plain version, its bound and the one-call yardstick in the
    same dtype."""
    from paddle_tpu_torch.ops import flash_attention as fa
    import torch.nn.functional as F
    from torch_checks import flash_vs_plain

    q, k, v, do = (torch.randn(*shape, device=dev, generator=gen).to(dtype)
                   for _ in range(4))
    do = (do.float() * do_scale).to(dtype)
    errs, lse, delta = flash_vs_plain(q, k, v, do, causal, do_scale)
    outputs = {"flash_fwd": ("out", "lse"), "flash_dq": ("dq",),
               "flash_dkv": ("dk", "dv")}
    kernel_err = {n: max(errs[o][0] for o in outs)
                  for n, outs in outputs.items()}
    kernel_ratio = {n: max(errs[o][1] for o in outs)
                    for n, outs in outputs.items()}
    half = dtype in (torch.bfloat16, torch.float16)
    tag = {torch.bfloat16: " bf16", torch.float16: " fp16"}.get(dtype, "")
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
        label = f"{list(shape)} {'causal' if causal else 'full'}{tag}"
        for name, (kern, plain, lib) in calls.items():
            work = flash_work(shape, causal, name, q.element_size())
            bounds = (dict(zip(("bound_ms", "bound_by"),
                               work_bound(*work, bf16=True)))
                      if half else both_bounds(*work, TF32_PASSES[name]))
            rows[name] = {"shape": label, "max_abs_err": kernel_err[name],
                          "err_over_limit": kernel_ratio[name],
                          "ms": median_ms(kern, flush),
                          "plain_ms": median_ms(plain, flush),
                          **bounds, "library_ms": lib}
        rows[PAIR] = {"shape": label, "ms": rows["flash_dq"]["ms"]
                      + rows["flash_dkv"]["ms"], "library_ms": lib_bwd}

    def at(name, r):
        if half:
            return f"{tag.strip()} tensor cores"
        return (f"{TF32_PASSES[name]} TF32 passes, fp32 SIMT bound "
                f"{r['bound_simt_ms']:.4f}")

    scaled = f" dO x {do_scale:g}" if do_scale != 1.0 else ""
    log(f"flash {list(shape)} {dtype} causal={causal}{scaled}: max abs diff "
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
    ran = {"bfloat16": "_bf16", "float16": "_fp16"}.get(cfg.dtype, "")
    flash = cfg.use_flash_attention and cfg.attn_dropout == 0.0
    want = {name + sfx: cfg.num_layers * steps * (sfx == ran and flash)
            for sfx in ("", "_bf16", "_fp16")
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
    half = cfg.dtype in ("bfloat16", "float16")
    tol = BF16_LOSS_RTOL if half else 1e-5
    log(f"train {cfg.dtype}{_variant(cfg)} card vs CPU (gpt-125m width, 2 "
        f"layers, b2 s128): loss {card_loss:.7f} vs {cpu_loss:.7f} (rel "
        f"{rel:.2e}, limit {tol:.0e})")
    if not rel <= tol:
        raise AssertionError(f"card and CPU losses differ beyond {tol:.0e}")
    if half:
        r = bf16_step_parity(card, cpu, LR)
        log(f"train {cfg.dtype} card vs CPU after one AdamW step: gradients "
            f"within {r['grad_rtol']:.2e} of each tensor's largest (limit "
            f"2e-2); on the {100 * r['clear_share']:.1f}% of elements whose "
            f"gradient is clear of the noise, every 16-bit weight within one "
            f"ulp of the CPU's, the fp32 ones within 1e-2 lr; "
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
            for sfx in ("", "_bf16", "_fp16")
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
    shares = {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
              "idle_share": 1 - busy_us / wall_us}
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
    return {**kinds, **shares}


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


def _qmm_bf16_case(dev, gen, mkn, launches, flush, dtype=torch.bfloat16,
                   out_dtype=None):
    """``quant_matmul`` on bf16 ``x`` (or ``dtype``'s: fp16; the
    ``quant_matmul_16`` kernels) at ``mkn`` against its plain version
    (``torch_checks.qmm16_vs_plain``; out in x's dtype, or ``out_dtype``
    fp32), timed beside it, its bound (bytes at 3.35 TB/s, operations at
    989 TFLOP/s bf16 and fp16) and a like yardstick: ``torch.matmul`` on
    ``x`` and the weight dequantized to x's dtype, at the port's GEMM
    settings (no reduced-precision reduction)."""
    from torch_checks import qmm16_vs_plain

    from paddle_tpu_torch.framework.precision import matmul_precision

    qm = _quant_module()
    m, k, n = mkn
    name = str(dtype).split(".")[-1]
    x = torch.randn(m, k, device=dev, generator=gen).to(dtype)
    q, sc = qm.quantize_int8(torch.randn(k, n, device=dev, generator=gen)
                             * 0.02)
    err, ratio = qmm16_vs_plain(x, q, sc, out_dtype)
    w = (q.float() * sc).to(dtype)
    # read x (16-bit), q and the scales once, write the output; 2 m n k
    out_b = 4 if out_dtype == torch.float32 else 2
    bound_ms, bound_by = work_bound(2 * m * k + k * n + 4 * n
                                    + out_b * m * n, 2 * m * n * k,
                                    bf16=True)
    with matmul_precision("float32"):
        library_ms = median_ms(lambda: torch.matmul(x, w), flush)
    out_tag = " -> fp32" if out_dtype == torch.float32 else ""
    r = {"shape": f"({m}, {k}, {n}) {name}{out_tag}",
         "launches_at_shape": launches, "bf16_route": qm.route16(x, q),
         "max_abs_err": err, "err_over_limit": ratio,
         "ms": median_ms(lambda: qm.quant_matmul(x, q, sc,
                                                 out_dtype=out_dtype),
                         flush),
         "plain_ms": median_ms(lambda: qm.quant_matmul_plain(
             x, q, sc, out_dtype), flush),
         "library_ms": library_ms, "library_form":
         f"torch.matmul(x {name}, dequantized weight {name})",
         "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"quant_matmul {r['shape']} ({launches} in the "
        f"timed forwards, {r['bf16_route']} route): max abs diff "
        f"{err:.3e}, at most {ratio:.4f} of the limit | {r['ms']:.4f} ms "
        f"({2 * m * n * k / r['ms'] / 1e9:.2f} TFLOP/s; plain "
        f"{r['plain_ms']:.4f}, {name} torch.matmul {library_ms:.4f}, bound "
        f"{bound_ms:.4f} {bound_by}, the kernel at "
        f"{100 * bound_ms / r['ms']:.1f}% of it)")
    return r


def phase_infer_kernels_bf16(dev, gen, shapes, dtype=torch.bfloat16):
    """Phase 27's kernel rows (phase 50's on fp16 ``x``):
    ``quant_matmul`` on 16-bit ``x`` at every shape the O2 forwards
    launched it at (``shapes``, most launched first) and at a ragged one
    a route (k % 8 != 0, n % 16 != 0: element loads; at m > 64 the
    mma.sync route)."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows = [_qmm_bf16_case(dev, gen, mkn, n, flush, dtype)
            for mkn, n in [*shapes.most_common(), (RAGGED_QMM, 0),
                           (RAGGED_QMM_SMALL, 0)]]
    del flush
    return rows


def _at_rest_bytes(model) -> int:
    from paddle_tpu_torch.framework.modules import (torch_buffers,
                                                    torch_parameters)

    return sum(t.numel() * t.element_size()
               for t in (*torch_parameters(model), *torch_buffers(model)))


def infer_launch_counts() -> dict:
    """Launches since the last reset: totals, and the int8 kernels' by
    shape (``"shapes"``)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    qm = _quant_module()
    flash = fa.launch_counts()
    return {**qm.launch_counts(), "flash_fwd": flash["flash_fwd"],
            "flash_fwd_bf16": flash["flash_fwd_bf16"],
            "flash_fwd_fp16": flash["flash_fwd_fp16"],
            "shapes": qm.shape_counts(), "routes": qm.route_counts(),
            "routes_fp16": qm.route_counts(torch.float16)}


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
                cfg=None, level=None, dtype="bfloat16", decorated=False):
    """Phase 10 (``level`` None), phase 27 (``level="O2"``: the forwards
    under ``auto_cast(level="O2")``) and phase 50 (``dtype="float16"``,
    ``decorated``: the model decorated at O2 in that dtype before the
    conversion)."""
    from paddle_tpu_torch.amp import auto_cast, decorate
    from paddle_tpu_torch.models import BertForPretraining, bert_presets
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.quantization import convert_to_int8

    cfg = cfg or bert_presets("bert-base")
    t0 = time.perf_counter()
    model = BertForPretraining(cfg, seed=0, device=dev).eval()
    if decorated:
        model = decorate(model, level="O2", dtype=dtype)
    build_s = time.perf_counter() - t0
    before = _at_rest_bytes(model)
    linears = [m for m in model.modules() if isinstance(m, Linear)]
    linear_bytes = sum(_at_rest_bytes(m) for m in linears)
    weights = Counter(tuple(m._parameters["weight"].shape) for m in linears)
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
                                           level=level or "O1",
                                           dtype=dtype):
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
                         + counts["shapes"]["quant_matmul_bf16"]
                         + counts["shapes"]["quant_matmul_fp16"]).items():
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
    tag = (f" {level}" if level else "") + (
        f" {dtype}" if dtype != "bfloat16" else "")
    log(f"infer{tag} " + json.dumps(summary))
    # under O2 the MLM logits are in amp's dtype ("mlm_logits" casts) and
    # the NSP head's fp32 (the int8 layer adds its fp32 bias by promotion;
    # decorated, the bias is in amp's dtype too)
    amp_dt = getattr(torch, dtype)
    want_dt = amp_dt if level == "O2" else torch.float32
    nsp_dt = amp_dt if decorated else torch.float32
    if tuple(logits.shape) != (b, s, cfg.vocab_size) or \
            tuple(nsp.shape) != (b, 2) or logits.dtype != want_dt or \
            nsp.dtype != nsp_dt:
        raise AssertionError(f"logits {tuple(logits.shape)} {logits.dtype}, "
                             f"nsp {tuple(nsp.shape)} {nsp.dtype}")
    if not (torch.isfinite(logits).all() and torch.isfinite(nsp).all()):
        raise AssertionError("non-finite logits")
    sfx = SFX16[dtype] if level == "O2" else ""
    n16, n32 = (amp_int8_split(cfg.num_layers) if level == "O2"
                else (0, len(linears)))
    want = {"quantize_int8": 0, "quant_matmul": n32 * iters}
    for f in ("_bf16", "_fp16"):
        want["quant_matmul" + f] = n16 * iters * (f == sfx)
    for f in ("", "_bf16", "_fp16"):
        want["flash_fwd" + f] = cfg.num_layers * iters * (f == sfx)
    # the 16-bit form's routes by m: the cluster route for the pooler and
    # the NSP head at m = b, and at m = b * s where that is at most 64;
    # else wgmma
    want_routes = Counter()
    if level == "O2":
        want_routes["cluster" if b * s <= 64 else "wgmma"] += (n16 - 2) * iters
        want_routes["cluster"] += 2 * iters
    routes = counts["routes_fp16" if sfx == "_fp16" else "routes"]
    got = {k: counts[k] for k in want}
    if got != want or per_forward != weights or routes != want_routes:
        raise AssertionError(f"launch counts {got}, expected {want}; per "
                             f"forward by weight {dict(per_forward)}, "
                             f"expected {dict(weights)}; routes "
                             f"{dict(routes)}, expected "
                             f"{dict(want_routes)}")
    del logits, nsp
    return conversion, counts, model, (ids, types), summary


def _named(counts) -> dict:
    """Launch counts with the by-shape keys as strings, for JSON."""
    return {**counts, "shapes": {name: {str(k): n for k, n in c.items()}
                                 for name, c in counts["shapes"].items()}}


def phase_infer_profile(model, batch, level=None, tag="", dtype="bfloat16"):
    """One forward profiled: device busy and idle shares, the top kernels
    and the int8 and flash kernels' shares. Returns (busy us, {kernel
    name: device us})."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.amp import auto_cast

    with torch.inference_mode(), auto_cast(enable=level is not None,
                                           level=level or "O1",
                                           dtype=dtype):
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
                 "qmm_cluster_kernel", "fwd_kernel",
                 "fwd_wgmma_kernel<__nv_bfloat16", "fwd_wgmma_kernel<__half"):
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
DP16_STEPS = 5                      # timed steps of the 16-bit dp phases
DP_REPLAY_LAYERS = 1                # depth of the card-vs-CPU dp replays
SFX16 = {"bfloat16": "_bf16", "float16": "_fp16"}   # counters' suffixes


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


def _table_err(table, lr, world=None) -> float:
    """The error of a timed row 6 (row 7 with ``world``): one launch over
    clones of ``table``'s entries, from the beta powers it would read,
    against the plain walk over other clones; the largest absolute
    difference of any parameter, slot or stepped power. Raises unless
    they are bit for bit, as ``buckets_vs_plain`` holds the kernel. A
    dequantizing table's payloads are read only, and shared."""
    from paddle_tpu_torch.ops import fused_update as fu

    sides = []
    for plain in (False, True):
        t = fu.BucketTable(table.kind, table.hyper, [
            (p.clone(), g if table.dequant else g.clone(),
             [s.clone() for s in arrs], wd, lm)
            for p, g, arrs, wd, lm in table.entries],
            block_size=table.block_size)
        if t.adam:
            t.load_powers(table.powers())
        if plain:
            fu.buckets_plain(t, lr, world)
        elif t.dequant:
            fu.fused_dequant_update_buckets(t, lr, world)
        else:
            fu.fused_update_buckets(t, lr)
        sides.append([x.float() for p, _, arrs, *_ in t.entries
                      for x in (p, *arrs)] + ([t.pows] if t.adam else []))
    err = max(float((a - b).abs().max()) for a, b in zip(*sides))
    if err:
        raise AssertionError(f"{table.kind} table of {len(table.entries)} "
                             f"entries: the launch {err:.3e} off its plain "
                             f"walk")
    return err


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
           "max_abs_err": _table_err(table, lr, DP_WORLD),
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
    """Phase 13's 16-bit forms at every bucket of a 16-bit plan (9 bf16
    buckets and the fp32 final norm, or phase 48's 9 fp16 ones and the
    fp32 final norm): two ranks' gradients encoded from their own dtype
    by codec_encode, int8_block and fp8_block, bit for bit against the
    plain encode; their summed carriers decoded to the bucket's dtype by
    codec_decode, bit for bit; the plan's one
    fused_dequant_update_buckets launch, bit for bit against the plain
    walk over two steps, residual off and on. Timed: at each bucket the
    carrier encode (against torch.quantize_per_channel on the bucket
    lifted to fp32, which takes no 16-bit input) and the decode (against
    torch.mul into the bucket's dtype); the table as phase 13 times it.
    Returns (encode rows, decode rows, the table row), the rows by block
    count."""
    from torch_checks import encoded_inputs, same_bits

    from paddle_tpu_torch.distributed import grad_comm as plain
    from paddle_tpu_torch.ops import codec

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    plan = next(str(b.dtype).split(".")[-1] for b in buckets
                if b.dtype != torch.float32)
    enc_rows, dec_rows = {}, {}
    subnormals = 0      # fp16 subnormals among the decoded values
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
            if dt == torch.float16:
                subnormals += int(((d != 0) & (d.abs() < 2.0 ** -14)).sum())
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
                                f"lifted to fp32 (it takes no {plan})",
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
            log(f"{plan} plan bucket {n} ({dt}): codec_encode carrier "
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
    log(f"{plan} plan: codec_encode from each bucket's dtype and codec_decode "
        f"to it bit-identical to plain at all {len(buckets)} buckets, "
        f"int8_block and fp8_block; fused_dequant_update_buckets over the "
        f"plan in one launch a step, bit-identical to the plain walk over "
        f"2 steps, residual off and on"
        + (f"; {subnormals} fp16 subnormals among the decoded values, each "
           f"the plain decode's" if plan == "float16" else ""))
    if plan == "float16" and not subnormals:
        raise AssertionError("no fp16 subnormal decoded: the case does not "
                             "reach them")
    row = _dequant_table_row(dev, gen, buckets, flush)
    del flush
    return enc_rows, dec_rows, row


def dp_launch_counts() -> dict:
    """The train phase's counts, the codecs' (the 16-bit forms apart: a
    launch from or to bf16 counts under ``codec_encode`` and again under
    ``codec_encode_bf16``, fp16 under ``codec_encode_fp16``) and the
    dequantizing update's, with its fp16 buckets' launches apart
    (``fused_dequant_update_fp16``: launches whose table held one)."""
    from paddle_tpu_torch.ops import codec
    from paddle_tpu_torch.ops import fused_update as fu

    out = {**train_launch_counts(), **codec.launch_counts(),
           "fused_dequant_update": fu.fused_dequant_update_buckets.launches,
           "fused_dequant_update_fp16":
               fu.fused_dequant_update_buckets.dtypes[torch.float16]}
    for sfx, dt in (("_bf16", torch.bfloat16), ("_fp16", torch.float16)):
        out["codec_encode" + sfx] = codec.block_encode.dtypes[dt]
        out["codec_decode" + sfx] = codec.block_decode.dtypes[dt]
    return out


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
    the port's eager AdamW (one fused_update launch a round); launch
    counts reset just before and read just after. Returns the losses, the counts and the parameters' sha256."""
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
                  layers=None, dp_rounds=0, profile=False):
    """One rank of a "dp train" phase (run by ``spawn``); with
    ``dp_rounds``, ``_data_parallel_rounds`` after it; with ``profile``,
    one more step, rank 0's under torch.profiler (wall, device busy and
    idle share)."""
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
    shares = None
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as profiled

        sync()
        with (profiled(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
              if rank == 0 else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            losses.append(float(step(inputs=(ids,), labels=(labels,))))
            sync()
            wall = time.perf_counter() - t0
        if rank == 0:
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
            shares = {"wall_ms": wall * 1e3, "busy_ms": busy / 1e3,
                      "idle_share": 1 - busy / 1e6 / wall}
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
           "table_builds": step.updater.table_builds, "profile": shares,
           "checksum": _param_checksum(model)}
    if dp_rounds:
        del step, model
        out["data_parallel"] = _data_parallel_rounds(cfg, device, ids, labels,
                                                     rank, b, dp_rounds)
    return out


def phase_dp_train(cfg, seed, warmup=2, steps=5, wire_steps=2, b=DP_B,
                   s=DP_S, device="cuda", layers=None, dp_rounds=0,
                   profile=False):
    """GPT-125M (``cfg``: fp32, or bf16 or fp16 at bench.py's
    configuration) data parallel on the int8_block wire: two ranks on the
    one card (gloo, host-staged), each on its half of the global batch;
    with ``dp_rounds``, DataParallel after it (``_data_parallel_rounds``);
    with ``profile``, rank 0's idle share over one more step."""
    from paddle_tpu_torch.distributed import spawn

    t0 = time.perf_counter()
    ranks = spawn(dp_train_rank,
                  args=(cfg, seed, warmup, steps, wire_steps, b, s, device,
                        layers, dp_rounds, profile),
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
        "profile": r0["profile"],
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
    ran = SFX16.get(cfg.dtype, "")
    want = {name + sfx: n_layers * steps * (sfx == ran)
            for sfx in ("", "_bf16", "_fp16")
            for name in ("flash_fwd", "flash_dq", "flash_dkv")}
    want.update(fused_update=0, codec_encode=nb * steps,
                codec_encode_bf16=0, codec_decode=0, codec_decode_bf16=0,
                codec_encode_fp16=0, codec_decode_fp16=0,
                fused_dequant_update=steps,
                fused_dequant_update_fp16=steps * (ran == "_fp16"),
                ce_chunk_fwd=0, ce_chunk_bwd=0)
    # the first step has no residual: each 16-bit bucket encoded from its
    # dtype
    n_16 = r0["bucket_dtypes"].count(f"torch.{cfg.dtype}") if ran else 0
    want_first = {**{k: v // steps for k, v in want.items()}}
    if ran:
        want_first["codec_encode" + ran] = n_16
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
        _check_data_parallel([r["data_parallel"] for r in ranks], nb, n_16,
                             n_layers, dp_rounds, ran)
    return r0


def _check_data_parallel(runs, nb, n_16, n_layers, rounds, ran):
    """DataParallel's rounds on both ranks: losses finite, the replicas
    identical, every bucket encoded once a round (the 16-bit ones from
    their dtype in the first round) and decoded once a round to its
    dtype."""
    if not all(math.isfinite(x) for r in runs for x in r["losses"]):
        raise AssertionError(f"non-finite DataParallel loss: "
                             f"{[r['losses'] for r in runs]}")
    if len({r["checksum"] for r in runs}) != 1:
        raise AssertionError("the DataParallel replicas differ")
    want = {name + sfx: n_layers * rounds * (sfx == ran)
            for sfx in ("", "_bf16", "_fp16")
            for name in ("flash_fwd", "flash_dq", "flash_dkv")}
    # the eager AdamW's step: one fused_update launch a round
    want.update(fused_update=rounds, codec_encode=nb * rounds,
                codec_decode=nb * rounds, fused_dequant_update=0,
                fused_dequant_update_fp16=0, ce_chunk_fwd=0, ce_chunk_bwd=0)
    for sfx in ("_bf16", "_fp16"):
        want["codec_encode" + sfx] = n_16 * (sfx == ran)
        want["codec_decode" + sfx] = n_16 * rounds * (sfx == ran)
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


def phase_dp_parity(seed, layers=DP_REPLAY_LAYERS, b=2, s=128):
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


def phase_dp_parity_bf16(cfg, seed, layers=DP_REPLAY_LAYERS, b=2,
                         s=128):
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
    log(f"dp {cfg.dtype} wire, card vs its CPU replay ({cfg.dtype}, {layers} "
        f"layers, world 2, global b{DP_WORLD * b} s{s}, "
        f"{card['elements']} elements): "
        + ("parameters, moments, beta powers, residuals, payloads, scales "
           f"and the {cfg.dtype} decode bit-identical on both ranks in both "
           "steps"
           if not bad else f"differ: {bad}"))
    if bad:
        raise AssertionError(f"the card's dp step differs from its CPU "
                             f"replay: {bad}")
    rel = [abs(a - c) / abs(c) for a, c in zip(card["losses"],
                                                cpu["losses"])]
    log(f"dp {cfg.dtype} card vs CPU end to end: losses {card['losses']} vs "
        f"{cpu['losses']} (rel {max(rel):.2e}, limit {BF16_LOSS_RTOL}); "
        f"the phase {time.perf_counter() - t0:.1f} s")
    if not max(rel) <= BF16_LOSS_RTOL:
        raise AssertionError(f"card and CPU {cfg.dtype} dp losses differ "
                             f"beyond {BF16_LOSS_RTOL}")
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
    residual adds, the average pool, the classifier and the loss
    (``kind_profile``)."""
    return kind_profile(one, RESNET_KINDS, "resnet50",
                        "batch norm, ReLU and the other elementwise work")


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
            "max_abs_err": _table_err(table, lr),
            "step_ms": median_ms(upd.step, flush),
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
    port's eager ``Adam.step()`` (one fused_update launch); examples/s
    with the pushes flushed."""
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
            "max_abs_err": _table_err(table, lr),
            "step_ms": median_ms(upd.step, flush),
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
    from paddle_tpu_torch.framework.modules import torch_named_parameters
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
        named = dict(torch_named_parameters(bench.deep))
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
    from paddle_tpu_torch.framework.modules import torch_named_parameters
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
              for n, t in torch_named_parameters(proto)}
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
                 resnet_run, widedeep_run, lenet_run, flash_entry,
                 mobilenet_run, ptb_run, gcn_run, fp16_run, wire16_run,
                 zero_run):
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
    bucket, with phase 31's launches, LeNet's eager step (phase
    35): Adam over its table of 10 parameters, with phase 35's
    launches, MobileNetV2's (phase 38): Momentum with L2Decay over
    its table of 158 parameters, with phase 38's launches, and the PTB
    LSTM language model's (phase 40): SGD over its table of 11
    parameters (19,780,400 elements), with phase 40's launches, and the
    GCN's (phase 43): Adam with L2Decay on the first weight over its
    table of 4 parameters (23,063 elements), with phase 43's 200
    launches. Phase 37's
    launches through ``F.flash_attention`` are ``at_shapes`` of the flash
    kernels of their dtype, at GPT-125M's and BERT-base's shapes, each
    with its time through the entry (``entry_ms``). The fp16 forms
    (``fp16_run``, phases 44-47) are entries of their own:
    ``flash_fwd_fp16`` etc. at the fp16 train step's shape, their
    launches those of phase 45's timed steps, BERT-base's full-mode shape
    in ``at_shapes`` with phase 47's launches, and ``fused_update_fp16``
    over GPT-125M's fp16 plan (the same kernel), its launches phase 45's;
    each row carries ``bf16_ms``, the bf16 form's time at the same shape
    in the same call. So are the fp16 forms of phases 48-50
    (``wire16_run``): ``codec_encode_fp16`` and ``codec_decode_fp16`` at
    the largest fp16 bucket of GPT-125M's fp16 plan (the others in
    ``at_shapes``), their launches those of phase 49's first TrainStep
    step and DataParallel rounds on rank 0;
    ``fused_dequant_update_fp16``, the one launch over the fp16 plan, its
    launches phase 49's timed steps'; ``quant_matmul_fp16`` (the wgmma
    and mma.sync routes) and ``quant_matmul_fp16_cluster`` at phase 50's
    most launched shapes, the fp32-out rows in ``at_shapes``, their
    launches phase 50's timed forwards'."""
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
    for name, rows_ in flash_entry.items():
        by_name[name].setdefault("at_shapes", []).extend(rows_)
    for extra in (resnet_run, widedeep_run, lenet_run, mobilenet_run,
                  ptb_run, gcn_run):
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
    k16 = fp16_run["kernels"]
    counts45 = fp16_run["train"]["counts"]
    counts47 = fp16_run["bert"]["counts"]
    for name, replaces in (
            ("flash_fwd", "paddle_tpu/ops/flash_attention.py:118"),
            ("flash_dq", "paddle_tpu/ops/flash_attention.py:213"),
            ("flash_dkv", "paddle_tpu/ops/flash_attention.py:251"),
            ("fused_update", "paddle_tpu/ops/pallas/fused_update.py:122")):
        update = name == "fused_update"
        entry = dict(name=name + "_fp16", route="cuda",
                     source=(fu if update else fa).KERNEL_SOURCE,
                     replaces=replaces,
                     launches=counts45[name if update else name + "_fp16"],
                     **_numbers(k16["rows"][name]))
        if not update:
            entry["bf16_ms"] = k16["bf16"]["gpt"][name]["ms"]
            entry["at_shapes"] = [dict(
                _numbers(k16["bert"][name]),
                bf16_ms=k16["bf16"]["bert"][name]["ms"],
                launches_at_shape=counts47[name + "_fp16"])]
        out.append(entry)
    pair = k16["rows"][PAIR]
    next(e for e in out if e["name"] == "flash_dkv_fp16").update(
        pair_ms=pair["ms"], library_ms=pair["library_ms"])
    zero_entries(by_name, zero_run)
    return {"kernels": out + wire16_entries(wire16_run)}


def zero_entries(by_name, zero_run) -> None:
    """Phases 51-53 on the kernels line: the codecs' and the shard
    table's launches there (``launches_zero``, by phase, rank 0's), and
    the shard table, one ``fused_update_buckets`` launch over the owned
    halves of GPT-125M's buckets, an ``at_shapes`` row of
    ``fused_update`` with its launches in phases 51 and 52."""
    for name in ("codec_encode", "codec_decode", "fused_update"):
        by_name[name]["launches_zero"] = {
            ph: zero_run[ph]["launches"][name] for ph in ("51", "52", "53")}
    by_name["fused_update"]["at_shapes"].append(dict(
        _numbers(zero_run["row"]),
        launches_at_shape=sum(zero_run[ph]["launches"]["fused_update"]
                              for ph in ("51", "52"))))


def wire16_entries(wire16_run) -> list:
    """The kernels line's entries of phases 48-50 (``kernels_line``)."""
    from paddle_tpu_torch.ops.codec import KERNEL_SOURCE
    from paddle_tpu_torch.ops import fused_update as fu

    qm = _quant_module()
    out = []
    w16 = wire16_run["rank"]
    dp_counts = w16["data_parallel"]["counts"]
    for name, rows, launches, line in (
            ("codec_encode_fp16", wire16_run["encode"],
             w16["first_step_counts"]["codec_encode_fp16"]
             + dp_counts["codec_encode_fp16"], 93),
            ("codec_decode_fp16", wire16_run["decode"],
             dp_counts["codec_decode_fp16"], 138)):
        h = {nb: r for nb, r in rows.items() if "float16" in r["shape"]}
        main = max(h)
        out.append(dict(name=name, route="cuda", source=KERNEL_SOURCE,
                        replaces=f"paddle_tpu/ops/pallas/codec.py:{line}",
                        launches=launches, **_numbers(h.pop(main)),
                        at_shapes=[_numbers(r) for r in h.values()]))
    out.append(dict(name="fused_dequant_update_fp16", route="cuda",
                    source=fu.KERNEL_SOURCE,
                    replaces="paddle_tpu/ops/pallas/fused_update.py:134",
                    launches=w16["counts"]["fused_dequant_update_fp16"],
                    buckets_a_launch=len(w16["buckets"]),
                    **_numbers(wire16_run["table"])))
    routes = wire16_run["qmm_routes"]
    for name, cluster in (("quant_matmul_fp16", False),
                          ("quant_matmul_fp16_cluster", True)):
        main, *rest = [r for r in wire16_run["qmm_rows"]
                       if (r["bf16_route"] == "cluster") == cluster]
        out.append(dict(name=name, route="cuda", source=qm.KERNEL_SOURCE,
                        replaces="paddle_tpu/ops/quant_matmul.py:110",
                        launches=sum(n for r, n in routes.items()
                                     if (r == "cluster") == cluster),
                        routes=dict(routes), **_numbers(main),
                        at_shapes=[_numbers(r) for r in rest]))
    return out


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
    prof25 = phase_train_profile(lambda: bert_step(step, batch),
                                 names=BF16_KERNELS, tag=" bert O2")
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
    counts_b1, infer_b1 = phase_infer_b1(dev, seed)
    before = clocks("before int8-kernels bf16")
    qmm_rows = phase_infer_kernels_bf16(
        dev, gen, infer_counts["shapes"]["quant_matmul_bf16"]
        + counts_b1["shapes"]["quant_matmul_bf16"])
    stamp(qmm_rows, before, clocks("after int8-kernels bf16"))
    log_ratios("int8-kernels bf16", {str(i): r
                                     for i, r in enumerate(qmm_rows)})
    return {"counts": counts, "counts_ce": counts_ce, "rows": rows,
            "ce_rows": ce_rows, "cfg_ce": cfg_ce, "qmm_rows": qmm_rows,
            "qmm_routes": infer_counts["routes"] + counts_b1["routes"],
            "unfused": unfused, "profile": prof25, "infer16": infer16,
            "infer_b1": infer_b1}


def phase_infer_b1(dev, seed, b=INFER_B1[0], s=INFER_B1[1],
                   dtype="bfloat16", decorated=False):
    """Phase 27's second shape (phase 50's in fp16): the same int8
    BERT-base forward under O2 at batch 1 x 64 tokens, where every 16-bit
    launch has m <= 64 (the cluster route) and the fp32 ones take
    ``qmm_kernel`` (row 9): forward ms, launches by route, device time by
    kernel and the two routes' shares of it. Returns its launch counts
    and summary."""
    _, counts, model, batch, summary = phase_infer(
        dev, seed, b=b, s=s, level="O2", dtype=dtype, decorated=decorated)
    sfx = SFX16[dtype]
    busy_us, split = phase_infer_profile(model, batch, level="O2",
                                         tag=f"{b} x {s} {dtype}",
                                         dtype=dtype)
    del model, batch
    torch.cuda.empty_cache()
    iters = len(summary["forward_ms"])
    routes = counts["routes_fp16" if sfx == "_fp16" else "routes"]
    a_forward = {r: n // iters for r, n in routes.items()}
    log(f"infer O2 {dtype} {b} x {s}: forward "
        f"{summary['forward_ms_median']:.3f} ms (median of {iters}), device "
        f"busy {busy_us / 1e3:.3f} ms a forward; quant_matmul{sfx} "
        f"{counts['quant_matmul' + sfx] // iters} launches a forward, by "
        f"route {a_forward}, the cluster route "
        f"{split['qmm_cluster_kernel'] / 1e3:.4f} ms "
        f"({100 * split['qmm_cluster_kernel'] / busy_us:.1f}% of the "
        f"device time); quant_matmul on fp32 x (row 9) "
        f"{counts['quant_matmul'] // iters} launches a forward, qmm_kernel "
        f"{split['qmm_kernel'] / 1e3:.4f} ms "
        f"({100 * split['qmm_kernel'] / busy_us:.1f}%)")
    return counts, summary


def _numbers(r) -> dict:
    keys = ("shape", "max_abs_err", "ms", "bias_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_form", "launches_at_shape",
            "bf16_route",
            "err_over_limit", "step_ms", "step_span_ms", "clocks")
    return {k: r[k] for k in keys if k in r}


# ------------------------------------------------------------ eager
def port_launch_counts() -> dict:
    """Every kernel wrapper's launches since its last reset."""
    from paddle_tpu_torch.ops import codec

    return {**codec.launch_counts(), **train_launch_counts(),
            **_quant_module().launch_counts()}


def reset_port_launch_counts() -> None:
    from paddle_tpu_torch.ops import codec

    codec.reset_launch_counts()
    reset_train_launch_counts()
    _quant_module().reset_launch_counts()


def _us_per_op(fn, ops: int) -> float:
    """Host wall time of ``fn()`` (which ends in a host read of a value on
    the card, as bench.py's loops do), in us per op."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) / ops * 1e6


def phase_eager(dev):
    """Phase 33: bench.py's eager mode through the port on the card (the
    module docstring), beside plain PyTorch, then against the CPU."""
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as port_device
    from paddle_tpu_torch.framework.precision import matmul_precision
    from torch_checks import (EAGER_CHAIN, EAGER_GRAD, EAGER_GRAD_RTOL,
                              bench_eager_loops)

    (csize, n), (gsize, k) = EAGER_CHAIN, EAGER_GRAD
    iters = max(1, n // (2 * k))
    prev = list(port_device._CURRENT)
    try:
        paddle.set_device("gpu")
        x = paddle.ones(csize)
        xs, w = paddle.ones(gsize), paddle.ones(gsize)
        w.stop_gradient = False
        chain, train_iter = bench_eager_loops(paddle, xs, w, k)
        _ = float(chain(x, 20).sum())          # bench.py's warm-up
        _ = train_iter()
        out = {}

        def run_chain():
            out["y"] = chain(x, n)
            _ = float(out["y"].sum())

        def run_grad():
            for _ in range(iters):
                out["g"] = train_iter()
            _ = float(out["g"].sum())

        reset_port_launch_counts()
        us_chain = _us_per_op(run_chain, 2 * n)
        us_grad = _us_per_op(run_grad, iters * 4 * k)
        counts = port_launch_counts()
        if any(counts.values()):
            raise AssertionError(f"a kernel of the port ran on the eager "
                                 f"path: {counts}")

        # the yardstick: the same loops in plain PyTorch, in this call
        tx = torch.ones(csize, device=dev)
        txs = torch.ones(gsize, device=dev)
        tw = torch.ones(gsize, device=dev, requires_grad=True)

        def plain_chain():
            t = tx
            for _ in range(n):
                t = t * 1.0001 + 0.1
            _ = float(t.sum())

        def plain_iter():
            t = txs
            for _ in range(k):
                t = t @ tw
                t = t * 0.5
            t.sum().backward()
            g, tw.grad = tw.grad, None
            return g

        def plain_grad():
            for _ in range(iters):
                g = plain_iter()
            _ = float(g.sum())

        with matmul_precision("float32"):
            plain_chain()
            plain_iter()
            plain_us_chain = _us_per_op(plain_chain, 2 * n)
            plain_us_grad = _us_per_op(plain_grad, iters * 4 * k)

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_grad()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)

        made = {"x": x, "xs": xs, "w": w, "chain": out["y"],
                "w.grad": out["g"]}
        off = [name for name, t in made.items() if not t._value.is_cuda]
        if off:
            raise AssertionError(f"eager tensors off the card: {off}")

        paddle.set_device("cpu")
        xc = paddle.ones(csize)
        xsc, wc = paddle.ones(gsize), paddle.ones(gsize)
        wc.stop_gradient = False
        _, cpu_iter = bench_eager_loops(paddle, xsc, wc, k)
        y_cpu, g_cpu = chain(xc, n).numpy(), cpu_iter().numpy()
    finally:
        port_device._CURRENT[:] = prev
    y_card, g_card = out["y"].numpy(), out["g"].numpy()
    if not np.array_equal(y_card, y_cpu):
        raise AssertionError(f"eager chain: card and CPU differ, max "
                             f"{np.max(np.abs(y_card - y_cpu)):.3e}")
    rel = float(np.max(np.abs(g_card - g_cpu) / np.abs(g_cpu)))
    if not rel <= EAGER_GRAD_RTOL:
        raise AssertionError(f"eager w.grad: card against CPU {rel:.3e} "
                             f"relative, limit {EAGER_GRAD_RTOL}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(f"eager ({smi.stdout.strip()}): no-grad chain [256, 256] x {n}: "
        f"{us_chain:.2f} us/op (plain torch {plain_us_chain:.2f}, "
        f"{us_chain / plain_us_chain:.2f}x); grad loop [16, 16] k {k} x "
        f"{iters}: {us_grad:.2f} us/op (plain torch {plain_us_grad:.2f}, "
        f"{us_grad / plain_us_grad:.2f}x); launch counts all 0; chain "
        f"bit for bit against the CPU, w.grad {rel:.2e} relative; "
        f"grad loop under the profiler: wall {wall_us / 1e3:.3f} ms, "
        f"device busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}% "
        f"busy, {100 * (1 - busy_us / wall_us):.1f}% idle), "
        f"{sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  "
            f"{e.key[:90]}")
    return {"us_chain": us_chain, "us_grad": us_grad,
            "plain_us_chain": plain_us_chain, "plain_us_grad": plain_us_grad,
            "idle": 1 - busy_us / wall_us}


# ------------------------------------------------------------ random ops
RANDOM_N = 1 << 20          # elements a draw (randperm: 1 << 16)
RANDOM_SIGMAS = 6.0         # moments within this many standard errors


def _random_draws(paddle, n):
    """name -> (draw, dtype name, shape, (mean, variance) or None, check):
    every name of the reference's tensor/random.py and shuffle_batch, on
    the current place. ``check`` takes the draw as float64 numpy."""
    base = paddle.zeros([n])
    probs, rates = paddle.full([n], 0.3), paddle.full([n], 2.5)
    w = paddle.to_tensor(np.random.RandomState(3).rand(64, 1000)
                         .astype(np.float32))
    rows = paddle.to_tensor(np.arange(1 << 16, dtype=np.float32)[:, None]
                            * np.ones(16, np.float32))

    def within(lo, hi):
        def check(x):
            if not (x.min() >= lo and x.max() < hi):
                raise AssertionError(f"range [{x.min()}, {x.max()}] outside "
                                     f"[{lo}, {hi})")
        return check

    def integral(lo, hi):
        def check(x):
            within(lo, hi)(x)
            if not np.all(x == np.round(x)):
                raise AssertionError("a draw that is not an integer")
        return check

    def perm(x):
        if not np.array_equal(np.sort(x), np.arange(x.size)):
            raise AssertionError("not a permutation")

    def distinct(x):
        within(0, 1000)(x)
        if not all(len(set(r)) == r.size for r in x):
            raise AssertionError("an index repeats in a row")

    def shuffled():
        out, order = paddle.shuffle_batch(rows)
        if not np.array_equal(out.numpy()[:, 0], order.numpy()):
            raise AssertionError("shuffle_batch's rows are not its order's")
        return order

    f32, i32 = "float32", "int32"
    return {
        "rand": (lambda: paddle.rand([n]), f32, [n], (0.5, 1 / 12),
                 within(0, 1)),
        "uniform": (lambda: paddle.uniform([n], min=-2.0, max=3.0), f32, [n],
                    (0.5, 25 / 12), within(-2, 3)),
        "randn": (lambda: paddle.randn([n]), f32, [n], (0.0, 1.0), None),
        "standard_normal": (lambda: paddle.standard_normal([n]), f32, [n],
                            (0.0, 1.0), None),
        "normal": (lambda: paddle.normal(1.5, 2.0, [n]), f32, [n],
                   (1.5, 4.0), None),
        "randint": (lambda: paddle.randint(-3, 7, [n]), i32, [n],
                    (1.5, 99 / 12), integral(-3, 7)),
        "randperm": (lambda: paddle.randperm(1 << 16), i32, [1 << 16], None,
                     perm),
        "rand_like": (lambda: paddle.rand_like(base), f32, [n],
                      (0.5, 1 / 12), within(0, 1)),
        "randn_like": (lambda: paddle.randn_like(base), f32, [n], (0.0, 1.0),
                       None),
        "randint_like": (lambda: paddle.randint_like(base, 0, 4), f32, [n],
                         (1.5, 15 / 12), integral(0, 4)),
        "bernoulli": (lambda: paddle.bernoulli(probs), f32, [n],
                      (0.3, 0.21), integral(0, 2)),
        "poisson": (lambda: paddle.poisson(rates), f32, [n], (2.5, 2.5),
                    integral(0, math.inf)),
        "multinomial": (lambda: paddle.multinomial(w, 20), i32, [64, 20],
                        None, distinct),
        "uniform_": (lambda: paddle.zeros([n]).uniform_(-1.0, 2.0), f32,
                     [n], (0.5, 0.75), within(-1, 2)),
        "normal_": (lambda: paddle.zeros([n]).normal_(1.0, 0.5), f32, [n],
                    (1.0, 0.25), None),
        "exponential_": (lambda: paddle.zeros([n]).exponential_(2.0), f32,
                         [n], (0.5, 0.25), within(0, math.inf)),
        "shuffle_batch": (shuffled, i32, [1 << 16], None, perm),
    }


def _moments_ok(x, mean, var, what):
    """The draw's mean and variance within ``RANDOM_SIGMAS`` standard
    errors of the distribution's (the variance's from the sample's own
    fourth moment). Returns the two distances in standard errors."""
    n = x.size
    m, v = float(x.mean()), float(x.var())
    se_m = math.sqrt(var / n)
    se_v = math.sqrt(max(float(np.mean((x - m) ** 4)) - v * v, 1e-30) / n)
    zm, zv = abs(m - mean) / se_m, abs(v - var) / se_v
    if not (zm <= RANDOM_SIGMAS and zv <= RANDOM_SIGMAS):
        raise AssertionError(f"{what}: mean {m:.6g} ({zm:.2f} se from "
                             f"{mean}), variance {v:.6g} ({zv:.2f} se from "
                             f"{var}), limit {RANDOM_SIGMAS}")
    return zm, zv


def phase_random(dev):
    """Phase 34: every random op on the card (the module docstring)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as port_device
    from paddle_tpu_torch.framework.dtype import dtype_name

    n = RANDOM_N
    prev = list(port_device._CURRENT)
    worst = {}
    try:
        paddle.set_device("gpu")
        reset_port_launch_counts()
        for name, (draw, dt, shape, mom, check) in _random_draws(
                paddle, n).items():
            paddle.seed(17)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = draw()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if not a._value.is_cuda:
                raise AssertionError(f"{name}: drawn on {a.place}")
            if (dtype_name(a.dtype), a.shape) != (dt, shape):
                raise AssertionError(f"{name}: {dtype_name(a.dtype)} "
                                     f"{a.shape}, expected {dt} {shape}")
            x = a.numpy().astype(np.float64)
            if check is not None:
                check(x)
            z = _moments_ok(x.ravel(), *mom, name) if mom else (0.0, 0.0)
            paddle.seed(17)
            if not np.array_equal(draw().numpy(), a.numpy()):
                raise AssertionError(f"{name}: seed(17) drew other bits")
            state = paddle.get_cuda_rng_state()
            b = draw().numpy()
            paddle.set_cuda_rng_state(state)
            if not np.array_equal(draw().numpy(), b):
                raise AssertionError(f"{name}: the restored card state drew "
                                     f"other bits")
            if np.array_equal(b, a.numpy()) and name != "randperm":
                raise AssertionError(f"{name}: two draws in a row are equal")
            worst[name] = (ms, *z)
        paddle.seed(1)
        u = paddle.uniform([n], seed=9).numpy()
        paddle.seed(2)
        paddle.rand([5])
        if not np.array_equal(paddle.uniform([n], seed=9).numpy(), u):
            raise AssertionError("uniform(seed=9) moved with the global "
                                 "stream")
        paddle.seed(4)
        g1 = paddle.rand([64]).numpy()
        paddle.seed(4)
        paddle.uniform([n], seed=9)
        if not np.array_equal(paddle.rand([64]).numpy(), g1):
            raise AssertionError("uniform(seed=9) moved the global stream")
        # the CPU and the card draw other bits from one seed (on purpose,
        # ROADMAP.md Queue C); each repeats itself
        paddle.seed(0)
        card = paddle.rand([64]).numpy()
        paddle.set_device("cpu")
        paddle.seed(0)
        host = paddle.rand([64]).numpy()
        if np.array_equal(card, host):
            raise AssertionError("the CPU's and the card's seeded draws now "
                                 "agree: drop the pinned difference")
        counts = port_launch_counts()
        if any(counts.values()):
            raise AssertionError(f"a kernel of the port ran: {counts}")
    finally:
        port_device._CURRENT[:] = prev
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(f"random ({smi.stdout.strip()}): {len(worst)} names at {n} "
        f"elements (randperm, shuffle_batch 65536, multinomial [64, 1000] "
        f"x 20): dtypes, shapes, ranges; moments within {RANDOM_SIGMAS} "
        f"standard errors; seed -> the same bits twice; "
        f"get_cuda_rng_state -> draw -> set_cuda_rng_state -> the same "
        f"draw; uniform(seed=9) apart from the global stream; the CPU's "
        f"seeded draw differs from the card's (pinned); no kernel of the "
        f"port launched")
    for name, (ms, zm, zv) in worst.items():
        log(f"  {name:16s} first draw {ms:8.3f} ms (host wall, synced); "
            f"mean {zm:.2f} se, variance {zv:.2f} se")
    return worst


# ------------------------------------------------------------------ LeNet
LENET_B = 64                # Paddle's MNIST quick start: batch 64
LENET_STEPS = 5
LENET_WARMUP, LENET_TIMED = 5, 30
LENET_GRAD_RTOL = 1e-5      # the first step, card against CPU
# five Adam steps card against CPU: the fp32 convolutions and GEMMs sum
# in other orders (~1e-6 of each output); Adam's normalised step carries
# a gradient's relative error into the update, so a few steps move the
# loss by a few 1e-6. 1e-4 holds that with room and still fails an
# update that skipped a parameter or a step (1e-3 of the loss a step).
LENET_LOSS_RTOL = 1e-4


def _lenet_batches(paddle, seed, steps):
    rs = np.random.RandomState(seed)
    return [(paddle.to_tensor(rs.rand(LENET_B, 1, 28, 28)
                              .astype(np.float32)),
             paddle.to_tensor(rs.randint(0, 10, (LENET_B,)), dtype="int64"))
            for _ in range(steps)]


def _norm_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _plain_lenet(model, dev):
    """The same LeNet in plain PyTorch (torch.nn), the port's weights
    copied in (a Linear's [in, out] weight transposed)."""
    from paddle_tpu_torch.framework.modules import torch_named_parameters

    net = torch.nn.Sequential(
        torch.nn.Conv2d(1, 6, 3, 1, 1), torch.nn.ReLU(),
        torch.nn.MaxPool2d(2, 2), torch.nn.Conv2d(6, 16, 5, 1, 0),
        torch.nn.ReLU(), torch.nn.MaxPool2d(2, 2), torch.nn.Flatten(1),
        torch.nn.Linear(400, 120), torch.nn.Linear(120, 84),
        torch.nn.Linear(84, 10)).to(dev)
    src = [t.detach() for _, t in torch_named_parameters(model)]
    with torch.no_grad():
        for (name, p), s in zip(net.named_parameters(), src):
            p.copy_(s.t() if name.endswith("weight") and p.dim() == 2
                    else s)
    return net


def _eager_update_row(opt, flush, library, library_form, bytes_per_el,
                      flops_per_el, label, kernel=None):
    """Row 6 at an eager optimizer's table (one entry a parameter): its
    error (``_table_err``); then, in one call, ``kernel(table, lr)`` (one
    launch by default), the update as ``Optimizer.step()`` calls it, the
    plain walk and ``library(ps, gs, *slots)`` over clones of the same
    tensors, timed; the bound: ``bytes_per_el`` bytes and
    ``flops_per_el`` operations an element."""
    from paddle_tpu_torch.ops import fused_update as fu

    table = opt._table
    lr = opt._lr_tensor_kept(table.device)
    kernel = kernel or fu.fused_update_buckets
    ps = [e[0].clone() for e in table.entries]
    gs = [e[1].clone() for e in table.entries]
    slots = [[e[2][k].clone() for e in table.entries]
             for k in range(len(table.entries[0][2]))]
    n = sum(e[0].numel() for e in table.entries)
    bound_ms, bound_by = work_bound(bytes_per_el * n, flops_per_el * n)
    return {"shape": f"{label}: {len(table.entries)} parameters, {n} "
                     f"elements (one eager step, float32, {table.kind})",
            "library_form": library_form,
            "max_abs_err": _table_err(table, lr),
            "step_ms": median_ms(opt.step, flush),
            "ms": median_ms(lambda: kernel(table, lr), flush),
            "library_ms": median_ms(lambda: library(ps, gs, *slots),
                                    flush),
            "step_span_ms": span_ms(opt.step, flush),
            "span_ms": span_ms(lambda: kernel(table, lr), flush),
            "library_span_ms": span_ms(lambda: library(ps, gs, *slots),
                                       flush),
            "plain_ms": median_ms(lambda: fu.buckets_plain(table, lr),
                                  flush),
            "bound_ms": bound_ms, "bound_by": bound_by, "elements": n}


def _step_ms(step, runs):
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def phase_lenet(dev, seed):
    """Phase 35: LeNet trained as a Paddle user writes it (the module
    docstring)."""
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.framework import device as port_device
    from paddle_tpu_torch.framework.precision import matmul_precision
    from paddle_tpu_torch.ops import fused_update as fu
    from torch_checks import same_bits

    prev = list(port_device._CURRENT)
    F = paddle.nn.functional
    calls = {"update_math": 0}
    real_math = popt.update_math

    def counted_math(p, *a, **k):     # the plain update of a card tensor
        calls["update_math"] += int(p.is_cuda)
        return real_math(p, *a, **k)

    try:
        paddle.set_device("gpu")
        paddle.seed(0)
        model = paddle.vision.models.LeNet()
        opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                    parameters=model.parameters())
        batches = _lenet_batches(paddle, seed, LENET_STEPS)
        paddle.set_device("cpu")
        cpu_model = paddle.vision.models.LeNet()
        cpu_model.set_state_dict(model.state_dict())
        cpu_opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                        parameters=cpu_model.parameters())
        cpu_batches = [(x.cpu(), y.cpu()) for x, y in batches]
        paddle.set_device("gpu")
        if not all(p._value.is_cuda for p in model.parameters()):
            raise AssertionError("a LeNet parameter is off the card")

        def one(m, o, x, y):
            loss = F.cross_entropy(m(x), y)
            loss.backward()
            return loss

        losses, cpu_losses, builds, tables = [], [], 0, set()
        first = {}
        popt.update_math = counted_math
        reset_port_launch_counts()
        for i, ((x, y), (xc, yc)) in enumerate(zip(batches, cpu_batches)):
            loss, loss_c = one(model, opt, x, y), one(cpu_model, cpu_opt,
                                                      xc, yc)
            if i == 0:
                first["loss"] = _norm_rel(float(loss), float(loss_c))
                first["grads"] = max(
                    _norm_rel(p.grad.numpy(), q.grad.numpy())
                    for p, q in zip(model.parameters(),
                                    cpu_model.parameters()))
            if i == 1:   # the eager step's launch against its plain version
                snap = [(p._value.detach().clone(), p._value.grad.clone())
                        for p in model.parameters()]
                slots = [{k: v.clone() for k, v in
                          opt._slots[id(p._value)].items()}
                         for p in model.parameters()]
            opt.step()
            if id(opt._table) not in tables:
                tables.add(id(opt._table))
                builds += 1
            opt.clear_grad()
            cpu_opt.step()
            cpu_opt.clear_grad()
            losses.append(float(loss))
            cpu_losses.append(float(loss_c))
            if i == 1:
                calls_before = calls["update_math"]
                ref = popt.Adam(learning_rate=1e-3, parameters=[
                    s[0] for s in snap])
                for (p0, g0), s in zip(snap, slots):
                    ref._slots[id(p0)] = s
                ref._step_plain([s[0] for s in snap], [s[1] for s in snap])
                calls["update_math"] = calls_before   # the reference's
                differ = [k for k, (p, (p0, _)) in enumerate(zip(
                    model.parameters(), snap))
                    if not same_bits(p._value.detach(), p0)]
                for p, (p0, _) in zip(model.parameters(), snap):
                    mine, plain = opt._slots[id(p._value)], ref._slots[id(p0)]
                    differ += [nm for nm in ("moment1", "moment2",
                                             "beta1_pow", "beta2_pow")
                               if not same_bits(mine[nm], plain[nm])]
                if differ:
                    raise AssertionError(f"the eager step's kernel and its "
                                         f"plain version differ: {differ}")
        counts = port_launch_counts()
        popt.update_math = real_math
        if calls["update_math"]:
            raise AssertionError(f"update_math ran {calls['update_math']} "
                                 f"times on the card")
        want = {k: LENET_STEPS if k == "fused_update" else 0 for k in counts}
        if counts != want:
            raise AssertionError(f"LeNet launch counts {counts}, expected "
                                 f"{want}")
        if not (first["loss"] <= LENET_GRAD_RTOL
                and first["grads"] <= LENET_GRAD_RTOL):
            raise AssertionError(f"LeNet's first step, card against CPU: "
                                 f"{first}, limit {LENET_GRAD_RTOL}")
        loss_rel = max(_norm_rel(a, b) for a, b in zip(losses, cpu_losses))
        if not loss_rel <= LENET_LOSS_RTOL:
            raise AssertionError(f"LeNet's losses, card against CPU: "
                                 f"{loss_rel:.2e} (limit {LENET_LOSS_RTOL})")
        param_rel = max(_norm_rel(p.numpy(), q.numpy()) for p, q in zip(
            model.parameters(), cpu_model.parameters()))
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"LeNet's losses {losses}")

        # ms a step: the port's loop against the same LeNet in plain
        # PyTorch (torch.optim.Adam), from the same weights, in this call
        x, y = batches[0]

        def port_step():
            one(model, opt, x, y)
            opt.step()
            opt.clear_grad()

        net = _plain_lenet(model, dev)
        topt = torch.optim.Adam(net.parameters(), lr=1e-3)
        tx, ty = x._value, y._value.long()

        def plain_step():
            loss = torch.nn.functional.cross_entropy(net(tx), ty)
            loss.backward()
            topt.step()
            topt.zero_grad()

        for _ in range(LENET_WARMUP):
            port_step()
        port_ms = _step_ms(port_step, LENET_TIMED)
        with matmul_precision("float32"):
            for _ in range(LENET_WARMUP):
                plain_step()
            plain_ms = _step_ms(plain_step, LENET_TIMED)
        port_ms_again = _step_ms(port_step, LENET_TIMED)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                port_step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        one(model, opt, x, y)      # gradients in place for the row's step()
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                            device=dev)
        steps = [torch.full((), 4.0, device=dev) for _ in opt._table.entries]

        def adam(ps, gs, m1, m2):
            torch._fused_adam_(ps, gs, m1, m2, [], steps, lr=1e-3,
                               beta1=0.9, beta2=0.999, weight_decay=0.0,
                               eps=1e-8, amsgrad=False, maximize=False)

        def kernel(table, lr):     # the same powers each time
            fu.fused_update_buckets(table, lr)
            table.parity = 1 - table.parity

        # p, g, m1, m2 read, p, m1, m2 written; ~20 operations an element
        with torch.no_grad():      # the table's views of the leaves
            row = _eager_update_row(opt, flush, adam,
                                    "torch._fused_adam_, fp32 moments", 28,
                                    20, "LeNet's table", kernel)
        del flush
        opt.clear_grad()
    finally:
        popt.update_math = real_math
        port_device._CURRENT[:] = prev
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    idle = 1 - busy_us / wall_us
    log(f"lenet ({smi.stdout.strip()}): vision.models.LeNet after "
        f"paddle.seed(0), batch {LENET_B} x 1 x 28 x 28, Adam(1e-3), "
        f"F.cross_entropy, {LENET_STEPS} steps of loss.backward(); "
        f"opt.step(); opt.clear_grad() on eager Tensors: losses "
        f"{[round(v, 6) for v in losses]}; launch counts {counts} (one "
        f"fused_update a step, update_math 0 calls); {builds} table(s) "
        f"built; the eager step's kernel bit for bit against its plain "
        f"version; card against CPU from the same weights: first loss "
        f"{first['loss']:.2e}, gradients {first['grads']:.2e} (limit "
        f"{LENET_GRAD_RTOL}), {LENET_STEPS} losses {loss_rel:.2e} (limit "
        f"{LENET_LOSS_RTOL}), parameters after them {param_rel:.2e}")
    log(f"lenet step (median of {LENET_TIMED}, host wall, synced): port "
        f"{port_ms:.3f} ms, then {port_ms_again:.3f} ms; plain PyTorch "
        f"(torch.nn, torch.optim.Adam) {plain_ms:.3f} ms "
        f"({min(port_ms, port_ms_again) / plain_ms:.2f}x); the port's loop "
        f"under the profiler: wall {wall_us / 1e3:.3f} ms for 10 steps, "
        f"device busy {busy_us / 1e3:.3f} ms ({100 * idle:.1f}% idle), "
        f"{sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  "
            f"{e.key[:90]}")
    log(f"fused_update, {row['shape']}, one launch, device time (from an "
        f"idle card): as Optimizer.step() calls it {row['step_ms']:.4f} ms "
        f"({row['step_span_ms']:.4f}), the kernel alone {row['ms']:.4f} "
        f"({row['span_ms']:.4f}), torch._fused_adam_ {row['library_ms']:.4f}"
        f" ({row['library_span_ms']:.4f}); plain {row['plain_ms']:.4f}; "
        f"bound {row['bound_ms']:.5f} {row['bound_by']}, the kernel at "
        f"{100 * row['bound_ms'] / row['ms']:.2f}% of it")
    return {"counts": counts, "row": row, "port_ms": port_ms,
            "plain_ms": plain_ms, "idle": idle}


# ------------------------------------------------------ nn on the card
def phase_nn(dev):
    """Phase 36: every case of ``tests/torch_nn_checks.py`` ``NN_CASES``
    (each new functional and every layer that holds state) on the card
    against the CPU, then the dropout family's properties on the card's
    generator; no kernel of the port launched."""
    from torch_nn_checks import (NN_CASES, NN_RTOL, dropout_properties,
                                 nn_case_label, nn_case_vs_cpu)

    reset_port_launch_counts()
    worst = {"out": (0.0, ""), "grad": (0.0, "")}
    for case in NN_CASES:
        errs = nn_case_vs_cpu(dev, case)
        for k, v in errs.items():
            if v > worst[k][0]:
                worst[k] = (v, nn_case_label(case))
    shares = dropout_properties(dev)
    counts = port_launch_counts()
    if any(counts.values()):
        raise AssertionError(f"nn launched a port kernel: {counts}")
    log(f"nn on the card: {len(NN_CASES)} cases against the CPU, worst "
        f"output {worst['out'][0]:.2e} ({worst['out'][1]}), worst gradient "
        f"{worst['grad'][0]:.2e} ({worst['grad'][1]}), limit {NN_RTOL}; "
        f"masks and one-hot rows bit for bit; every output on the card")
    log("dropout on the card (share dropped, 6 standard errors held; kept "
        "entries x / (1 - p) bit for bit, gradient the mask's scale, whole "
        "channels, alpha_dropout's moments, repeats after paddle.seed, "
        "gumbel_softmax rows): "
        + ", ".join(f"{k} {v:.4f}" for k, v in shares.items()))
    return {"cases": len(NN_CASES), "worst": worst, "shares": shares}


# -------------------------------------------- the public flash entry
# F.flash_attention at GPT-125M's train shape (causal) and BERT-base's
# (full), [b, s, n, d] as the entry takes them
FLASH_ENTRY = (((8, 1024, 12, 64), True), ((16, 512, 12, 64), False))


def _flash_entry_case(dev, gen, shape, causal, dtype, flush):
    """``F.flash_attention`` on card tensors of ``shape`` ([b, s, n, d]):
    one forward and backward through the entry, its launches, out and
    the gradients against the kernels' plain versions; dropout > 0
    launching none; ``flash_attn_unpadded`` at equal lengths; then the
    entry's forward and backward, the kernels alone, their plain
    versions and SDPA, timed."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import flash_attention as fa
    from torch_checks import flash_err

    F = paddle.nn.functional
    b, s, n, d = shape
    bf16 = dtype == torch.bfloat16
    sfx = "_bf16" if bf16 else ""
    q, k, v, do = (torch.randn(*shape, device=dev, generator=gen)
                   .to(dtype) for _ in range(4))
    qt, kt, vt = (x.detach().requires_grad_() for x in (q, k, v))
    fa.reset_launch_counts()
    out, _ = F.flash_attention(qt, kt, vt, causal=causal)
    dq, dk, dv = torch.autograd.grad(out, (qt, kt, vt), do)
    counts = fa.launch_counts()
    want = {f"flash_fwd{sfx}": 1, f"flash_dq{sfx}": 1, f"flash_dkv{sfx}": 1}
    if any(counts[k_] != want.get(k_, 0) for k_ in counts):
        raise AssertionError(f"F.flash_attention {list(shape)} {dtype}: "
                             f"launches {counts}, expected {want}")
    # the plain versions on the kernels' own inputs: the forward on q, k,
    # v; the backward also on the kernel's lse and delta, as the entry's
    # backward feeds them (torch_checks.flash_vs_plain)
    bn = [x.transpose(1, 2).contiguous() for x in (q, k, v, do)]
    p_out, p_lse = fa.flash_fwd_plain(*bn[:3], causal)
    k_out, lse = fa.flash_fwd(*bn[:3], causal)
    kdelta = (bn[3].float() * k_out.float()).sum(-1, keepdim=True)
    plain = dict(zip(("dq", "dk", "dv"), fa.flash_bwd_plain(
        *bn, lse, kdelta, causal)))
    errs = {"out": flash_err("out", dtype, out.detach().transpose(1, 2),
                             p_out)}
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        errs[name] = flash_err(name, dtype, got.transpose(1, 2),
                               plain[name])
    over = {k_: e for k_, e in errs.items() if not e[1] <= 1.0}
    if over:
        raise AssertionError(f"F.flash_attention {list(shape)} {dtype} "
                             f"against the plain kernels: {over}")
    fa.reset_launch_counts()
    F.flash_attention(qt, kt, vt, dropout=0.1, causal=causal)[0].sum(
        ).backward()
    if any(fa.launch_counts().values()):
        raise AssertionError(f"dropout 0.1 reached the flash kernels: "
                             f"{fa.launch_counts()}")
    cu = torch.arange(0, (b + 1) * s, s, dtype=torch.int32)
    packed = [x.reshape(b * s, n, d) for x in (q, k, v)]
    up, _ = F.flash_attn_unpadded(*packed, cu, cu, s, s, 0.5, causal=causal)
    if fa.launch_counts()[f"flash_fwd{sfx}"] != 1 or not torch.equal(
            up, out.detach().reshape(b * s, n, d)):
        raise AssertionError("flash_attn_unpadded did not run the kernel "
                             "of the padded entry")

    ref = F.flash_attention(qt, kt, vt, causal=causal)[0]
    sd = [x.detach().requires_grad_() for x in bn[:3]]
    sref = torch.nn.functional.scaled_dot_product_attention(
        *sd, is_causal=causal)
    delta = (bn[3].float() * p_out.float()).sum(-1, keepdim=True)
    times = {
        "entry_fwd_ms": median_ms(lambda: F.flash_attention(
            q, k, v, causal=causal), flush),
        "entry_bwd_ms": median_ms(lambda: torch.autograd.grad(
            ref, (qt, kt, vt), do, retain_graph=True), flush),
        "fwd_ms": median_ms(lambda: fa.flash_fwd(*bn[:3], causal), flush),
        "dq_ms": median_ms(lambda: fa.flash_dq(*bn, lse, kdelta, causal),
                           flush),
        "dkv_ms": median_ms(lambda: fa.flash_dkv(*bn, lse, kdelta, causal),
                            flush),
        "plain_fwd_ms": median_ms(lambda: fa.flash_fwd_plain(
            *bn[:3], causal), flush),
        "plain_dq_ms": median_ms(lambda: fa.flash_dq_plain(
            *bn, p_lse, delta, causal), flush),
        "plain_dkv_ms": median_ms(lambda: fa.flash_dkv_plain(
            *bn, p_lse, delta, causal), flush),
        "sdpa_fwd_ms": median_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                *bn[:3], is_causal=causal), flush),
        "sdpa_bwd_ms": median_ms(lambda: torch.autograd.grad(
            sref, sd, bn[3], retain_graph=True), flush)}
    bounds = {}
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        work = flash_work((b, n, s, d), causal, name, q.element_size())
        bounds[name] = (work_bound(*work, bf16=True) if bf16 else
                        work_bound(*work, TF32_PASSES[name]))
    label = (f"[{b}, {s}, {n}, {d}] {'causal' if causal else 'full'} "
             f"{'bf16' if bf16 else 'fp32'} via F.flash_attention")
    log(f"flash entry {label}: launches {counts}; max abs diff against "
        f"plain " + ", ".join(f"{k_} {e:.2e} ({r:.3f} of its limit)"
                              for k_, (e, r) in errs.items())
        + f"; dropout 0.1 took SDPA (0 launches); flash_attn_unpadded "
        f"bit for bit | entry forward {times['entry_fwd_ms']:.4f} ms "
        f"(kernel {times['fwd_ms']:.4f}, plain {times['plain_fwd_ms']:.4f}"
        f", bound {bounds['flash_fwd'][0]:.4f} {bounds['flash_fwd'][1]}, "
        f"SDPA {times['sdpa_fwd_ms']:.4f}); entry backward "
        f"{times['entry_bwd_ms']:.4f} ms (dq {times['dq_ms']:.4f} + dkv "
        f"{times['dkv_ms']:.4f}, plain {times['plain_dq_ms']:.4f} + "
        f"{times['plain_dkv_ms']:.4f}, bounds "
        f"{bounds['flash_dq'][0]:.4f} + {bounds['flash_dkv'][0]:.4f}, SDPA "
        f"backward {times['sdpa_bwd_ms']:.4f})")
    rows = {}
    for name, ms, plain_ms, lib, outs in (
            ("flash_fwd", times["fwd_ms"], times["plain_fwd_ms"],
             times["sdpa_fwd_ms"], ("out",)),
            ("flash_dq", times["dq_ms"], times["plain_dq_ms"], None,
             ("dq",)),
            ("flash_dkv", times["dkv_ms"], times["plain_dkv_ms"],
             times["sdpa_bwd_ms"], ("dk", "dv"))):
        rows[name + sfx] = {
            "shape": label, "launches_at_shape": counts[name + sfx],
            "max_abs_err": max(errs[o][0] for o in outs), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "library_ms": lib,
            "entry_ms": times["entry_fwd_ms"] if name == "flash_fwd"
            else times["entry_bwd_ms"]}
    return rows


def phase_flash_entry(dev, gen):
    """Phase 37: the public flash entry at full width (the module
    docstring). Returns its rows for the kernels line."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows = {}
    for shape, causal in FLASH_ENTRY:
        for dtype in (torch.float32, torch.bfloat16):
            for name, r in _flash_entry_case(dev, gen, shape, causal, dtype,
                                             flush).items():
                rows.setdefault(name, []).append(r)
            torch.cuda.empty_cache()
    del flush
    return rows


# ------------------------------------------------------- MobileNetV2
# Sandler et al. 2018 (MobileNetV2), section 6.1: batch 96 a worker, lr
# 0.045, weight decay 4e-5 (RMSProp there; Momentum 0.9 here, the port
# has no RMSProp: ROADMAP Queue A 5), dropout 0.2 before the classifier
MOBILENET_B, MOBILENET_IMG = 96, 224
MOBILENET_LR, MOBILENET_MOM, MOBILENET_WD = 0.045, 0.9, 4e-5
MOBILENET_WARMUP, MOBILENET_STEPS = 2, 5
MOBILENET_CHECK_B = 2
# card against CPU at batch 2 x 224 x 224, dropout 0, from the same
# weights: the first loss, relative; the gradients stage by stage (the
# 19 feature stages and the head, each fed the CPU's previous output and
# the same cotangent: torch_checks.stage_run), within RESNET_STAGE_TOL's
# fp32 limits, all but at most two stages within RESNET_FP32_GRAD_CLEAN
# (the whole network's gradients cannot be held: its batch norms over two
# images and its ReLU6 bounds amplify rounding); the
# update from the same gradients (the card's copied to the CPU), each
# parameter's step by norm_rel
MOBILENET_LOSS_RTOL = 1e-5
MOBILENET_UPDATE_RTOL = 1e-6
MOBILENET_KINDS = (
    ("conv backward (cuDNN, PyTorch's depthwise)",
     ("convolution_backward",)),
    ("conv forward (cuDNN, PyTorch's depthwise)",
     ("cudnn_convolution", "aten::convolution", "aten::_convolution",
      "aten::conv2d")),
    ("ReLU6 (hardtanh)", ("hardtanh",)),
    ("fused_update", ()),
)


class _PlainInvertedResidual(torch.nn.Module):
    def __init__(self, body, res):
        super().__init__()
        self.conv, self.res = body, res

    def forward(self, x):
        return x + self.conv(x) if self.res else self.conv(x)


def _plain_mobilenet(model, dev):
    """The same MobileNetV2 in plain PyTorch (torch.nn, its batch norm,
    ReLU6 and Dropout), the port's weights and running statistics copied
    in (a Linear's [in, out] weight transposed)."""
    from paddle_tpu_torch.framework.modules import (torch_buffers,
                                                    torch_named_parameters)

    tn = torch.nn

    def plain(m):
        kind = type(m).__name__
        if kind in ("Sequential", "ConvBNReLU"):
            return tn.Sequential(*[plain(c) for c in m.children()])
        if kind == "InvertedResidual":
            return _PlainInvertedResidual(plain(m.conv), m.use_res_connect)
        if kind == "Conv2D":
            w = m._parameters["weight"]
            return tn.Conv2d(w.shape[1] * m._groups, w.shape[0],
                             tuple(w.shape[2:]), m._stride, m._padding,
                             groups=m._groups, bias=False)
        if kind == "BatchNorm2D":
            return tn.BatchNorm2d(m._num_features, eps=m._epsilon,
                                  momentum=1 - m._momentum)
        if kind == "ReLU6":
            return tn.ReLU6()
        if kind == "Dropout":
            return tn.Dropout(m.p)
        if kind == "Linear":
            w = m._parameters["weight"]
            return tn.Linear(w.shape[0], w.shape[1])
        raise TypeError(kind)

    net = tn.Sequential(plain(model.features), tn.AdaptiveAvgPool2d(1),
                        tn.Flatten(1), plain(model.classifier)).to(dev)
    src = [t.detach() for _, t in torch_named_parameters(model)]
    bufs = [t.detach() for t in torch_buffers(model)]
    with torch.no_grad():
        for (name, p), s in zip(net.named_parameters(), src):
            p.copy_(s.t() if p.dim() == 2 else s)
        mine = [b for n, b in net.named_buffers()
                if not n.endswith("num_batches_tracked")]
        for b, s in zip(mine, bufs):
            b.copy_(s)
    return net


def kind_profile(one, kinds, tag, rest):
    """torch.profiler over one step (``one()``): busy and idle share, the
    kernels, and the device time by ``kinds`` ((label, op-name words); a
    kind with no words is the port's update kernel), the rest under
    ``rest``."""
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
    by = dict.fromkeys([k for k, _ in kinds] + [rest], 0.0)
    by["fused_update"] = sum(e.self_device_time_total for e in kernels
                             if "update_kernel" in e.key)
    for e in avgs:
        if (e.device_type != torch.autograd.DeviceType.CPU
                or not e.self_device_time_total):
            continue
        kind = next((k for k, words in kinds
                     if words and any(w in e.key for w in words)), rest)
        by[kind] += e.self_device_time_total
    by[rest] = busy - sum(v for k, v in by.items() if k != rest)
    log(f"{tag} profile: one step, wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% busy, "
        f"{100 * (1 - busy / wall_us):.1f}% idle), "
        f"{sum(e.count for e in kernels)} kernels per step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
            f"{100 * e.self_device_time_total / busy:5.1f}% "
            f"{e.count:5d}x  {e.key[:90]}")
    log("  by kind: " + ", ".join(f"{k} {t / 1e3:.3f} ms "
                                  f"({100 * t / busy:.1f}%)"
                                  for k, t in by.items()))
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle": 1 - busy / wall_us,
            "by_kind_ms": {k: t / 1e3 for k, t in by.items()}}


def _mobilenet_setup(paddle, batch, seed):
    """``mobilenet_v2()`` after ``paddle.seed(0)`` on the current place,
    Momentum with L2Decay, ``nn.CrossEntropyLoss()``, and a batch of
    images and labels from ``RandomState(seed)``."""
    paddle.seed(0)
    model = paddle.vision.models.mobilenet_v2()
    opt = paddle.optimizer.Momentum(
        learning_rate=MOBILENET_LR, momentum=MOBILENET_MOM,
        parameters=model.parameters(),
        weight_decay=paddle.regularizer.L2Decay(MOBILENET_WD))
    rs = np.random.RandomState(seed)
    x = paddle.to_tensor(rs.rand(batch, 3, MOBILENET_IMG, MOBILENET_IMG)
                         .astype(np.float32))
    y = paddle.to_tensor(rs.randint(0, 1000, (batch,)), dtype="int64")
    return model, opt, paddle.nn.CrossEntropyLoss(), x, y


def _mobilenet_stage_parity(card_model, cpu_model):
    """Every stage of MobileNetV2 on the card and on the CPU, fed the
    CPU's previous output and the same cotangent."""
    from torch_checks import mobilenet_stages, stage_errors, stage_run

    x = torch.from_numpy(np.random.RandomState(5).rand(
        MOBILENET_CHECK_B, 3, MOBILENET_IMG, MOBILENET_IMG).astype(
        np.float32))
    tol = RESNET_STAGE_TOL[None]
    worst, flipped = dict.fromkeys(tol, 0.0), []
    for i, (cs, ps) in enumerate(zip(mobilenet_stages(card_model),
                                     mobilenet_stages(cpu_model))):
        want = stage_run(cpu_model, ps, x, i)
        errs = stage_errors(stage_run(card_model, cs, x, i), want)
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
            if not v <= tol[k]:
                raise AssertionError(f"mobilenet_v2 stage {cs[0]} {k}: "
                                     f"{v:.2e} (limit {tol[k]:.0e})")
        if max(errs["dx"], errs["grads"]) > RESNET_FP32_GRAD_CLEAN:
            flipped.append(cs[0])
        x = want["out"]
    if len(flipped) > 2:
        raise AssertionError(f"mobilenet_v2 stages with gradients above "
                             f"{RESNET_FP32_GRAD_CLEAN:.0e}: {flipped}")
    return {**worst, "above_clean": flipped}


def _mobilenet_parity(paddle, dev, seed):
    """Card against CPU at batch 2, dropout 0, from the card's weights
    (MOBILENET_LOSS_RTOL's comment): the first loss, every stage, the
    update from the same gradients; then, dropout live, two runs of 2
    steps after ``paddle.seed(seed)`` from the same weights, their losses
    bit for bit (cuDNN held to its deterministic algorithms)."""
    from paddle_tpu_torch.framework.modules import torch_named_parameters

    first, models = {}, {}
    for place in ("gpu", "cpu"):
        paddle.set_device(place)
        model, opt, loss_fn, x, y = _mobilenet_setup(
            paddle, MOBILENET_CHECK_B, seed)
        if place == "cpu":
            model.set_state_dict(start)
        else:
            start = {n: t._value.detach().cpu().clone()
                     for n, t in model.state_dict().items()}
        model.train()
        model.classifier[0].p = 0.0
        loss = loss_fn(model(x), y)
        loss.backward()
        first[place] = float(loss)
        models[place] = (model, opt)
    res = {"loss": abs(first["gpu"] - first["cpu"]) / abs(first["cpu"])}
    # the update from the same gradients: the card's, on both sides
    (gm, gopt), (cm, copt) = models["gpu"], models["cpu"]
    before = {n: p.detach().cpu().clone()
              for n, p in torch_named_parameters(gm)}
    with torch.no_grad():
        for (n, pg), (_, pc) in zip(torch_named_parameters(gm),
                                    torch_named_parameters(cm)):
            pc.grad.copy_(pg.grad.cpu())
    gopt.step()
    copt.step()
    res["update"] = max(_norm_rel(
        (pg.detach().cpu() - before[n]).numpy(),
        (pc.detach() - before[n]).numpy())
        for (n, pg), (_, pc) in zip(torch_named_parameters(gm),
                                    torch_named_parameters(cm)))
    for m, o in models.values():
        o.clear_grad()
    gm.set_state_dict(start)
    cm.set_state_dict(start)
    res["stages"] = _mobilenet_stage_parity(gm, cm)
    del models, gm, cm
    paddle.set_device("gpu")
    runs = []
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for _ in range(2):
            model, opt, loss_fn, x, y = _mobilenet_setup(
                paddle, MOBILENET_CHECK_B, seed)
            model.set_state_dict(start)
            model.train()
            paddle.seed(seed)
            losses = []
            for _ in range(2):
                loss = loss_fn(model(x), y)
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(float(loss))
            runs.append(losses)
    finally:
        torch.backends.cudnn.deterministic = saved
    res["dropout_runs"] = runs
    return res


def phase_mobilenet(dev, seed):
    """Phase 38: MobileNetV2 trained as a Paddle user writes it, at
    ImageNet width (the module docstring)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.framework import device as port_device
    from paddle_tpu_torch.framework.precision import matmul_precision

    prev = list(port_device._CURRENT)
    calls = {"update_math": 0}
    real_math = popt.update_math

    def counted_math(p, *a, **k):     # the plain update of a card tensor
        calls["update_math"] += int(p.is_cuda)
        return real_math(p, *a, **k)

    try:
        paddle.set_device("gpu")
        model, opt, loss_fn, x, y = _mobilenet_setup(paddle, MOBILENET_B,
                                                     seed)
        n_params = sum(p._value.numel() for p in model.parameters())
        if not all(p._value.is_cuda for p in model.parameters()):
            raise AssertionError("a MobileNetV2 parameter is off the card")

        def step():
            loss = loss_fn(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        model.train()
        losses = [float(step()) for _ in range(MOBILENET_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        popt.update_math = counted_math
        reset_port_launch_counts()
        tables, step_ms = set(), []
        for _ in range(MOBILENET_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step()))       # waits for it
            step_ms.append((time.perf_counter() - t0) * 1e3)
            tables.add(id(opt._table))
        counts = port_launch_counts()
        popt.update_math = real_math
        peak = torch.cuda.max_memory_allocated() / 2**30
        if calls["update_math"]:
            raise AssertionError(f"update_math ran {calls['update_math']} "
                                 f"times on the card")
        want = {k: MOBILENET_STEPS if k == "fused_update" else 0
                for k in counts}
        if counts != want:
            raise AssertionError(f"MobileNetV2 launch counts {counts}, "
                                 f"expected {want}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"MobileNetV2's losses {losses}")
        med = statistics.median(step_ms)
        prof = kind_profile(step, MOBILENET_KINDS, "mobilenet_v2",
                            "batch norm and the other elementwise work")

        # the same network in plain PyTorch, from the same weights
        net = _plain_mobilenet(model, dev)
        topt = torch.optim.SGD(net.parameters(), lr=MOBILENET_LR,
                               momentum=MOBILENET_MOM,
                               weight_decay=MOBILENET_WD)
        tx, ty = x._value, y._value.long()

        def plain_step():
            loss = torch.nn.functional.cross_entropy(net(tx), ty)
            loss.backward()
            topt.step()
            topt.zero_grad()

        with matmul_precision("float32"):
            for _ in range(MOBILENET_WARMUP):
                plain_step()
            plain_ms = _step_ms(plain_step, MOBILENET_STEPS)
        port_again = _step_ms(step, MOBILENET_STEPS)
        del net, topt
        loss = loss_fn(model(x), y)     # gradients in place for the row
        loss.backward()
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                            device=dev)
        def sgd(ps, gs, vs):
            torch._fused_sgd_(ps, gs, vs, weight_decay=MOBILENET_WD,
                              momentum=MOBILENET_MOM, lr=MOBILENET_LR,
                              dampening=0.0, nesterov=False, maximize=False,
                              is_first_step=False)

        # p, g, v read, p, v written; 4 operations an element
        with torch.no_grad():
            row = _eager_update_row(
                opt, flush, sgd, "torch._fused_sgd_, momentum 0.9, "
                "dampening 0, weight_decay 4e-5", 20, 4,
                f"MobileNetV2's table (L2Decay {MOBILENET_WD})")
        del flush
        opt.clear_grad()
        del model, opt, x, y
        torch.cuda.empty_cache()
        parity = _mobilenet_parity(paddle, dev, seed)
    finally:
        popt.update_math = real_math
        port_device._CURRENT[:] = prev
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    ips = MOBILENET_B / (med / 1e3)
    log(f"mobilenet_v2 ({smi.stdout.strip()}): vision.models.mobilenet_v2()"
        f" after paddle.seed(0), {n_params} parameters, batch "
        f"{MOBILENET_B} x 3 x {MOBILENET_IMG} x {MOBILENET_IMG} fp32 NCHW, "
        f"nn.CrossEntropyLoss(), Momentum({MOBILENET_LR}, "
        f"{MOBILENET_MOM}, L2Decay({MOBILENET_WD})), Dropout(0.2) live; "
        f"{MOBILENET_WARMUP} + {MOBILENET_STEPS} steps: losses "
        f"{[round(v, 5) for v in losses]}; step {med:.2f} ms (median, host "
        f"wall), then {port_again:.2f}; {ips:.1f} images/s; peak "
        f"{peak:.2f} GiB; launch counts {counts} (one fused_update a step, "
        f"update_math 0 calls on the card), {len(tables)} table(s) built; "
        f"plain PyTorch (torch.nn, torch.optim.SGD) {plain_ms:.2f} ms "
        f"({min(med, port_again) / plain_ms:.2f}x)")
    log(f"fused_update, {row['shape']}, one launch, device time: as "
        f"Optimizer.step() calls it {row['step_ms']:.4f} ms "
        f"({row['step_span_ms']:.4f} from an idle card), the kernel alone "
        f"{row['ms']:.4f} ({row['span_ms']:.4f}), torch._fused_sgd_ "
        f"{row['library_ms']:.4f} ({row['library_span_ms']:.4f}); plain "
        f"{row['plain_ms']:.4f}; bound {row['bound_ms']:.5f} "
        f"{row['bound_by']}, the kernel at "
        f"{100 * row['bound_ms'] / row['ms']:.1f}% of it")
    runs = parity["dropout_runs"]
    st = parity["stages"]
    log(f"mobilenet_v2 card against CPU (batch {MOBILENET_CHECK_B} x 224, "
        f"dropout 0, the card's weights): loss {parity['loss']:.2e} (limit "
        f"{MOBILENET_LOSS_RTOL}); stage by stage (19 features, the "
        f"head): worst output {st['out']:.2e}, input gradient "
        f"{st['dx']:.2e}, parameter gradient {st['grads']:.2e}, buffers "
        f"{st['buffers']:.2e}, stages above {RESNET_FP32_GRAD_CLEAN:.0e}: "
        f"{st['above_clean']}; the update from the same gradients "
        f"{parity['update']:.2e} (limit {MOBILENET_UPDATE_RTOL}); dropout "
        f"live, two runs after paddle.seed({seed}): {runs}")
    if not (parity["loss"] <= MOBILENET_LOSS_RTOL
            and parity["update"] <= MOBILENET_UPDATE_RTOL):
        raise AssertionError(f"MobileNetV2 card against CPU: {parity}")
    if runs[0] != runs[1]:
        raise AssertionError(f"dropout did not repeat after paddle.seed: "
                             f"{runs}")
    return {"counts": counts, "row": row, "step_ms": med,
            "images_per_s": ips, "peak_gib": peak, "plain_ms": plain_ms,
            "profile": prof, "parity": parity}


# ------------------------------------------------------ the recurrent nn
def phase_rnn_nn(dev):
    """Phase 39: every case of ``tests/torch_rnn_checks.py`` (each new
    name of the recurrent slice) on the card against the CPU; no kernel
    of the port launched."""
    from torch_nn_checks import NN_RTOL
    from torch_rnn_checks import tail_vs_cpu

    reset_port_launch_counts()
    t0 = time.perf_counter()
    res = tail_vs_cpu(dev)
    counts = port_launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the recurrent nn launched a port kernel: "
                             f"{counts}")
    worst, more, beam = res["worst"], res["more"], res["beam"]
    top = max(more.items(), key=lambda kv: kv[1])
    log(f"rnn nn on the card: {res['cases']} cases against the CPU in "
        f"{time.perf_counter() - t0:.1f} s, worst output "
        f"{worst['out'][0]:.2e} ({worst['out'][1]}), worst gradient "
        f"{worst['grad'][0]:.2e} ({worst['grad'][1]}); RNN/BiRNN over "
        f"cells, nn.utils, sequence_concat, center_loss's centers: worst "
        f"{top[1]:.2e} ({top[0]}); limit {NN_RTOL}; integers (masks, "
        f"lengths, gather_tree, class_center_sample's draw after the same "
        f"np.random.seed) bit for bit; beam search (LSTMCell 128, vocab "
        f"1000, beam 4, 12 steps, 4 rows, the logits times "
        f"{beam['scale']:.3f} to a standard deviation of 4 at the first "
        f"step): {beam['rows_equal']} of {beam['rows']} rows' ids equal, "
        f"{beam['rows_parted_at_ties']} parting at a near tie, "
        f"{beam['tie_steps']} near ties in {beam['steps_held']} (row, step) "
        f"pairs held, the candidates' totals {beam['score_err']:.2e} of "
        f"their size apart")
    return res


PTB_VOCAB, PTB_HIDDEN, PTB_LAYERS = 10000, 650, 2   # Zaremba et al. medium
PTB_DROPOUT, PTB_INIT = 0.5, 0.05
PTB_B, PTB_T = 20, 35                # batch 20 x 35 unrolled steps
PTB_LR, PTB_CLIP = 1.0, 5.0
PTB_WARMUP, PTB_STEPS = 3, 10
PTB_ELEMENTS = 19_780_400            # the SGD table's fp32 elements
PTB_LOSS_RTOL = 1e-5                 # the first loss, card against CPU
# every parameter's gradient, card against CPU (norm_rel): cuDNN's
# recurrence and the CPU's sum in other orders through 35 steps and two
# layers, 0.2-1.0e-6 of each gradient (PR 23); a wrong gate or a step
# left out moves a gradient by its own size
PTB_GRAD_RTOL = 1e-5
PTB_ROUTE_RUNS = 20                  # timed runs of each recurrence route
# jit.TrainStep over a small LM on the card against the CPU: every
# parameter's change over 3 steps (norm_rel). The LSTM's weights change
# by ~1e-4 of their size, so the float32 rounding of the updated weights
# is ~1e-4 of a change; a parameter the update misses changes by 0,
# 1.0 from the CPU's
PTB_TS_VOCAB, PTB_TS_HIDDEN, PTB_TS_STEPS = 200, 64, 3
PTB_TS_RTOL = 1e-3
PTB_BEAM, PTB_CONTEXTS, PTB_DECODE_STEPS = 10, 20, 35
PTB_EOS = 0
PTB_KINDS = (
    ("recurrence (cuDNN)", ("cudnn_rnn", "_thnn_fused_lstm",
                            "lstm_cell")),
    ("GEMMs (output layer)", GEMM_OPS),
    ("softmax cross entropy", ("log_softmax", "nll_loss",
                               "_softmax_backward")),
    ("embedding", ("embedding",)),
    ("dropout", ("rand", "where", "div", "lt")),
    ("fused_update", ()))


def _ptb_model(paddle):
    from torch_rnn_checks import ptb_lm

    return ptb_lm(paddle, PTB_VOCAB, PTB_HIDDEN, PTB_LAYERS, PTB_DROPOUT,
                  PTB_INIT)


class _PlainPTB(torch.nn.Module):
    """The same network in plain PyTorch (``torch.nn.LSTM``), the port's
    weights copied in (a Linear's [in, out] weight transposed)."""

    def __init__(self, model, dev):
        super().__init__()
        self.embedding = torch.nn.Embedding(PTB_VOCAB, PTB_HIDDEN)
        self.drop = torch.nn.Dropout(PTB_DROPOUT)
        self.lstm = torch.nn.LSTM(PTB_HIDDEN, PTB_HIDDEN, PTB_LAYERS,
                                  batch_first=True)
        self.fc = torch.nn.Linear(PTB_HIDDEN, PTB_VOCAB)
        self.to(dev)
        src = dict(model.state_dict())
        with torch.no_grad():
            for name, p in self.named_parameters():
                v = src[name]._value
                p.copy_(v.t() if name == "fc.weight" else v)

    def forward(self, ids, states=None):
        y, states = self.lstm(self.drop(self.embedding(ids)), states)
        return self.fc(self.drop(y)), states


def _ptb_batches(paddle, seed, n):
    rs = np.random.RandomState(seed)
    return paddle.to_tensor(rs.randint(0, PTB_VOCAB, (n, PTB_B, PTB_T + 1)))


def _ptb_parity(paddle, model, ids, dev):
    """One step's loss and gradients on the card and on the CPU from the
    same weights, dropout off (the two generators draw other masks)."""
    from paddle_tpu_torch.framework.modules import torch_named_parameters

    cpu_state = {n: t._value.detach().cpu()
                 for n, t in model.state_dict().items()}
    paddle.set_device("cpu")
    cpu = _ptb_model(paddle)
    cpu.set_state_dict(cpu_state)
    paddle.set_device("gpu")
    got = {}
    for m, x in ((model, ids), (cpu, ids.cpu())):
        m.eval()
        logits, _ = m(x[:, :-1])
        loss = paddle.nn.functional.cross_entropy(
            logits.reshape([-1, PTB_VOCAB]), x[:, 1:].reshape([-1]))
        loss.backward()
        got[m is cpu] = (float(loss), {n: p.grad.detach().cpu().clone()
                                        for n, p in torch_named_parameters(m)})
        for _, p in torch_named_parameters(m):
            p.grad = None
        m.train()
    (lc, gc), (ld, gd) = got[True], got[False]
    grads = {n: _norm_rel(gd[n].numpy(), gc[n].numpy()) for n in gc}
    return {"loss": abs(ld - lc) / abs(lc), "grads": grads,
            "loss_card": ld, "loss_cpu": lc, "cpu_model": cpu}


def phase_ptb_lm(dev, seed):
    """Phase 40: the PTB LSTM language model, medium, trained as a Paddle
    user writes it at full width and depth (the module docstring)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.framework import device as port_device
    from paddle_tpu_torch.framework.precision import matmul_precision

    prev = list(port_device._CURRENT)
    calls = {"update_math": 0}
    real_math = popt.update_math

    def counted_math(p, *a, **k):     # the plain update of a card tensor
        calls["update_math"] += int(p.is_cuda)
        return real_math(p, *a, **k)

    try:
        paddle.set_device("gpu")
        paddle.seed(0)
        model = _ptb_model(paddle)
        n_params = sum(p._value.numel() for p in model.parameters())
        if n_params != PTB_ELEMENTS or not all(
                p._value.is_cuda for p in model.parameters()):
            raise AssertionError(f"the PTB LM holds {n_params} elements, "
                                 f"expected {PTB_ELEMENTS} on the card")
        opt = paddle.optimizer.SGD(
            learning_rate=PTB_LR, parameters=model.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(PTB_CLIP))
        loss_fn = paddle.nn.CrossEntropyLoss()
        ids = _ptb_batches(paddle, seed, PTB_WARMUP + PTB_STEPS)
        parity = _ptb_parity(paddle, model, ids[0], dev)
        carry = {"states": None, "i": 0}

        def step():
            x = ids[carry["i"] % ids.shape[0]]
            carry["i"] += 1
            logits, states = model(x[:, :-1], carry["states"])
            loss = loss_fn(logits.reshape([-1, PTB_VOCAB]),
                           x[:, 1:].reshape([-1]))
            loss.backward()
            opt.step()
            opt.clear_grad()
            carry["states"] = tuple(s.detach() for s in states)
            return loss

        model.train()
        losses = [float(step()) for _ in range(PTB_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        popt.update_math = counted_math
        reset_port_launch_counts()
        tables, step_ms = set(), []
        for _ in range(PTB_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step()))       # waits for it
            step_ms.append((time.perf_counter() - t0) * 1e3)
            tables.add(id(opt._table))
        counts = port_launch_counts()
        popt.update_math = real_math
        peak = torch.cuda.max_memory_allocated() / 2**30
        if calls["update_math"]:
            raise AssertionError(f"update_math ran {calls['update_math']} "
                                 f"times on the card")
        want = {k: PTB_STEPS if k == "fused_update" else 0 for k in counts}
        if counts != want:
            raise AssertionError(f"PTB LM launch counts {counts}, expected "
                                 f"{want}")
        if len(tables) != 1:
            raise AssertionError(f"the SGD table was built {len(tables)} "
                                 f"times in {PTB_STEPS} steps")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"the PTB LM's losses {losses}")
        med = statistics.median(step_ms)
        prof = kind_profile(step, PTB_KINDS, "ptb_lm",
                            "the rest (elementwise, the clip's norms)")

        # the dropout masks repeat after paddle.seed, and differ after
        # another seed
        with paddle.no_grad():
            draws = []
            for s_ in (7, 7, 8):
                paddle.seed(s_)
                logits, _ = model(ids[0][:, :-1])
                draws.append(float(logits.sum()))
        if not (draws[0] == draws[1] != draws[2]):
            raise AssertionError(f"dropout after paddle.seed: {draws}")

        # the same network in plain PyTorch, from the same weights
        net = _PlainPTB(model, dev)
        topt = torch.optim.SGD(net.parameters(), lr=PTB_LR)
        plain = {"states": None, "i": 0}
        tx = ids._value.long()

        def plain_step():       # the port's batches, in the port's order
            x = tx[plain["i"] % tx.shape[0]]
            plain["i"] += 1
            logits, states = net(x[:, :-1], plain["states"])
            loss = torch.nn.functional.cross_entropy(
                logits.reshape(-1, PTB_VOCAB), x[:, 1:].reshape(-1))
            loss.backward()
            torch.nn.utils.clip_grad_norm_(net.parameters(), PTB_CLIP)
            topt.step()
            topt.zero_grad()
            plain["states"] = tuple(s.detach() for s in states)

        with matmul_precision("float32"):
            for _ in range(PTB_WARMUP):
                plain_step()
            plain_ms = _step_ms(plain_step, PTB_STEPS)
        carry["i"] = PTB_WARMUP           # the same batches again
        port_again = _step_ms(step, PTB_STEPS)
        del net, topt
        routes = _ptb_routes(model, ids[0])
        trainstep = _ptb_trainstep(paddle, seed)
        x = ids[0]
        logits, _ = model(x[:, :-1])      # gradients in place for the row
        loss_fn(logits.reshape([-1, PTB_VOCAB]),
                x[:, 1:].reshape([-1])).backward()
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                            device=dev)

        def sgd(ps, gs):
            torch._fused_sgd_(ps, gs, [], weight_decay=0.0, momentum=0.0,
                              lr=PTB_LR, dampening=0.0, nesterov=False,
                              maximize=False, is_first_step=False)

        # p, g read, p written; 2 operations an element
        with torch.no_grad():
            row = _eager_update_row(opt, flush, sgd, "torch._fused_sgd_, "
                                    "lr 1.0, no momentum", 12, 2,
                                    "the PTB LM's table")
        del flush
        opt.clear_grad()
        if row["elements"] != PTB_ELEMENTS:
            raise AssertionError(f"row 6's table holds {row['elements']} "
                                 f"elements")
    finally:
        popt.update_math = real_math
        port_device._CURRENT[:] = prev
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    words = PTB_B * PTB_T / (med / 1e3)
    worst_grad = max(parity["grads"].items(), key=lambda kv: kv[1])
    log(f"ptb_lm ({smi.stdout.strip()}): Zaremba et al. medium, "
        f"Embedding({PTB_VOCAB}, {PTB_HIDDEN}), Dropout({PTB_DROPOUT}), "
        f"LSTM({PTB_HIDDEN}, {PTB_HIDDEN}, num_layers={PTB_LAYERS}), "
        f"Dropout, Linear({PTB_HIDDEN}, {PTB_VOCAB}), {n_params} parameters"
        f" drawn from Uniform(-{PTB_INIT}, {PTB_INIT}) after paddle.seed(0);"
        f" batch {PTB_B} x {PTB_T} fp32, the states carried and detached; "
        f"SGD({PTB_LR}, ClipGradByGlobalNorm({PTB_CLIP})), "
        f"nn.CrossEntropyLoss(); {PTB_WARMUP} + {PTB_STEPS} steps: losses "
        f"{[round(v, 5) for v in losses]}; step {med:.2f} ms (median, host "
        f"wall), then {port_again:.2f}; {words:.0f} words/s; peak "
        f"{peak:.2f} GiB; launch counts {counts} (one fused_update a step, "
        f"update_math 0 calls on the card), {len(tables)} table(s) built; "
        f"plain PyTorch (torch.nn.LSTM, torch.optim.SGD, clip_grad_norm_, "
        f"TF32 off; batches {PTB_WARMUP}-{PTB_WARMUP + PTB_STEPS - 1} as "
        f"the port's, {PTB_STEPS} steps, median) {plain_ms:.2f} ms: the "
        f"port at {med / plain_ms:.2f}x, its second reading over the same "
        f"batches at {port_again / plain_ms:.2f}x; dropout repeats after "
        f"paddle.seed(7), differs after 8")
    log(f"ptb_lm recurrence ({smi.stdout.strip()}): the LM's LSTM forward "
        f"and backward at [{PTB_B}, {PTB_T}, {PTB_HIDDEN}] fp32, device "
        f"time, median of {PTB_ROUTE_RUNS}: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in routes["ms"].items())
        + f"; the whole-length route against pack_padded_sequence: "
        f"outputs, states and gradients {routes['agree']:.2e} apart "
        f"(norm_rel); the LSTM weights in {routes['buffers']} buffer "
        f"after the steps above, cuDNN weight-layout warnings in the LM's "
        f"forwards: {routes['layout_warnings']}")
    log(f"ptb_lm under jit.TrainStep ({smi.stdout.strip()}): vocab "
        f"{PTB_TS_VOCAB}, hidden {PTB_TS_HIDDEN}, {PTB_LAYERS} layers, "
        f"{PTB_TS_STEPS} steps of SGD({PTB_LR}, ClipGradByGlobalNorm("
        f"{PTB_CLIP})) on the card and on the CPU from the same weights: "
        f"losses {trainstep['losses']}; every parameter's change, card "
        f"against CPU (norm_rel), worst {trainstep['worst'][1]:.2e} "
        f"({trainstep['worst'][0]}), limit {PTB_TS_RTOL}; the LSTM "
        f"weights' smallest change {trainstep['least_move']:.2e} of their "
        f"norm; cuDNN copied the re-laid-out weights "
        f"({trainstep['layout_warnings']} layout warning(s))")
    log(f"fused_update, {row['shape']}, one launch, device time: as "
        f"Optimizer.step() calls it {row['step_ms']:.4f} ms "
        f"({row['step_span_ms']:.4f} from an idle card), the kernel alone "
        f"{row['ms']:.4f} ({row['span_ms']:.4f}), torch._fused_sgd_ "
        f"{row['library_ms']:.4f} ({row['library_span_ms']:.4f}); plain "
        f"{row['plain_ms']:.4f}; bound {row['bound_ms']:.5f} "
        f"{row['bound_by']}, the kernel at "
        f"{100 * row['bound_ms'] / row['ms']:.1f}% of it; max_abs_err "
        f"{row['max_abs_err']}")
    log(f"ptb_lm card against CPU (one step from the same weights, dropout "
        f"off): loss {parity['loss_card']:.7f} against "
        f"{parity['loss_cpu']:.7f} (rel {parity['loss']:.2e}, limit "
        f"{PTB_LOSS_RTOL}); gradients by norm_rel, worst "
        f"{worst_grad[1]:.2e} ({worst_grad[0]}), limit {PTB_GRAD_RTOL}: "
        + ", ".join(f"{n} {v:.2e}" for n, v in parity["grads"].items()))
    if not (parity["loss"] <= PTB_LOSS_RTOL
            and worst_grad[1] <= PTB_GRAD_RTOL):
        raise AssertionError(f"the PTB LM card against CPU: loss "
                             f"{parity['loss']:.2e}, {worst_grad}")
    return {"counts": counts, "row": row, "step_ms": med,
            "port_again_ms": port_again, "routes": routes,
            "trainstep": trainstep,
            "words_per_s": words, "peak_gib": peak, "plain_ms": plain_ms,
            "profile": prof, "model": model, "cpu_model":
            parity["cpu_model"], "ids": ids}


def _ptb_routes(model, ids):
    """The LM's LSTM stack forward and backward at its training shape by
    three routes of the fused recurrence, device time by CUDA events:
    the port's (the whole length, ``batch_sizes`` all B), the packed
    route that ``sequence_length`` takes (``pack_padded_sequence``, all
    lengths T) and the unpacked one; the first two held together. Also
    counts cuDNN's weight-layout warnings over two of the LM's forwards
    (none while the weights keep the layout they were built with)."""
    import warnings

    from paddle_tpu_torch.framework.precision import (matmul_precision,
                                                      settings_for)
    from paddle_tpu_torch.nn.layer import rnn as rnn_mod

    lstm = model.lstm
    ws = lstm._weights()
    with torch.no_grad():
        x0 = model.embedding(ids[:, :-1])._value.detach()
    b, t = x0.shape[:2]
    gen = torch.Generator(device="cpu").manual_seed(5)
    states = [torch.randn(PTB_LAYERS, b, PTB_HIDDEN, generator=gen).to(
        x0.device) for _ in range(2)]
    cots = [torch.randn(*shape, generator=gen).to(x0.device) for shape in
            ((b, t, PTB_HIDDEN), (PTB_LAYERS, b, PTB_HIDDEN),
             (PTB_LAYERS, b, PTB_HIDDEN))]
    lens = torch.full((b,), t, dtype=torch.int64)
    routes = {
        "whole length (the port)": lambda x, hx: rnn_mod._full_call(
            "LSTM", x, hx, ws, PTB_LAYERS, False, False, True),
        "pack_padded_sequence": lambda x, hx: rnn_mod._packed_call(
            "LSTM", x, hx, ws, lens, PTB_LAYERS, False, False, True),
        "unpacked": lambda x, hx: torch._VF.lstm(
            x, tuple(hx), ws, True, PTB_LAYERS, 0.0, True, False, True)}
    ms, got = {}, {}
    with matmul_precision(settings_for(torch.float32)):
        for name, fn in routes.items():
            def run():
                x = x0.clone().requires_grad_()
                hx = [s.clone().requires_grad_() for s in states]
                outs = fn(x, hx)
                return outs, torch.autograd.grad(outs, [x, *hx, *ws],
                                                 cots)
            for _ in range(3):
                run()
            times = []
            for _ in range(PTB_ROUTE_RUNS):
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
                res = run()
                ev[1].record()
                torch.cuda.synchronize()
                times.append(ev[0].elapsed_time(ev[1]))
            ms[name] = statistics.median(times)
            got[name] = [v.detach().cpu().numpy() for v in (*res[0],
                                                            *res[1])]
    a, b_ = got["whole length (the port)"], got["pack_padded_sequence"]
    agree = max(_norm_rel(u, v) for u, v in zip(a, b_))
    if agree > PTB_GRAD_RTOL:
        raise AssertionError(f"the whole-length route and the packed one "
                             f"differ by {agree:.2e}")
    with warnings.catch_warnings(record=True) as seen, torch.no_grad():
        warnings.simplefilter("always")
        for _ in range(2):
            model(ids[:, :-1])
    layout = sum("contiguous chunk" in str(w.message) for w in seen)
    buffers = len({w.untyped_storage().data_ptr() for w in ws})
    if layout or buffers != 1:
        raise AssertionError(f"the LM's LSTM weights left cuDNN's layout: "
                             f"{layout} warning(s), {buffers} buffers")
    return {"ms": ms, "agree": agree, "layout_warnings": layout,
            "buffers": buffers}


def _ptb_trainstep(paddle, seed):
    """A small LM of phase 40's network trained by ``jit.TrainStep`` on the
    card and on the CPU from the same weights: ``FusedFlatUpdater``
    re-lays the parameters out as views of its buckets, and every
    parameter, the LSTM's too, must change as the CPU's does."""
    import warnings

    from paddle_tpu_torch.framework.modules import torch_named_parameters
    from paddle_tpu_torch.jit import TrainStep
    from torch_rnn_checks import ptb_lm

    def build():
        return ptb_lm(paddle, PTB_TS_VOCAB, PTB_TS_HIDDEN, PTB_LAYERS, 0.0,
                      PTB_INIT)

    def loss_fn(logits, states, labels):
        return paddle.nn.functional.cross_entropy(
            logits.reshape([-1, PTB_TS_VOCAB]), labels.reshape([-1]))

    paddle.set_device("gpu")
    paddle.seed(1)
    card = build()
    state = {n: t._value.detach().cpu().clone()
             for n, t in card.state_dict().items()}
    paddle.set_device("cpu")
    cpu = build()
    cpu.set_state_dict(state)
    paddle.set_device("gpu")
    ids = np.random.RandomState(seed).randint(
        0, PTB_TS_VOCAB, (PTB_TS_STEPS, 4, 13))
    moved, losses, layout = {}, {}, 0
    for m in (card, cpu):
        before = {n: p.detach().cpu().clone()
                  for n, p in torch_named_parameters(m)}
        opt = paddle.optimizer.SGD(
            learning_rate=PTB_LR, parameters=m.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(PTB_CLIP))
        step = TrainStep(m, loss_fn, opt)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            losses[m is cpu] = [round(float(step(x[:, :-1], x[:, 1:])), 6)
                                for x in ids]
        if m is card:
            layout = sum("contiguous chunk" in str(w.message) for w in seen)
        moved[m is cpu] = {n: (p.detach().cpu() - before[n]).numpy()
                           for n, p in torch_named_parameters(m)}
    rel = {n: _norm_rel(moved[False][n], v) for n, v in moved[True].items()}
    after = dict(torch_named_parameters(card))
    least = min(float(np.linalg.norm(v) / np.linalg.norm(
        after[n].detach().cpu().numpy()))
        for n, v in moved[False].items() if n.startswith("lstm."))
    worst = max(rel.items(), key=lambda kv: kv[1])
    if worst[1] > PTB_TS_RTOL or not least > 0:
        raise AssertionError(f"jit.TrainStep on the LM: the card's "
                             f"parameters moved otherwise than the CPU's "
                             f"({worst}), the LSTM's least change {least}")
    return {"losses": [losses[False], losses[True]], "worst": worst,
            "least_move": least, "layout_warnings": layout}


def _ptb_cell(model):
    """One step of the model's LSTM layers as a decoder's cell, its
    states ``(h, c)`` batch-first ``[N, layers, hidden]``."""
    import paddle_tpu_torch as paddle

    def cell(emb, states):
        h, c = (paddle.transpose(s, [1, 0, 2]) for s in states)
        y, (h, c) = model.lstm(paddle.unsqueeze(emb, 1), (h, c))
        return y[:, 0], tuple(paddle.transpose(s, [1, 0, 2])
                              for s in (h, c))

    return cell


def phase_ptb_beam(dev, trained):
    """Phase 41: beam search on phase 40's trained model, card against
    CPU (the module docstring)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as port_device
    from torch_rnn_checks import (LOGIT_STD, SCORE_RTOL, beam_vs_cpu,
                                  logit_scale)

    prev = list(port_device._CURRENT)
    model, cpu = trained["model"], trained["cpu_model"]
    ctx = trained["ids"]._value[0, :PTB_CONTEXTS, :PTB_T]
    cpu.set_state_dict({n: t._value.detach().cpu()
                        for n, t in model.state_dict().items()})

    def init(d):
        m = model if d.type == "cuda" else cpu
        with paddle.no_grad():
            _, (h, c) = m(paddle.to_tensor(ctx, place=d))
        return tuple(paddle.transpose(s, [1, 0, 2]) for s in (h, c))

    try:
        paddle.set_device("gpu")
        for m in (model, cpu):
            m.eval()
        with paddle.no_grad():
            logits, _ = cpu(paddle.to_tensor(ctx, place=torch.device("cpu")))
        scale = logit_scale(logits[:, -1], LOGIT_STD)
        t0 = time.perf_counter()
        res = beam_vs_cpu(dev, cpu, model, _ptb_cell, lambda m: m.embedding,
                          lambda m: m.fc, init, PTB_BEAM, PTB_DECODE_STEPS,
                          start_token=PTB_EOS, end_token=PTB_EOS, scale=scale)
        secs = time.perf_counter() - t0
    finally:
        port_device._CURRENT[:] = prev
    split = np.asarray(res["split_ms"])
    total = split.sum(1)
    med = float(np.median(total))
    share = split.sum(0) / total.sum()
    log(f"ptb beam search ({PTB_CONTEXTS} contexts of {PTB_T} tokens, "
        f"BeamSearchDecoder(beam_size={PTB_BEAM}) over the model's "
        f"{PTB_LAYERS} LSTM layers a step, dynamic_decode(max_step_num="
        f"{PTB_DECODE_STEPS}), the logits times {scale:.3f} to a standard "
        f"deviation of {LOGIT_STD} at the contexts' ends, card and CPU in "
        f"{secs:.1f} s): "
        f"{res['steps']} steps, {med:.3f} ms a decode step on the card "
        f"(median, host wall; the device's work {100 * share[0]:.1f}%, "
        f"the [{PTB_CONTEXTS * PTB_BEAM}, {PTB_VOCAB}] logits' copy to the "
        f"host {100 * share[1]:.1f}%, the host's bookkeeping "
        f"{100 * share[2]:.1f}%); finalized ids card against CPU: "
        f"{res['rows_equal']} of {res['rows']} rows equal, "
        f"{res['rows_parted_at_ties']} rows parting at a near tie (two of "
        f"the CPU's best beam + 1 totals within the spread of the step's "
        f"card-CPU differences; the exception), {res['tie_steps']} near "
        f"ties in the {res['steps_held']} (row, step) pairs held of "
        f"{res['rows'] * res['steps']}, lengths equal: "
        f"{res['lengths_equal']}; the candidates' totals until each row "
        f"parts, card against CPU, {res['score_err']:.2e} of max(1, |best|)"
        f" (limit {SCORE_RTOL})")
    return {**res, "decode_step_ms": med, "share": share.tolist()}



# ------------------------------------------ the other eager namespaces
STFT_B, STFT_N = 16, 16000          # 16 utterances of 1 s at 16 kHz
STFT_NFFT, STFT_HOP = 512, 160      # a speech front end's frames
# stft/istft card against CPU, relative to the spectrum's (the signal's)
# largest magnitude: cuFFT and pocketfft sum the 512 points in other
# orders, ~1e-7 of the largest bin
STFT_RTOL = 1e-5
DIST_N = 1 << 20                    # draws a distribution's moments hold
DEVICE_ALLOC = 256 << 20            # bytes phase 42 allocates


def _stft_row(paddle, dev, flush):
    """``paddle.signal.stft``/``istft`` at the speech front end's size on
    the card against the CPU, and ``stft`` timed beside ``torch.stft``
    on the same signal (a Hann window, reflect padding)."""
    rs = np.random.RandomState(42)
    x = rs.randn(STFT_B, STFT_N).astype(np.float32)
    w = np.hanning(STFT_NFFT).astype(np.float32)
    out = {}
    for where in ("cpu", "gpu"):
        paddle.set_device(where)
        xt, wt = paddle.to_tensor(x), paddle.to_tensor(w)
        spec = paddle.signal.stft(xt, STFT_NFFT, STFT_HOP, window=wt)
        back = paddle.signal.istft(spec, STFT_NFFT, STFT_HOP, window=wt,
                                   length=STFT_N)
        out[where] = (spec.numpy(), back.numpy(), xt, wt)
    (sc, bc, _, _), (sg, bg, xt, wt) = out["cpu"], out["gpu"]
    spec_err = float(np.max(np.abs(sg - sc)) / np.max(np.abs(sc)))
    back_err = float(np.max(np.abs(bg - bc)) / np.max(np.abs(bc)))
    tx, tw = xt._value, wt._value
    ref = torch.stft(tx, STFT_NFFT, STFT_HOP, window=tw, center=True,
                     pad_mode="reflect", return_complex=True)
    lib_err = float((ref - paddle.signal.stft(xt, STFT_NFFT, STFT_HOP,
                                              window=wt)._value).abs().max()
                    / ref.abs().max())
    ms = median_ms(lambda: paddle.signal.stft(xt, STFT_NFFT, STFT_HOP,
                                              window=wt), flush)
    lib = median_ms(lambda: torch.stft(tx, STFT_NFFT, STFT_HOP, window=tw,
                                       center=True, pad_mode="reflect",
                                       return_complex=True), flush)
    spec = paddle.to_tensor(sg)
    ims = median_ms(lambda: paddle.signal.istft(
        spec, STFT_NFFT, STFT_HOP, window=wt, length=STFT_N), flush)
    return {"spec_err": spec_err, "back_err": back_err, "lib_err": lib_err,
            "ms": ms, "library_ms": lib, "istft_ms": ims,
            "frames": sg.shape[-1], "bins": sg.shape[-2]}


def _dist_moments(paddle):
    """The distributions' draws on the card by their moments at
    ``DIST_N``, and their repeating after ``paddle.seed`` and with
    ``sample(seed=k)``: ``{what: (worst standard errors, ...)}``."""
    D = paddle.distribution
    worst = {}

    def held(name, x, mean, var):
        x = x.astype(np.float64)
        se = math.sqrt(var / x.size)
        z = abs(x.mean() - mean) / se
        zv = abs(x.var() - var) / (var * math.sqrt(2.0 / x.size) * 2)
        worst[name] = max(worst.get(name, 0.0), z, zv)

    cases = {
        "Normal": (lambda: D.Normal(np.float32(0.5), np.float32(1.5)),
                   0.5, 2.25),
        "Uniform": (lambda: D.Uniform(np.float32(-1.0), np.float32(2.0)),
                    0.5, 0.75),
        "Bernoulli": (lambda: D.Bernoulli(probs=paddle.to_tensor(
            np.float32(0.3))), 0.3, 0.21),
        "Beta": (lambda: D.Beta(np.float32(2.0), np.float32(3.0)), 0.4,
                 0.04),
    }
    repeat = []
    for name, (mk, mean, var) in cases.items():
        d = mk()
        held(name, d.sample([DIST_N]).numpy(), mean, var)
        paddle.seed(11)
        a = d.sample([64]).numpy()
        paddle.seed(11)
        b = d.sample([64]).numpy()
        repeat.append(np.array_equal(a, b))
        if name != "Beta":
            repeat.append(np.array_equal(d.sample([64], seed=5).numpy(),
                                         d.sample([64], seed=5).numpy()))
    p = np.array([0.2, 0.3, 0.5])
    cat = D.Categorical(probs=paddle.to_tensor(p.astype(np.float32)))
    draws = cat.sample([DIST_N]).numpy()
    for k in range(3):
        held("Categorical", (draws == k).astype(np.float64), p[k],
             p[k] * (1 - p[k]))
    m = D.Multinomial(5, p.astype(np.float32)).sample([DIST_N]).numpy()
    for k in range(3):
        held("Multinomial", m[:, k], 5 * p[k], 5 * p[k] * (1 - p[k]))
    c = np.array([1.5, 2.0, 0.8])
    dd = D.Dirichlet(c.astype(np.float32)).sample([DIST_N]).numpy()
    for k in range(3):
        held("Dirichlet", dd[:, k], c[k] / c.sum(),
             c[k] * (c.sum() - c[k]) / (c.sum() ** 2 * (c.sum() + 1)))
    return worst, all(repeat)


def phase_namespaces(dev):
    """Phase 42: every new name of the other eager namespaces on the card
    against the CPU (``tests/torch_namespace_checks.py``), stft/istft at
    a speech front end's size beside ``torch.stft``, the distributions'
    draws by their moments, ``paddle.device`` reporting the card,
    ``save``/``load`` of card tensors, the seven optimizers without a
    kernel on the card against the CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as port_device
    from torch_namespace_checks import (NS_RTOL, namespaces_vs_cpu,
                                        optimizers_vs_cpu)

    prev = list(port_device._CURRENT)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card_name = smi.stdout.strip().split(",")[0].strip()
    try:
        reset_port_launch_counts()
        t0 = time.perf_counter()
        cases = namespaces_vs_cpu(dev)
        opts = optimizers_vs_cpu(dev)
        counts = port_launch_counts()
        if any(counts.values()):
            raise AssertionError(f"the namespaces launched a port kernel: "
                                 f"{counts}")
        cases_s = time.perf_counter() - t0
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                            device=dev)
        stft = _stft_row(paddle, dev, flush)
        del flush
        paddle.set_device("gpu")
        moments, repeats = _dist_moments(paddle)

        # paddle.device answers for the card
        D = paddle.device
        props = D.get_device_properties()
        D.synchronize()
        before = D.memory_allocated()
        block = torch.empty(DEVICE_ALLOC // 4, dtype=torch.float32,
                            device=dev)
        grown = D.memory_allocated() - before
        del block
        D.cuda.synchronize()
        device_ok = (D.cuda.is_available() and props.name == card_name
                     and grown == DEVICE_ALLOC
                     and D.get_cudnn_version()
                     == torch.backends.cudnn.version()
                     and D.cuda.device_count() == torch.cuda.device_count())

        # save/load of card tensors, bit for bit
        import tempfile

        rs = np.random.RandomState(9)
        state = {"w": paddle.to_tensor(rs.randn(257, 33).astype(np.float32)),
                 "b": paddle.to_tensor(rs.randn(8).astype(np.float32))
                 .astype("bfloat16"),
                 "i": paddle.to_tensor(rs.randint(0, 9, 7)),
                 "m": paddle.to_tensor(rs.rand(5) > 0.5)}
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "state.pdparams")
            paddle.save(state, path)
            back = paddle.load(path)
        saved_ok = True
        for k, t in state.items():
            got = paddle.to_tensor(back[k])._value
            want = t._value
            if want.dtype == torch.bfloat16:
                got, want = got.view(torch.int16), want.view(torch.int16)
            saved_ok &= bool(torch.equal(got.cpu(), want.cpu()))
    finally:
        port_device._CURRENT[:] = prev
    log(f"namespaces on the card ({smi.stdout.strip()}): "
        f"{len(cases)} case groups against the CPU in {cases_s:.1f} s, "
        f"worst relative to max(1, the CPU's largest magnitude): "
        + ", ".join(f"{k} {v:.2e}" for k, v in cases.items())
        + f" (limit {NS_RTOL}); no port kernel launched")
    log(f"the seven optimizers without a kernel, {len(opts)} rules x 3 "
        f"steps on the GCN's parameter shapes, card against CPU: "
        + ", ".join(f"{k} {v:.2e} (limit {lim})"
                    for k, (v, lim) in opts.items()))
    log(f"stft ({smi.stdout.strip()}): {STFT_B} x {STFT_N} samples, n_fft "
        f"{STFT_NFFT}, hop {STFT_HOP}, Hann, [{STFT_B}, {stft['bins']}, "
        f"{stft['frames']}]: card against CPU {stft['spec_err']:.2e}, istft "
        f"{stft['back_err']:.2e} (limit {STFT_RTOL}, relative to the "
        f"largest magnitude); paddle.signal.stft {stft['ms']:.4f} ms against "
        f"torch.stft {stft['library_ms']:.4f} ms "
        f"({stft['ms'] / stft['library_ms']:.2f}x; the two "
        f"{stft['lib_err']:.2e} apart); istft {stft['istft_ms']:.4f} ms "
        f"(device time, medians of 30, L2 flushed)")
    log(f"distributions on the card: draws of {DIST_N} by their moments, "
        f"worst standard errors " + ", ".join(f"{k} {v:.2f}" for k, v in
                                              moments.items())
        + f" (limit {RANDOM_SIGMAS}); repeating after paddle.seed(11) and "
        f"with sample(seed=5): {repeats}")
    log(f"paddle.device: name {props.name!r} (nvidia-smi {card_name!r}), "
        f"total {props.total_memory} bytes, cuDNN {D.get_cudnn_version()}, "
        f"memory_allocated up by {grown} bytes for a {DEVICE_ALLOC}-byte "
        f"tensor, synchronize ran: {device_ok}; save/load of card tensors "
        f"(fp32, bf16, int32, bool) bit for bit: {saved_ok}")
    bad = [k for k, v in cases.items() if not v <= NS_RTOL]
    bad += [k for k, (v, lim) in opts.items() if not v <= lim]
    bad += [k for k, v in moments.items() if not v <= RANDOM_SIGMAS]
    if not (stft["spec_err"] <= STFT_RTOL and stft["back_err"] <= STFT_RTOL):
        bad.append("stft")
    if bad or not (repeats and device_ok and saved_ok):
        raise AssertionError(f"phase 42: {bad}, repeats {repeats}, device "
                             f"{device_ok}, save/load {saved_ok}")
    return {"cases": cases, "optimizers": opts, "stft": stft,
            "moments": moments}


# ------------------------------------------------------- the GCN (Cora)
GCN_STEPS, GCN_RESUME_AT = 200, 100
GCN_WARMUP, GCN_TIMED = 5, 30
GCN_LOSS_RTOL = 1e-5                # the first loss, card against CPU
GCN_KINDS = (
    ("gather/scatter (send_u_recv)", ("segment_reduce", "argsort", "sort",
                                      "bincount", "index", "gather")),
    ("GEMMs", GEMM_OPS),
    ("dropout", ("bernoulli", "dropout", "rand")),
    ("loss", ("log_softmax", "nll_loss", "_softmax_backward")),
    ("fused_update", ()))


class _PlainGCN(torch.nn.Module):
    """The same GCN in plain PyTorch, the propagation an ``index_add_``
    of the gathered rows; the port's weights copied in."""

    def __init__(self, model, g):
        super().__init__()
        src = dict(model.state_dict())
        self.w1, self.b1, self.w2, self.b2 = (
            torch.nn.Parameter(src[k]._value.detach().clone())
            for k in ("fc1.weight", "b1", "fc2.weight", "b2"))
        self.src, self.dst = g["src"]._value.long(), g["dst"]._value.long()
        self.norm, self.n = g["norm"]._value, g["nodes"]

    def conv(self, h, w, b):
        h = (h * self.norm) @ w
        out = torch.zeros(self.n, h.shape[1], dtype=h.dtype,
                          device=h.device)
        return out.index_add_(0, self.dst, h[self.src]) * self.norm + b

    def forward(self, x):
        F = torch.nn.functional
        h = F.relu(self.conv(F.dropout(x, 0.5, self.training), self.w1,
                             self.b1))
        return self.conv(F.dropout(h, 0.5, self.training), self.w2, self.b2)


def _gcn_run(paddle, make, weights, batch, steps, rng_seed, resume=None):
    """``steps`` Adam steps of a model from ``make()`` loaded with
    ``weights``, the streams seeded with ``rng_seed``; with ``resume`` (a
    path), the layer, the optimizer and the card's RNG state saved after
    ``GCN_RESUME_AT`` steps and the rest run by a fresh model and
    optimizer loaded from it. Returns the losses, the final model and
    what the load checked: the loaded slots against the saved ones."""
    import torch_gcn_checks as G

    model = make()
    model.set_state_dict(weights)
    opt = G.gcn_optimizer(paddle, model)
    paddle.seed(rng_seed)
    if resume is None:
        return G.train_steps(paddle, model, opt, batch, steps), model, None
    losses = G.train_steps(paddle, model, opt, batch, GCN_RESUME_AT)
    paddle.save({"model": model.state_dict(), "opt": opt.state_dict(),
                 "rng": paddle.get_cuda_rng_state()}, resume)
    saved = opt.state_dict()
    fresh = make()          # draws its weights: the stream moves on
    fresh_opt = G.gcn_optimizer(paddle, fresh)
    ck = paddle.load(resume)
    fresh.set_state_dict(ck["model"])
    fresh_opt.set_state_dict(ck["opt"])
    paddle.set_cuda_rng_state(ck["rng"])
    loaded = fresh_opt.state_dict()
    slots_equal = len(loaded) == len(saved) and all(
        ka.rsplit(".", 1)[1] == kb.rsplit(".", 1)[1]
        and va.dtype == vb.dtype and np.array_equal(va, vb)
        for (ka, va), (kb, vb) in zip(saved.items(), loaded.items()))
    losses += G.train_steps(paddle, fresh, fresh_opt, batch,
                            steps - GCN_RESUME_AT)
    return losses, fresh, {"slots_equal": slots_equal,
                           "entries": len(saved)}


def phase_gcn(dev, seed):
    """Phase 43: a GCN at Cora's widths trained, checkpointed and resumed
    on the card as a Paddle user writes it (the module docstring)."""
    import tempfile

    import paddle_tpu_torch as paddle
    import torch_gcn_checks as G
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.framework import device as port_device
    from paddle_tpu_torch.framework.precision import matmul_precision
    from paddle_tpu_torch.ops import fused_update as fu

    c = G.CORA
    prev = list(port_device._CURRENT)
    calls = {"update_math": 0}
    real_math = popt.update_math

    def counted_math(p, *a, **k):
        calls["update_math"] += int(p.is_cuda)
        return real_math(p, *a, **k)

    t0 = time.perf_counter()
    data = G.cora_like(seed, **c)
    data_s = time.perf_counter() - t0
    def make():
        return G.make_gcn(paddle, c["features"], c["hidden"], c["classes"])

    try:
        paddle.set_device("gpu")
        paddle.seed(0)
        model = make()
        weights = {k: v._value.detach().clone()
                   for k, v in model.state_dict().items()}
        n_params = sum(p._value.numel() for p in model.parameters())
        batch = G.to_framework(paddle, data)
        x, g, y, train = batch

        # card against CPU from the same weights, dropout off
        paddle.set_device("cpu")
        cpu = make()
        cpu.set_state_dict({k: v.cpu() for k, v in weights.items()})
        cpu_batch = G.to_framework(paddle, data)
        paddle.set_device("gpu")
        first = {}
        for name, m, b in (("card", model, batch), ("cpu", cpu, cpu_batch)):
            m.eval()
            loss = G.gcn_loss(paddle, m, *b)
            loss.backward()
            first[name] = (float(loss), {n: p.grad.numpy() for n, p in
                                         m.named_parameters()})
            m.clear_gradients()
            m.train()
        first_rel = abs(first["card"][0] - first["cpu"][0]) / abs(
            first["cpu"][0])
        grad_rel = max(_norm_rel(first["card"][1][n], first["cpu"][1][n])
                       for n in first["cpu"][1])

        # 200 steps, one update launch a step
        popt.update_math = counted_math
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_port_launch_counts()
        t0 = time.perf_counter()
        losses, model, _ = _gcn_run(paddle, make, weights, batch,
                                    GCN_STEPS, 1)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = port_launch_counts()
        popt.update_math = real_math
        peak = torch.cuda.max_memory_allocated() / 2**30
        if calls["update_math"]:
            raise AssertionError(f"update_math ran {calls['update_math']} "
                                 f"times on the card")
        want = {k: GCN_STEPS if k == "fused_update" else 0 for k in counts}
        if counts != want:
            raise AssertionError(f"GCN launch counts {counts}, expected "
                                 f"{want}")

        # the checkpoint at step 100, resumed in a fresh model; a second
        # uninterrupted run measures the spread of two runs
        again, model2, _ = _gcn_run(paddle, make, weights, batch,
                                    GCN_STEPS, 1)
        with tempfile.TemporaryDirectory() as d:
            resumed, model3, load = _gcn_run(
                paddle, make, weights, batch, GCN_STEPS, 1,
                resume=os.path.join(d, "gcn.ckpt"))
        final = {n: p.numpy() for n, p in model.named_parameters()}

        def spread(m):
            return max(float(np.max(np.abs(p.numpy() - final[n])))
                       for n, p in m.named_parameters())

        loss_spread = max(abs(a - b) for a, b in zip(losses, again))
        loss_resumed = max(abs(a - b) for a, b in zip(losses, resumed))
        param_spread, param_resumed = spread(model2), spread(model3)
        bitwise = (resumed == losses and param_resumed == 0.0)

        # ms a step: the port's loop against the same GCN in plain PyTorch
        opt = G.gcn_optimizer(paddle, model)

        def port_step():
            loss = G.gcn_loss(paddle, model, x, g, y, train)
            loss.backward()
            opt.step()
            opt.clear_grad()

        net = _PlainGCN(model, g)
        topt = torch.optim.Adam([{"params": [net.w1],
                                  "weight_decay": G.WEIGHT_DECAY},
                                 {"params": [net.b1, net.w2, net.b2]}],
                                lr=G.LR)
        tx, ty, tt = x._value, y._value.long(), train._value.long()

        def plain_step():
            loss = torch.nn.functional.cross_entropy(net(tx)[tt], ty[tt])
            loss.backward()
            topt.step()
            topt.zero_grad()

        for _ in range(GCN_WARMUP):
            port_step()
        port_ms = _step_ms(port_step, GCN_TIMED)
        with matmul_precision("float32"):
            for _ in range(GCN_WARMUP):
                plain_step()
            plain_ms = _step_ms(plain_step, GCN_TIMED)
        port_again = _step_ms(port_step, GCN_TIMED)
        prof = kind_profile(port_step, GCN_KINDS, "gcn",
                            "the rest (elementwise, the normalisation)")
        loss = G.gcn_loss(paddle, model, x, g, y, train)
        loss.backward()                 # gradients in place for the row
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                            device=dev)
        steps = [torch.full((), 4.0, device=dev) for _ in opt._table.entries]

        def adam(ps, gs, m1, m2):
            torch._fused_adam_(ps, gs, m1, m2, [], steps, lr=G.LR,
                               beta1=0.9, beta2=0.999, weight_decay=0.0,
                               eps=1e-8, amsgrad=False, maximize=False)

        def kernel(table, lr):          # the same powers each time
            fu.fused_update_buckets(table, lr)
            table.parity = 1 - table.parity

        with torch.no_grad():
            row = _eager_update_row(opt, flush, adam,
                                    "torch._fused_adam_, fp32 moments", 28,
                                    20, "the GCN's table", kernel)
        del flush
        opt.clear_grad()
    finally:
        popt.update_math = real_math
        port_device._CURRENT[:] = prev
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    edges = len(data["src"])
    log(f"gcn ({smi.stdout.strip()}): Kipf & Welling 2017 at Cora's widths, "
        f"{c['nodes']} nodes x {c['features']} binary features -> "
        f"{c['hidden']} -> {c['classes']}, {edges} edges with the self "
        f"loops (drawn from --seed in {data_s:.1f} s), {len(data['train'])} "
        f"labelled nodes, {n_params} parameters after paddle.seed(0); "
        f"Adam({G.LR}), L2Decay({G.WEIGHT_DECAY}) on the first weight, "
        f"dropout {G.DROPOUT}; {GCN_STEPS} full-batch steps in "
        f"{run_s:.2f} s: losses {losses[0]:.6f} -> {losses[-1]:.6f}; "
        f"launch counts {counts} (one fused_update a step, update_math 0 "
        f"calls on the card); peak {peak:.3f} GiB; card against CPU, "
        f"dropout off: first loss {first['card'][0]:.7f} against "
        f"{first['cpu'][0]:.7f} (rel {first_rel:.2e}, limit "
        f"{GCN_LOSS_RTOL}), gradients {grad_rel:.2e} (norm_rel)")
    log(f"gcn checkpoint: paddle.save at step {GCN_RESUME_AT} of the layer, "
        f"the optimizer ({load['entries']} entries) and the card's RNG "
        f"state, paddle.load into a fresh model and optimizer, resumed to "
        f"{GCN_STEPS}: the loaded moments and beta powers bit for bit: "
        f"{load['slots_equal']}; against the uninterrupted run: losses "
        f"{loss_resumed:.3e}, parameters {param_resumed:.3e} apart "
        f"({'bit for bit' if bitwise else 'not bit for bit'}); two "
        f"uninterrupted runs {loss_spread:.3e}, {param_spread:.3e} apart")
    log(f"gcn step (median of {GCN_TIMED}, host wall, synced): port "
        f"{port_ms:.3f} ms, then {port_again:.3f}; plain PyTorch (index_add_"
        f", torch.optim.Adam) {plain_ms:.3f} ms "
        f"({port_ms / plain_ms:.2f}x, {port_again / plain_ms:.2f}x)")
    log(f"fused_update, {row['shape']}, one launch, device time: as "
        f"Optimizer.step() calls it {row['step_ms']:.4f} ms "
        f"({row['step_span_ms']:.4f} from an idle card), the kernel alone "
        f"{row['ms']:.4f} ({row['span_ms']:.4f}), torch._fused_adam_ "
        f"{row['library_ms']:.4f} ({row['library_span_ms']:.4f}); plain "
        f"{row['plain_ms']:.4f}; bound {row['bound_ms']:.5f} "
        f"{row['bound_by']}, the kernel at "
        f"{100 * row['bound_ms'] / row['ms']:.2f}% of it; max_abs_err "
        f"{row['max_abs_err']}")
    ok_resume = load["slots_equal"] and (
        bitwise or (loss_resumed <= 2 * loss_spread
                    and param_resumed <= 2 * param_spread))
    if not (first_rel <= GCN_LOSS_RTOL and losses[-1] < losses[0]
            and all(math.isfinite(v) for v in losses) and ok_resume):
        raise AssertionError(f"phase 43: first loss {first_rel:.2e}, "
                             f"losses {losses[0]} -> {losses[-1]}, resume "
                             f"{load}, {loss_resumed}, {param_resumed}")
    return {"counts": counts, "row": row, "port_ms": port_ms,
            "plain_ms": plain_ms, "profile": prof, "bitwise": bitwise}


# ------------------------------------------------------- fp16 (44-47)
DS_SMALL = 2.0 ** -16               # dO of a GradScaler's unscaled step
OPT_LOSS_RTOL = 1e-4                # phase 46: the loss after one update
POLICIES = (("none",), ("remat",), ("offload",), ("none", "remat",
                                                  "offload"))


def fp16_config(**over):
    """bench.py's GPT-125M training configuration in fp16."""
    from paddle_tpu_torch.models import gpt_presets

    return gpt_presets("gpt-125m", max_position_embeddings=1024,
                       dtype="float16", **over)


def phase_fp16_kernels(dev, gen, plan):
    """Phase 44: the fp16 forms of the train step's kernels, checked and
    timed as phase 16 times the bf16 ones (``plan``: the fp16 plan), the
    bf16 forms timed again here beside them."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    fp16, bf16 = torch.float16, torch.bfloat16
    rows = _flash_case(dev, gen, FLASH_MAIN, True, True, flush, fp16)
    bert = _flash_case(dev, gen, FLASH_BERT, False, True, flush, fp16)
    beside = {"gpt": _flash_case(dev, gen, FLASH_MAIN, True, True, flush,
                                 bf16),
              "bert": _flash_case(dev, gen, FLASH_BERT, False, True, flush,
                                  bf16)}
    for shape, causal in FLASH_CHECKS:
        _flash_case(dev, gen, shape, causal, False, flush, fp16)
    for shape, causal in ((FLASH_MAIN, True), (FLASH_BERT, False)):
        _flash_case(dev, gen, shape, causal, False, flush, fp16, DS_SMALL)
    for key, got in (("gpt", rows), ("bert", bert)):
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            r, b = got[name], beside[key][name]
            log(f"fp16 against bf16, {name} {r['shape']}: {r['ms']:.4f} ms "
                f"against {b['ms']:.4f} (bound {r['bound_ms']:.4f} "
                f"{r['bound_by']}, both); fp16 at "
                f"{100 * r['bound_ms'] / r['ms']:.1f}% of it")
    fused = _fused_timing(dev, gen, plan, flush)
    rows["fused_update"] = fused
    log(f"fused_update fp16 plan, one step's {fused['shape']}, one launch, "
        f"device time (from an idle card): as FusedFlatUpdater.step() calls "
        f"it {fused['step_ms']:.4f} ms ({fused['step_span_ms']:.4f}), the "
        f"kernel alone {fused['ms']:.4f} ({fused['span_ms']:.4f}), "
        f"torch._fused_adamw_ ({fused['library_form']}) "
        f"{fused['library_ms']:.4f} ({fused['library_span_ms']:.4f}); plain "
        f"{fused['plain_ms']:.4f}; bound {fused['bound_ms']:.4f} "
        f"{fused['bound_by']}, the kernel at "
        f"{100 * fused['bound_ms'] / fused['ms']:.1f}% of it")
    del flush
    return {"rows": rows, "bert": bert, "bf16": beside}


def phase_fp16_train(dev, seed, plan, train16, prof17):
    """Phase 45: GPT-125M in fp16 with dropout 0.1 at bench.py's shape
    (``phase_train``: launch counts, losses), profiled, beside phase 17
    (``train16``, ``prof17``); card against CPU at 2 layers; a step at
    ``attn_dropout=0.1`` launches no flash kernel."""
    import dataclasses

    cfg = fp16_config(dropout=0.1)
    counts, step, ids, labels, summary = phase_train(cfg, dev, seed)
    if [(b.size, b.dtype) for b in step.buckets] != [(b.size, b.dtype)
                                                    for b in plan]:
        raise AssertionError("the fp16 train step's bucket plan is not the "
                             "timed one")
    prof = phase_train_profile(lambda: bench_step(step, cfg, ids, labels),
                               names=FP16_KERNELS, tag=" fp16")
    del step
    torch.cuda.empty_cache()
    log(f"train fp16 (dropout 0.1) against phase 17 (bf16) in this call: "
        f"step {summary['step_ms_median']:.2f} ms against "
        f"{train16['step_ms_median']:.2f}, {summary['tokens_per_s']:.0f} "
        f"tokens/s against {train16['tokens_per_s']:.0f}, peak "
        f"{summary['peak_memory_gib']:.2f} GiB against "
        f"{train16['peak_memory_gib']:.2f}, idle "
        f"{100 * prof['idle_share']:.1f}% against "
        f"{100 * prof17['idle_share']:.1f}%")
    phase_train_parity(dataclasses.replace(cfg, dropout=0.0), dev, seed)
    torch.cuda.empty_cache()
    ad = dataclasses.replace(cfg, attn_dropout=0.1, num_layers=2)
    _, step_ad, ids, labels = _train_setup(ad, dev, 2, TRAIN_S, seed)
    reset_train_launch_counts()
    loss = float(bench_step(step_ad, ad, ids, labels))
    got = train_launch_counts()
    flash = {k: v for k, v in got.items() if k.startswith("flash")}
    log(f"train fp16, attn_dropout 0.1, 2 layers, b2 s{TRAIN_S}: one step, "
        f"loss {loss:.5f}, flash launches {flash}, fused_update "
        f"{got['fused_update']}")
    if any(flash.values()) or got["fused_update"] != 1 or \
            not math.isfinite(loss):
        raise AssertionError(f"attn_dropout > 0 launched {got}")
    del step_ad
    torch.cuda.empty_cache()
    return {"counts": counts, "summary": summary, "profile": prof}


def _policy_grads(model, ids, labels):
    """The loss and every gradient of one forward and backward."""
    from paddle_tpu_torch.models import GPTPretrainingCriterion

    for p in model.parameters():
        p.grad = None
    loss = GPTPretrainingCriterion()(model(ids), labels)
    loss.backward()
    return loss.detach().clone(), {n: p.grad.clone() for n, p in
                                   model.named_parameters()}


def phase_gpt_options(dev, seed):
    """Phase 46: recompute_policy at GPT-125M fp16 (dropout 0), then
    Lamb, Lars and DGCMomentum under TrainStep."""
    from paddle_tpu_torch.models import gpt as gpt_mod

    cfg = fp16_config()
    model, step, ids, labels = _train_setup(cfg, dev, TRAIN_B, TRAIN_S, seed)
    idt = torch.as_tensor(ids, device=dev)
    lbt = torch.as_tensor(labels, device=dev)

    def set_policy(vec):
        import dataclasses

        pols = gpt_mod._resolve_policies(
            dataclasses.replace(cfg, recompute_policy=vec), cfg.num_layers)
        for blk, pol in zip(model.gpt.decoder, pols):
            blk.policy = pol

    set_policy(("none",))
    base_loss, base = _policy_grads(model, idt, lbt)
    again_loss, again = _policy_grads(model, idt, lbt)
    noisy = [n for n in base if not torch.equal(base[n], again[n])]
    spread = {n: float((base[n].float() - again[n].float()).abs().max())
              for n in noisy}
    if noisy or not torch.equal(base_loss, again_loss):
        log(f"policies: two 'none' runs differ in {len(noisy)} gradients "
            f"({noisy[:4]}...); policies held within twice that spread")
    results = {}
    for vec in POLICIES[1:]:
        set_policy(vec)
        loss, grads = _policy_grads(model, idt, lbt)
        same = torch.equal(loss, base_loss) and all(
            torch.equal(g, base[n]) for n, g in grads.items())
        if not same:
            over = [n for n, g in grads.items()
                    if float((g.float() - base[n].float()).abs().max())
                    > 2 * spread.get(n, 0.0)]
            if over or not noisy:
                raise AssertionError(f"recompute_policy {vec}: gradients "
                                     f"differ from 'none' in {over[:6]}")
        results[vec] = {"bitwise": same}
    del base, again
    log(f"recompute_policy at GPT-125M fp16 b{TRAIN_B} s{TRAIN_S}: loss and "
        f"every gradient equal to 'none' bit for bit: "
        + ", ".join(f"{'/'.join(v)} {r['bitwise']}"
                    for v, r in results.items()))
    for vec in POLICIES:
        set_policy(vec)
        float(bench_step(step, cfg, ids, labels))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gpt_mod.reset_offload_bytes()
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            float(bench_step(step, cfg, ids, labels))
            ms.append((time.perf_counter() - t0) * 1e3)
        r = results.setdefault(vec, {"bitwise": True})
        r.update(step_ms=statistics.median(ms),
                 peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                 offload_bytes_a_step=gpt_mod.offload_bytes // 3)
        log(f"recompute_policy {'/'.join(vec)}: step {r['step_ms']:.2f} ms, "
            f"peak {r['peak_memory_gib']:.2f} GiB, parked in pinned host "
            f"memory {r['offload_bytes_a_step'] / 2**20:.1f} MiB a step")
    if results[("offload",)]["offload_bytes_a_step"] != \
            cfg.num_layers * TRAIN_B * TRAIN_S * cfg.hidden_size * 2:
        raise AssertionError("offload parked another size than the blocks' "
                             "inputs")
    del step, model
    torch.cuda.empty_cache()
    opts = phase_unfusable_optimizers(dev, seed)
    return {"policies": {"/".join(v): r for v, r in results.items()},
            "optimizers": opts}


def _opt_run(cfg, device, name, b, s, seed, steps):
    """``steps`` TrainStep steps of ``cfg`` under the optimizer ``name``
    (lr 1e-4); returns the losses and the fused_update launches."""
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM, GPTPretrainingCriterion
    from paddle_tpu_torch.ops import fused_update as fu

    model = GPTForCausalLM(cfg, seed=0, device=device)
    kw = {"DGCMomentum": dict(rampup_begin_step=0, sparsity=(0.999,))}
    opt = getattr(optim, name)(learning_rate=LR,
                               parameters=model.parameters(),
                               **kw.get(name, {}))
    step = TrainStep(model, GPTPretrainingCriterion(), opt)
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size, (b, s))
    labels = rs.randint(0, cfg.vocab_size, (b, s))
    before = fu.fused_update_buckets.launches
    losses = [float(step(inputs=(ids,), labels=(labels,)))
              for _ in range(steps)]
    return losses, fu.fused_update_buckets.launches - before


def phase_unfusable_optimizers(dev, seed):
    """Phase 46's second half: Lamb, Lars, DGCMomentum under TrainStep
    at GPT-125M fp16, then card against CPU at 2 layers in fp32."""
    import dataclasses

    out = {}
    for name in ("Lamb", "Lars", "DGCMomentum"):
        t0 = time.perf_counter()
        losses, launches = _opt_run(fp16_config(), dev, name, TRAIN_B,
                                    TRAIN_S, seed, 3)
        torch.cuda.synchronize()
        small = dataclasses.replace(fp16_config(), dtype="float32",
                                    num_layers=2)
        card, _ = _opt_run(small, dev, name, 2, 128, seed + 2, 2)
        cpu, _ = _opt_run(small, "cpu", name, 2, 128, seed + 2, 2)
        rel = [abs(a - c) / abs(c) for a, c in zip(card, cpu)]
        log(f"TrainStep {name} at GPT-125M fp16 b{TRAIN_B} s{TRAIN_S}: "
            f"losses {losses}, fused_update launches {launches}, "
            f"{time.perf_counter() - t0:.1f} s with the 2-layer check; card "
            f"vs CPU (fp32, 2 layers, b2 s128): losses {card} vs {cpu} (rel "
            f"{rel[0]:.2e} limit 1e-5, {rel[1]:.2e} limit "
            f"{OPT_LOSS_RTOL:.0e})")
        if launches or not all(math.isfinite(x) for x in losses) or \
                not (rel[0] <= 1e-5 and rel[1] <= OPT_LOSS_RTOL):
            raise AssertionError(f"TrainStep {name}: {losses}, {launches} "
                                 f"launches, card vs CPU {rel}")
        out[name] = {"losses": losses, "card_vs_cpu_rel": rel}
        torch.cuda.empty_cache()
    return out


def phase_bert_fp16(dev, seed, bert25, warmup_max=8, steps=BERT_STEPS,
                    b=BERT_B, s=BERT_S):
    """Phase 47: BERT-base under decorate and auto_cast(O2, float16) with
    a GradScaler in the eager step, beside phase 25 (``bert25``). Each
    backward's gradients fp16, each unscaled one fp32 (the reference's
    ``unscale_``), the eager table built once over the timed steps."""
    from paddle_tpu_torch import tensor as T
    from paddle_tpu_torch.amp import GradScaler, auto_cast, decorate
    from paddle_tpu_torch.framework.modules import torch_parameters
    from paddle_tpu_torch.models import BertForPretraining, bert_presets
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    cfg = bert_presets("bert-base")
    model = decorate(BertForPretraining(cfg, seed=0, device=dev),
                     level="O2", dtype="float16")
    opt = AdamW(learning_rate=BERT_LR, parameters=model.parameters())
    scaler = GradScaler()
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size, (b, s))
    mlm = np.where(rs.rand(b, s) < 0.15, ids, -1)
    nsp = rs.randint(0, 2, (b,))
    ids, mlm, nsp = (torch.as_tensor(a, dtype=torch.long, device=dev)
                     for a in (ids, mlm, nsp))

    params = torch_parameters(model)
    seen = {"backward": set(), "unscaled": set(), "tables": set()}

    def one(plant=False):
        with auto_cast(level="O2", dtype="float16"):
            a, n = model(ids, None, None, None, mlm)
            loss = T.add(a, F.cross_entropy(n, nsp))
        scaler.scale(loss).backward()
        seen["backward"] |= {p.grad.dtype for p in params}
        if plant:
            next(model.parameters()).grad.view(-1)[0] = float("inf")
        scaler.step(opt)
        seen["unscaled"] |= {p.grad.dtype for p in params}
        seen["tables"].add(id(opt._table))
        scaler.update()
        opt.clear_grad()
        return float(loss.detach())

    scales, losses, good = [], [], 0
    for _ in range(warmup_max):    # until two steps in a row update
        losses.append(one())
        scales.append(scaler.state_dict()["scale"])
        good = 0 if scaler.last_step_skipped else good + 1
        if good >= 2:
            break
    log(f"bert fp16 O2 warm-up: scale {scales}, losses {losses}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_launch_counts()
    reads, ms, skipped = scaler.host_reads, [], 0
    seen["tables"].clear()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(one())              # float() waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        skipped += scaler.last_step_skipped
    counts = train_launch_counts()
    reads = scaler.host_reads - reads
    med = statistics.median(ms)
    summary = {"losses": losses, "step_ms": ms, "step_ms_median": med,
               "samples_per_s": b / (med / 1e3),
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
               "skipped": skipped, "scale": scaler.state_dict()["scale"],
               "host_reads": reads, "launches": counts,
               "grad_dtypes": {k: sorted(map(str, seen[k]))
                               for k in ("backward", "unscaled")},
               "tables": len(seen["tables"] - {id(None)})}
    log("bert train O2 fp16 eager + GradScaler " + json.dumps(summary))
    want = {k: 0 for k in counts}
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        want[name + "_fp16"] = cfg.num_layers * steps
    want["fused_update"] = steps - skipped
    if counts != want or reads != steps or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"bert fp16: launch counts {counts}, expected "
                             f"{want}; {reads} host reads for {steps} "
                             f"steps; losses {losses}")
    if seen["backward"] != {torch.float16} or \
            seen["unscaled"] != {torch.float32} or summary["tables"] != 1:
        raise AssertionError(f"bert fp16: gradient dtypes {seen}, "
                             f"{summary['tables']} tables for {steps} steps "
                             f"(one expected)")
    prof = phase_train_profile(one, names=FP16_KERNELS, tag=" bert O2 fp16")
    u25, p25 = bert25["unfused"], bert25["profile"]
    log(f"bert fp16 O2 eager step against phase 25 (bf16 O2, TrainStep) in "
        f"this call: {med:.2f} ms against {u25['step_ms_median']:.2f}, "
        f"{summary['samples_per_s']:.1f} samples/s against "
        f"{u25['samples_per_s']:.1f}, idle {100 * prof['idle_share']:.1f}% "
        f"against {100 * p25['idle_share']:.1f}%, peak "
        f"{summary['peak_memory_gib']:.2f} GiB against "
        f"{u25['peak_memory_gib']:.2f}")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    scale = scaler.state_dict()["scale"]
    one(plant=True)
    still = all(torch.equal(p.detach().view(torch.int16),
                            before[n].view(torch.int16))
                for n, p in model.named_parameters())
    halved = scaler.state_dict()["scale"] == scale / 2
    log(f"bert fp16 planted inf: step skipped {scaler.last_step_skipped}, "
        f"every parameter's bits kept {still}, scale {scale} -> "
        f"{scaler.state_dict()['scale']}")
    if not (scaler.last_step_skipped and still and halved):
        raise AssertionError("the planted inf step was not skipped cleanly")
    return {"counts": counts, "summary": summary, "profile": prof}


# ---------------------------------------- fp16 wire and int8 fp16 (48-50)
INT8_FP16_LOGIT_RTOL = 1e-2         # phase 50: mean relative, card vs CPU


def phase_dp_train_fp16(seed, train_h, dp16_rank):
    """Phase 49: GPT-125M fp16 (``fp16_config()``, phase 45's dtype)
    data parallel on the int8_block wire at phase 19's shape, DataParallel
    rounds after it, rank 0's idle share over one more step; beside phase
    45's fp16 step (``train_h``) and phase 19's bf16 dp step
    (``dp16_rank``) in this call; then the 1-layer card-vs-CPU run (phase
    20's check on the fp16 model). Returns rank 0's results."""
    cfg = fp16_config()
    rank = phase_dp_train(cfg, seed, steps=DP16_STEPS, dp_rounds=2,
                          profile=True)
    if [(n, dt) for n, dt in zip(rank["buckets"], rank["bucket_dtypes"])] \
            != [(b.size, str(b.dtype)) for b in bucket_plan(cfg)]:
        raise AssertionError("the fp16 dp train step's bucket plan is not "
                             "the timed one")
    med = statistics.median(rank["step_ms"])
    log(f"dp train fp16 against phase 19 (bf16 dp) and phase 45 (fp16, one "
        f"card) in this call: step {med:.2f} ms against "
        f"{statistics.median(dp16_rank['step_ms']):.2f} and "
        f"{train_h['summary']['step_ms_median']:.2f}; rank 0 idle "
        f"{100 * rank['profile']['idle_share']:.1f}% (wall "
        f"{rank['profile']['wall_ms']:.2f} ms, device "
        f"{rank['profile']['busy_ms']:.2f}) against phase 45's "
        f"{100 * train_h['profile']['idle_share']:.1f}%; all-reduces "
        f"{rank['allreduce_ms_per_step']:.2f} ms a step (rank 0)")
    torch.cuda.empty_cache()
    phase_dp_parity_bf16(cfg, seed)
    torch.cuda.empty_cache()
    return rank


def _int8_fp16_parity(dev, seed, layers=2, b=2, s=128):
    """BERT-base's widths at ``layers`` layers, decorated at O2 in fp16 and
    converted to int8, one forward under auto_cast(O2, float16) on the
    card and on the CPU (``flash_route``: the flash kernels' plain
    versions): MLM and NSP logits fp16, finite, within
    INT8_FP16_LOGIT_RTOL mean relative error."""
    import dataclasses

    from paddle_tpu_torch.amp import auto_cast, decorate
    from paddle_tpu_torch.models import BertForPretraining, bert_presets
    from paddle_tpu_torch.nn.functional import flash_route
    from paddle_tpu_torch.quantization import convert_to_int8

    cfg = dataclasses.replace(bert_presets("bert-base"), num_layers=layers)
    ids, types = _bert_batch(cfg, b, s, seed)
    out = {}
    for device in (dev, "cpu"):
        model = decorate(BertForPretraining(cfg, seed=0, device=device)
                         .eval(), level="O2", dtype="float16")
        convert_to_int8(model)
        batch = [torch.as_tensor(a, device=device) for a in (ids, types)]
        with torch.inference_mode(), auto_cast(level="O2", dtype="float16"), \
                (flash_route() if device == "cpu"
                 else contextlib.nullcontext()):
            out[str(device)] = [t.cpu() for t in model(*batch)]
    rel = {}
    for name, a, c in zip(("mlm", "nsp"), out[str(dev)], out["cpu"]):
        if a.dtype != torch.float16 or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"int8 fp16 {name} logits {a.dtype}")
        rel[name] = float((a.float() - c.float()).abs().mean()
                          / c.float().abs().mean())
    log(f"int8 O2 fp16 card vs CPU ({layers} layers, b{b} s{s}): mean "
        f"relative error {rel} (limit {INT8_FP16_LOGIT_RTOL})")
    if not max(rel.values()) <= INT8_FP16_LOGIT_RTOL:
        raise AssertionError(f"int8 fp16 logits card vs CPU {rel}")
    return rel


def phase_int8_fp16(dev, gen, seed, bert):
    """Phase 50: int8 BERT-base decorated at O2 in fp16 and run under
    auto_cast(O2, float16) at 16 x 512 (the wgmma route) and 1 x 64 (the
    cluster route), beside phase 27's bf16 forwards (``bert``); the
    fp16 form at every shape they launched plus a ragged one a route
    against ``quant_matmul_plain``, and fp32 out from fp16 x on each
    route; the logits card against CPU at 2 layers."""
    _, counts, model, batch, summary = phase_infer(
        dev, seed, level="O2", dtype="float16", decorated=True)
    busy_us, split = phase_infer_profile(model, batch, level="O2",
                                         dtype="float16", tag="float16")
    del model, batch
    torch.cuda.empty_cache()
    counts_b1, summary_b1 = phase_infer_b1(dev, seed, dtype="float16",
                                           decorated=True)
    log(f"infer O2 fp16 against phase 27 (bf16) in this call: forward "
        f"{summary['forward_ms_median']:.2f} ms against "
        f"{bert['infer16']['forward_ms_median']:.2f} at {INFER_B} x "
        f"{INFER_S}, {summary_b1['forward_ms_median']:.3f} against "
        f"{bert['infer_b1']['forward_ms_median']:.3f} at {INFER_B1[0]} x "
        f"{INFER_B1[1]}; peak {summary['peak_memory_gib']:.2f} GiB against "
        f"{bert['infer16']['peak_memory_gib']:.2f}; device busy "
        f"{busy_us / 1e3:.3f} ms a forward, the wgmma route "
        f"{split['qmm_wgmma_kernel'] / 1e3:.3f} ms")
    before = clocks("before int8-kernels fp16")
    rows = phase_infer_kernels_bf16(
        dev, gen, counts["shapes"]["quant_matmul_fp16"]
        + counts_b1["shapes"]["quant_matmul_fp16"], torch.float16)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows += [_qmm_bf16_case(dev, gen, mkn, 0, flush, torch.float16,
                            torch.float32)
             for mkn in ((INFER_B * INFER_S, 768, 768),
                         (INFER_B1[1], 768, 768), RAGGED_QMM)]
    del flush
    stamp(rows, before, clocks("after int8-kernels fp16"))
    log_ratios("int8-kernels fp16", {str(i): r for i, r in enumerate(rows)})
    rel = _int8_fp16_parity(dev, seed)
    torch.cuda.empty_cache()
    return {"counts": counts, "counts_b1": counts_b1, "summary": summary,
            "summary_b1": summary_b1, "qmm_rows": rows, "parity": rel,
            "qmm_routes": counts["routes_fp16"] + counts_b1["routes_fp16"]}


# ------------------------------------------------------------ ZeRO
ZERO_WARMUP, ZERO_STEPS = 1, 3      # int8_block steps of phases 51-52
ZERO_FP32_STEPS = 2                 # the fp32 wire's steps
ZERO_RAGGED = 5_000_001             # phase 53's ragged bucket
ZERO_OVERLAP_LAYERS = 2             # phase 53's overlap check: depth cut
ZERO_WIRE_BLOCK = 1024


def _timed_collectives(coll, sync, acc):
    """Wrap ``coll``'s all_reduce, reduce_scatter and all_gather so each
    call is timed between two waits for the card into ``acc``; returns
    the originals."""
    saved = {n: getattr(coll, n) for n in ("all_reduce", "reduce_scatter",
                                           "all_gather")}

    def wrap(name, fn):
        def timed(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            acc[name] = acc.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            acc[name + "_calls"] = acc.get(name + "_calls", 0) + 1
            return out
        return timed

    for name, fn in saved.items():
        setattr(coll, name, wrap(name, fn))
    return saved


def _zero_run(cfg, level, codec, x, y, rank, world, warmup, steps, device,
              full):
    """One wire of a ZeRO phase on this rank (``zero_rank``)."""
    from torch_checks import table_step_vs_plain

    from paddle_tpu_torch.distributed import GradCommConfig
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.distributed.grad_comm import comm_plan
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    model = GPTForCausalLM(cfg, seed=0, device=device)
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=model.parameters())
    model, opt, _ = group_sharded_parallel(
        model, opt, level, overlap_comm=True, fuse_update=True,
        grad_comm=GradCommConfig(codec))
    store = getattr(model, "_zero3", None)
    if store is not None:
        store.register_external_use(model,
                                    model.gpt.embeddings.word_embeddings)
    fused, comm = model._fused_update, model._grad_comm
    params = fused.params
    crit = GPTPretrainingCriterion()
    update_gathers = []
    check = {}

    def one(table_check=False):
        fused.zero_grad()
        comm.prepare(params, world=world, use_reduce_scatter=True)
        loss = crit(model(x), y)
        loss.backward()
        comm.sync(params, world=world, use_reduce_scatter=True)
        ag, n = coll.all_gather, [0]

        def counted(*a, **k):
            n[0] += 1
            return ag(*a, **k)

        coll.all_gather = counted
        try:
            if table_check:
                check["err"] = table_step_vs_plain(
                    fused._shard_table, fused._lr_tensor(x.device),
                    lambda: fused.step_sharded(rank, world,
                                               param_store=store))
            else:
                fused.step_sharded(rank, world, param_store=store)
        finally:
            coll.all_gather = ag
        update_gathers.append(n[0])
        return float(loss.detach())

    losses = [one() for _ in range(warmup)]
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    if store is not None:
        store.reset_exposed()
        store.gathers.clear()
    reset_dp_launch_counts()
    step_ms, effs, exposed = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(one())
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        effs.append(comm.stats["overlap_efficiency"])
        exposed.append(comm.stats["exposed_comm_s"] * 1e3)
    counts = dp_launch_counts()
    out = {"losses": losses, "step_ms": step_ms, "counts": counts,
           "overlap_efficiency": effs, "exposed_comm_ms": exposed,
           "buckets": [b.size for b in fused.buckets],
           "comm_stats": {k: v for k, v in comm.stats.items()
                          if k in ("codec", "n_buckets", "collectives",
                                   "comm_bytes")},
           "plan": comm_plan(params, comm.config, world=world)}
    if on_card:
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["at_rest_gib"] = torch.cuda.memory_allocated() / 2**30
    out["slot_bytes"] = sum(v.numel() * v.element_size()
                            for s in fused._shard_slots.values()
                            for v in s.values() if v.dim())
    out["param_bytes"] = (store.param_bytes_per_rank() if store is not None
                          else sum(t.numel() * t.element_size()
                                   for t in fused._flat_p.values()))
    if store is not None:
        out.update(gathers=dict(store.gathers),
                   exposed_gather_s=store.exposed_gather_s,
                   resident=store.resident_buckets())
    if full:
        wire = {}
        saved = _timed_collectives(coll, sync, wire)
        try:
            losses.append(one())
        finally:
            for name, fn in saved.items():
                setattr(coll, name, fn)
        out["wire_ms"] = wire
        losses.append(one(table_check=True))
        out["table_err"] = check["err"]
    out["update_gathers"] = update_gathers[warmup:]
    ctx = (store.materialize() if store is not None
           else contextlib.nullcontext())
    with ctx:
        out["checksum"] = _param_checksum(model)
    del model, opt, fused, comm, store
    return out


def zero_rank(cfg, seed, level, warmup, steps, fp32_steps, b, s,
              device="cuda", layers=None):
    """One rank of phase 51 (``level="os_g"``) or 52 (``"p_g_os"``), run
    by ``spawn``: the int8_block wire (``_zero_run``, all its checks),
    then the fp32 wire's ``fp32_steps``."""
    import dataclasses

    from paddle_tpu_torch.distributed import get_rank, init_parallel_env

    env = init_parallel_env()
    rank, world = get_rank(), env.world_size
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size, (b * world, s))
    labels = rs.randint(0, cfg.vocab_size, (b * world, s))
    x = torch.as_tensor(ids[rank * b:(rank + 1) * b], device=device)
    y = torch.as_tensor(labels[rank * b:(rank + 1) * b], device=device)
    out = {"rank": rank, "backend": env.backend}
    out["int8_block"] = _zero_run(cfg, level, "int8_block", x, y, rank,
                                  world, warmup, steps, device, True)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out["fp32"] = _zero_run(cfg, level, "fp32", x, y, rank, world, 0,
                            fp32_steps, device, False)
    return out


def _zero_want(n_layers, nb, steps):
    """Launches of ``steps`` ZeRO steps a rank: each layer's flash trio,
    one encode and one decode a bucket, one update."""
    want = {name + sfx: n_layers * steps * (sfx == "")
            for sfx in ("", "_bf16", "_fp16")
            for name in ("flash_fwd", "flash_dq", "flash_dkv")}
    want.update(fused_update=steps, codec_encode=nb * steps,
                codec_decode=nb * steps, codec_encode_bf16=0,
                codec_decode_bf16=0, codec_encode_fp16=0,
                codec_decode_fp16=0, fused_dequant_update=0,
                fused_dequant_update_fp16=0, ce_chunk_fwd=0, ce_chunk_bwd=0)
    return want


def phase_zero(cfg, seed, level, dp_rank, zero2=None, warmup=ZERO_WARMUP,
               steps=ZERO_STEPS, fp32_steps=ZERO_FP32_STEPS, b=DP_B,
               s=DP_S, device="cuda", layers=None):
    """Phase 51 (``level="os_g"``) or 52 (``"p_g_os"``, with phase 51's
    summary as ``zero2``): ``zero_rank`` on two ranks, its numbers beside
    phase 14's replicated run (``dp_rank``), and its checks."""
    from paddle_tpu_torch.distributed import spawn

    t0 = time.perf_counter()
    ranks = spawn(zero_rank, args=(cfg, seed, level, warmup, steps,
                                   fp32_steps, b, s, device, layers),
                  nprocs=DP_WORLD, timeout=DP_RANK_TIMEOUT)
    r0 = ranks[0]
    run = r0["int8_block"]
    nb = len(run["buckets"])
    n_layers = layers or cfg.num_layers
    stage = 2 if level == "os_g" else 3
    replicated_slots = 2 * 4 * sum(run["buckets"])
    summary = {
        "stage": stage, "level": level, "backend": r0["backend"],
        "world": DP_WORLD, "batch_per_rank": [b, s], "buckets": nb,
        "losses": run["losses"],
        "rank_losses": {w: [r[w]["losses"] for r in ranks]
                        for w in ("int8_block", "fp32")},
        "step_ms": [r["int8_block"]["step_ms"] for r in ranks],
        "step_ms_median": statistics.median(run["step_ms"]),
        "fp32_step_ms": [r["fp32"]["step_ms"] for r in ranks],
        "wire_ms_per_step": [r["int8_block"]["wire_ms"] for r in ranks],
        "overlap_efficiency": [r["int8_block"]["overlap_efficiency"]
                               for r in ranks],
        "exposed_comm_ms": [r["int8_block"]["exposed_comm_ms"]
                            for r in ranks],
        "peak_memory_gib": [r["int8_block"].get("peak_memory_gib")
                            for r in ranks],
        "at_rest_gib": [r["int8_block"].get("at_rest_gib") for r in ranks],
        "param_bytes": [r["int8_block"]["param_bytes"] for r in ranks],
        "slot_bytes": [r["int8_block"]["slot_bytes"] for r in ranks],
        "replicated_slot_bytes": replicated_slots,
        "launches_per_rank": [r["int8_block"]["counts"] for r in ranks],
        "update_gathers": run["update_gathers"],
        "comm_stats": run["comm_stats"],
        "comm_plan": {k: run["plan"][k] for k in (
            "n_buckets", "collectives_per_step", "comm_bytes_per_step",
            "total_grad_numel")},
        "table_err": [r["int8_block"]["table_err"] for r in ranks],
        "checksums": [r["int8_block"]["checksum"][:16] for r in ranks],
        "phase14": {"step_ms_median": dp_rank and statistics.median(
                        dp_rank["step_ms"]),
                    "peak_memory_gib": dp_rank and dp_rank[
                        "peak_memory_gib"]},
        "seconds": time.perf_counter() - t0}
    if stage == 3:
        summary.update(
            gathers=[r["int8_block"]["gathers"] for r in ranks],
            exposed_gather_s=[r["int8_block"]["exposed_gather_s"]
                              for r in ranks])
    log(f"zero-{stage} " + json.dumps(summary))
    log(f"zero-{stage} beside phase 14 in this call: step "
        f"{summary['step_ms_median']:.2f} ms against "
        f"{summary['phase14']['step_ms_median']}; peak "
        f"{summary['peak_memory_gib']} GiB against "
        f"{summary['phase14']['peak_memory_gib']}; AdamW slots "
        f"{run['slot_bytes'] / 2**30:.4f} GiB a rank against "
        f"{replicated_slots / 2**30:.4f} replicated; parameters at rest "
        f"{run['param_bytes'] / 2**30:.4f} GiB a rank")
    for wire, losses in summary["rank_losses"].items():
        # each rank's loss is that of its own half of the batch
        if not all(math.isfinite(v) for v in sum(losses, [])):
            raise AssertionError(f"non-finite zero-{stage} {wire} loss: "
                                 f"{losses}")
        if len({r[wire]["checksum"] for r in ranks}) != 1:
            raise AssertionError(f"zero-{stage} {wire}: the ranks' "
                                 f"parameters differ")
        if zero2 is not None and losses != zero2["rank_losses"][wire]:
            raise AssertionError(
                f"zero-3 {wire} losses {losses} are not zero-2's "
                f"{zero2['rank_losses'][wire]} bit for bit")
    if not all(r["int8_block"]["losses"][-1] < r["int8_block"]["losses"][0]
               for r in ranks):
        raise AssertionError(f"zero-{stage} loss did not fall: "
                             f"{run['losses']}")
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError("expected gloo (one card, two ranks)")
    want = _zero_want(n_layers, nb, steps)
    for r in ranks:
        got = r["int8_block"]
        if got["counts"] != want:
            raise AssertionError(f"rank {r['rank']} launch counts "
                                 f"{got['counts']}, expected {want}")
        if got["update_gathers"] != [nb if stage == 2 else 0] * (steps + 2):
            raise AssertionError(f"rank {r['rank']} all_gathers in the "
                                 f"update {got['update_gathers']}")
        if got["table_err"] != 0.0:
            raise AssertionError(f"the shard table's launch differs from "
                                 f"its plain walk: {got['table_err']}")
        chunks = sum(-(-n // DP_WORLD) for n in got["buckets"])
        if got["slot_bytes"] != 2 * 4 * chunks:
            raise AssertionError(f"{got['slot_bytes']} slot bytes, the "
                                 f"shards hold {2 * 4 * chunks}")
        if stage == 3:
            if got["resident"] or got["gathers"].get("fallback"):
                raise AssertionError(f"zero-3 at rest: {got['resident']} "
                                     f"gathered, gathers {got['gathers']}")
            if got["param_bytes"] != 4 * chunks:
                raise AssertionError(f"zero-3 holds {got['param_bytes']} "
                                     f"parameter bytes, its shards "
                                     f"{4 * chunks}")
    plan, stats = run["plan"], run["comm_stats"]
    if (stats["collectives"], stats["comm_bytes"]) != (
            plan["collectives_per_step"] + plan["n_buckets"],
            plan["comm_bytes_per_step"] + plan["total_grad_numel"]):
        raise AssertionError(f"comm_stats {stats} against comm_plan {plan} "
                             f"with use_reduce_scatter")
    if zero2 is not None:
        half = zero2["param_bytes"][0] / 2
        if not abs(summary["param_bytes"][0] - half) <= 0.01 * half:
            raise AssertionError(
                f"zero-3 parameters at rest {summary['param_bytes'][0]} "
                f"bytes, zero-2's half {half}")
    summary["launches"] = run["counts"]
    return summary


def phase_zero_kernels(dev, gen, plan):
    """The shard table at GPT-125M's plan: the owned half of each bucket
    (``ceil(size / 2)`` elements) in one ``fused_update_buckets`` launch,
    held against its plain walk and timed beside its bound at the shard's
    bytes and torch._fused_adamw_ (``_fused_timing``)."""
    from paddle_tpu_torch.distributed.grad_comm import GradBucket

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    shards = []
    for b in plan:
        sb = GradBucket(b.index, b.dtype)
        sb.add(b.index, (-(-b.size // DP_WORLD),))
        shards.append(sb)
    row = _fused_timing(dev, gen, shards, flush)
    row["shape"] = f"shard table: rank 0's half of {row['shape']}"
    log(f"zero shard table, {row['shape']}, one launch: as step() calls "
        f"it {row['step_ms']:.4f} ms, the kernel alone {row['ms']:.4f}, "
        f"torch._fused_adamw_ {row['library_ms']:.4f}; plain "
        f"{row['plain_ms']:.4f}; bound {row['bound_ms']:.4f} "
        f"{row['bound_by']}, the kernel at "
        f"{100 * row['bound_ms'] / row['ms']:.1f}% of it")
    return row


def _plain_block_ops():
    from paddle_tpu_torch.distributed import grad_comm as gc

    return gc.block_encode, gc.block_decode


def zero_wire_rank(cfg, seed, device="cuda", layers=ZERO_OVERLAP_LAYERS,
                   b=DP_B, s=DP_S):
    """One rank of phase 53 (``spawn``): ``traced_reduce_scatter_quantized``
    at the word table's size and a ragged one on the codec kernels and on
    the plain codecs, and the overlapped reduce_scatter sync against the
    serial one over two backward passes of ``cfg`` cut to ``layers``."""
    import dataclasses

    from paddle_tpu_torch.distributed import (GradCommConfig, get_rank,
                                              init_parallel_env)
    from paddle_tpu_torch.distributed import grad_comm as gc
    from paddle_tpu_torch.distributed.overlap import communicator_for
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.ops import codec

    env = init_parallel_env()
    rank, world = get_rank(), env.world_size
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 100 + rank)
    cfg_w = GradCommConfig("int8_block", block_size=ZERO_WIRE_BLOCK)
    out = {"rank": rank, "traced": {}}
    reset_dp_launch_counts()
    for n in (cfg.vocab_size * cfg.hidden_size, ZERO_RAGGED):
        flat = torch.randn(n, device=device, generator=gen) * 1e-3
        res = torch.randn(n, device=device, generator=gen) * 1e-6

        def call():
            sync()
            t0 = time.perf_counter()
            out_ = gc.traced_reduce_scatter_quantized(flat, None, world,
                                                      cfg_w, residual=res)
            sync()
            return out_, (time.perf_counter() - t0) * 1e3

        kernel_ops = gc._block_kernel_ops
        gc._block_kernel_ops = _plain_block_ops
        try:
            call()                      # a warm run of each form first
            want, plain_ms = call()
        finally:
            gc._block_kernel_ops = kernel_ops
        call()
        before = codec.launch_counts()
        got, ms = call()
        after = codec.launch_counts()
        same = [name for name, a, c in zip(("full", "shard", "residual"),
                                           got[:3], want[:3])
                if not torch.equal(a.view(torch.int32), c.view(torch.int32))]
        out["traced"][n] = {
            "ms": ms, "plain_ms": plain_ms, "differ": same,
            "wire_bytes": got[3], "collectives": got[4],
            "launches": {k: after[k] - before[k] for k in after},
            "shard": got[1].numel(),
            "max_abs_err": max(float((a - c).abs().max())
                               for a, c in zip(got[:3], want[:3]))}
    cut = dataclasses.replace(cfg, num_layers=layers)
    model = GPTForCausalLM(cut, seed=0, device=device)
    params = [p for p in model.parameters() if p.requires_grad]
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cut.vocab_size, (b * world, s))
    x = torch.as_tensor(ids[rank * b:(rank + 1) * b], device=device)
    crit = GPTPretrainingCriterion()
    runs = {}
    for overlap in (False, True):
        comm = communicator_for(GradCommConfig("int8_block",
                                               overlap=overlap))
        rounds, effs = [], []
        for k in range(2):
            for p in params:
                p.grad = None
            if overlap:
                comm.prepare(params, world=world, use_reduce_scatter=True)
            crit(model(x), x.roll(k + 1, -1)).backward()
            comm.sync(params, world=world, use_reduce_scatter=True)
            rounds.append([p.grad.clone() for p in params])
            if overlap:
                effs.append(comm.stats["overlap_efficiency"])
        runs[overlap] = (rounds, comm, effs)
    (ser, scomm, _), (ovl, ocomm, effs) = runs[False], runs[True]
    out["overlap"] = {
        "differ": sum(not torch.equal(a, c) for ra, rc in zip(ser, ovl)
                      for a, c in zip(ra, rc)),
        "residuals_differ": sum(
            not torch.equal(scomm._residuals[i], ocomm._residuals[i])
            for i in scomm._residuals),
        "n_residuals": len(scomm._residuals),
        "efficiency": effs,
        "launched_early": ocomm.stats["buckets_launched_early"],
        "n_buckets": ocomm.stats["n_buckets"],
        "stats_equal": {k: scomm.stats[k] for k in ("collectives",
                                                    "comm_bytes")}
        == {k: ocomm.stats[k] for k in ("collectives", "comm_bytes")}}
    out["launches"] = dp_launch_counts()
    sync()
    return out


def phase_zero_wire(cfg, seed, device="cuda", layers=ZERO_OVERLAP_LAYERS,
                    b=DP_B, s=DP_S):
    """Phase 53: ``zero_wire_rank`` on two ranks, and its checks."""
    from paddle_tpu_torch.distributed import spawn

    t0 = time.perf_counter()
    ranks = spawn(zero_wire_rank, args=(cfg, seed, device, layers, b, s),
                  nprocs=DP_WORLD, timeout=DP_RANK_TIMEOUT)
    summary = {"traced": [r["traced"] for r in ranks],
               "overlap": [r["overlap"] for r in ranks],
               "seconds": time.perf_counter() - t0}
    log("zero wire " + json.dumps(summary, default=str))
    for r in ranks:
        for n, t in r["traced"].items():
            if t["differ"] or t["launches"] != {"codec_encode": 2,
                                                "codec_decode": 2}:
                raise AssertionError(
                    f"traced_reduce_scatter_quantized at {n}: {t['differ']} "
                    f"differ from the plain codecs, launches "
                    f"{t['launches']}")
        ov = r["overlap"]
        if ov["differ"] or ov["residuals_differ"] or not ov["stats_equal"] \
                or not ov["n_residuals"]:
            raise AssertionError(f"the overlapped sync is not the serial "
                                 f"one: {ov}")
        if ov["launched_early"] != ov["n_buckets"]:
            raise AssertionError(f"{ov['launched_early']} of "
                                 f"{ov['n_buckets']} buckets launched "
                                 f"before the flush")
    summary["launches"] = ranks[0]["launches"]
    return summary


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
    prof17 = phase_train_profile(lambda: bench_step(step, cfg16, ids,
                                                    labels),
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

    # bench.py's eager mode (measure_eager), then card against CPU
    t0 = time.perf_counter()
    phase_eager(dev)
    log(f"phase 33 (eager): {time.perf_counter() - t0:.1f} s")

    # the eager training surface: the random ops, then LeNet
    t0 = time.perf_counter()
    phase_random(dev)
    log(f"phase 34 (random): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lenet = phase_lenet(dev, args.seed)
    log(f"phase 35 (lenet): {time.perf_counter() - t0:.1f} s")

    # the feed-forward nn: every new functional and layer, the public
    # flash entry, then MobileNetV2 trained at ImageNet width
    t0 = time.perf_counter()
    phase_nn(dev)
    log(f"phase 36 (nn): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flash_entry = phase_flash_entry(dev, gen)
    log(f"phase 37 (flash entry): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mobilenet = phase_mobilenet(dev, args.seed)
    log(f"phase 38 (mobilenet_v2): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # the recurrent nn: every new name, then the PTB LSTM language model
    # trained at full width and beam search on it
    t0 = time.perf_counter()
    phase_rnn_nn(dev)
    log(f"phase 39 (rnn nn): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ptb = phase_ptb_lm(dev, args.seed)
    log(f"phase 40 (ptb lm): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_ptb_beam(dev, ptb)
    log(f"phase 41 (ptb beam search): {time.perf_counter() - t0:.1f} s")
    ptb_run = {"counts": ptb["counts"], "row": ptb["row"]}
    del ptb
    torch.cuda.empty_cache()

    # the other eager namespaces, then a GCN at Cora's widths trained,
    # checkpointed with paddle.save and resumed with paddle.load
    t0 = time.perf_counter()
    phase_namespaces(dev)
    log(f"phase 42 (namespaces): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gcn = phase_gcn(dev, args.seed)
    log(f"phase 43 (gcn): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # fp16: the kernels' fp16 forms, GPT-125M trained in fp16, GPT's
    # remaining training options, BERT-base under fp16 amp
    plan_h = bucket_plan(fp16_config())
    t0 = time.perf_counter()
    before = clocks("before fp16 kernels")
    fp16_k = phase_fp16_kernels(dev, gen, plan_h)
    stamp([*fp16_k["rows"].values(), *fp16_k["bert"].values()], before,
          clocks("after fp16 kernels"))
    log_ratios("fp16 kernels", {**fp16_k["rows"],
                                **{f"bert {n}": r
                                   for n, r in fp16_k["bert"].items()}})
    log(f"phase 44 (fp16 kernels): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fp16_t = phase_fp16_train(dev, args.seed, plan_h, train16, prof17)
    log(f"phase 45 (train fp16): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    options = phase_gpt_options(dev, args.seed)
    log(f"phase 46 (gpt options): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bert_h = phase_bert_fp16(dev, args.seed, bert)
    log(f"phase 47 (bert fp16): {time.perf_counter() - t0:.1f} s")
    del options
    torch.cuda.empty_cache()

    # fp16 on the gradient wire (GPT-125M's fp16 plan, then phase 19 in
    # fp16) and int8 BERT-base on fp16 activations
    t0 = time.perf_counter()
    before = clocks("before fp16 wire kernels")
    enc_h, dec_h, table_h = phase_dp_kernels_bf16(dev, gen, plan_h)
    timed = {"fused_dequant_update fp16 plan": table_h,
             **{f"carrier from fp16 plan {nb}": r for nb, r in enc_h.items()},
             **{f"decode to fp16 plan {nb}": r for nb, r in dec_h.items()}}
    stamp(timed.values(), before, clocks("after fp16 wire kernels"))
    log_ratios("fp16 wire kernels", timed)
    log(f"phase 48 (fp16 wire kernels): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wire_h = phase_dp_train_fp16(args.seed, fp16_t, dp16_rank)
    log(f"phase 49 (dp train fp16): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    int8_h = phase_int8_fp16(dev, gen, args.seed, bert)
    log(f"phase 50 (int8 fp16): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # ZeRO: stages 2 and 3 through group_sharded_parallel on the
    # overlapped reduce_scatter wire, then the quantized reduce_scatter
    t0 = time.perf_counter()
    zero2 = phase_zero(cfg, args.seed, "os_g", dp_rank)
    log(f"phase 51 (zero-2): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    zero3 = phase_zero(cfg, args.seed, "p_g_os", dp_rank, zero2)
    log(f"phase 52 (zero-3): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    before = clocks("before zero kernels")
    zero_row = phase_zero_kernels(dev, gen, plan)
    stamp([zero_row], before, clocks("after zero kernels"))
    zero_wire = phase_zero_wire(cfg, args.seed)
    log(f"phase 53 (zero wire): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    log(f"total {time.perf_counter() - t_start:.1f} s")
    dp16 = {"encode": enc16, "decode": dec16, "table": table16,
            "rank": dp16_rank}
    print(json.dumps(kernels_line(rows, counts, train_rows, train_counts,
                                  infer_rows, conversion, infer_counts,
                                  dp_row, carrier_rows, dp_rank, bf16_rows,
                                  bf16_counts, dp16, ce_rows, ce_counts,
                                  bert, {"counts": counts29, "row": row_r},
                                  {"counts": counts31, "row": row_wd},
                                  lenet, flash_entry, mobilenet, ptb_run,
                                  gcn, {"kernels": fp16_k, "train": fp16_t,
                                        "bert": bert_h},
                                  {"encode": enc_h, "decode": dec_h,
                                   "table": table_h, "rank": wire_h,
                                   "qmm_rows": int8_h["qmm_rows"],
                                   "qmm_routes": int8_h["qmm_routes"]},
                                  {"51": zero2, "52": zero3,
                                   "53": zero_wire, "row": zero_row})))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
