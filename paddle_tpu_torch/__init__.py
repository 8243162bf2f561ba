"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` stays the reference; this package is its
counterpart for an NVIDIA Hopper card (H100, ``sm_90a``), ported slice
by slice. Each module mirrors the path of the ``paddle_tpu`` module it
ports and names that file in its docstring. Nothing here imports ``jax``
or ``paddle_tpu``.

Slice 1: GPT continuous-batching serving on a paged KV cache whose
int8/fp8 at-rest codec runs on two hand-written CUDA kernels
(``csrc/codec.cu``). Slice 2: the GPT training step, with flash
attention forward/backward on three CUDA kernels
(``csrc/flash_attention.cu``) and the optimizer update on a fourth
(``csrc/fused_update.cu``). Slice 3: int8 weight-only BERT inference,
with weight quantization and the quantized matmul on two CUDA kernels
(``csrc/quant_matmul.cu``) and attention on the flash forward kernel.
Slice 4: data-parallel training on the quantized gradient wire, one
process per rank over ``torch.distributed``, each bucket's summed
payload decoded inside the optimizer update by a CUDA kernel
(``csrc/fused_update.cu``, one launch a step over every bucket). Later
slices: bf16 GPT training on bf16 forms of the flash and update kernels,
bf16 buckets on the gradient wire (the codecs read and write bf16), and
the training options of ``bench.py``: the chunked linear +
cross-entropy loss on two CUDA chunk kernels (``csrc/fused_ce.cu``),
recompute, learning-rate schedulers and gradient clips; then
``bench.py``'s BERT pretraining under ``amp`` (the reference's cast
points), and int8 BERT on bf16 activations through the bf16 form of the
quantized matmul (``csrc/quant_matmul.cu``); then ``bench.py``'s
ResNet-50 training under O2 (convolutions on cuDNN, the reference's
BatchNorm, pooling, ``vision.models.resnet``) on the fused Momentum
update; then ``bench.py``'s Wide&Deep on the parameter server: the host
sparse table (native C++, built with ``g++``), the local PS, its
communicators, the pass cache on the card, the pass step (the dense Adam
on the fused update, the table's Adagrad over the slab) and the AUC:

  amp/         auto_cast (the reference's O1/O2 lists and cast rules),
               the cast points' amp_cast_inputs, decorate, GradScaler
  tensor/      the tensor ops the reference dispatches as ops (add,
               reshape, flatten, clone, getitem, where, ...), each a
               cast point
  framework/   device resolution (cuda by default), flags, GEMM
               precision, per-request random streams
  core/        the host sparse table (the reference's C++ source, built
               with g++ at first use, ctypes)
  metric/      Accuracy, Precision, Recall, Auc (host numpy)
  models/      GPTConfig/presets, numpy-seeded GPTForCausalLM parameters
               and training forward, GPTPretrainingCriterion;
               BertConfig/presets, BertForPretraining (the MLM loss,
               fused or not) and BertPretrainingCriterion; WideDeep and
               bench.py's widedeep run (WideDeepBench.run);
               weight conversion from the JAX models' numpy arrays
               (GPT, BERT, ResNet)
  nn/          Linear ([in, out] weights), Embedding, Dropout, LayerNorm,
               the transformer encoder, Conv1D/2D/3D, BatchNorm*,
               MaxPool2D, AvgPool2D, AdaptiveAvgPool2D, ReLU, Sigmoid,
               Sequential, Flatten, BCELoss, BCEWithLogitsLoss; linear,
               embedding, dropout, gelu, relu, sigmoid, tanh,
               layer_norm, batch_norm, conv, pooling, cross_entropy,
               the binary cross-entropies and scaled dot-product
               attention functionals; ClipGradBy*
  vision/      the ResNet family (resnet18..152, ResNeXt, wide ResNets)
  incubate/    fused_linear_cross_entropy (the chunked LM head + loss)
  quantization/ Int8Linear and convert_to_int8
  distributed/ the process group (env, spawn), collectives, the wire
               codecs and bucket plan, GradCommunicator, DataParallel;
               ps/: LocalPs, DenseTable, TheOnePSRuntime, the sync,
               async and geo communicators, distributed_lookup_table,
               DevicePassCache, heter_embedding, CompiledPassStep
  ops/         kernel wrappers (kernel on CUDA, plain on CPU) for the
               codec, flash attention, the fused update (plain and
               dequantizing), the int8 quantize/quantized matmul and the
               fused loss's chunk epilogues, and the nvcc/ctypes build
  optimizer/   SGD, Momentum, Adam, AdamW, the learning-rate schedulers
               (lr) and the fused flat updater
  jit/         TrainStep (data parallel with grad_comm)
  serving/     decode model, KV block pool, sampler, queue, engine
  observability/ counters, gauges and histograms

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; a CUDA request without a card raises.
"""
from . import metric, nn, quantization, vision

__all__ = ["metric", "nn", "quantization", "vision"]
