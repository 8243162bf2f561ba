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
slices: bf16 GPT training on bf16 forms of the flash and update kernels
(and fp16 training on their fp16 forms, with ``GradScaler`` under fp16
amp and GPT's dropout, ``recompute_policy`` and the per-parameter
optimizers in ``jit.TrainStep``), bf16 buckets on the gradient wire (the codecs read and write bf16), and
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
on the fused update, the table's Adagrad over the slab) and the AUC;
then the eager tensor API of ``bench.py``'s eager mode: ``Tensor``,
``to_tensor``, autograd (``backward``, ``grad``, ``no_grad``) and the
``paddle.*`` op namespace, so that ``import paddle_tpu_torch as paddle``
runs the reference's eager code on the card:

  framework/tensor.py, autograd.py, dtype.py
               the eager Tensor (a torch.Tensor payload with Paddle's
               surface: stop_gradient, list shapes, clear_grad, numpy),
               to_tensor, no_grad/grad over PyTorch's autograd, the
               reference's dtypes (64-bit narrowed), places
  tensor/      the paddle.* op namespace (about 290 ops: creation,
               math, logic, manipulation, search, linalg, einsum) and
               the Tensor methods and operators; each op takes an eager
               Tensor or a plain torch.Tensor and is a cast point under
               amp with the reference's op name
  amp/         auto_cast (the reference's O1/O2 lists and cast rules),
               the cast points' amp_cast_inputs, decorate, GradScaler
  framework/   device resolution (cuda by default), places, flags,
               GEMM precision, per-request random streams
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

Then the eager training surface: the random ops over per-device
generators (``framework/random.py``, ``tensor/random.py``: ``seed``,
the RNG states), ``Parameter``, ``create_parameter`` and ``ParamAttr``,
``nn.Layer`` (a ``torch.nn.Module`` whose Paddle accessors return eager
views of its parameters, ``nn/layer/layers.py``), ``nn.initializer``,
the functionals over eager ``Tensor``s, the optimizers' ``step()`` over
eager parameters (one fused update launch on the card), and
``vision.models.LeNet``.

Then the other eager namespaces and the top-level utilities:

  autograd/    backward, grad, PyLayer (a torch.autograd.Function node)
  linalg.py    the op namespace's linear algebra and lu_unpack,
               matrix_exp, householder_product, vector_norm,
               matrix_norm, svd_lowrank, pca_lowrank
  fft.py, signal.py
               torch.fft transforms (the reference's Hermitian n-D
               forms and norms), frame, overlap_add, stft, istft
  framework/io.py
               save/load (the reference's pickle, atomic writes, typed
               errors); Optimizer.state_dict/set_state_dict
  distribution/ Normal, Uniform, Categorical, Bernoulli, Beta,
               Dirichlet, Multinomial, kl_divergence on the port's
               generators
  sparse/      COO/CSR tensors over torch's sparse layouts
  geometric.py send_u_recv, send_ue_recv, segment_* on
               torch.segment_reduce (deterministic on the card)
  device/      the card's device, memory and cuDNN queries
  optimizer/   Adagrad, Adadelta, Adamax, RMSProp, Lamb, Lars,
               DGCMomentum: per parameter on the card
  top level    save, load, DataParallel, finfo, iinfo, tolist,
               set_printoptions, LazyGuard, batch, check_shape, places,
               version, sysconfig

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; a CUDA request without a card raises. New eager
tensors and layers go to the current place: the card until
``set_device("cpu")``.
"""
import numpy as _np
import torch

from .framework.autograd import (  # noqa: F401
    enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled,
)
from .framework.device import (  # noqa: F401
    CPUPlace, CUDAPlace, Place, TPUPlace, device_count, get_device,
    is_compiled_with_cuda, set_device,
)
from .framework.dtype import (  # noqa: F401
    bfloat16, complex64, complex128, convert_dtype, float16, float32,
    float64, get_default_dtype, int8, int16, int32, int64,
    set_default_dtype, uint8,
)
from .framework.dtype import bool  # noqa: F401,A004
from .framework.flags import get_flags, set_flags  # noqa: F401
from .framework.param_attr import ParamAttr  # noqa: F401
from .framework.random import (  # noqa: F401
    get_cuda_rng_state, get_rng_state, seed, set_cuda_rng_state,
    set_rng_state,
)
from .framework.tensor import (  # noqa: F401
    Parameter, Tensor, create_parameter, to_tensor,
)

# the op namespace (paddle.add, paddle.matmul, ...) and the Tensor methods
from .tensor import *  # noqa: F401,F403
from .tensor import is_tensor  # noqa: F401

from . import (metric, nn, optimizer, quantization, regularizer,  # noqa: E402,F401
               vision)
from . import (amp, autograd, device, distributed, distribution,  # noqa: E402,F401
               fft, geometric, incubate, jit, linalg, observability,
               signal, sparse, sysconfig, version)
from .distributed.parallel import DataParallel  # noqa: E402,F401
from .framework.device import XPUPlace  # noqa: E402,F401
from .framework.io import load, save  # noqa: E402,F401
from .device import get_cudnn_version  # noqa: E402,F401

CUDAPinnedPlace = CPUPlace     # pinned host memory is the host's place
NPUPlace = XPUPlace            # another accelerator's name: the card
dtype = torch.dtype            # the type of the port's dtypes


def enable_static():
    """Accepted as the reference's is: the port runs eagerly."""


def disable_static():
    """Accepted as the reference's is: the port runs eagerly."""


def in_dynamic_mode():
    return True


def in_static_mode():
    return False


def iinfo(dtype_):
    """``numpy.iinfo`` of the dtype (the reference's, 64-bit narrowed)."""
    from .framework.dtype import dtype_name

    return _np.iinfo(_np.dtype(dtype_name(dtype_)))


class _BF16Info:
    """bfloat16's limits, from ``torch.finfo`` (the reference's
    ``jnp.finfo`` values)."""
    _f = torch.finfo(torch.bfloat16)
    bits = _f.bits
    eps = float(_f.eps)
    min = float(_f.min)
    max = float(_f.max)
    tiny = float(_f.tiny)
    dtype = "bfloat16"


def finfo(dtype_):
    """``numpy.finfo`` of the dtype; bfloat16's limits for bfloat16."""
    from .framework.dtype import dtype_name

    name = dtype_name(dtype_)
    if name == "bfloat16":
        return _BF16Info()
    return _np.finfo(_np.dtype(name))


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """numpy's print options, which ``Tensor.__repr__`` formats with (its
    precision stays 8, as the reference's)."""
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    _np.set_printoptions(**kw)


class LazyGuard:
    """``paddle.LazyGuard``: parameters are made when a layer is built;
    the guard is accepted and changes nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def batch(reader, batch_size, drop_last=False):
    """``paddle.batch``: a reader of lists of ``batch_size`` items."""
    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


def check_shape(shape):
    """Ints, or a 1-D integer tensor; -1 at most once, nothing below -1."""
    if isinstance(shape, Tensor):
        if len(shape.shape) != 1:
            raise ValueError("shape tensor must be 1-D")
        return
    dims = list(shape)
    if len([d for d in dims if int(d) == -1]) > 1:
        raise ValueError("only one dimension may be -1")
    for d in dims:
        if int(d) < -1:
            raise ValueError(f"invalid dimension {d}")


def disable_signal_handler():
    """Accepted: the port installs no signal handlers."""


def tolist(x):
    """``paddle.tolist``."""
    return x.tolist()
