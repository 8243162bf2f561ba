"""Functionals of the port (reference: ``paddle_tpu/nn/functional``).

Each takes plain ``torch.Tensor``s (the models' path, which it returns
plain) or the eager ``Tensor``s of a Paddle user's code, whose results
it wraps (``framework/autograd.py`` ``eager_fn``); either way it is the
amp cast point of the reference's op name. Each takes the reference's
parameters, by the same names and in the same order (``name`` is taken
and not used, as there). The in-place forms (``relu_``, ``softmax_``,
``elu_``, ``tanh_``) rebind an eager ``Tensor`` to the result, as the
reference's do, or write a ``torch.Tensor`` in place.

Not ported yet: the RNN family's sequence ops, the fluid-era
functionals and four losses (ROADMAP Queue A 4c-2), the transposed
convolutions (Queue A 14, they raise).
"""
from .activation import (celu, elu, gelu, glu, gumbel_softmax, hardshrink,
                         hardsigmoid, hardswish, hardtanh, leaky_relu,
                         log_sigmoid, log_softmax, maxout, mish, prelu, relu,
                         relu6, selu, sigmoid, silu, softmax, softplus,
                         softshrink, softsign, swish, tanh, tanhshrink,
                         thresholded_relu)
from .attention import flash_route, scaled_dot_product_attention
from .common import (affine_grid, alpha_dropout, bilinear, channel_shuffle,
                     cosine_similarity, diag_embed, dropout, dropout2d,
                     dropout3d, embedding, fold, grid_sample, interpolate,
                     label_smooth, linear, max_unpool1d, max_unpool2d,
                     max_unpool3d, normalize, one_hot, pad,
                     pairwise_distance, pixel_shuffle, pixel_unshuffle,
                     unfold, upsample, zeropad2d)
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .flash_attention import flash_attention, flash_attn_unpadded
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   bpr_loss, cosine_embedding_loss, cross_entropy, ctc_loss,
                   dice_loss, gaussian_nll_loss, hinge_embedding_loss, kl_div,
                   l1_loss, log_loss, margin_ranking_loss, mse_loss,
                   multi_margin_loss, nll_loss, npair_loss, poisson_nll_loss,
                   rank_loss, sigmoid_focal_loss, smooth_l1_loss,
                   soft_margin_loss, softmax_with_cross_entropy,
                   square_error_cost, triplet_margin_loss)
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   local_response_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)

_IN_PLACE = ["elu_", "relu_", "softmax_", "tanh_"]

__all__ = sorted(
    [n for n, v in dict(globals()).items()
     if callable(v) and not n.startswith("_") and n != "flash_route"])
__all__ += ["flash_route"] + _IN_PLACE

from ...framework.autograd import eager_fn as _eager_fn  # noqa: E402
from ...framework.tensor import Tensor as _Tensor  # noqa: E402

for _name in __all__:
    if _name not in _IN_PLACE and _name != "flash_route":
        globals()[_name] = _eager_fn(globals()[_name])


def _in_place(x, out):
    """Rebind the eager ``x`` to ``out`` (the reference's
    ``_replace_from``), or write a ``torch.Tensor`` ``x`` in place."""
    if isinstance(x, _Tensor):
        x._replace_from(out)
    else:
        x.copy_(out)
    return x


def relu_(x, name=None):
    return _in_place(x, relu(x))


def softmax_(x, axis=-1, dtype=None, name=None):
    return _in_place(x, softmax(x, axis, dtype))


def elu_(x, alpha=1.0, name=None):
    return _in_place(x, elu(x, alpha))


def tanh_(x, name=None):
    return _in_place(x, tanh(x))
