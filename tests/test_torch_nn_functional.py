"""The port's ``nn.functional`` (``paddle_tpu_torch/nn/functional``)
against the JAX reference's (``paddle_tpu.nn.functional``), eager, on
the CPU: the activations, the common functionals, the losses, the
norms, the pools and the public flash entry.

Each case runs one functional on both sides from the same numpy inputs
(``RandomState`` seeds) as eager ``Tensor``s, and compares the outputs'
values, dtype names and shapes, then the gradients of ``sum(out *
cot)`` with respect to every floating input, through ``paddle.grad`` on
both sides (the cotangent from the same seed). Tolerances:

- fp32 values and gradients within 1e-5 relative (``np.allclose``,
  ``rtol=1e-5, atol=1e-6``), unless a case states its own;
- integer outputs (``one_hot``, the pools' masks) bit for bit.

Inputs sit at the traps where the reference's formulas differ from
PyTorch's functions of the same name: the kinks and bounds of the
activations (0, the thresholds, the clip bounds), ties in a pool window
(integer-valued inputs), padding and ``ceil_mode``, adaptive pools over
sizes that do not divide, every ``interpolate`` mode at a shrinking and
a growing non-integer scale, CTC's impossible alignment, each
``reduction``, ``ignore_index`` and ``weight``.

The random ops cannot match threefry's bits, so the dropout family and
``gumbel_softmax`` are held by their properties (as
``tests/test_torch_random.py`` holds the draws), through
``tests/torch_nn_checks.py`` ``dropout_properties`` on the CPU's
generator (``chip_smoke.py`` phase 36 runs it on the card): the drop
share within 6 standard errors of ``p``; kept entries exactly ``x / (1
- p)``, numpy's fp32 quotient, which the reference's kept entries equal
too (checked here); whole channels for ``dropout2d``/``dropout3d``;
``alpha_dropout``'s mean and variance; the gradient equal to the mask's
scale; the same draws after ``paddle.seed``; rows of ``gumbel_softmax``
summing to 1 and one-hot under ``hard``.

Two differences from the reference's conventions are pinned here
(``ROADMAP.md`` Queue C, reference caveats): ``interpolate`` ignores
``align_corners`` outside the 2-D nearest and bilinear modes, and
``flash_attn_unpadded`` ignores its ``scale``.

The file collects one test that runs every case
(``tests/torch_checks.py`` says why).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as RP
import paddle_tpu_torch as PT
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.framework.dtype import dtype_name
from torch_checks import run_checks
from torch_nn_checks import dropout_properties

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
rng = np.random.RandomState(0)


class A:
    """A tensor argument: the same numpy array on both sides."""

    def __init__(self, arr, grad=None):
        self.arr = np.asarray(arr)
        self.grad = grad if grad is not None else self.arr.dtype.kind == "f"


def _n(*shape):
    return A(rng.normal(size=shape).astype(np.float32))


def _u(lo, hi, *shape):
    return A(rng.uniform(lo, hi, shape).astype(np.float32))


def _i(lo, hi, *shape, dt=np.int64):
    return A(rng.randint(lo, hi, shape).astype(dt))


def _ties(*shape):
    """Integer-valued floats: every pool window holds ties."""
    return A(rng.randint(-2, 3, shape).astype(np.float32))


# the activations' kinks and bounds, with ordinary values around them
KINK = A(np.array([[0.0, -0.0, 0.5, -0.5, 1.0, -1.0, 3.0, -3.0],
                   [6.0, 20.0, 25.0, -25.0, 0.25, -0.7, 2.2, -1.6]],
                  np.float32))


def case(fn_name, /, *args, tol=None, grad=True, check=None, **kw):
    return dict(name=fn_name, args=args, kw=kw, tol=tol, grad=grad,
                check=check)


# ----------------------------------------------------------- comparisons
def _dt(t):
    if isinstance(t, RP.Tensor):
        return np.dtype(t.dtype).name
    return dtype_name(t.dtype)


def _np(t):
    return np.asarray(t.numpy())


def close(r, p, what, tol=None):
    r, p = np.asarray(r), np.asarray(p)
    if r.shape != p.shape:
        raise AssertionError(f"{what}: shape {p.shape} != {r.shape}")
    if r.dtype.kind in "biu":
        if not np.array_equal(r, p):
            raise AssertionError(f"{what}: {p} != {r}")
        return
    rtol, atol = tol or (RTOL, ATOL)
    r64, p64 = r.astype(np.float64), p.astype(np.float64)
    if not np.array_equal(np.isnan(r64), np.isnan(p64)):
        raise AssertionError(f"{what}: NaNs at other places")
    if not np.allclose(p64, r64, rtol=rtol, atol=atol, equal_nan=True):
        err = np.nanmax(np.abs(p64 - r64))
        raise AssertionError(f"{what}: max diff {err:.3e} (rtol {rtol}, "
                             f"atol {atol})\nport {p}\nreference {r}")


def compare(r, p, what, tol=None):
    if isinstance(r, (tuple, list)):
        assert isinstance(p, (tuple, list)) and len(p) == len(r), what
        for k, (a, b) in enumerate(zip(r, p)):
            compare(a, b, f"{what}[{k}]", tol)
        return
    if r is None:
        assert p is None, f"{what}: {p!r}, not None"
        return
    assert isinstance(p, PT.Tensor), f"{what}: {type(p).__name__}"
    if _dt(r) != _dt(p):
        raise AssertionError(f"{what}: dtype {_dt(p)} != {_dt(r)}")
    close(_np(r), _np(p), what, tol)


def _build(args, S):
    out = []
    for a in args:
        if isinstance(a, A):
            t = S.to_tensor(a.arr)
            if a.grad:
                t.stop_gradient = False
            out.append(t)
        else:
            out.append(a)
    return out


def _floats(out):
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return [o for o in outs
            if isinstance(o, (RP.Tensor, PT.Tensor)) and "float" in _dt(o)]


def _side(c, S):
    fn = getattr(S.nn.functional, c["name"])
    names = list(c["kw"])
    built = _build([*c["args"], *c["kw"].values()], S)
    n = len(c["args"])
    out = fn(*built[:n], **dict(zip(names, built[n:])))
    if not c["grad"]:
        return out, None
    outs = _floats(out)
    live = [t for t in built if isinstance(t, (RP.Tensor, PT.Tensor))
            and not t.stop_gradient]
    loss = None
    for k, o in enumerate(outs):
        cot = np.random.RandomState(k + 1).normal(size=o.shape).astype(
            np.float32)
        term = (o * S.to_tensor(cot)).sum()
        loss = term if loss is None else loss + term
    return out, S.grad(loss, live)


def check_case(name, k):
    c = CASES[k]
    r, r_grads = _side(c, RP)
    p, p_grads = _side(c, PT)
    if c["check"] is not None:
        c["check"](r, p)
    else:
        compare(r, p, "out", c["tol"])
    if c["grad"]:
        compare(list(r_grads), list(p_grads), "grad", c["tol"])


# ------------------------------------------------------------------ cases
X = _n(2, 3, 4, 5)
X4 = _n(2, 4, 6, 6)
ACT = [case(n, KINK) for n in (
    "relu", "relu6", "gelu", "sigmoid", "tanh", "elu", "selu", "celu",
    "silu", "swish", "mish", "hardswish", "hardsigmoid", "hardtanh",
    "hardshrink", "softshrink", "tanhshrink", "softplus", "softsign",
    "log_sigmoid", "thresholded_relu", "leaky_relu")]
ACT += [
    case("gelu", KINK, approximate=True),
    case("elu", KINK, alpha=0.7), case("celu", KINK, alpha=1.5),
    case("selu", KINK, scale=1.2, alpha=1.1),
    case("leaky_relu", KINK, negative_slope=0.2),
    case("hardtanh", KINK, min=-0.5, max=2.2),
    case("hardsigmoid", KINK, slope=0.2, offset=0.3),
    case("hardshrink", KINK, threshold=1.0),
    case("softshrink", KINK, threshold=1.0),
    case("softplus", KINK, beta=2.0, threshold=10.0),
    case("thresholded_relu", KINK, threshold=0.25),
    case("softmax", X), case("softmax", X, axis=1),
    case("softmax", X, axis=2, dtype="float64"),
    case("log_softmax", X), case("log_softmax", X, axis=0, dtype="float32"),
    case("prelu", X, _u(0.1, 0.3, 3)),
    case("prelu", X, A(np.array([0.2], np.float32))),
    case("prelu", _n(2, 4, 5, 3), _u(0.1, 0.3, 3), data_format="NHWC"),
    case("maxout", X4, 2), case("maxout", _ties(2, 3, 4, 6), 3, axis=-1),
    case("glu", X4), case("glu", X4, axis=1),
    case("relu", KINK, name="r"),
]

POOL = [
    case("max_pool1d", _ties(2, 3, 11), 3, 2, 1),
    case("max_pool1d", _n(2, 3, 10), 3, 2, 0, ceil_mode=True),
    case("max_pool2d", _ties(2, 3, 9, 9), 3, 2, 1),
    case("max_pool2d", _n(2, 3, 9, 8), 2, ceil_mode=True),
    case("max_pool2d", _n(2, 3, 8, 8), 3, 2, "SAME"),
    case("max_pool2d", _n(2, 8, 8, 3), 2, 2, 0, data_format="NHWC"),
    case("max_pool3d", _ties(1, 2, 5, 6, 5), 2, 2, 1),
    case("max_pool3d", _n(1, 2, 5, 5, 5), 3, 2, [0, 1, 1, 0, 0, 1]),
    case("avg_pool1d", _n(2, 3, 11), 3, 2, 1),
    case("avg_pool1d", _n(2, 3, 11), 3, 2, 1, exclusive=False),
    case("avg_pool2d", _n(2, 3, 9, 9), 3, 2, 1),
    case("avg_pool2d", _n(2, 3, 9, 9), 3, 2, 1, exclusive=False),
    case("avg_pool2d", _n(2, 3, 9, 8), 2, ceil_mode=True),
    case("avg_pool3d", _n(1, 2, 6, 5, 6), 2, 2, 1),
    case("avg_pool3d", _n(1, 2, 5, 6, 5), 3, 2, 0, ceil_mode=True),
    case("adaptive_avg_pool1d", _n(2, 3, 12), 4),
    case("adaptive_avg_pool1d", _n(2, 3, 10), 4),
    case("adaptive_avg_pool2d", _n(2, 3, 7, 9), (3, 4)),
    case("adaptive_avg_pool2d", _n(2, 6, 8, 3), 4, data_format="NHWC"),
    case("adaptive_avg_pool3d", _n(1, 2, 6, 5, 7), (2, 3, 4)),
    case("adaptive_max_pool1d", _ties(2, 3, 12), 4),
    case("adaptive_max_pool1d", _ties(2, 3, 10), 4),
    case("adaptive_max_pool2d", _ties(2, 3, 8, 8), 4),
    case("adaptive_max_pool2d", _ties(2, 3, 7, 9), (3, 4)),
    case("adaptive_max_pool3d", _ties(1, 2, 4, 6, 4), 2),
    case("adaptive_max_pool3d", _n(1, 2, 5, 6, 7), (2, 3, 3)),
    # return_mask: the reference's flattened index, first maximum of a
    # tie, lowest-finite padding
    case("max_pool1d", _ties(2, 3, 11), 3, 2, 1, return_mask=True),
    case("max_pool2d", _ties(2, 3, 9, 9), 3, 2, 1, return_mask=True),
    case("max_pool2d", _n(2, 3, 9, 8), 2, return_mask=True,
         ceil_mode=True),
    case("max_pool3d", _ties(1, 2, 5, 6, 5), 2, 2, 1, return_mask=True),
    case("adaptive_max_pool1d", _ties(2, 3, 12), 4, return_mask=True),
    case("adaptive_max_pool2d", _ties(2, 3, 8, 8), 4, return_mask=True),
    case("adaptive_max_pool3d", _ties(1, 2, 4, 6, 4), 2, return_mask=True),
]


def _pooled(x, ks, nd):
    """A max pool's values and mask, the unpools' inputs on both sides
    (the port's pool on torch tensors: nothing of JAX at import)."""
    fn = getattr(PT.nn.functional, f"max_pool{nd}d")
    v, m = fn(torch.from_numpy(x), ks, return_mask=True)
    return v.numpy(), m.numpy()


UNPOOL = []
for _nd, _shape in ((1, (2, 3, 8)), (2, (2, 3, 6, 8)), (3, (1, 2, 4, 6, 4))):
    _v, _m = _pooled(rng.normal(size=_shape).astype(np.float32), 2, _nd)
    UNPOOL.append(case(f"max_unpool{_nd}d", A(_v), A(_m, grad=False), 2))
UNPOOL.append(case("max_unpool2d", A(_pooled(rng.normal(size=(1, 2, 6, 6))
                                             .astype(np.float32), 2, 2)[0]),
                   A(_pooled(rng.normal(size=(1, 2, 6, 6))
                             .astype(np.float32), 2, 2)[1], grad=False), 2,
                   output_size=[7, 7]))

IMG = _n(2, 3, 8, 8)
NHWC = _n(2, 8, 8, 3)
INTERP = []
for _sf in (0.7, 1.7):
    INTERP += [
        case("interpolate", IMG, scale_factor=_sf),
        case("interpolate", IMG, scale_factor=_sf, align_corners=True),
        case("interpolate", IMG, scale_factor=_sf, mode="bilinear"),
        case("interpolate", IMG, scale_factor=_sf, mode="bilinear",
             align_corners=True),
        case("interpolate", IMG, scale_factor=_sf, mode="bilinear",
             align_mode=1),
        case("interpolate", NHWC, scale_factor=_sf, mode="bilinear",
             data_format="NHWC"),
        case("interpolate", IMG, scale_factor=_sf, mode="bicubic"),
        case("interpolate", IMG, scale_factor=_sf, mode="area"),
        case("interpolate", _n(2, 3, 10), scale_factor=_sf, mode="linear"),
        case("interpolate", _n(2, 3, 10), scale_factor=_sf),
        case("interpolate", _n(1, 2, 5, 6, 4), scale_factor=_sf,
             mode="trilinear"),
        case("interpolate", _n(1, 2, 5, 6, 4), scale_factor=_sf),
    ]
INTERP += [case("interpolate", IMG, size=[5, 11], mode="bicubic"),
           case("interpolate", IMG, size=[13, 6], mode="bilinear"),
           case("upsample", IMG, scale_factor=2, mode="bilinear"),
           case("upsample", IMG, size=[4, 12])]

COMMON = [
    case("linear", _n(3, 5), _n(5, 4), _n(4), name="l"),
    case("linear", _n(2, 3, 5), _n(5, 4)),
    case("one_hot", A(np.array([[0, 3], [5, -1], [2, 2]], np.int64)), 4,
         grad=False),
    case("label_smooth", _u(0, 1, 3, 5)),
    case("label_smooth", _u(0, 1, 3, 5), _u(0, 1, 1, 5), epsilon=0.2),
    case("pad", X, [1, 2, 0, 3]),
    case("pad", X, [1, 2, 0, 3], value=1.5),
    case("pad", X, [0, 0, 1, 0, 2, 1, 1, 3]),
    case("pad", X, [2, 1, 1, 3], mode="reflect"),
    case("pad", X, [4, 1, 2, 0], mode="replicate"),
    case("pad", X, [3, 1, 2, 5], mode="circular"),
    case("pad", _n(2, 4, 5, 3), [2, 1, 1, 2], mode="reflect",
         data_format="NHWC"),
    case("pad", _n(2, 3, 7), [2, 3], mode="replicate", data_format="NCL"),
    case("pad", _n(1, 2, 3, 4, 5), [1, 1, 2, 0, 0, 2], mode="circular",
         data_format="NCDHW"),
    case("zeropad2d", X, [1, 2, 3, 0]),
    case("normalize", X), case("normalize", X, p=1, axis=-1),
    case("cosine_similarity", _n(4, 6), _n(4, 6)),
    case("cosine_similarity", _n(2, 3, 5), _n(2, 3, 5), axis=-1),
    case("pairwise_distance", _n(4, 6), _n(4, 6)),
    case("pairwise_distance", _n(4, 6), _n(4, 6), p=1.0, keepdim=True),
    case("unfold", IMG, 3), case("unfold", IMG, [2, 3], 2, 1, 1),
    case("unfold", IMG, 3, 1, [1, 0, 2, 1], 2),
    case("fold", _n(2, 12, 49), [8, 8], 2),
    case("fold", _n(2, 27, 36), [8, 8], 3, 1, 1, 2),
    case("bilinear", _n(4, 5), _n(4, 3), _n(6, 5, 3), _n(1, 6)),
    case("bilinear", _n(4, 5), _n(4, 3), _n(6, 5, 3)),
    case("pixel_shuffle", _n(2, 8, 3, 4), 2),
    case("pixel_shuffle", _n(2, 3, 4, 18), 3, data_format="NHWC"),
    case("pixel_unshuffle", _n(2, 2, 6, 4), 2),
    case("pixel_unshuffle", _n(2, 6, 4, 2), 2, data_format="NHWC"),
    case("channel_shuffle", _n(2, 6, 3, 4), 3),
    case("channel_shuffle", _n(2, 3, 4, 6), 2, data_format="NHWC"),
    case("affine_grid", _n(2, 2, 3), [2, 3, 5, 4]),
    case("affine_grid", _n(2, 2, 3), [2, 3, 5, 4], align_corners=False),
    case("grid_sample", _n(2, 3, 6, 5), _u(-1.1, 1.1, 2, 4, 7, 2)),
    case("grid_sample", _n(2, 3, 6, 5), _u(-1.1, 1.1, 2, 4, 7, 2),
         mode="nearest", padding_mode="border", align_corners=False),
    case("grid_sample", _n(2, 3, 6, 5), _u(-1.1, 1.1, 2, 4, 7, 2),
         align_corners=False),
    case("diag_embed", _n(2, 4)), case("diag_embed", _n(2, 4), offset=1),
    case("diag_embed", _n(2, 3, 4), offset=-2, dim1=0, dim2=2),
    case("dropout", X, 0.0), case("dropout", X, 0.5, training=False),
    case("dropout", X, 0.3, training=False, mode="downscale_in_infer"),
    case("dropout", X, 1.0), case("dropout2d", X, 0.4, training=False),
    case("alpha_dropout", X, 0.4, training=False),
] + UNPOOL + INTERP

LOGITS = _n(6, 5)
LABELS = A(np.array([1, 0, 4, 3, 1, 2], np.int64))
IGN = A(np.array([1, -100, 4, 3, -100, 2], np.int64))
W5 = _u(0.5, 2.0, 5)
LOSS = [
    case("cross_entropy", LOGITS, LABELS),
    case("cross_entropy", LOGITS, IGN, W5),
    case("cross_entropy", LOGITS, IGN, reduction="sum"),
    case("cross_entropy", LOGITS, LABELS, reduction="none"),
    case("cross_entropy", LOGITS, A(LABELS.arr.reshape(6, 1)),
         label_smoothing=0.1),
    case("cross_entropy", LOGITS, _u(0, 1, 6, 5), soft_label=True),
    case("cross_entropy", _n(2, 5, 3), A(rng.randint(0, 5, (2, 3))),
         axis=1, ignore_index=2),
    case("cross_entropy", _u(0.05, 1, 6, 5), LABELS, use_softmax=False),
    case("softmax_with_cross_entropy", LOGITS, A(LABELS.arr.reshape(6, 1))),
    case("softmax_with_cross_entropy", LOGITS, _u(0, 1, 6, 5),
         soft_label=True, return_softmax=True),
    case("nll_loss", A(np.log(rng.dirichlet(np.ones(5), 6))
                       .astype(np.float32)), IGN, W5),
    case("nll_loss", _n(3, 5, 4), A(rng.randint(0, 5, (3, 4))),
         reduction="sum"),
    case("nll_loss", _n(6, 5), LABELS, reduction="none"),
    case("mse_loss", X, _n(2, 3, 4, 5)),
    case("mse_loss", X, _n(2, 3, 4, 5), reduction="sum"),
    case("l1_loss", X, _n(2, 3, 4, 5), reduction="none"),
    case("smooth_l1_loss", X, _n(2, 3, 4, 5)),
    case("smooth_l1_loss", X, _n(2, 3, 4, 5), delta=0.5, reduction="sum"),
    case("binary_cross_entropy", _u(0.05, 0.95, 4, 3), _u(0, 1, 4, 3),
         _u(0.5, 2, 4, 3)),
    case("binary_cross_entropy_with_logits", _n(4, 3), _u(0, 1, 4, 3),
         pos_weight=_u(0.5, 2, 3), reduction="none"),
    case("kl_div", _n(4, 5), _u(0, 1, 4, 5)),
    case("kl_div", _n(4, 5), _u(0, 1, 4, 5), reduction="batchmean"),
    case("kl_div", _n(4, 5), _u(0, 1, 4, 5), reduction="none"),
    case("margin_ranking_loss", _n(6), _n(6),
         A(np.array([1, -1, 1, 1, -1, -1], np.float32)), margin=0.3),
    case("hinge_embedding_loss",
         A(np.array([0.2, 1.0, 1.5, -0.3], np.float32)),
         A(np.array([1, -1, -1, 1], np.float32))),
    case("cosine_embedding_loss", _n(5, 4), _n(5, 4),
         A(np.array([1, -1, 1, -1, -1], np.float32)), margin=0.1),
    case("triplet_margin_loss", _n(5, 4), _n(5, 4), _n(5, 4)),
    case("triplet_margin_loss", _n(5, 4), _n(5, 4), _n(5, 4), p=1.0,
         swap=True, reduction="sum"),
    case("log_loss", _u(0.05, 0.95, 5, 1), _u(0, 1, 5, 1)),
    case("square_error_cost", _n(4, 3), _n(4, 3)),
    case("sigmoid_focal_loss", _n(6, 3), A((rng.rand(6, 3) > 0.5)
                                           .astype(np.float32))),
    case("sigmoid_focal_loss", _n(6, 3), A((rng.rand(6, 3) > 0.5)
                                           .astype(np.float32)),
         A(np.array([4.0], np.float32)), reduction="mean"),
    case("soft_margin_loss", _n(4, 5),
         A(np.sign(rng.normal(size=(4, 5))).astype(np.float32))),
    case("poisson_nll_loss", _n(4, 5), _u(0, 4, 4, 5)),
    case("poisson_nll_loss", _u(0.1, 3, 4, 5), A(rng.randint(0, 5, (4, 5))
                                                 .astype(np.float32)),
         log_input=False, full=True),
    case("gaussian_nll_loss", _n(4, 5), _n(4, 5), _u(0.1, 2, 4, 5)),
    case("gaussian_nll_loss", _n(4, 5), _n(4, 5), _u(0.1, 2, 4, 5),
         full=True, reduction="sum"),
    case("multi_margin_loss", LOGITS, LABELS),
    case("multi_margin_loss", LOGITS, LABELS, p=2, margin=0.5, weight=W5,
         reduction="none"),
    case("dice_loss", A(rng.dirichlet(np.ones(4), (2, 3)).astype(
        np.float32)), A(rng.randint(0, 4, (2, 3, 1)))),
    case("npair_loss", _n(4, 6), _n(4, 6), A(np.array([0, 1, 0, 2],
                                                      np.float32))),
    case("rank_loss", _u(0, 1, 5, 1), _n(5, 1), _n(5, 1)),
    case("bpr_loss", LOGITS, A(LABELS.arr.reshape(6, 1))),
]

# CTC: [T, B, C] logits; batch 1 is an impossible alignment (a repeated
# label needs a blank between: 3 labels "1 1 1" need 5 steps, T = 4)
CTC_LP = _n(4, 3, 4)
CTC_LAB = A(np.array([[1, 2, 0], [1, 1, 1], [3, 0, 0]], np.int32))
CTC_IN = A(np.array([4, 4, 3], np.int32))
CTC_LEN = A(np.array([2, 3, 1], np.int32))
LOSS += [case("ctc_loss", CTC_LP, CTC_LAB, CTC_IN, CTC_LEN,
              reduction=r) for r in ("mean", "sum", "none")]
LOSS += [case("ctc_loss", CTC_LP, CTC_LAB, CTC_IN, CTC_LEN, blank=3,
              norm_by_times=True, reduction="none")]

NORM = [
    case("instance_norm", X), case("instance_norm", X, weight=_n(3),
                                   bias=_n(3)),
    case("instance_norm", _n(2, 5, 4, 3), weight=_n(3), bias=_n(3),
         data_format="NHWC"),
    case("group_norm", X4, 2), case("group_norm", X4, 2, 1e-3, _n(4),
                                    _n(4)),
    case("group_norm", _n(2, 5, 6, 4), 2, weight=_n(4), bias=_n(4),
         data_format="NHWC"),
    case("local_response_norm", X4, 3),
    case("local_response_norm", _n(2, 7, 3, 3), 4, 1e-3, 0.6, 2.0),
    case("local_response_norm", _n(2, 3, 3, 5), 3, data_format="NHWC"),
]

Q = _n(2, 8, 2, 16)
K = _n(2, 8, 2, 16)
V = _n(2, 8, 2, 16)
FLASH = [
    case("flash_attention", Q, K, V),
    case("flash_attention", Q, K, V, causal=True),
    case("scaled_dot_product_attention", Q, K, V, is_causal=True, name="a"),
]

CASES = ACT + POOL + COMMON + LOSS + NORM + FLASH


# ------------------------------------------------------ cases by hand
def _pt(arr, grad=False):
    t = PT.to_tensor(arr)
    t.stop_gradient = not grad
    return t


def check_in_place_forms():
    """``relu_``, ``softmax_``, ``elu_``, ``tanh_`` rebind the tensor to
    the reference's result."""
    for name, kw in (("relu_", {}), ("softmax_", {"axis": 0}),
                     ("elu_", {"alpha": 0.5}), ("tanh_", {})):
        outs = []
        for S in (RP, PT):
            t = S.to_tensor(KINK.arr)
            got = getattr(S.nn.functional, name)(t, **kw)
            assert got is t, name
            outs.append(_np(t))
        close(outs[0], outs[1], name)


def check_interpolate_ignores_align_corners_off_2d():
    """A reference caveat pinned (ROADMAP Queue C): outside the 2-D
    nearest and bilinear modes the reference resizes with
    ``jax.image.resize``, which has no ``align_corners``; the port
    follows it."""
    x = IMG.arr
    for S in (RP, PT):
        F = S.nn.functional
        for mode in ("bicubic", "area"):
            a = F.interpolate(S.to_tensor(x), scale_factor=1.7, mode=mode)
            b = F.interpolate(S.to_tensor(x), scale_factor=1.7, mode=mode,
                              align_corners=True)
            assert np.array_equal(_np(a), _np(b)), (S.__name__, mode)
        lin = F.interpolate(S.to_tensor(x[:, :, 0]), scale_factor=0.7,
                            mode="linear", align_corners=True)
        assert np.array_equal(_np(lin), _np(F.interpolate(
            S.to_tensor(x[:, :, 0]), scale_factor=0.7, mode="linear"))), S


def check_flash_attention_routes():
    """CPU tensors take SDPA (the reference's off-TPU route); under
    ``flash_route()`` they take the kernels' plain versions, the card's
    route; dropout > 0 never does. ``return_softmax`` raises, as the
    reference's does."""
    from paddle_tpu_torch.ops import flash_attention as fa

    F = PT.nn.functional
    q, k, v = (PT.to_tensor(a.arr) for a in (Q, K, V))
    want = _np(RP.nn.functional.flash_attention(
        *(RP.to_tensor(a.arr) for a in (Q, K, V)), causal=True)[0])
    seen = []
    real = fa.flash_fwd_plain

    def spy(*a, **kw):
        seen.append(1)
        return real(*a, **kw)

    fa.flash_fwd_plain = spy
    try:
        F.flash_attention(q, k, v, causal=True)
        assert not seen, "a CPU tensor took the flash route"
        with F.flash_route():
            out, sm = F.flash_attention(q, k, v, causal=True)
            assert seen and sm is None
            n = len(seen)
            F.flash_attention(q, k, v, dropout=0.1, causal=True)
            assert len(seen) == n, "dropout > 0 took the flash route"
    finally:
        fa.flash_fwd_plain = real
    close(want, _np(out), "flash route (plain kernels) vs reference")
    for S in (RP, PT):
        with pytest.raises(ValueError, match="return_softmax"):
            S.nn.functional.flash_attention(
                S.to_tensor(Q.arr), S.to_tensor(K.arr), S.to_tensor(V.arr),
                return_softmax=True)


def check_flash_attn_unpadded():
    """Equal lengths run as one batch and match the reference; the
    reference's ``scale`` is not read (ROADMAP Queue C), nor the port's;
    unequal lengths raise on both sides."""
    q, k, v = (a.arr.reshape(16, 2, 16) for a in (Q, K, V))
    cu = np.array([0, 8, 16], np.int32)
    outs = {}
    for S in (RP, PT):
        F = S.nn.functional
        for scale in (0.25, 1.0 / math.sqrt(16)):
            out, sm = F.flash_attn_unpadded(
                S.to_tensor(q), S.to_tensor(k), S.to_tensor(v),
                S.to_tensor(cu), S.to_tensor(cu), 8, 8, scale, causal=True)
            assert sm is None
            outs[(S, scale)] = _np(out)
        assert np.array_equal(outs[(S, 0.25)], outs[(S, 0.25 * 1.0)])
        assert np.array_equal(outs[(S, 0.25)],
                              outs[(S, 1.0 / math.sqrt(16))]), S
        with pytest.raises(NotImplementedError):
            bad = np.array([0, 6, 16], np.int32)
            F.flash_attn_unpadded(S.to_tensor(q), S.to_tensor(k),
                                  S.to_tensor(v), S.to_tensor(bad),
                                  S.to_tensor(bad), 10, 10, 0.25)
    close(outs[(RP, 0.25)], outs[(PT, 0.25)], "flash_attn_unpadded")


def check_ctc_impossible_alignment_is_finite():
    """The reference's -1e30 "unreachable" gives a large finite loss, not
    inf, for batch 1 (three repeated labels in four steps)."""
    for S in (RP, PT):
        loss = S.nn.functional.ctc_loss(
            *(S.to_tensor(a.arr) for a in (CTC_LP, CTC_LAB, CTC_IN,
                                           CTC_LEN)), reduction="none")
        got = _np(loss)
        assert np.isfinite(got).all() and got[1] > 1e29, (S.__name__, got)


# ---------------------------------------------------- random: properties
def check_dropout_properties():
    """The draws' properties on the CPU's generator
    (``torch_nn_checks.dropout_properties``, which ``chip_smoke.py``
    runs on the card)."""
    dropout_properties(torch.device("cpu"))


def check_reference_keeps_the_true_quotient():
    """The reference's kept entries are ``x / (1 - p)`` rounded once, the
    fp32 quotient the port's are held to."""
    x = np.random.RandomState(3).uniform(0.5, 2.0, (64, 128)).astype(
        np.float32)
    for p in (0.1, 0.5, 0.9):
        r = _np(RP.nn.functional.dropout(RP.to_tensor(x), p=p))
        keep = r != 0
        want = x / np.float32(1 - p)
        assert np.array_equal(r[keep], want[keep]), p


def test_nn_functional_matches_reference():
    prev = list(port_device._CURRENT)
    PT.set_device("cpu")
    try:
        run_checks([(check_case, (c["name"], k))
                    for k, c in enumerate(CASES)]
                   + [(f, ()) for f in (
                       check_in_place_forms,
                       check_interpolate_ignores_align_corners_off_2d,
                       check_flash_attention_routes,
                       check_flash_attn_unpadded,
                       check_ctc_impossible_alignment_is_finite,
                       check_dropout_properties,
                       check_reference_keeps_the_true_quotient)])
    finally:
        port_device._CURRENT[:] = prev
