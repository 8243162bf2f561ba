"""The port's ``nn`` on a device against the same calls on the CPU, and
the dropout family's properties on a device's generator (no JAX:
``chip_smoke.py`` phase 36 and ``tests/test_torch_cuda.py`` run these on
the card, ``tests/test_torch_nn_functional.py`` the properties on the
CPU).

:data:`NN_CASES` holds every functional of ``nn/functional`` that the
feed-forward slice ported (the activations, the common functionals, the
losses, the norms, the pools with ``return_mask``) and every layer of
``nn/layer`` that holds state or calls one, at a few thousand to a
million elements. :func:`nn_case_vs_cpu` runs one on ``torch.Tensor``
inputs made on the CPU from a seed and copied to the device (a layer
built on the CPU and its state copied into one built on the device),
forward and backward of ``sum(out * cot)``, and holds the device's
outputs and gradients against the CPU's: a floating output by its
largest difference over its largest magnitude, a gradient by
:func:`torch_checks.norm_rel`, both within ``NN_RTOL``; an integer
output (a one-hot row, a pool's mask) bit for bit; every output on the
device (no host round trip).

:func:`dropout_properties` holds ``dropout``, ``dropout2d``,
``dropout3d``, ``alpha_dropout`` and ``gumbel_softmax`` to what a draw
must satisfy: the drop share within ``SIGMAS`` standard errors of ``p``;
kept entries exactly ``x / (1 - p)``, the true quotient (numpy's fp32
division); the gradient ``1 / (1 - p)`` on kept entries and 0 elsewhere;
``downscale_in_infer`` keeping ``x`` and scaling by ``1 - p`` at
inference; whole rows along ``axis``, whole channels for
``dropout2d``/``dropout3d``; ``alpha_dropout`` keeping a standard normal
input's mean at 0 and variance at 1; the same draws after
``paddle.seed``, others after another seed; ``gumbel_softmax`` rows on
the simplex, one-hot under ``hard`` with a gradient. Each output on the
device.
"""
import math

import numpy as np
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.framework.modules import torch_parameters
from torch_checks import norm_rel

F = paddle.nn.functional

NN_RTOL = 1e-5
SIGMAS = 6.0


def _is_spec(spec) -> bool:
    return (isinstance(spec, tuple) and len(spec) >= 2
            and isinstance(spec[0], str) and spec[0] in "nutsidc"
            and isinstance(spec[1], tuple))


def _arg(spec, rs):
    """A CPU tensor from ``(kind, shape[, high])``: "n" normal ("c" the
    same without a gradient), "u" uniform in (0.05, 0.95), "t"
    integer-valued floats (ties), "s" signs, "i" int64 in [0, high), "d"
    rows of a Dirichlet; anything else passes as it is."""
    if not _is_spec(spec):
        return spec
    kind, shape = spec[0], spec[1]
    if kind in "nc":
        a = rs.normal(size=shape)
    elif kind == "u":
        a = rs.uniform(0.05, 0.95, shape)
    elif kind == "t":
        a = rs.randint(-2, 3, shape)
    elif kind == "s":
        a = np.sign(rs.normal(size=shape))
    elif kind == "d":
        a = np.log(rs.dirichlet(np.ones(shape[-1]), shape[:-1]))
    else:
        return torch.from_numpy(rs.randint(0, spec[2], shape).astype(
            np.int64))
    return torch.from_numpy(a.astype(np.float32))


def fn_case(name, *args, **kw):
    return ("F", name, args, kw)


def layer_case(name, ctor, inputs, **kw):
    return ("L", name, (ctor, inputs), kw)


N = ("n", (64, 4096))
IMG = ("n", (8, 32, 32, 32))
KINK = ("n", (256, 1024))
LOG = ("n", (4096, 1000))
LBL = ("i", (4096,), 1000)

NN_CASES = [fn_case(a, KINK) for a in (
    "relu", "relu6", "gelu", "sigmoid", "tanh", "elu", "selu", "celu",
    "silu", "swish", "mish", "hardswish", "hardsigmoid", "hardtanh",
    "hardshrink", "softshrink", "tanhshrink", "softplus", "softsign",
    "log_sigmoid", "thresholded_relu", "leaky_relu", "softmax",
    "log_softmax")]
NN_CASES += [
    fn_case("gelu", KINK, approximate=True),
    fn_case("prelu", IMG, ("u", (32,))),
    fn_case("maxout", IMG, 4), fn_case("glu", IMG, axis=1),
    fn_case("softmax", IMG, axis=1),
    # common
    fn_case("one_hot", LBL, 1000),
    fn_case("label_smooth", ("u", (1024, 1000))),
    fn_case("pad", IMG, [2, 1, 3, 0]),
    fn_case("pad", IMG, [2, 1, 3, 0], mode="reflect"),
    fn_case("pad", IMG, [2, 1, 3, 0], mode="replicate"),
    fn_case("pad", IMG, [2, 1, 3, 0], mode="circular"),
    fn_case("zeropad2d", IMG, [1, 1, 2, 2]),
    fn_case("normalize", IMG), fn_case("cosine_similarity", IMG, IMG),
    fn_case("pairwise_distance", N, ("n", (64, 4096))),
    fn_case("interpolate", IMG, scale_factor=1.7),
    fn_case("interpolate", IMG, scale_factor=0.7, mode="bilinear"),
    fn_case("interpolate", IMG, scale_factor=1.7, mode="bilinear",
            align_corners=True),
    fn_case("interpolate", IMG, scale_factor=1.7, mode="bilinear",
            align_mode=1),
    fn_case("interpolate", IMG, scale_factor=1.7, mode="bicubic"),
    fn_case("interpolate", IMG, scale_factor=0.7, mode="area"),
    fn_case("interpolate", ("n", (8, 32, 1024)), scale_factor=0.7,
            mode="linear"),
    fn_case("interpolate", ("n", (2, 8, 16, 16, 16)), scale_factor=1.7,
            mode="trilinear"),
    fn_case("unfold", IMG, 3, 1, 1),
    fn_case("fold", ("n", (8, 288, 1024)), [32, 32], 3, 1, 1),
    fn_case("bilinear", ("n", (512, 64)), ("n", (512, 32)),
            ("n", (16, 64, 32)), ("n", (1, 16))),
    fn_case("pixel_shuffle", IMG, 2), fn_case("pixel_unshuffle", IMG, 2),
    fn_case("channel_shuffle", IMG, 4),
    fn_case("affine_grid", ("n", (8, 2, 3)), [8, 3, 64, 64]),
    fn_case("grid_sample", IMG, ("n", (8, 24, 24, 2))),
    fn_case("grid_sample", IMG, ("n", (8, 24, 24, 2)), mode="nearest",
            padding_mode="border", align_corners=False),
    fn_case("diag_embed", ("n", (64, 128)), offset=1),
    # losses
    fn_case("cross_entropy", LOG, LBL),
    fn_case("cross_entropy", LOG, LBL, ("u", (1000,)), ignore_index=3,
            label_smoothing=0.1),
    fn_case("cross_entropy", LOG, ("u", (4096, 1000)), soft_label=True),
    fn_case("softmax_with_cross_entropy", LOG, ("i", (4096, 1), 1000)),
    fn_case("nll_loss", ("d", (4096, 1000)), LBL, ("u", (1000,))),
    fn_case("mse_loss", N, N), fn_case("l1_loss", N, N, reduction="sum"),
    fn_case("smooth_l1_loss", N, N, delta=0.5),
    fn_case("binary_cross_entropy", ("u", (64, 4096)), ("u", (64, 4096))),
    fn_case("binary_cross_entropy_with_logits", N, ("u", (64, 4096)),
            pos_weight=("u", (4096,))),
    fn_case("kl_div", N, ("u", (64, 4096)), reduction="batchmean"),
    fn_case("margin_ranking_loss", ("n", (8192,)), ("n", (8192,)),
            ("s", (8192,))),
    fn_case("hinge_embedding_loss", ("n", (8192,)), ("s", (8192,))),
    fn_case("cosine_embedding_loss", N, N, ("s", (64,))),
    fn_case("triplet_margin_loss", N, N, N, swap=True),
    fn_case("log_loss", ("u", (8192, 1)), ("u", (8192, 1))),
    fn_case("square_error_cost", N, N),
    fn_case("ctc_loss", ("n", (64, 16, 32)), ("i", (16, 10), 32),
            torch.full((16,), 64, dtype=torch.int32),
            torch.arange(1, 17, dtype=torch.int32).clamp_max(10)),
    fn_case("sigmoid_focal_loss", N, ("u", (64, 4096))),
    fn_case("soft_margin_loss", N, ("s", (64, 4096))),
    fn_case("poisson_nll_loss", N, ("u", (64, 4096)), full=True),
    fn_case("gaussian_nll_loss", N, N, ("u", (64, 4096))),
    fn_case("multi_margin_loss", LOG, LBL, p=2),
    fn_case("dice_loss", ("u", (16, 64, 64, 8)), ("i", (16, 64, 64, 1), 8)),
    fn_case("npair_loss", ("n", (256, 128)), ("n", (256, 128)),
            ("t", (256,))),
    fn_case("rank_loss", ("u", (8192, 1)), ("n", (8192, 1)),
            ("n", (8192, 1))),
    fn_case("bpr_loss", LOG, ("i", (4096, 1), 1000)),
    # norms
    fn_case("instance_norm", IMG, weight=("n", (32,)), bias=("n", (32,))),
    fn_case("group_norm", IMG, 8, weight=("n", (32,)), bias=("n", (32,))),
    fn_case("local_response_norm", IMG, 5),
    # pools
    fn_case("max_pool1d", ("t", (32, 32, 1024)), 3, 2, 1),
    fn_case("max_pool2d", ("t", (8, 32, 64, 64)), 3, 2, 1,
            return_mask=True),
    fn_case("max_pool3d", ("t", (4, 16, 16, 32, 32)), 2, 2, 0,
            return_mask=True),
    fn_case("avg_pool1d", ("n", (32, 32, 1024)), 3, 2, 1),
    fn_case("avg_pool2d", IMG, 3, 2, 1, ceil_mode=True),
    fn_case("avg_pool3d", ("n", (4, 16, 16, 32, 32)), 3, 2, 1,
            exclusive=False),
    fn_case("adaptive_avg_pool1d", ("n", (32, 32, 1000)), 7),
    fn_case("adaptive_avg_pool2d", IMG, 7),
    fn_case("adaptive_avg_pool3d", ("n", (4, 16, 16, 32, 32)), 4),
    fn_case("adaptive_max_pool1d", ("t", (32, 32, 1000)), 7),
    fn_case("adaptive_max_pool2d", ("t", (8, 32, 32, 32)), 4,
            return_mask=True),
    fn_case("adaptive_max_pool3d", ("t", (4, 16, 16, 32, 32)), 5),
    # layers that hold state
    layer_case("PReLU", (32, 0.1), (IMG,)),
    layer_case("Bilinear", (64, 32, 16), (("n", (512, 64)),
                                          ("n", (512, 32)))),
    layer_case("GroupNorm", (8, 32), (IMG,)),
    layer_case("InstanceNorm2D", (32,), (IMG,)),
    layer_case("SyncBatchNorm", (32,), (IMG,)),
    layer_case("AdaptiveLogSoftmaxWithLoss", (256, 10000, [1000, 4000]),
               (("n", (512, 256)), ("i", (512,), 10000))),
    layer_case("Upsample", (), (IMG,), scale_factor=2, mode="bilinear"),
    layer_case("MaxPool2D", (3, 2, 1), (IMG,)),
    layer_case("CrossEntropyLoss", (), (LOG, LBL), label_smoothing=0.1),
]


def flat(out) -> list:
    """An output's tensors, through nested tuples and lists."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat(o)]
    return [out]


def nn_case_label(case) -> str:
    kind, name, _, kw = case
    return name + (f" {kw}" if kw else "")


def _run(case, device, rs_seed, state=None):
    kind, name, args, kw = case
    rs = np.random.RandomState(rs_seed)
    if kind == "F":
        vals = [_arg(a, rs) for a in args]
        kwv = {k: _arg(v, rs) for k, v in kw.items()}
        fn = getattr(F, name)
        layer = None
    else:
        ctor, inputs = args
        vals = [_arg(a, rs) for a in inputs]
        kwv = {}
        layer = getattr(paddle.nn, name)(*ctor, **kw)
        if state is not None:
            layer.set_state_dict(state)
        layer.train()
        fn = layer
    on = [v.to(device, copy=True) if isinstance(v, torch.Tensor) else v
          for v in vals]
    kwo = {k: v.to(device, copy=True) if isinstance(v, torch.Tensor) else v
           for k, v in kwv.items()}
    specs = [*args, *kw.values()] if kind == "F" else list(args[1])
    live = [v for v, sp in zip([*on, *kwo.values()], specs)
            if isinstance(v, torch.Tensor) and v.is_floating_point()
            and not (_is_spec(sp) and sp[0] == "c")]
    for v in live:
        v.requires_grad_()
    params = [] if layer is None else torch_parameters(layer)
    out = fn(*on, **kwo)
    outs = flat(out)
    grs = rs_seed + 1
    loss = None
    for o in outs:
        if o.is_floating_point() and o.requires_grad:
            cot = torch.from_numpy(np.random.RandomState(grs).normal(
                size=tuple(o.shape)).astype(np.float32)).to(device)
            term = (o * cot).sum()
            loss = term if loss is None else loss + term
    grads = []
    if loss is not None:
        grads = torch.autograd.grad(loss, live + params, allow_unused=True)
    return layer, outs, grads


def nn_case_vs_cpu(device, case, seed: int = 0) -> dict:
    """One case on ``device`` against the CPU (the module docstring):
    returns the worst readings ``{"out": ..., "grad": ...}``; raises when
    one is over ``NN_RTOL``, an integer output differs, or an output is
    off the device."""
    prev = list(port_device._CURRENT)
    try:
        paddle.set_device("cpu")
        paddle.seed(seed)
        layer_c, outs_c, grads_c = _run(case, "cpu", seed)
        state = None if layer_c is None else {
            n: t._value.detach().clone()
            for n, t in layer_c.state_dict().items()}
        paddle.set_device(device.type if device.type != "cuda"
                          else f"gpu:{device.index or 0}")
        _, outs_d, grads_d = _run(case, device, seed, state)
    finally:
        port_device._CURRENT[:] = prev
    label = nn_case_label(case)
    worst = {"out": 0.0, "grad": 0.0}
    for k, (a, b) in enumerate(zip(outs_d, outs_c)):
        if a.device.type != torch.device(device).type:
            raise AssertionError(f"{label}: output {k} on {a.device}")
        if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
            raise AssertionError(f"{label}: output {k} {a.dtype} "
                                 f"{tuple(a.shape)} against {b.dtype} "
                                 f"{tuple(b.shape)}")
        a, b = a.detach().cpu(), b.detach()
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: integer output {k} differs")
            continue
        e = float((a.double() - b.double()).abs().max()
                  / b.double().abs().max().clamp_min(1e-30))
        worst["out"] = max(worst["out"], e)
    for a, b in zip(grads_d, grads_c):
        if (a is None) != (b is None):
            raise AssertionError(f"{label}: a gradient is missing on one "
                                 f"side")
        if a is not None:
            worst["grad"] = max(worst["grad"], norm_rel(a.cpu(), b))
    for k, v in worst.items():
        if not v <= NN_RTOL:
            raise AssertionError(f"{label}: {k} {v:.2e}, limit {NN_RTOL}")
    return worst


# ------------------------------------------------------------- dropout
def _share_ok(dropped, n, p, what):
    se = math.sqrt(p * (1 - p) / n)
    share = dropped / n
    if not abs(share - p) <= SIGMAS * se:
        raise AssertionError(f"{what}: dropped {share:.5f}, p {p}, "
                             f"{SIGMAS} standard errors {SIGMAS * se:.5f}")
    return share


def _on(t, device, what):
    if t.device.type != torch.device(device).type:
        raise AssertionError(f"{what} on {t.device}")


def dropout_properties(device, n_rows: int = 64) -> dict:
    """The dropout family and ``gumbel_softmax`` on ``device``'s
    generator (the module docstring). Returns the drop shares read."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.uniform(0.5, 2.0, (n_rows, 1024)).astype(
        np.float32))
    shares = {}
    for p in (0.1, 0.5, 0.9):
        t = x.to(device, copy=True).requires_grad_()
        out = F.dropout(t, p)
        _on(out, device, f"dropout p={p}")
        (g,) = torch.autograd.grad(out.sum(), t)
        out, g = out.detach().cpu().numpy(), g.cpu().numpy()
        keep = out != 0
        shares[f"dropout p={p}"] = _share_ok(int((~keep).sum()), out.size,
                                             p, f"dropout p={p}")
        want = x.numpy() / np.float32(1 - p)
        if not np.array_equal(out[keep], want[keep]):
            raise AssertionError(f"dropout p={p}: kept entries are not "
                                 f"x / (1 - p)")
        scale = np.float32(1) / np.float32(1 - p)
        if not np.array_equal(g, np.where(keep, scale, np.float32(0))):
            raise AssertionError(f"dropout p={p}: gradient not the mask's "
                                 f"scale")
    xd = x.to(device)
    out = F.dropout(xd, 0.5, mode="downscale_in_infer").cpu().numpy()
    keep = out != 0
    if not np.array_equal(out[keep], x.numpy()[keep]):
        raise AssertionError("downscale_in_infer: kept entries not x")
    inf = F.dropout(xd, 0.3, training=False, mode="downscale_in_infer")
    if not torch.equal(inf.cpu(), x * 0.7):
        raise AssertionError("downscale_in_infer at inference: not x * 0.7")
    out = F.dropout(xd, 0.5, axis=1).cpu().numpy()
    if not ((out != 0).all(0) | (out == 0).all(0)).all():
        raise AssertionError("dropout axis=1: a column kept in part")
    shares["dropout axis=1"] = _share_ok(int((out == 0).all(0).sum()),
                                         out.shape[1], 0.5, "axis=1")
    for fn, shape, df, ch in (
            (F.dropout2d, (16, 64, 8, 8), "NCHW", 1),
            (F.dropout2d, (16, 8, 8, 64), "NHWC", 3),
            (F.dropout3d, (8, 64, 2, 4, 4), "NCDHW", 1),
            (F.dropout3d, (8, 2, 4, 4, 64), "NDHWC", 4)):
        v = torch.from_numpy(rs.uniform(0.5, 2.0, shape).astype(np.float32))
        out = fn(v.to(device), 0.5, data_format=df)
        _on(out, device, fn.__name__)
        kept = np.moveaxis(out.cpu().numpy() != 0, ch, 1).reshape(
            shape[0], shape[ch], -1)
        if not (kept.all(-1) | (~kept).all(-1)).all():
            raise AssertionError(f"{fn.__name__} {df}: a channel kept in "
                                 f"part")
        shares[f"{fn.__name__} {df}"] = _share_ok(
            int((~kept.any(-1)).sum()), kept.shape[0] * kept.shape[1], 0.5,
            f"{fn.__name__} {df}")
    z = torch.from_numpy(rs.normal(size=(1 << 18,)).astype(np.float32))
    for p in (0.2, 0.5):
        t = z.to(device, copy=True).requires_grad_()
        out = F.alpha_dropout(t, p)
        _on(out, device, "alpha_dropout")
        (g,) = torch.autograd.grad(out.sum(), t)
        o = out.detach().double().cpu().numpy()
        n = o.size
        if not (abs(o.mean()) <= 3 * SIGMAS / math.sqrt(n)
                and abs(o.var() - 1) <= 3 * SIGMAS * math.sqrt(2.0 / n)):
            raise AssertionError(f"alpha_dropout p={p}: mean {o.mean()}, "
                                 f"variance {o.var()}")
        alpha_p = -1.6732632423543772 * 1.0507009873554805
        a = np.float32(1.0 / np.sqrt((1 - p) * (1 + p * alpha_p ** 2)))
        gv = g.cpu().numpy()
        if not set(np.unique(gv).tolist()) <= {0.0, float(a)}:
            raise AssertionError(f"alpha_dropout p={p}: gradient not the "
                                 f"mask's scale")
        shares[f"alpha_dropout p={p}"] = _share_ok(
            int((gv == 0).sum()), n, p, f"alpha_dropout p={p}")
    ones = torch.ones(64, 64, device=device)

    def draws():
        return [F.dropout(ones, 0.5), F.dropout2d(ones.reshape(4, 16, 8, 8),
                                                  0.5),
                F.alpha_dropout(ones, 0.5), F.gumbel_softmax(ones)]

    paddle.seed(11)
    first = draws()
    paddle.seed(11)
    again = draws()
    paddle.seed(12)
    other = draws()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("a draw did not repeat after paddle.seed")
    if torch.equal(first[0], other[0]):
        raise AssertionError("another seed gave the same dropout mask")
    logits = torch.from_numpy(rs.normal(size=(4096, 8)).astype(np.float32))
    soft = F.gumbel_softmax(logits.to(device), temperature=0.5)
    _on(soft, device, "gumbel_softmax")
    if not torch.allclose(soft.sum(-1).cpu(), torch.ones(4096), atol=1e-5):
        raise AssertionError("gumbel_softmax rows do not sum to 1")
    t = logits.to(device, copy=True).requires_grad_()
    hard = F.gumbel_softmax(t, hard=True)
    h = hard.detach().cpu()
    if not (((h == 0) | (h == 1)).all() and (h.sum(-1) == 1).all()):
        raise AssertionError("gumbel_softmax hard rows are not one-hot")
    (g,) = torch.autograd.grad((hard * t.detach()).sum(), t)
    if not float(g.abs().sum()) > 0:
        raise AssertionError("gumbel_softmax hard: no gradient")
    return shares
