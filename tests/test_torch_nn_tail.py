"""The tail of the port's ``nn`` against the JAX reference's, eager, on
the CPU: the sequence ops (``nn/functional/sequence.py``), the
fluid-era functionals and ``gather_tree`` (``nn/functional/common.py``),
the last four losses and ``HSigmoidLoss``, and ``nn.utils``.

Each functional case runs on both sides from the same numpy inputs as
eager ``Tensor``s (``tests/test_torch_nn_functional.py``'s harness) and
compares the outputs' values, dtype names and shapes, then the gradients
of ``sum(out * cot)`` with respect to every floating input. Tolerances:
fp32 within 1e-5 relative (``np.allclose``, ``rtol=1e-5, atol=1e-6``);
integer outputs (masks, lengths, indices, ``gather_tree``'s ids, the
sampled classes) bit for bit; NaNs at the same places.

The cases sit at the edges: a sequence of length 0 and one of the full
length in every sequence op (``sequence_pool``'s max of an empty
sequence is ``-inf`` on both sides), host-sized outputs
(``sequence_expand`` with a count of 0, ``filter_by_instag`` keeping
nothing, ``sequence_slice`` of length 0), ``margin_cross_entropy``'s
``arccos`` at exactly +-1 and past it (the reference's infinite and NaN
gradients), a CSR row with no entries and a pattern shorter than the
columns' width in ``sparse_attention``, the
guide at 0 and 1 in ``bilateral_slice`` (the grid's edges clamped).
``class_center_sample`` draws with numpy's global generator: after the
same ``np.random.seed`` both sides sample the same classes.
``center_loss`` updates its centers in place on both sides.

``nn.utils``: ``weight_norm``/``remove_weight_norm`` and
``spectral_norm`` on ``Linear`` and ``Conv2D`` (the effective weight
reaches the layer's own forward, which reads ``self._parameters``) with
the gradients, ``spectral_norm`` over two forwards with the carried
``u``;
``parameters_to_vector``/``vector_to_parameters``; ``clip_grad_norm_``
at norm types 2, 1 and inf; ``clip_grad_value_``.

The file collects one test that runs every case
(``tests/torch_checks.py`` says why).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as RP
import paddle_tpu_torch as PT
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.models.convert import load_layer_state
from test_torch_nn_functional import A, _np, _side, case, close, compare
from torch_checks import run_checks

torch.set_num_threads(2)

rng = np.random.RandomState(23)


def _n(*shape):
    return A(rng.normal(size=shape).astype(np.float32))


def _u(lo, hi, *shape):
    return A(rng.uniform(lo, hi, shape).astype(np.float32))


def _ints(values, dt=np.int64):
    return A(np.asarray(values, dt))


def _ties(*shape):
    return A(rng.randint(-2, 3, shape).astype(np.float32))


# ----------------------------------------------------------- sequence ops
X3 = _n(3, 5, 4)
T3 = _ties(3, 5, 4)
LENS = _ints([5, 0, 2])              # a full length and an empty one
SEQ = [case("sequence_mask", LENS, grad=False),
       case("sequence_mask", LENS, maxlen=7, dtype="float32", grad=False),
       case("sequence_pad", _n(7, 4), 0.5, LENS),
       case("sequence_pad", _n(7, 4), 0.5, LENS, maxlen=6),
       case("sequence_pad", _n(7, 2, 3), A(np.float32(-1.0)), LENS),
       case("sequence_unpad", A(X3.arr, False), LENS, grad=False),
       case("sequence_reverse", X3, LENS), case("sequence_reverse", X3),
       case("sequence_softmax", _n(3, 5), LENS),
       case("sequence_softmax", X3, LENS), case("sequence_softmax", X3),
       case("sequence_first_step", X3, LENS),
       case("sequence_last_step", X3, LENS),
       case("sequence_last_step", X3),
       case("sequence_expand", A(_n(3, 4).arr, False), _ints([2, 0, 3]),
            grad=False),
       case("sequence_slice", X3, _ints([0, 2, 4]), _ints([3, 0, 4])),
       case("sequence_slice", X3, _ints([[1], [0], [3]]),
            _ints([[2], [5], [1]]))]
SEQ += [case("sequence_pool", X3, kind, LENS)
        for kind in ("sum", "average", "sqrt", "max", "min", "first",
                     "last")]
# ties in a window: the max's and min's gradient split as jnp's
SEQ += [case("sequence_pool", T3, "max", LENS),
        case("sequence_pool", T3, "min", LENS),
        case("sequence_pool", X3, "MEAN"),
        case("sequence_pool", T3, "max")]

# ------------------------------------------------------ fluid-era tail
IDS = _ints(rng.randint(0, 10, (4, 2, 3)))
PARENTS = _ints(rng.randint(0, 3, (4, 2, 3)))
EDGES = _ints([[[1, 2], [1, 3], [2, 4], [2, 5], [0, 0]],
               [[1, 2], [2, 3], [3, 4], [0, 0], [0, 0]]])
RANKS = _ints([[1, 1, 0, 2, 1, 3, 2],
               [2, 3, 3, 0, 1, 1, 0],
               [0, 1, 2, 2, 3, 3, 1],
               [3, 2, 1, 1, 0, -1, 2]], np.int32)
# the second pattern one entry short of nnz: its last column is padding
CSR_OFF = _ints([[[0, 2, 2, 5, 6], [0, 1, 3, 4, 5]]], np.int32)
CSR_COL = _ints([[[0, 3, 1, 2, 3, 0], [1, 0, 2, 3, 1, 2]]], np.int32)
GUIDE = A(np.clip(rng.uniform(-0.1, 1.1, (1, 5, 6)), 0.0, 1.0).astype(
    np.float32))
FLUID = [
    case("temporal_shift", _n(4, 8, 3, 3), 2),
    case("temporal_shift", _n(6, 5, 2, 2), 3, shift_ratio=0.4),
    case("gather_tree", IDS, PARENTS, grad=False),
    case("affine_channel", _n(2, 3, 4, 4), _n(3), _n(3)),
    case("affine_channel", _n(2, 4, 4, 3), _n(3), _n(3), data_layout="NHWC"),
    case("cvm", _n(4, 6), _u(0, 5, 4, 2)),
    case("cvm", _n(4, 6), _u(0, 5, 4, 2), use_cvm=False),
    case("im2sequence", _n(2, 3, 6, 7), [2, 3], [2, 1], [1, 0]),
    case("im2sequence", _n(1, 2, 5, 5), 3, 2, [1, 0, 2, 1]),
    case("conv_shift", _n(3, 8), _n(3, 3)),
    case("conv_shift", _n(2, 5), _n(2, 5)),
    case("fsp_matrix", _n(2, 3, 4, 4), _n(2, 5, 4, 4)),
    case("batch_fc", _n(3, 4, 5), _n(3, 5, 6), _n(3, 6)),
    case("batch_fc", _n(3, 4, 5), _n(3, 5, 6)),
    case("correlation", _n(1, 3, 9, 9), _n(1, 3, 9, 9), 2, 3, 2, 1, 1),
    case("correlation", _n(2, 2, 10, 8), _n(2, 2, 10, 8), 1, 1, 2, 2, 2),
    case("filter_by_instag", _n(5, 3), _ints([[1], [2], [3], [1], [4]]),
         _ints([1, 3])),
    case("filter_by_instag", _n(5, 3), _ints([[1], [2], [3], [1], [4]]),
         _ints([9]), out_val_if_empty=-2, grad=False),
    case("filter_by_instag", _n(5, 3), _ints([[1, 5], [2, 6]]), _ints([6]),
         ins_lod=_ints([3, 2])),
    case("inplace_abn", _n(2, 3, 4, 4), A(np.zeros(3, np.float32), False),
         A(np.ones(3, np.float32), False), _n(3), _n(3),
         activation="leaky_relu", alpha=0.2),
    case("inplace_abn", _n(2, 3, 4, 4), A(np.zeros(3, np.float32), False),
         A(np.ones(3, np.float32), False), _n(3), _n(3), training=True,
         activation="elu"),
    case("inplace_abn", _n(2, 3, 4), A(np.zeros(3, np.float32), False),
         A(np.ones(3, np.float32), False)),
    case("bilateral_slice", _n(1, 2, 5, 6), GUIDE, _n(1, 6, 3, 4, 4),
         has_offset=True),
    case("bilateral_slice", _n(1, 2, 5, 6), GUIDE, _n(1, 4, 2, 3, 5)),
    case("tree_conv", _n(2, 5, 3), EDGES, _n(3, 3, 2, 2)),
    case("tree_conv", _n(2, 5, 3), EDGES, _n(3, 3, 1, 4), max_depth=3),
    case("rank_attention", _n(4, 3), RANKS, _n(27, 2)),
    case("sparse_attention", _n(1, 2, 4, 3), _n(1, 2, 4, 3),
         _n(1, 2, 4, 3), CSR_OFF, CSR_COL),
]

# ------------------------------------------------------------ the losses
LBL7 = _ints([0, 2, 5, 6])
PATH_TABLE = _ints([[0, 1, 3], [0, 2, -1], [0, 1, 4], [0, 2, 5]])
PATH_CODE = _ints([[1, 0, 1], [0, 1, -1], [1, 1, 0], [0, 0, 1]])
COS = A(np.array([[1.0, -1.0, 0.3, 1.2, -0.5, 0.9],
                  [0.2, 0.999, -1.0, -0.4, 1.0, 0.0],
                  [-1.3, 0.5, 0.7, -0.2, 0.1, 0.6],
                  [0.4, -0.6, 0.8, 0.0, -0.9, 1.0]], np.float32))
LOSSES = [
    case("hsigmoid_loss", _n(4, 5), LBL7, 7, _n(6, 5), _n(6)),
    case("hsigmoid_loss", _n(4, 5), LBL7, 7, _n(6, 5)),
    case("hsigmoid_loss", _n(3, 5), _ints([0, 1, 1]), 2, _n(1, 5), _n(1)),
    case("hsigmoid_loss", _n(4, 5), LBL7, 7, _n(7, 5), _n(7),
         path_table=PATH_TABLE, path_code=PATH_CODE),
    case("margin_cross_entropy", _u(-0.95, 0.95, 4, 6), _ints([1, 0, 5, 3])),
    case("margin_cross_entropy", _u(-0.95, 0.95, 4, 6), _ints([1, 0, 5, 3]),
         0.9, 0.3, 0.1, 30.0, return_softmax=True, reduction="sum"),
    case("margin_cross_entropy", _u(-0.95, 0.95, 4, 6),
         _ints([[2], [4], [0], [3]]), reduction=None),
    # arccos at +-1 and past it: infinite and NaN gradients, as there
    case("margin_cross_entropy", COS, _ints([0, 4, 1, 5])),
    case("margin_cross_entropy", COS, _ints([3, 1, 0, 2]),
         return_softmax=True, reduction="none"),
    case("center_loss", _n(5, 4), _ints([0, 2, 2, 0, 1]), _n(3, 4),
         update_center=False),
]

CASES = SEQ + FLUID + LOSSES


def check_case(name, k):
    c = CASES[k]
    r, r_grads = _side(c, RP)
    p, p_grads = _side(c, PT)
    compare(r, p, "out", c["tol"])
    if c["grad"]:
        compare(list(r_grads), list(p_grads), "grad", c["tol"])


def _pair(arr, S, grad=False):
    t = S.to_tensor(arr)
    if grad:
        t.stop_gradient = False
    return t


def check_sequence_concat():
    a, b = _n(2, 3, 4).arr, _n(2, 2, 4).arr
    outs, grads = [], []
    for S in (RP, PT):
        ta, tb = _pair(a, S, True), _pair(b, S, True)
        out = S.nn.functional.sequence_concat([ta, tb])
        cot = S.to_tensor(np.random.RandomState(1).normal(
            size=out.shape).astype(np.float32))
        outs.append(out)
        grads.append(S.grad((out * cot).sum(), [ta, tb]))
    compare(outs[0], outs[1], "sequence_concat")
    compare(list(grads[0]), list(grads[1]), "sequence_concat grad")
    assert PT.nn.functional.sequence.sequence_concat is not None


def check_fluid_raises():
    """The options both sides refuse; ``sequence_unpad`` and
    ``sequence_expand`` refuse an input that needs a gradient (the
    reference traces such an op, and they refuse a trace)."""
    for S in (RP, PT):
        F = S.nn.functional
        seq = _pair(X3.arr, S, True)
        with pytest.raises(ValueError):
            F.sequence_unpad(seq, S.to_tensor(LENS.arr))
        with pytest.raises(ValueError):
            F.sequence_expand(seq, S.to_tensor(np.array([1, 2, 0])))
        x = S.to_tensor(np.ones((1, 1, 4, 4), np.float32))
        with pytest.raises(ValueError):
            F.im2sequence(x, 2, out_stride=2)
        with pytest.raises(ValueError):
            F.correlation(x, x, 1, 2, 1, 1, 1)
        with pytest.raises(ValueError):
            F.bilateral_slice(S.to_tensor(np.ones((1, 2, 4, 4), np.float32)),
                              S.to_tensor(np.ones((1, 4, 4), np.float32)),
                              S.to_tensor(np.ones((1, 5, 2, 2, 2),
                                                  np.float32)))


def check_class_center_sample():
    """numpy's global generator draws the negatives: the same seed, the
    same classes, bit for bit; the positives first, then the draw
    sorted."""
    lbl = np.array([[3, 9], [3, 17], [0, 9]], np.int64)
    for seed, n in ((0, 8), (5, 20), (1, 2)):
        outs = []
        for S in (RP, PT):
            np.random.seed(seed)
            outs.append(S.nn.functional.class_center_sample(
                S.to_tensor(lbl), 20, n))
        compare(outs[0], outs[1], f"class_center_sample {seed}")
        remapped, sampled = (_np(t) for t in outs[1])
        assert list(sampled[:4]) == [0, 3, 9, 17]
        assert np.array_equal(sampled[remapped], lbl)


def check_center_loss_updates_centers():
    x, y, c0 = _n(6, 4).arr, np.array([0, 2, 2, 0, 1, 2]), _n(4, 3).arr
    c0 = np.concatenate([c0, c0[:, :1]], 1)[:, :4]
    res = {}
    for S in (RP, PT):
        tx, tc = _pair(x, S, True), _pair(c0, S)
        out = S.nn.functional.center_loss(tx, S.to_tensor(y), tc,
                                          alpha=0.3)
        g = S.grad((out * S.to_tensor(np.arange(6, dtype=np.float32)
                                      .reshape(6, 1))).sum(), [tx])
        res[S] = (out, g[0], _np(tc))
    compare(res[RP][0], res[PT][0], "center_loss")
    compare(res[RP][1], res[PT][1], "center_loss grad")
    close(res[RP][2], res[PT][2], "centers after the update")
    assert np.array_equal(res[PT][2][3], c0[3]), "class 3 moved"
    assert not np.allclose(res[PT][2][0], c0[0])


def check_hsigmoid_layer():
    x = _n(4, 5).arr
    outs = {}
    for S in (RP, PT):
        RP.seed(0)
        layers = [S.nn.HSigmoidLoss(5, 7), S.nn.HSigmoidLoss(5, 7,
                                                             is_custom=True)]
        outs[S] = layers
    for k in range(2):
        ref, port = outs[RP][k], outs[PT][k]
        load_layer_state(port, {n: _np(t) for n, t in
                                ref.state_dict().items()})
        got = []
        for S, layer in ((RP, ref), (PT, port)):
            kw = {} if k == 0 else dict(
                path_table=S.to_tensor(PATH_TABLE.arr),
                path_code=S.to_tensor(PATH_CODE.arr))
            tx = _pair(x, S, True)
            out = layer(tx, S.to_tensor(LBL7.arr), **kw)
            got.append((out, S.grad(out.sum(), [tx] + layer.parameters())))
        compare(got[0][0], got[1][0], f"HSigmoidLoss {k}")
        compare(list(got[0][1]), list(got[1][1]), f"HSigmoidLoss grad {k}")


# --------------------------------------------------------------- nn.utils
def _built(S, cls, *args, ref=None):
    RP.seed(0)
    layer = getattr(S.nn, cls)(*args)
    if ref is not None:
        load_layer_state(layer, {n: _np(t) for n, t in
                                 ref.state_dict().items()})
    return layer


def _forward_grads(layer, S, x, cot_seed):
    tx = _pair(x, S, True)
    out = layer(tx)
    cot = np.random.RandomState(cot_seed).normal(size=out.shape).astype(
        np.float32)
    loss = (out * S.to_tensor(cot)).sum()
    return out, S.grad(loss, [tx] + layer.parameters())


UTIL_LAYERS = (("Linear", (4, 3), (5, 4)), ("Conv2D", (2, 3, 3), (2, 2, 6, 6)))


def check_weight_norm():
    for cls, args, shape in UTIL_LAYERS:
        for dim in (0, 1, None):
            x = _n(*shape).arr
            ref = _built(RP, cls, *args)
            port = _built(PT, cls, *args, ref=ref)
            for S, layer in ((RP, ref), (PT, port)):
                S.nn.utils.weight_norm(layer, dim=dim)
            assert list(port.state_dict()) == list(ref.state_dict()), (
                list(port.state_dict()), list(ref.state_dict()))
            load_layer_state(port, {n: _np(t) for n, t in
                                    ref.state_dict().items()})
            r = _forward_grads(ref, RP, x, 0)
            p = _forward_grads(port, PT, x, 0)
            what = f"weight_norm {cls} dim={dim}"
            compare(r[0], p[0], what)
            compare(list(r[1]), list(p[1]), what + " grad")
            compare(ref.weight, port.weight, what + " weight")
            for S, layer in ((RP, ref), (PT, port)):
                S.nn.utils.remove_weight_norm(layer)
            assert list(port.state_dict()) == list(ref.state_dict())
            compare(ref(RP.to_tensor(x)), port(PT.to_tensor(x)),
                    f"remove_weight_norm {cls}")
            compare(ref.weight, port.weight, "folded weight")


def check_spectral_norm():
    for cls, args, shape in UTIL_LAYERS:
        for iters, dim in ((1, None), (3, 1)):
            x = _n(*shape).arr
            ref = _built(RP, cls, *args)
            port = _built(PT, cls, *args, ref=ref)
            for S, layer in ((RP, ref), (PT, port)):
                S.nn.utils.spectral_norm(layer, n_power_iterations=iters,
                                         dim=dim)
            assert list(port.state_dict()) == list(ref.state_dict())
            for step in range(2):
                r = _forward_grads(ref, RP, x, step)
                p = _forward_grads(port, PT, x, step)
                what = f"spectral_norm {cls} x{iters} dim={dim} step {step}"
                compare(r[0], p[0], what)
                compare(list(r[1]), list(p[1]), what + " grad")
                close(np.asarray(ref._sn_u), port._sn_u.numpy(), what + " u")


def check_parameter_vectors_and_clips():
    xs = [_n(5, 4).arr for _ in range(4)]
    ref = _built(RP, "Linear", 4, 3)
    port = _built(PT, "Linear", 4, 3, ref=ref)
    res = {}
    for S, layer in ((RP, ref), (PT, port)):
        params = layer.parameters()
        vec = S.nn.utils.parameters_to_vector(params)
        g = S.grad((vec * S.to_tensor(np.arange(15, dtype=np.float32)))
                   .sum(), params)
        S.nn.utils.vector_to_parameters(
            S.to_tensor(np.linspace(-1, 1, 15).astype(np.float32)), params)
        after = [_np(p) for p in params]
        clips = []
        for x, (norm_type, max_norm) in zip(xs, ((2.0, 0.5), (1.0, 100.0),
                                                 (float("inf"), 0.3))):
            out = layer(S.to_tensor(x))
            (out * out).sum().backward()
            total = S.nn.utils.clip_grad_norm_(params, max_norm, norm_type)
            clips.append((total, [_np(p.grad) for p in params]))
            layer.clear_gradients()
        out = layer(S.to_tensor(xs[3]))
        (out * out).sum().backward()
        S.nn.utils.clip_grad_value_(params, 0.05)
        clips.append((None, [_np(p.grad) for p in params]))
        res[S] = (vec, g, after, clips)
    compare(res[RP][0], res[PT][0], "parameters_to_vector")
    compare(list(res[RP][1]), list(res[PT][1]), "parameters_to_vector grad")
    for a, b in zip(res[RP][2], res[PT][2]):
        close(a, b, "vector_to_parameters")
    for k, ((tr, gr), (tp, gp)) in enumerate(zip(res[RP][3], res[PT][3])):
        compare(tr, tp, f"clip {k} total")
        for a, b in zip(gr, gp):
            close(a, b, f"clip {k} gradient")
    bad = PT.to_tensor(np.ones(2, np.float32))
    bad.stop_gradient = False
    (bad * float("nan")).sum().backward()
    with pytest.raises(RuntimeError):
        PT.nn.utils.clip_grad_norm_([bad], 1.0, error_if_nonfinite=True)


def test_nn_tail_matches_reference(fresh_mesh):
    prev = list(port_device._CURRENT)
    PT.set_device("cpu")
    try:
        run_checks([(check_case, (c["name"], k))
                    for k, c in enumerate(CASES)]
                   + [(f, ()) for f in (
                       check_sequence_concat, check_fluid_raises,
                       check_class_center_sample,
                       check_center_loss_updates_centers,
                       check_hsigmoid_layer, check_weight_norm,
                       check_spectral_norm,
                       check_parameter_vectors_and_clips)])
    finally:
        port_device._CURRENT[:] = prev
