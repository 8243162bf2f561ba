"""The port's ``paddle.*`` op namespace (``paddle_tpu_torch.tensor``)
against the JAX reference's (``paddle_tpu.tensor``), eager, on the CPU.

One case for every name the port exports from ``tensor/``: the same
inputs, made from ``RandomState(0)`` with numpy, go through
``paddle_tpu.<op>`` and ``paddle_tpu_torch.<op>``. Each case compares the
outputs' values, dtype names and shapes, and, for a differentiable op,
the gradients of ``(out * cotangent).sum()`` (the cotangent from the
same seed; run as ``backward`` with the cotangent as its gradient,
which computes the same), with the outputs' ``stop_gradient``.

Tolerances, by the kind of output:

- exact: integer, bool and index outputs, copies and layout ops, and
  ``+ - * /`` (``EXACT``); their gradients too where the backward is a
  copy or a product with the cotangent (``gtol="exact"``);
- at most 4 fp32 ulps of the reference's value (``ULP``) for the other
  elementwise ops (transcendentals, and formulas a compiled reference
  may contract into an FMA);
- ``rtol=1e-5, atol=1e-6`` (``RED``) for reductions, products,
  ``linalg`` and every other gradient;
- the dtype and shape only (``DRAW``) for the random ops, whose bits
  cannot be the reference's (``tests/test_torch_random.py`` holds their
  ranges, moments and determinism).

Where the reference's outputs are defined only up to sign or order
(``qr``, ``svd``, ``eig``, ``eigh``, ``eigvals``), a case compares what
is invariant: the sign-fixed factors, the sorted eigenvalues, and ``A v
= w v`` for the port's vectors.

``DIFFERS`` lists the ops whose result differs from the reference on
purpose, each with the reason; their cases assert that the difference
is what it says (``ROADMAP.md`` Queue C lists them). A last case holds
the reference's exported names that the port lacks to the list in
``ROADMAP.md`` (``Eager names not ported``).

The file collects one test that runs every case
(``tests/torch_checks.py`` says why).
"""
import os
import re

import numpy as np
import scipy.special as sps
import torch

import paddle_tpu as RP
import paddle_tpu_torch as PT
from paddle_tpu.framework import autograd as r_autograd
from paddle_tpu_torch.framework import autograd as p_autograd
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.framework.dtype import dtype_name
from torch_checks import run_checks

torch.set_num_threads(2)

EXACT, ULP, RED, DRAW = "exact", "ulp", "red", "draw"
ROADMAP = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "ROADMAP.md")

# the reference's top-level names outside its op namespace
# (paddle_tpu/__init__.py:15-30)
TOP_LEVEL = [
    "CPUPlace", "CUDAPlace", "Parameter", "Place", "TPUPlace", "Tensor",
    "bfloat16", "complex64", "complex128", "device_count", "enable_grad",
    "float16", "float32", "float64", "get_default_dtype", "get_device",
    "get_flags", "grad", "int8", "int16", "int32", "int64",
    "is_compiled_with_cuda", "is_grad_enabled", "no_grad", "seed",
    "set_default_dtype", "set_device", "set_flags", "set_grad_enabled",
    "to_tensor", "uint8", "bool", "convert_dtype", "get_cuda_rng_state",
    "set_cuda_rng_state", "is_tensor", "enable_static", "disable_static",
    "in_dynamic_mode", "in_static_mode", "create_parameter",
]


class A:
    """A tensor argument: the same numpy array on both sides."""

    def __init__(self, arr, grad=None):
        self.arr = np.asarray(arr)
        self.grad = grad        # None: by dtype (floating arrays get one)


rng = np.random.RandomState(0)


def _u(lo, hi, shape=(3, 4)):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _n(shape=(3, 4)):
    return rng.normal(size=shape).astype(np.float32)


def _i(lo, hi, shape=(3, 4)):
    return rng.randint(lo, hi, shape).astype(np.int32)


P = _u(0.1, 0.9)            # (0, 1): log, sqrt, asin, logit, erfinv, ...
N, N2 = _n(), _n()
G = _u(1.1, 3.0)            # acosh
Q = _u(0.5, 2.0)            # positive bases and divisors
I, I2 = _i(-5, 6), _i(1, 6)
B, B2 = rng.rand(3, 4) > 0.5, rng.rand(3, 4) > 0.5
V, V2 = _n((3,)), _n((3,))
V4 = _n((4,))
M = _n((3, 3)) + 3 * np.eye(3, dtype=np.float32)
SPD = (M @ M.T + 3 * np.eye(3)).astype(np.float32)
T3 = _n((2, 3, 4))
D = np.array([[3.0, 1.0, 3.0, 2.0], [5.0, 5.0, 1.0, 4.0],
              [2.0, 7.0, 7.0, 0.0]], np.float32)    # distinct per row
S8 = np.sort(_n((8,)))
Bt = _n((2, 3, 4))
Bt2 = _n((2, 4, 5))
NEG0 = np.array([0.0, -0.0, 1.5, -2.5, np.inf, -np.inf, np.nan],
                np.float32)
Z = _u(2.5, 5.0)            # away from lgamma's and digamma's zeros
KINK = np.array([[0.0, -0.0, 1.5], [-2.5, 0.0, -0.5]], np.float32)
CONST = np.array([[2.0, 2.0, 2.0], [1.0, 3.0, 2.0]], np.float32)
WIDE = np.array([3e9, -3e9, np.nan, np.inf, -np.inf, 1e20, -7.9],
                np.float32)
I3 = np.array([1, -1, 0], np.int32)


def case(name, *args, tol=RED, grad=True, gtol=RED, fn=None, pfn=None,
         check=None, pick=None, **kw):
    """One op: ``fn`` (default ``paddle_tpu.<name>``) against ``pfn``
    (default ``paddle_tpu_torch.<name>``) on ``args``/``kw``; ``check``
    replaces the value comparison (sign- or order-free ops), ``pick``
    selects the outputs that the gradient's loss reads."""
    return dict(name=name, args=args, kw=kw, tol=tol, grad=grad, gtol=gtol,
                fn=fn, pfn=pfn, check=check, pick=pick)


def _ew(name, *args, tol=ULP, **kw):
    return case(name, *args, tol=tol, **kw)


# --------------------------------------------------------------- comparisons
def _np(t):
    if isinstance(t, RP.Tensor):
        return np.asarray(t.numpy()).astype(
            np.float32 if t.dtype.name == "bfloat16" else t.numpy().dtype)
    return t.numpy()


def _dtname(t):
    if isinstance(t, RP.Tensor):
        return np.dtype(t.dtype).name
    return dtype_name(t.dtype)


def close(r, p, tol, what):
    if r.shape != p.shape:
        raise AssertionError(f"{what}: shape {p.shape} != {r.shape}")
    if tol == DRAW:
        return
    if r.dtype == np.bool_ or np.issubdtype(r.dtype, np.integer):
        if not np.array_equal(r, p):
            raise AssertionError(f"{what}: {p} != {r}")
        return
    r64, p64 = r.astype(np.complex128 if np.iscomplexobj(r) else np.float64), \
        p.astype(np.complex128 if np.iscomplexobj(p) else np.float64)
    nan_r, nan_p = np.isnan(r64), np.isnan(p64)
    if not np.array_equal(nan_r, nan_p):
        raise AssertionError(f"{what}: NaNs at other places")
    r64, p64 = np.where(nan_r, 0, r64), np.where(nan_p, 0, p64)
    if tol == EXACT:
        ok = np.array_equal(r64, p64)
        lim = 0.0
    elif tol == ULP:
        lim = 4 * np.spacing(np.abs(r).astype(np.float32)).astype(np.float64)
        ok = bool(np.all((np.abs(p64 - r64) <= lim) | (p64 == r64)))
    else:
        ok = np.allclose(p64, r64, rtol=1e-5, atol=1e-6)
        lim = 1e-6 + 1e-5 * np.abs(r64)
    if not ok:
        err = np.abs(p64 - r64)
        raise AssertionError(f"{what}: max diff {np.max(err):.3e} "
                             f"(limit {np.max(lim):.3e}, {tol})\n"
                             f"port {p}\nreference {r}")


def compare(r, p, tol, what):
    if isinstance(r, (tuple, list)):
        if not isinstance(p, (tuple, list)) or len(r) != len(p):
            raise AssertionError(f"{what}: {type(p)} of {len(p)} != "
                                 f"{type(r)} of {len(r)}")
        for k, (a, b) in enumerate(zip(r, p)):
            compare(a, b, tol, f"{what}[{k}]")
        return
    if isinstance(r, RP.Tensor):
        if not isinstance(p, PT.Tensor):
            raise AssertionError(f"{what}: {type(p).__name__}, not Tensor")
        if _dtname(r) != _dtname(p):
            raise AssertionError(f"{what}: dtype {_dtname(p)} != "
                                 f"{_dtname(r)}")
        close(_np(r), _np(p), tol, what)
        return
    if r != p:
        raise AssertionError(f"{what}: {p!r} != {r!r}")


def _build(args, side, grads):
    out = []
    for a in args:
        if isinstance(a, A):
            t = side.to_tensor(a.arr)
            want = a.grad if a.grad is not None else (
                grads and a.arr.dtype.kind == "f")
            if want:
                t.stop_gradient = False
            out.append(t)
        elif isinstance(a, list) and a and isinstance(a[0], A):
            out.append(_build(a, side, grads))
        else:
            out.append(a)
    return out


def _leaves(built):
    for t in built:
        if isinstance(t, list):
            yield from _leaves(t)
        elif isinstance(t, (RP.Tensor, PT.Tensor)):
            yield t


def _floats(out):
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return [o for o in outs if isinstance(o, (RP.Tensor, PT.Tensor))
            and "float" in _dtname(o)]


def _run(c, side, grads):
    fn = (c["fn"] if side is RP else c["pfn"]) or getattr(side, c["name"])
    built = _build(c["args"], side, grads)
    return built, fn(*built, **c["kw"])


def check_case(name, k):
    """A differentiable op runs once, with gradients: its values and its
    gradients are both compared from that run."""
    c = CASES[k]
    r_in, r = _run(c, RP, c["grad"])
    p_in, p = _run(c, PT, c["grad"])
    if c["check"] is not None:
        c["check"](r, p, *[a.arr for a in c["args"] if isinstance(a, A)])
    else:
        compare(r, p, c["tol"], "out")
    # in-place ops: the first argument after the call
    if c["name"].endswith("_") or c["name"] == "increment":
        compare(r_in[0], p_in[0], c["tol"], "mutated input")
    if not c["grad"]:
        return
    pick = c["pick"] or _floats
    r_outs, p_outs = pick(r), pick(p)
    if not r_outs:
        raise AssertionError("no floating output to differentiate")
    cots = []
    for k, (ro, po) in enumerate(zip(r_outs, p_outs)):
        if ro.stop_gradient != po.stop_gradient:
            raise AssertionError(f"out[{k}].stop_gradient "
                                 f"{po.stop_gradient} != {ro.stop_gradient}")
        cots.append(np.random.RandomState(k + 1).normal(
            size=ro.shape).astype(np.float32))
    # the gradient of sum_k (out_k * cot_k).sum(), as backward(cot) runs it
    r_autograd.run_backward(r_outs, [RP.to_tensor(c) for c in cots])
    p_autograd.run_backward(p_outs, [PT.to_tensor(c) for c in cots])
    for k, (a, b) in enumerate(zip(_leaves(r_in), _leaves(p_in))):
        if (a.grad is None) != (b.grad is None):
            raise AssertionError(f"grad[{k}]: port {b.grad is None and 'None'}"
                                 f" reference {a.grad is None and 'None'}")
        if a.grad is not None:
            compare(a.grad, b.grad, c["gtol"], f"grad[{k}]")


# ----------------------------------------------- invariant comparisons
def _signfix_cols(m):
    """Each column's sign made so that its largest |entry| is positive."""
    idx = np.argmax(np.abs(m), axis=0)
    s = np.sign(m[idx, np.arange(m.shape[1])])
    return m * np.where(s == 0, 1, s), np.where(s == 0, 1, s)


def check_qr(r, p, *_):
    (rq, rr), (pq, pr) = [[_np(t) for t in o] for o in (r, p)]
    for q, rm in ((rq, rr), (pq, pr)):
        s = np.sign(np.diag(rm))
        q *= s
        rm *= s[:, None]
    close(rq, pq, RED, "Q (diag of R made positive)")
    close(rr, pr, RED, "R")


def check_svd(r, p, *_):
    (ru, rs, rv), (pu, ps, pv) = [[_np(t) for t in o] for o in (r, p)]
    close(rs, ps, RED, "S")
    ru, sr = _signfix_cols(ru)
    pu, sp = _signfix_cols(pu)
    close(ru, pu, RED, "U (column signs fixed)")
    close(rv * sr[:, None], pv * sp[:, None], RED, "Vh (row signs fixed)")


def check_eigh(r, p, *_):
    close(_np(r[0]), _np(p[0]), RED, "eigenvalues")
    close(_signfix_cols(_np(r[1]))[0], _signfix_cols(_np(p[1]))[0], RED,
          "eigenvectors (signs fixed)")
    if _dtname(r[1]) != _dtname(p[1]):
        raise AssertionError("eigenvector dtype")


def _sorted_eig(w):
    return w[np.lexsort((np.round(w.imag, 4), np.round(w.real, 4)))]


def check_eig(r, p, *_):
    close(_sorted_eig(_np(r[0])), _sorted_eig(_np(p[0])), RED,
          "eigenvalues (sorted)")
    w, v = _np(p[0]), _np(p[1])
    close(M.astype(np.complex64) @ v, v * w[None, :], RED, "A v = w v")
    if [_dtname(t) for t in r] != [_dtname(t) for t in p]:
        raise AssertionError("dtypes")


def check_eigvals(r, p, *_):
    close(_sorted_eig(_np(r)), _sorted_eig(_np(p)), RED,
          "eigenvalues (sorted)")


def check_vs_float64(truth):
    """The port within 4 fp32 ulps of the float64 value ``truth(x)`` of
    its input (scipy), and within RED of the reference: the reference's
    XLA lgamma, digamma and polygamma are 8 to 47 ulps from it."""
    def check(r, p, x):
        t = truth(x.astype(np.float64))
        lim = 4 * np.spacing(np.abs(t).astype(np.float32)).astype(np.float64)
        err = np.abs(_np(p).astype(np.float64) - t)
        if not np.all(err <= lim):
            raise AssertionError(f"port {np.max(err / lim) * 4:.2f} ulps "
                                 "from the float64 value")
        compare(r, p, RED, "out")
    return check


def _getitem_ref(x, idx):
    return x[idx]


# ------------------------------------------------------------------- cases
CASES = [
    # attribute
    case("shape", A(T3), tol=EXACT, grad=False),
    case("rank", A(T3), tol=EXACT, grad=False),
    case("is_floating_point", A(N), grad=False),
    case("is_integer", A(I), grad=False),
    case("is_complex", A(N), grad=False),
    # creation
    case("to_tensor", [[1, 2], [3, 4]], tol=EXACT, grad=False),
    case("zeros", [2, 3], tol=EXACT, grad=False),
    case("ones", [2, 3], "int32", tol=EXACT, grad=False),
    case("full", [2, 3], 7, tol=EXACT, grad=False),
    case("empty", [2, 3], tol=EXACT, grad=False),
    case("zeros_like", A(N), tol=EXACT, grad=False),
    case("ones_like", A(I), tol=EXACT, grad=False),
    case("full_like", A(N), 2.5, tol=EXACT, grad=False),
    case("empty_like", A(N), tol=EXACT, grad=False),
    case("arange", 1, 11, 3, tol=EXACT, grad=False),
    case("linspace", 0.0, 1.0, 7, tol=ULP, grad=False),
    case("logspace", 0.0, 2.0, 5, tol=ULP, grad=False),
    case("eye", 3, 4, tol=EXACT, grad=False),
    case("diag", A(V), 1, tol=EXACT, gtol=EXACT),
    case("diagflat", A(V), -1, tol=EXACT, gtol=EXACT),
    case("tril", A(N), 1, tol=EXACT, gtol=EXACT),
    case("triu", A(N), -1, tol=EXACT, gtol=EXACT),
    case("meshgrid", A(V), A(V4), tol=EXACT, gtol=EXACT),
    case("assign", A(N), tol=EXACT, gtol=EXACT),
    case("clone", A(N), tol=EXACT, gtol=EXACT),
    case("numel", A(T3), tol=EXACT, grad=False),
    case("complex", A(V), A(V2), tol=EXACT, grad=False),
    case("real", A(N), tol=EXACT, gtol=EXACT),
    case("imag", A(N), tol=EXACT, grad=False),
    # elementwise binary
    case("add", A(N), A(N2), tol=EXACT, gtol=EXACT),
    case("subtract", A(N), A(N2), tol=EXACT, gtol=EXACT),
    case("multiply", A(N), A(N2), tol=EXACT, gtol=EXACT),
    case("divide", A(N), A(Q), tol=EXACT),
    case("floor_divide", A(I), A(I2), tol=EXACT, grad=False),
    case("remainder", A(I), A(I2), tol=EXACT, grad=False),
    case("mod", A(N), A(Q), tol=ULP, grad=False),
    case("floor_mod", A(I), -3, tol=EXACT, grad=False),
    case("pow", A(Q), A(N), tol=ULP),
    case("maximum", A(N), A(N2), tol=EXACT, gtol=EXACT),
    case("minimum", A(N), A(N2), tol=EXACT, gtol=EXACT),
    case("fmax", A(N), A(N2), tol=EXACT),
    case("fmin", A(N), A(N2), tol=EXACT),
    _ew("atan2", A(N), A(N2)),
    case("heaviside", A(N), A(N2), tol=EXACT, grad=False),
    case("inner", A(N), A(N2)),
    case("outer", A(V), A(V4), tol=EXACT),
    _ew("logaddexp", A(N), A(N2)),
    case("nextafter", A(N), A(N2), tol=EXACT, grad=False),
    case("copysign", A(N), A(N2), tol=EXACT, gtol=EXACT),
    case("gcd", A(I), A(I2), tol=EXACT, grad=False),
    case("lcm", A(I), A(I2), tol=EXACT, grad=False),
    case("atan2", A(I), A(I2), tol=ULP, grad=False),
    # unary
    case("abs", A(N), tol=EXACT, gtol=EXACT),
    case("neg", A(N), tol=EXACT, gtol=EXACT),
    _ew("exp", A(N)), _ew("expm1", A(N)), _ew("log", A(Q)),
    _ew("log2", A(Q)), _ew("log10", A(Q)), _ew("log1p", A(P)),
    _ew("sqrt", A(Q)), _ew("rsqrt", A(Q)),
    case("square", A(N), tol=EXACT),
    case("sign", A(N), tol=EXACT),
    _ew("sin", A(N)), _ew("cos", A(N)), _ew("tan", A(P)), _ew("asin", A(P)),
    _ew("acos", A(P)), _ew("atan", A(N)), _ew("sinh", A(N)),
    _ew("cosh", A(N)), _ew("tanh", A(N)), _ew("asinh", A(N)),
    _ew("acosh", A(G)), _ew("atanh", A(P)),
    case("ceil", A(N), tol=EXACT, gtol=EXACT),
    case("floor", A(N), tol=EXACT, gtol=EXACT),
    case("round", A(N * 3), tol=EXACT, gtol=EXACT),
    case("trunc", A(N * 3), tol=EXACT, gtol=EXACT),
    case("frac", A(N * 3), tol=EXACT, gtol=EXACT),
    _ew("reciprocal", A(Q)), _ew("erf", A(N)), _ew("erfinv", A(P)),
    case("lgamma", A(Z), check=check_vs_float64(sps.gammaln)),
    case("digamma", A(Z), check=check_vs_float64(sps.digamma)),
    _ew("logit", A(P)),
    _ew("logit", A(P), eps=0.2), _ew("sigmoid", A(N)),
    case("isfinite", A(NEG0), tol=EXACT, grad=False),
    case("isnan", A(NEG0), tol=EXACT, grad=False),
    case("isinf", A(NEG0), tol=EXACT, grad=False),
    case("nan_to_num", A(NEG0), tol=EXACT, grad=False),
    case("scale", A(N), 2.5, 0.5),
    case("scale", A(N), 2.5, 0.5, bias_after_scale=False),
    case("scale", A(I), 2, 1, tol=EXACT, grad=False),
    case("increment", A(N, grad=False), 2.0, tol=EXACT, grad=False),
    case("clip", A(N), -0.5, 0.5, tol=EXACT, gtol=EXACT),
    case("clip", A(I), 1.5, 3, tol=EXACT, grad=False),
    _ew("lerp", A(N), A(N2), 0.3),
    _ew("lerp", A(N), A(N2), A(P)),
    _ew("stanh", A(N)),
    _ew("rad2deg", A(N)), _ew("deg2rad", A(N)),
    case("angle", A(N), tol=EXACT, grad=False),
    case("conj", A(N), tol=EXACT, gtol=EXACT),
    case("diff", A(N), tol=EXACT, gtol=EXACT),
    case("diff", A(N), 2, 0, tol=EXACT, gtol=EXACT),
    case("trace", A(N), 1),
    # reductions
    case("sum", A(N)), case("sum", A(N), 1, keepdim=True),
    case("sum", A(B), 0, tol=EXACT, grad=False),
    case("sum", A(I), [0, 1], tol=EXACT, grad=False),
    case("mean", A(N), [0, 1]), case("mean", A(I), 1, grad=False),
    case("prod", A(Q), 1), case("prod", A(I2), None, tol=EXACT, grad=False),
    case("max", A(N), 1, tol=EXACT), case("min", A(N), None, tol=EXACT),
    case("amax", A(N), 0, True, tol=EXACT),
    case("amin", A(N), -1, tol=EXACT),
    case("nansum", A(NEG0[[0, 2, 3, 6]]), tol=EXACT, grad=False),
    case("nanmean", A(NEG0[[0, 2, 3, 6]]), grad=False),
    case("std", A(N), 1), case("var", A(N), None, False),
    case("median", A(N), 1), case("median", A(T3), None),
    case("quantile", A(N), 0.3, 1), case("quantile", A(N), [0.25, 0.5]),
    case("logsumexp", A(N), 1),
    case("all", A(B), 1, tol=EXACT, grad=False),
    case("any", A(I), None, tol=EXACT, grad=False),
    case("count_nonzero", A(I), 1, tol=EXACT, grad=False),
    # cumulative
    case("cumsum", A(N), 1), case("cumsum", A(I), tol=EXACT, grad=False),
    case("cumsum", A(np.full((5,), 100, np.int8)), tol=EXACT, grad=False),
    case("cumprod", A(Q), 0),
    case("cumprod", A(np.full((3,), 100, np.int8)), tol=EXACT, grad=False),
    case("cummax", A(N), 1, tol=EXACT, gtol=EXACT),
    case("cummin", A(N), tol=EXACT, gtol=EXACT),
    case("logcumsumexp", A(N), 1, tol=ULP),
    # products
    case("matmul", A(N), A(N2.T.copy())),
    case("matmul", A(N), A(N2), transpose_y=True),
    case("mm", A(N), A(N2.T.copy())),
    case("dot", A(N), A(N2)), case("dot", A(V), A(V2)),
    case("bmm", A(Bt), A(Bt2)), case("mv", A(N), A(V4)),
    case("addmm", A(M), A(N), A(N2.T.copy()), beta=0.5, alpha=2.0),
    case("kron", A(V), A(N)),
    case("multiply_", A(N, grad=False), A(N2), tol=EXACT, gtol=EXACT),
    case("add_", A(N), A(N2), tol=EXACT, gtol=EXACT),
    case("subtract_", A(N), A(N2), tol=EXACT, gtol=EXACT),
    case("divide_", A(N), A(Q), tol=EXACT),
    case("scale_", A(N), 2.5, 0.5),
    case("clip_", A(N), -0.5, 0.5, tol=EXACT, gtol=EXACT),
    case("cdist", A(N), A(N2)), case("cdist", A(N), A(N2), 0),
    case("take", A(N), A(np.array([[0, 11], [-1, 5]], np.int32)),
         tol=EXACT, gtol=EXACT),
    case("renorm", A(N), 2.0, 0, 1.0),
    case("frexp", A(N * 5), tol=EXACT, grad=False),
    case("trapezoid", A(N)), case("trapezoid", A(N), A(np.sort(N2, 1))),
    case("cumulative_trapezoid", A(N), dx=0.5),
    case("vander", A(V), 4, tol=ULP),
    case("nanmedian", A(NEG0[[0, 2, 3, 6]]), grad=False),
    case("polygamma", A(Q), 1,
         check=check_vs_float64(lambda x: sps.polygamma(1, x))),
    _ew("i0", A(N)), _ew("i0e", A(N)),
    case("positive", A(N), tol=EXACT, gtol=EXACT),
    case("negative", A(N), tol=EXACT, gtol=EXACT),
    case("conj_physical", A(N), tol=EXACT, gtol=EXACT),
    case("ldexp", A(N), A(I), tol=EXACT, grad=False),
    _ew("hypot", A(N), A(N2)),
    case("signbit", A(NEG0), tol=EXACT, grad=False),
    case("isreal", A(N), tol=EXACT, grad=False),
    case("isposinf", A(NEG0), tol=EXACT, grad=False),
    case("isneginf", A(NEG0), tol=EXACT, grad=False),
    case("broadcast_shape", [3, 1, 4], [2, 1], grad=False),
    case("add_n", [A(N), A(N2), A(P)], tol=EXACT, gtol=EXACT),
    case("tanh_", A(N, grad=False), tol=ULP, grad=False),
    # logic
    case("equal", A(I), A(I2), tol=EXACT, grad=False),
    case("not_equal", A(I), 2, tol=EXACT, grad=False),
    case("greater_than", A(N), A(N2), tol=EXACT, grad=False),
    case("greater_equal", A(I), A(I2), tol=EXACT, grad=False),
    case("less_than", A(N), 0.5, tol=EXACT, grad=False),
    case("less_equal", A(I), A(I2), tol=EXACT, grad=False),
    case("logical_and", A(B), A(B2), tol=EXACT, grad=False),
    case("logical_or", A(B), A(I), tol=EXACT, grad=False),
    case("logical_xor", A(B), A(B2), tol=EXACT, grad=False),
    case("logical_not", A(I), tol=EXACT, grad=False),
    case("bitwise_and", A(I), A(I2), tol=EXACT, grad=False),
    case("bitwise_or", A(I), A(I2), tol=EXACT, grad=False),
    case("bitwise_xor", A(B), A(B2), tol=EXACT, grad=False),
    case("bitwise_not", A(I), tol=EXACT, grad=False),
    case("equal_all", A(I), A(I), tol=EXACT, grad=False),
    case("allclose", A(N), A(N + 1e-7), tol=EXACT, grad=False),
    case("isclose", A(N), A(N2), tol=EXACT, grad=False),
    case("is_empty", A(N), tol=EXACT, grad=False),
    case("is_tensor", A(N), grad=False),
    # manipulation
    case("reshape", A(T3), [0, 4, -1], tol=EXACT, gtol=EXACT),
    case("reshape_", A(T3), [6, 4], tol=EXACT, gtol=EXACT),
    case("flatten", A(T3), 1, tol=EXACT, gtol=EXACT),
    case("transpose", A(T3), [2, 0, 1], tol=EXACT, gtol=EXACT),
    case("t", A(N), tol=EXACT, gtol=EXACT),
    case("moveaxis", A(T3), 0, 2, tol=EXACT, gtol=EXACT),
    case("swapaxes", A(T3), 0, 2, tol=EXACT, gtol=EXACT),
    case("squeeze", A(_n((3, 1, 4, 1))), [1, 2], tol=EXACT, gtol=EXACT),
    case("squeeze_", A(_n((3, 1, 4))), tol=EXACT, gtol=EXACT),
    case("unsqueeze", A(N), [0, -1], tol=EXACT, gtol=EXACT),
    case("unsqueeze_", A(N), 1, tol=EXACT, gtol=EXACT),
    case("concat", [A(N), A(N2)], 1, tol=EXACT, gtol=EXACT),
    case("stack", [A(N), A(N2)], -1, tol=EXACT, gtol=EXACT),
    case("unstack", A(T3), 1, tol=EXACT, gtol=EXACT),
    case("unbind", A(T3), tol=EXACT, gtol=EXACT),
    case("split", A(T3), [1, -1, 1], 2, tol=EXACT, gtol=EXACT),
    case("split", A(T3), 2, tol=EXACT, gtol=EXACT),
    case("chunk", A(T3), 2, 2, tol=EXACT, gtol=EXACT),
    case("tile", A(N), [2, 1, 2], tol=EXACT),
    case("expand", A(_n((3, 1))), [2, -1, 4], tol=EXACT),
    case("expand_as", A(V4), A(T3), tol=EXACT, gtol=EXACT),
    case("broadcast_to", A(V4), [3, 4], tol=EXACT, gtol=EXACT),
    case("broadcast_tensors", [A(V4), A(_n((3, 1)))], tol=EXACT,
         gtol=EXACT),
    case("flip", A(T3), [0, 2], tol=EXACT, gtol=EXACT),
    case("roll", A(N), 2, tol=EXACT, gtol=EXACT),
    case("roll", A(N), [1, -1], [0, 1], tol=EXACT, gtol=EXACT),
    case("rot90", A(N), 3, tol=EXACT, gtol=EXACT),
    case("gather", A(N), A(np.array([2, 0, 2], np.int32)), tol=EXACT),
    case("gather", A(N), A(np.array([[3], [1]], np.int32)), 1, tol=EXACT),
    case("gather_nd", A(T3), A(np.array([[1, 2], [0, 1]], np.int32)),
         tol=EXACT, gtol=EXACT),
    case("scatter", A(N), A(np.array([2, 0], np.int32)), A(N2[:2]),
         tol=EXACT, gtol=EXACT),
    case("scatter", A(N), A(np.array([2, 0, 2], np.int32)), A(N2),
         overwrite=False, tol=EXACT),
    case("scatter_", A(N, grad=False), A(np.array([1], np.int32)),
         A(N2[:1]), tol=EXACT, grad=False),
    case("scatter_nd_add", A(N), A(np.array([[1, 2], [1, 2], [0, 3]],
                                            np.int32)),
         A(V), tol=EXACT, gtol=EXACT),
    case("scatter_nd", A(np.array([[1], [0], [1]], np.int32)), A(N[:, :2]),
         [3, 2], tol=EXACT, gtol=EXACT),
    case("index_select", A(N), A(np.array([3, 0, 3], np.int32)), 1,
         tol=EXACT),
    case("index_sample", A(N), A(np.array([[0, 3], [1, 1], [2, 0]],
                                          np.int32)), tol=EXACT),
    case("take_along_axis", A(N), A(np.array([[0, 3, 1]], np.int32)), 1,
         tol=EXACT),
    case("put_along_axis", A(N), A(np.array([[0], [3], [1]], np.int32)),
         A(V[:, None]), 1, tol=EXACT, gtol=EXACT),
    case("put_along_axis", A(N), A(np.array([[0], [3], [1]], np.int32)),
         2.0, 1, reduce="add", tol=EXACT, gtol=EXACT),
    case("masked_select", A(N), A(B), tol=EXACT, grad=False),
    case("masked_fill", A(N), A(B), -1.0, tol=EXACT, gtol=EXACT),
    case("repeat_interleave", A(N), 2, 1, tol=EXACT),
    case("repeat_interleave", A(V), A(np.array([1, 0, 2], np.int32)),
         tol=EXACT),
    case("unique", A(np.array([3, 1, 3, 2, 1, 5], np.int32)),
         return_index=True, return_counts=True, tol=EXACT, grad=False),
    case("unique", A(np.array([[2, 1], [1, 3]], np.int32)),
         return_inverse=True, tol=EXACT, grad=False),
    case("unique", A(np.array([[1, 2], [0, 1], [1, 2]], np.int32)),
         return_inverse=True, axis=0, tol=EXACT, grad=False),
    case("unique_consecutive", A(np.array([1, 1, 2, 2, 3, 1, 1], np.int32)),
         return_inverse=True, return_counts=True, tol=EXACT, grad=False),
    case("slice", A(T3), [0, 2], [1, -3], [2, 10], tol=EXACT, gtol=EXACT),
    case("strided_slice", A(T3), [1, 2], [2, 0], [-4, 4], [-1, 2],
         tol=EXACT, gtol=EXACT),
    case("as_real", A(np.array([1 + 2j, 3 - 1j], np.complex64)),
         tol=EXACT, grad=False),
    case("as_complex", A(_n((3, 2))), tol=EXACT, grad=False),
    case("tensordot", A(T3), A(_n((4, 3, 2))), [[1, 2], [1, 0]]),
    case("atleast_1d", A(np.float32(2.0)), tol=EXACT, gtol=EXACT),
    case("atleast_2d", A(V), tol=EXACT, gtol=EXACT),
    case("atleast_3d", A(N), tol=EXACT, gtol=EXACT),
    case("view", A(T3), [4, 6], tol=EXACT, gtol=EXACT),
    case("view", A(N), "int32", tol=EXACT, grad=False),
    case("cast", A(N * 3), "int32", tol=EXACT, grad=False),
    case("cast", A(N), "bfloat16", tol=EXACT),
    case("unflatten", A(N), 1, [2, -1], tol=EXACT, gtol=EXACT),
    case("as_strided", A(N), [2, 3], [1, 2], 1, tol=EXACT, gtol=EXACT),
    case("tensor_split", A(T3), 3, 2, tol=EXACT, gtol=EXACT),
    case("tensor_split", A(T3), [1, 3], 2, tol=EXACT, gtol=EXACT),
    case("hsplit", A(T3), 3, tol=EXACT, gtol=EXACT),
    case("vsplit", A(T3), [1], tol=EXACT, gtol=EXACT),
    case("dsplit", A(T3), 2, tol=EXACT, gtol=EXACT),
    case("hstack", [A(V), A(V4)], tol=EXACT, gtol=EXACT),
    case("vstack", [A(V4), A(N)], tol=EXACT, gtol=EXACT),
    case("dstack", [A(N), A(N2)], tol=EXACT, gtol=EXACT),
    case("column_stack", [A(V), A(N[:, :2])], tol=EXACT, gtol=EXACT),
    case("row_stack", [A(N), A(N2)], tol=EXACT, gtol=EXACT),
    case("crop", A(T3), [1, -1, 2], [1, 1, 1], tol=EXACT, gtol=EXACT),
    case("index_add", A(N), A(np.array([2, 0, 2], np.int32)), 1,
         A(_n((3, 3))), tol=EXACT, gtol=EXACT),
    case("index_put", A(N), [A(np.array([0, 2], np.int32)),
                             A(np.array([1, 3], np.int32))], A(V[:2]),
         tol=EXACT, gtol=EXACT),
    case("masked_scatter", A(N), A(B), A(_n((12,))), tol=EXACT,
         gtol=EXACT),
    case("reverse", A(N), 1, tol=EXACT, gtol=EXACT),
    case("diagonal", A(T3), 1, 1, 2, tol=EXACT, gtol=EXACT),
    case("multiplex", [A(N), A(N2)], A(np.array([[1], [0], [1]], np.int32)),
         tol=EXACT, gtol=EXACT),
    case("shard_index", A(np.array([[1], [6], [12], [19]], np.int32)), 20,
         2, 1, tol=EXACT, grad=False),
    case("fill_diagonal", A(N), 5.0, 1, tol=EXACT, gtol=EXACT),
    case("fill_diagonal", A(_n((7, 3))), -2.0, wrap=True, tol=EXACT,
         gtol=EXACT),
    case("fill_diagonal_", A(N, grad=False), 5.0, tol=EXACT, grad=False),
    case("partial_concat", [A(N), A(N2)], 1, 2, tol=EXACT, gtol=EXACT),
    case("partial_sum", [A(N), A(N2)], 1, 2, tol=EXACT, gtol=EXACT),
    case("pad_constant_like", A(_n((4, 5))), A(N), 0.5, tol=EXACT,
         gtol=EXACT),
    # search
    case("argmax", A(D), tol=EXACT, grad=False),
    case("argmax", A(D), 1, True, tol=EXACT, grad=False),
    case("argmin", A(D), 0, tol=EXACT, grad=False),
    case("argmax", A(B), 1, tol=EXACT, grad=False),
    case("argsort", A(N), 1, True, tol=EXACT, grad=False),
    case("sort", A(N), 0, tol=EXACT, gtol=EXACT),
    case("topk", A(N), 2, tol=EXACT, gtol=EXACT),
    case("topk", A(N), 2, 0, largest=False, tol=EXACT, gtol=EXACT),
    case("where", A(B), A(N), A(N2), tol=EXACT, gtol=EXACT),
    case("where", A(B), 0.5, A(N2), tol=EXACT, gtol=EXACT),
    case("where", A(I), tol=EXACT, grad=False),
    case("where_", A(B), A(N, grad=False), A(N2), tol=EXACT, grad=False),
    case("nonzero", A(I), tol=EXACT, grad=False),
    case("nonzero", A(B), True, tol=EXACT, grad=False),
    case("searchsorted", A(S8), A(N), tol=EXACT, grad=False),
    case("searchsorted", A(S8), A(S8[[1, 4]]), right=True, tol=EXACT,
         grad=False),
    case("bucketize", A(N), A(S8), tol=EXACT, grad=False),
    case("kthvalue", A(N), 2, 1, tol=EXACT, gtol=EXACT),
    case("mode", A(np.array([[1, 2, 2, 3, 3], [4, 4, 1, 1, 0]], np.int32)),
         tol=EXACT, grad=False),
    # linalg
    case("norm", A(N)), case("norm", A(N), 1, 1),
    case("norm", A(T3), "fro", [1, 2], True),
    case("norm", A(N), np.inf, 0), case("norm", A(N), 3, None),
    case("dist", A(N), A(N2)), case("dist", A(N), A(N2), np.inf),
    case("cond", A(M)), case("cross", A(N[:, :3].T.copy()), A(N2[:, :3].T.copy())),
    case("cholesky", A(SPD)), case("cholesky", A(SPD), True),
    case("cholesky_solve", A(N[:, :2]),
         A(np.linalg.cholesky(SPD).astype(np.float32))),
    case("qr", A(N.T.copy()), check=check_qr, grad=False),
    case("svd", A(N), check=check_svd, pick=lambda o: [o[1]]),
    case("eig", A(M), check=check_eig, grad=False),
    case("eigh", A(SPD), check=check_eigh, pick=lambda o: [o[0]]),
    case("eigvals", A(M), check=check_eigvals, grad=False),
    case("eigvalsh", A(SPD)),
    case("inv", A(M)), case("pinv", A(N)),
    case("solve", A(M), A(N[:, :2])),
    case("triangular_solve", A(np.triu(M)), A(N[:, :2])),
    case("triangular_solve", A(np.tril(M)), A(N[:, :2]), upper=False,
         transpose=True),
    case("lstsq", A(N.T.copy()), A(V4[:, None]), grad=False),
    case("lu", A(M), grad=False),
    case("matrix_power", A(M * 0.5), 3),
    case("matrix_rank", A(N), tol=EXACT, grad=False),
    case("det", A(M)), case("slogdet", A(M)),
    case("multi_dot", [A(N), A(N2.T.copy()), A(M)]),
    case("histogram", A(N), 5, tol=EXACT, grad=False),
    case("histogram", A(P), 4, 0, 1, tol=EXACT, grad=False),
    case("bincount", A(np.array([1, 3, 3, 0, 5], np.int32)), tol=EXACT,
         grad=False),
    case("bincount", A(np.array([1, 3, 3, 0], np.int32)), A(V4), tol=EXACT),
    case("corrcoef", A(N)), case("cov", A(N), False),
    case("einsum", "ij,kj->ik", A(N), A(N2)),
    case("einsum", "bij,bjk->bk", A(Bt), A(Bt2)),
    # the Tensor surface the models use
    case("getitem", A(T3), (1, slice(None, None, 2)), tol=EXACT, gtol=EXACT,
         fn=_getitem_ref),
    # the kinks, zeros, out-of-range values and negative indices where
    # the port once differed (ROADMAP.md Queue C, closed)
    case("clip", A(np.array([1.0, 2.0, 3.0], np.float32)), 1.0, 3.0,
         tol=EXACT, gtol=EXACT),
    case("clip", A(KINK), -0.5, 0.0, tol=EXACT, gtol=EXACT),
    case("abs", A(KINK), tol=EXACT, gtol=EXACT),
    case("norm", A(KINK), 1), case("norm", A(KINK), 1, 1),
    case("dist", A(KINK), A(np.zeros_like(KINK)), 1),
    case("std", A(CONST), 1), case("var", A(CONST), 1),
    case("std", A(CONST[0])),
    _ew("atan2", A(np.array([0.0, 1.0, 0.0], np.float32)),
        A(np.array([0.0, 2.0, -1.0], np.float32))),
    case("cast", A(np.array([-1.0, 300.0, np.nan], np.float32)), "uint8",
         tol=EXACT, grad=False),
    case("cast", A(np.array([200.0, -200.0, 5.7], np.float32)), "int8",
         tol=EXACT, grad=False),
    case("cast", A(WIDE), "int32", tol=EXACT, grad=False),
    case("cast", A(WIDE), "int64", tol=EXACT, grad=False),
    case("cast", A(np.array([np.nan, -5.0, 7e4], np.float32)), "int16",
         tol=EXACT, grad=False),
    case("cast", A(np.array([300.0, -1.0], np.float32)), "uint8",
         fn=lambda x, d: x.astype("bfloat16").astype(d),
         pfn=lambda x, d: x.astype("bfloat16").astype(d), tol=EXACT,
         grad=False),
    case("cast", A(WIDE), "int32", fn=lambda x, d: x.astype(d),
         pfn=lambda x, d: x.astype(d), tol=EXACT, grad=False),
    case("index_select", A(N), A(np.array([-1, 0, -4], np.int32)), 1,
         tol=EXACT),
    case("gather", A(N), A(np.array([-1, 0, -3], np.int32)), tol=EXACT),
    case("gather", A(N), A(np.array([[-1], [2]], np.int32)), 1, tol=EXACT),
    case("floor_divide", A(I3), A(np.zeros(3, np.int32)), tol=EXACT,
         grad=False),
    case("floor_divide", A(I3), 0, tol=EXACT, grad=False),
    case("remainder", A(I3), A(np.array([0, 0, 2], np.int32)), tol=EXACT,
         grad=False),
    case("remainder", A(I3), 0, tol=EXACT, grad=False),
    case("pow", A(np.array([1, 2, -1, 0, -3], np.int32)), -1, tol=EXACT,
         grad=False),
    case("pow", A(np.array([1, 2, -1, 0, -3], np.int32)), -2, tol=EXACT,
         grad=False),
    case("arange", 0.0, 2.0, 0.1, tol=EXACT, grad=False),
    case("arange", 0, 1, 0.3, tol=EXACT, grad=False),
    case("arange", 1.5, -2, -0.7, tol=EXACT, grad=False),
    case("sign", A(NEG0), tol=EXACT),
    # random
    case("rand", [2, 3], tol=DRAW, grad=False),
    case("randn", [4], tol=DRAW, grad=False),
    case("standard_normal", [2, 2], "float32", tol=DRAW, grad=False),
    case("normal", 1.0, 2.0, [3], tol=DRAW, grad=False),
    case("uniform", [3, 2], "float32", -1.0, 2.0, tol=DRAW, grad=False),
    case("uniform_", A(N, grad=False), -2.0, 2.0, tol=DRAW, grad=False),
    case("normal_", A(N, grad=False), tol=DRAW, grad=False),
    case("exponential_", A(P, grad=False), tol=DRAW, grad=False),
    case("randint", 0, 5, [4], tol=DRAW, grad=False),
    case("randint_like", A(I), 0, 4, tol=DRAW, grad=False),
    case("randperm", 6, tol=DRAW, grad=False),
    case("rand_like", A(N), tol=DRAW, grad=False),
    case("randn_like", A(N), tol=DRAW, grad=False),
    case("bernoulli", A(P), tol=DRAW, grad=False),
    case("poisson", A(Q), tol=DRAW, grad=False),
    case("multinomial", A(P), 2, tol=DRAW, grad=False),
    case("shuffle_batch", A(N), tol=DRAW, grad=False),
]

def differs_cdist_p():
    """``cdist`` at p other than 0 and 2: the reference's op raises (its
    compiled op asks ``jnp.isinf(p)`` of a traced value); the port gives
    the p-norm distance."""
    try:
        RP.cdist(RP.to_tensor(N), RP.to_tensor(N2), 1.0)
    except Exception as e:          # jax's TracerBoolConversionError
        assert "Tracer" in type(e).__name__, type(e).__name__
    else:
        raise AssertionError("the reference's cdist(p=1) now runs: hold "
                             "the port against it in CASES")
    want = np.abs(N[:, None, :] - N2[None, :, :]).sum(-1)
    got = PT.cdist(PT.to_tensor(N), PT.to_tensor(N2), 1.0).numpy()
    close(want, got, RED, "cdist p=1 against numpy")


def differs_clone_bool():
    """``clone`` of a bool tensor: the reference's is ``x + 0``, which
    JAX promotes to int32; the port's copies, and stays bool."""
    b = np.array([True, False, True])
    r, p = RP.to_tensor(b).clone(), PT.to_tensor(b).clone()
    assert _dtname(r) == "int32" and _dtname(p) == "bool", (
        _dtname(r), _dtname(p))
    assert np.array_equal(_np(r), b.astype(np.int32))
    assert np.array_equal(_np(p), b)


def differs_index_out_of_range():
    """An index past the end: the reference's ``take`` fills (NaN in a
    float tensor); the port's ``gather`` and ``index_select`` raise, as
    PyTorch's indexing does. A negative index wraps on both sides
    (``CASES``)."""
    rg = RP.gather(RP.to_tensor(D), RP.to_tensor(np.array([5, 0], np.int32)))
    rs = RP.index_select(RP.to_tensor(D),
                         RP.to_tensor(np.array([9], np.int32)), 1)
    assert np.isnan(_np(rg)[0]).all() and np.array_equal(_np(rg)[1], D[0])
    assert np.isnan(_np(rs)).all(), _np(rs)
    for fn in (lambda: PT.gather(PT.to_tensor(D),
                                 PT.to_tensor(np.array([5, 0], np.int32))),
               lambda: PT.index_select(PT.to_tensor(D), PT.to_tensor(
                   np.array([9], np.int32)), 1)):
        try:
            fn()
        except (IndexError, RuntimeError):
            continue
        raise AssertionError("the port's index past the end now runs: "
                             "hold it against the reference's fill")


def differs_bce_logits_at_zero():
    """``binary_cross_entropy_with_logits`` at a logit of exactly 0: the
    reference's gradient is ``-y`` (its ``jnp.abs`` gives 1 there and
    its ``jnp.maximum`` 0.5), 0.5 from the true ``sigmoid(0) - y``,
    which the port gives. Elsewhere the two agree."""
    z = np.array([0.0, 0.0, 1.0, -2.0], np.float32)
    y = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    grads = []
    for S in (RP, PT):
        t = S.to_tensor(z)
        t.stop_gradient = False
        S.nn.functional.binary_cross_entropy_with_logits(
            t, S.to_tensor(y), reduction="sum").backward()
        grads.append(_np(t.grad))
    true = 1 / (1 + np.exp(-z.astype(np.float64))) - y
    assert np.array_equal(grads[0][:2], -y[:2]), grads[0]
    close(true[:2].astype(np.float32), grads[1][:2], RED, "port at 0")
    close(grads[0][2:], grads[1][2:], RED, "away from 0")


# ops whose result differs from the reference's on purpose: name ->
# the check that shows the difference (ROADMAP.md Queue C)
DIFFERS = {"cdist": differs_cdist_p, "clone": differs_clone_bool,
           "gather": differs_index_out_of_range,
           "binary_cross_entropy_with_logits": differs_bce_logits_at_zero}


def check_covers_every_export():
    names = {c["name"] for c in CASES}
    exported = set(PT.tensor.__all__) - {"Tensor"}
    missing = sorted(exported - names)
    assert not missing, f"exports without a case: {missing}"
    extra = sorted(exported - set(RP.tensor.__all__) - {"getitem"})
    assert not extra, f"exports the reference lacks: {extra}"


def check_missing_names_match_roadmap():
    ref = {n for n in RP.tensor.__all__ if n != "annotations"
           and not isinstance(getattr(RP.tensor, n), type(os))}
    ref |= set(TOP_LEVEL)
    missing = sorted(n for n in ref if not hasattr(PT, n))
    text = open(ROADMAP).read()
    m = re.search(r"Eager names not ported:(.*?)\n\n", text, re.S)
    assert m, "ROADMAP.md has no 'Eager names not ported:' paragraph"
    listed = sorted(re.findall(r"`([A-Za-z_0-9]+)`", m.group(1)))
    assert missing == listed, (f"port lacks {missing}; ROADMAP lists "
                               f"{listed}")


def test_eager_ops_match_reference():
    prev = list(port_device._CURRENT)
    PT.set_device("cpu")
    try:
        checks = [(check_case, (c["name"], k)) for k, c in enumerate(CASES)]
        checks += [(f, ()) for f in DIFFERS.values()]
        checks += [(check_covers_every_export, ()),
                   (check_missing_names_match_roadmap, ())]
        run_checks(checks)
    finally:
        port_device._CURRENT[:] = prev
