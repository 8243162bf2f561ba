"""The port's random ops (``paddle_tpu_torch/framework/random.py``,
``tensor/random.py``) against the JAX reference's, on the CPU.

The port draws from PyTorch generators, the reference from threefry
keys, so no value is compared. What is held, for every name of the
reference's ``tensor/random.py`` and ``shuffle_batch``:

- the dtype names and shapes of the reference's draws at the same
  arguments (its narrowed 64-bit names: ``randint``'s "int64" is int32);
- ranges: ``[min, max)`` for ``uniform``/``rand``, ``[low, high)`` for
  ``randint``, 0/1 for ``bernoulli``, non-negative integers for
  ``poisson``, permutations for ``randperm`` and ``shuffle_batch``'s
  order, distinct indices a row for ``multinomial`` without
  replacement;
- moments at ``N = 2**16`` draws: the port's mean and variance within
  ``SIGMAS`` standard errors of the distribution's, and of the
  reference's own draws' (the standard error of a difference of two
  means is ``sqrt(2)`` times one's); an event's frequency
  (``bernoulli``, ``multinomial``) likewise;
- determinism: ``seed(s)`` then a draw repeats after ``seed(s)``;
  another seed gives another draw; ``get_rng_state`` -> draw ->
  ``set_rng_state`` -> the same draw; ``uniform(seed=k)`` is the same
  whatever the global stream did, and leaves the global stream as it
  was;
- the in-place forms write into the tensor itself (a ``Parameter``'s
  payload stays the same object), and a draw from an eager ``Tensor``
  is an eager ``Tensor``, from a ``torch.Tensor`` a ``torch.Tensor``;
- the initializers' ranges and moments against their formulas
  (``nn.initializer``), and ``seed`` making ``nn.Linear(4, 8)`` repeat.

The file collects one test that runs every case
(``tests/torch_checks.py`` says why).
"""
import math

import numpy as np
import torch

import paddle_tpu as RP
import paddle_tpu_torch as PT
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.framework.dtype import dtype_name
from torch_checks import run_checks

torch.set_num_threads(2)

N = 1 << 16
SIGMAS = 6.0


def _dt(t):
    if isinstance(t, RP.Tensor):
        return np.dtype(t.dtype).name
    return dtype_name(t.dtype)


def _f64(t):
    return np.asarray(t.numpy(), dtype=np.float64)


def _within(got, want, se, what, k=SIGMAS):
    if abs(got - want) > k * se:
        raise AssertionError(f"{what}: {got:.6g} vs {want:.6g} "
                             f"(> {k} x {se:.3g})")


def _moments(p, r, mean, var, what):
    """Mean and variance of the port's draw ``p`` against the
    distribution's (``mean``, ``var``) and the reference's draw ``r``."""
    a, b = _f64(p).ravel(), _f64(r).ravel()
    n = a.size
    se_m = math.sqrt(var / n)
    _within(a.mean(), mean, se_m, f"{what} mean")
    _within(a.mean(), b.mean(), math.sqrt(2) * se_m, f"{what} mean vs ref")
    # the variance's standard error, sqrt((m4 - var^2) / n), from the
    # sample's own fourth moment
    m4 = np.mean((a - a.mean()) ** 4)
    se_v = math.sqrt(max(m4 - a.var() ** 2, 1e-30) / n)
    _within(a.var(), var, se_v, f"{what} variance")
    _within(a.var(), b.var(), math.sqrt(2) * se_v, f"{what} variance vs ref")


# name -> (args, kwargs, (mean, variance) or None, range check)
def _in(lo, hi):
    def check(x):
        assert x.min() >= lo and x.max() < hi, (x.min(), x.max())
    return check


def _ints(lo, hi):
    def check(x):
        assert np.all(x == np.round(x)) and x.min() >= lo \
            and x.max() < hi, (x.min(), x.max())
    return check


DRAWS = {
    "rand": (([N],), {}, (0.5, 1 / 12), _in(0, 1)),
    "uniform": (([N],), dict(min=-2.0, max=3.0), (0.5, 25 / 12),
                _in(-2, 3)),
    "randn": (([N],), {}, (0.0, 1.0), None),
    "standard_normal": (([N], "float32"), {}, (0.0, 1.0), None),
    "normal": ((1.5, 2.0, [N]), {}, (1.5, 4.0), None),
    "randint": ((-3, 7, [N]), {}, (1.5, (10 ** 2 - 1) / 12), _ints(-3, 7)),
    "randperm": ((4096,), {}, None, None),
}


def check_draw(name):
    args, kw, mom, rng = DRAWS[name]
    RP.seed(11)
    PT.seed(11)
    r = getattr(RP, name)(*args, **kw)
    p = getattr(PT, name)(*args, **kw)
    assert isinstance(p, PT.Tensor), type(p)
    assert _dt(p) == _dt(r), (_dt(p), _dt(r))
    assert p.shape == list(r.shape), (p.shape, r.shape)
    x = _f64(p)
    if rng is not None:
        rng(x)
    if mom is not None:
        _moments(p, r, *mom, name)
    if name == "randperm":
        assert np.array_equal(np.sort(x), np.arange(args[0]))


def check_like_and_dtypes():
    base_r = RP.to_tensor(np.zeros((3, 5), np.float32))
    base_p = PT.to_tensor(np.zeros((3, 5), np.float32))
    for name, args in (("rand_like", ()), ("randn_like", ()),
                       ("randint_like", (0, 4))):
        r = getattr(RP, name)(base_r, *args)
        p = getattr(PT, name)(base_p, *args)
        assert (_dt(p), p.shape) == (_dt(r), list(r.shape)), name
    for name, args in (("rand", ([2, 3], "bfloat16")),
                       ("randn", ([4], "float64")),
                       ("randint", (0, 5, [2, 2], "int32")),
                       ("randperm", (7, "int32")),
                       ("uniform", ([3], "bfloat16"))):
        r, p = getattr(RP, name)(*args), getattr(PT, name)(*args)
        assert (_dt(p), p.shape) == (_dt(r), list(r.shape)), (name, _dt(p),
                                                             _dt(r))


def check_ops_of_an_input():
    """``bernoulli``, ``poisson``, ``multinomial`` and ``shuffle_batch``:
    dtypes, shapes, ranges and frequencies; an eager input gives an
    eager result, a ``torch.Tensor`` a ``torch.Tensor``."""
    prob = np.full((N,), 0.3, np.float32)
    rate = np.full((N,), 2.5, np.float32)
    for name, arr, mean, var in (("bernoulli", prob, 0.3, 0.21),
                                 ("poisson", rate, 2.5, 2.5)):
        r = getattr(RP, name)(RP.to_tensor(arr))
        p = getattr(PT, name)(PT.to_tensor(arr))
        assert (_dt(p), p.shape) == (_dt(r), list(r.shape)), name
        x = _f64(p)
        assert np.all(x >= 0) and np.all(x == np.round(x)), name
        if name == "bernoulli":
            assert set(np.unique(x)) <= {0.0, 1.0}
        _moments(p, r, mean, var, name)
        plain = getattr(PT, name)(torch.from_numpy(arr[:8]))
        assert type(plain) is torch.Tensor, type(plain)
    w = np.random.RandomState(3).rand(64, 1000).astype(np.float32)
    for repl, rows in ((False, w), (True, w[0])):
        r = RP.multinomial(RP.to_tensor(rows), 20, replacement=repl)
        p = PT.multinomial(PT.to_tensor(rows), 20, replacement=repl)
        assert (_dt(p), p.shape) == (_dt(r), list(r.shape)), repl
        x = p.numpy()
        assert x.min() >= 0 and x.max() < 1000
        if not repl:
            assert all(len(set(row)) == 20 for row in x), "repeats"
    # with replacement over rows: the reference's categorical draw asks
    # for a shape its batch does not broadcast to, and raises; the port
    # draws each row (ROADMAP.md Queue C, on purpose)
    try:
        RP.multinomial(RP.to_tensor(w), 20, replacement=True)
    except ValueError as e:
        assert "broadcast" in str(e), e
    else:
        raise AssertionError("the reference's multinomial over rows with "
                             "replacement now runs: compare it")
    p = PT.multinomial(PT.to_tensor(w), 20, replacement=True)
    assert p.shape == [64, 20] and _dt(p) == "int32"
    # frequency of one category with replacement
    two = np.array([[0.2, 0.8]], np.float32)
    draws = PT.multinomial(PT.to_tensor(two), N, replacement=True).numpy()
    _within(float(np.mean(draws == 1)), 0.8, math.sqrt(0.16 / N),
            "multinomial frequency")
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    r_out, r_ord = RP.shuffle_batch(RP.to_tensor(x), seed=5)
    p_out, p_ord = PT.shuffle_batch(PT.to_tensor(x), seed=5)
    assert [_dt(t) for t in (p_out, p_ord)] == [_dt(t) for t in (r_out,
                                                                  r_ord)]
    order = p_ord.numpy()
    assert np.array_equal(np.sort(order), np.arange(10))
    assert np.array_equal(p_out.numpy(), x[order])
    again = PT.shuffle_batch(PT.to_tensor(x), seed=5)[1].numpy()
    assert np.array_equal(order, again)


def check_in_place_forms():
    for name, kw in (("uniform_", dict(min=-1.0, max=2.0)),
                     ("normal_", dict(mean=1.0, std=0.5)),
                     ("exponential_", dict(lam=2.0))):
        r = RP.to_tensor(np.zeros(N, np.float32))
        p = PT.create_parameter([N], "float32")
        payload = p._value
        out = getattr(PT, name)(p, **kw)
        getattr(RP, name)(r, **kw)
        assert out is p and p._value is payload, name
        assert not p.stop_gradient and p.is_leaf, name
        assert _dt(p) == _dt(r), name
        mean, var = {"uniform_": (0.5, 9 / 12), "normal_": (1.0, 0.25),
                     "exponential_": (0.5, 0.25)}[name]
        _moments(p, r, mean, var, name)
        m = getattr(p, name)(**kw)          # the Tensor method
        assert m is p
    x = np.zeros(N, np.float32)
    x_t = torch.from_numpy(x.copy())
    PT.uniform_(x_t, 0.0, 1.0)
    _in(0, 1)(x_t.numpy())


def check_seed_and_state():
    PT.seed(7)
    a = PT.rand([64]).numpy()
    b = PT.randn([64]).numpy()
    PT.seed(7)
    assert np.array_equal(PT.rand([64]).numpy(), a)
    assert np.array_equal(PT.randn([64]).numpy(), b)
    PT.seed(8)
    assert not np.array_equal(PT.rand([64]).numpy(), a)
    st = PT.get_rng_state()
    c = PT.randint(0, 1000, [64]).numpy()
    host = PT.framework.random.host_rng().rand(4)
    PT.set_rng_state(st)
    assert np.array_equal(PT.randint(0, 1000, [64]).numpy(), c)
    assert np.array_equal(PT.framework.random.host_rng().rand(4), host)
    # seed pins the host stream too, as the reference's does
    PT.seed(3)
    RP.seed(3)
    assert np.array_equal(PT.framework.random.host_rng().rand(5),
                          RP.framework.random.host_rng().rand(5))
    assert PT.get_cuda_rng_state() == []        # no card here
    assert PT.framework.random.default_generator().initial_seed() == 3


def check_explicit_seed_is_its_own_stream():
    PT.seed(1)
    a = PT.uniform([32], seed=9).numpy()
    PT.seed(2)
    PT.rand([5])
    assert np.array_equal(PT.uniform([32], seed=9).numpy(), a)
    PT.seed(4)
    g1 = PT.rand([16]).numpy()
    PT.seed(4)
    PT.uniform([32], seed=9)
    PT.shuffle_batch(PT.to_tensor(np.arange(6.0)), seed=9)
    assert np.array_equal(PT.rand([16]).numpy(), g1), (
        "a seeded draw moved the global stream")


def check_initializers():
    I = PT.nn.initializer
    PT.seed(0)
    p = PT.create_parameter([256, 512], "float32")
    cases = [
        (I.Uniform(-0.5, 1.5), (0.5, 4 / 12), (-0.5, 1.5)),
        (I.Normal(0.5, 2.0), (0.5, 4.0), None),
        (I.TruncatedNormal(0.0, 1.0), (0.0, 0.7737413), (-2.0, 2.0)),
        (I.XavierUniform(), (0.0, 2.0 / (256 + 512)),
         (-math.sqrt(6 / 768), math.sqrt(6 / 768))),
        (I.XavierNormal(), (0.0, 2.0 / 768), None),
        (I.KaimingUniform(), (0.0, 2.0 / 256),
         (-math.sqrt(6 / 256), math.sqrt(6 / 256))),
        (I.KaimingNormal(), (0.0, 2.0 / 256), None),
        (I.Constant(0.25), (0.25, 0.0), (0.25, 0.25)),
    ]
    for init, (mean, var), rng in cases:
        init(p)
        x = _f64(p).ravel()
        se = math.sqrt(max(var, 1e-30) / x.size)
        _within(x.mean(), mean, max(se, 1e-12), f"{type(init).__name__}")
        if var:
            _within(x.var(), var, var * math.sqrt(2.0 / x.size) * 2,
                    f"{type(init).__name__} variance")
        if rng is not None:
            assert rng[0] <= x.min() and x.max() <= rng[1], type(init)
    q = PT.create_parameter([6, 10], "float32",
                            default_initializer=I.Orthogonal())
    m = q.numpy().astype(np.float64)
    assert np.allclose(m @ m.T, np.eye(6), atol=1e-5)
    r = RP.create_parameter([6, 10], "float32",
                            default_initializer=RP.nn.initializer.Orthogonal())
    assert (_dt(q), q.shape) == (_dt(r), list(r.shape))
    conv = PT.create_parameter([4, 2, 3, 3], "float32",
                               default_initializer=I.Dirac())
    rconv = RP.create_parameter([4, 2, 3, 3], "float32",
                                default_initializer=RP.nn.initializer.Dirac())
    assert np.array_equal(conv.numpy(), rconv.numpy())
    for act in ("relu", "tanh", "leaky_relu", "sigmoid"):
        assert I.calculate_gain(act) == \
            RP.nn.initializer.calculate_gain(act), act
    PT.seed(5)
    w1 = PT.nn.Linear(4, 8).weight.numpy()
    PT.seed(5)
    w2 = PT.nn.Linear(4, 8).weight.numpy()
    assert np.array_equal(w1, w2)


def test_random_ops_match_reference():
    prev = list(port_device._CURRENT)
    PT.set_device("cpu")
    try:
        run_checks([(check_draw, (n,)) for n in DRAWS]
                   + [(check_like_and_dtypes, ()),
                      (check_ops_of_an_input, ()),
                      (check_in_place_forms, ()),
                      (check_seed_and_state, ()),
                      (check_explicit_seed_is_its_own_stream, ()),
                      (check_initializers, ())])
    finally:
        port_device._CURRENT[:] = prev
