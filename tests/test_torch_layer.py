"""The port's eager training surface against the JAX reference's, on the
CPU: ``nn.Layer``, ``Parameter``/``create_parameter``/``ParamAttr``, the
functionals over eager ``Tensor``s and the optimizers' ``step()`` over
eager parameters, proved on ``vision.models.LeNet`` and a user MLP.

- **LeNet at batch 8**, the reference's weights carried across
  (``models/convert.py`` ``load_layer_state``), the same 1 x 28 x 28
  inputs and labels from ``RandomState``: 5 steps of ``loss.backward();
  opt.step(); opt.clear_grad(); sched.step()`` under SGD, Momentum,
  Adam and AdamW, each with a learning-rate scheduler. Each step's loss
  and every parameter after it within ``RTOL`` (1e-5) of the
  reference's, by the norm of the difference over the norm of the
  reference's array.
- **A user MLP** written with ``create_parameter`` and ``ParamAttr``:
  a ``learning_rate`` of 0.5 and an ``L2Decay`` regularizer on one
  parameter, ``trainable=False`` on one, ``need_clip=False`` on one,
  under ``ClipGradByGlobalNorm`` that binds (the gradients' norm is
  above the clip at every step). The reference's step clips every
  gradient, ``need_clip`` or not; the port keeps a ``need_clip=False``
  gradient out of the clip, as Paddle does (``ROADMAP.md`` Queue C). So
  the reference side runs two optimizers over one scheduler, one with
  the clip over the clipped parameters and one without it over the
  other, which is Paddle's rule on the reference's arithmetic;
  ``check_need_clip_differs`` pins the difference itself.
- **One LeNet step under ``auto_cast`` O1** (bf16): the port's cast
  sequence (op name, input dtypes, output dtypes) equals the
  reference's op for op, the loss is within 2% (bf16 products), and
  every gradient is finite and of its parameter's shape.
- **The ``Layer`` surface**: parameter names, shapes (lists) and
  count; ``state_dict`` names as the reference's, and a round trip
  through ``set_state_dict``; ``register_buffer(persistable=False)``;
  ``train``/``eval`` down the sublayers; forward pre- and post-hooks
  and their removal; ``paddle.grad`` through a layer against the
  reference's; ``sublayers``, ``children``, ``apply``,
  ``clear_gradients``, ``to(dtype)``.
- **The models' path** keeps ``torch.Tensor``s: a ``Layer`` given a
  ``torch.Tensor`` returns one, and ``framework/modules.py`` reads its
  ``torch.nn.Parameter``s.

The file collects one test that runs every case
(``tests/torch_checks.py`` says why).
"""
import contextlib

import numpy as np
import torch

import paddle_tpu as RP
import paddle_tpu_torch as PT
from paddle_tpu import amp as ramp
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.framework.dtype import dtype_name
from paddle_tpu_torch.framework.modules import torch_parameters
from paddle_tpu_torch.models.convert import load_layer_state
from torch_checks import run_checks

torch.set_num_threads(2)

RTOL = 1e-5
STEPS = 5
BATCH = 8


def _state(layer):
    return {n: np.asarray(t.numpy(), np.float32)
            for n, t in layer.state_dict().items()}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _lenet_pair():
    RP.seed(0)
    ref = RP.vision.models.LeNet()
    port = load_layer_state(PT.vision.models.LeNet(), _state(ref))
    return ref, port


def _batch(step, b=BATCH):
    rs = np.random.RandomState(100 + step)
    x = rs.rand(b, 1, 28, 28).astype(np.float32)
    y = rs.randint(0, 10, (b,)).astype(np.int64)
    return x, y


def _optimizers(S, name, params, sched):
    O = S.optimizer
    if name == "SGD":
        return O.SGD(learning_rate=sched, parameters=params)
    if name == "Momentum":
        return O.Momentum(learning_rate=sched, momentum=0.9,
                          parameters=params, weight_decay=1e-4)
    if name == "Adam":
        return O.Adam(learning_rate=sched, parameters=params)
    return O.AdamW(learning_rate=sched, parameters=params,
                   weight_decay=0.01)


def _sched(S, name):
    L = S.optimizer.lr
    if name in ("SGD", "Momentum"):
        return L.StepDecay(learning_rate=0.05, step_size=2, gamma=0.5)
    return L.CosineAnnealingDecay(learning_rate=2e-3, T_max=STEPS)


def _lenet_run(S, model, opt_name):
    sched = _sched(S, opt_name)
    opt = _optimizers(S, opt_name, model.parameters(), sched)
    F = S.nn.functional
    losses, params = [], []
    for step in range(STEPS):
        x, y = _batch(step)
        loss = F.cross_entropy(model(S.to_tensor(x)),
                               S.to_tensor(y, dtype="int64"))
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss))
        params.append(_state(model))
    return losses, params


def check_lenet_trains_with_reference(opt_name):
    ref, port = _lenet_pair()
    r_losses, r_params = _lenet_run(RP, ref, opt_name)
    p_losses, p_params = _lenet_run(PT, port, opt_name)
    for i in range(STEPS):
        e = _rel(p_losses[i], r_losses[i])
        assert e <= RTOL, f"{opt_name} step {i} loss {e:.2e}"
        for n, want in r_params[i].items():
            e = _rel(p_params[i][n], want)
            assert e <= RTOL, f"{opt_name} step {i} {n}: {e:.2e}"


class _MLP:
    """The same user model on either side (``S`` the package)."""

    @staticmethod
    def build(S):
        class MLP(S.nn.Layer):
            def __init__(self):
                super().__init__()
                A = S.ParamAttr
                self.w1 = self.create_parameter(
                    [12, 16], attr=A(name="mlp_w1", learning_rate=0.5,
                                     regularizer=S.regularizer.L2Decay(0.01)))
                self.b1 = self.create_parameter([16], is_bias=True)
                self.w2 = self.create_parameter([16, 4],
                                                attr=A(need_clip=False))
                self.b2 = self.create_parameter(
                    [4], attr=A(trainable=False,
                                initializer=S.nn.initializer.Constant(0.1)),
                    is_bias=True)

            def forward(self, x):
                h = S.nn.functional.relu(S.matmul(x, self.w1) + self.b1)
                return S.matmul(h, self.w2) + self.b2

        return MLP()


def _mlp_pair():
    RP.seed(1)
    ref = _MLP.build(RP)
    port = load_layer_state(_MLP.build(PT), _state(ref))
    return ref, port


def _mlp_batch(step):
    rs = np.random.RandomState(200 + step)
    return (rs.randn(6, 12).astype(np.float32) * 3,
            rs.randint(0, 4, (6,)).astype(np.int64))


CLIP = 0.05


def _mlp_run(S, model, opt_name, split_clip):
    """5 steps; ``split_clip``: the clip's optimizer over the ``need_clip``
    parameters and a second one, without it, over the rest (the
    reference side, see the module docstring)."""
    sched = _sched(S, opt_name)
    clip = S.nn.ClipGradByGlobalNorm(CLIP)
    params = model.parameters()
    if split_clip:
        keep = [p for p in params if p.name != model.w2.name]
        opts = [_optimizers(S, opt_name, keep, sched),
                _optimizers(S, opt_name, [model.w2], sched)]
        opts[0]._grad_clip = clip
    else:
        opts = [_optimizers(S, opt_name, params, sched)]
        opts[0]._grad_clip = clip
    losses, states = [], []
    for step in range(STEPS):
        x, y = _mlp_batch(step)
        loss = S.nn.functional.cross_entropy(
            model(S.to_tensor(x)), S.to_tensor(y, dtype="int64"))
        loss.backward()
        norm = np.sqrt(sum(float((p.grad.numpy().astype(np.float64) ** 2)
                                 .sum()) for p in params
                           if p.grad is not None and p.name != model.w2.name))
        assert norm > CLIP, f"the clip does not bind at step {step}"
        for o in opts:
            o.step()
            o.clear_grad()
        sched.step()
        losses.append(float(loss))
        states.append(_state(model))
    return losses, states


def check_param_attr_mlp_trains_with_reference(opt_name):
    ref, port = _mlp_pair()
    assert port.w1.name == "mlp_w1" and port.w1.optimize_attr == {
        "learning_rate": 0.5}
    assert port.b2.stop_gradient and not port.b2.trainable
    assert port.w2.need_clip is False and port.w1.need_clip is True
    r_losses, r_states = _mlp_run(RP, ref, opt_name, split_clip=True)
    p_losses, p_states = _mlp_run(PT, port, opt_name, split_clip=False)
    for i in range(STEPS):
        e = _rel(p_losses[i], r_losses[i])
        assert e <= RTOL, f"{opt_name} MLP step {i} loss {e:.2e}"
        for n, want in r_states[i].items():
            e = _rel(p_states[i][n], want)
            assert e <= RTOL, f"{opt_name} MLP step {i} {n}: {e:.2e}"
    assert np.array_equal(p_states[-1]["b2"], np.full(4, 0.1, np.float32))


def check_need_clip_differs():
    """The reference's eager step clips a ``need_clip=False`` gradient
    with the rest; the port's keeps it out (Paddle's rule)."""
    for S, clipped in ((RP, True), (PT, False)):
        w = S.create_parameter([4], "float32",
                               attr=S.ParamAttr(need_clip=False),
                               default_initializer=S.nn.initializer.Constant(
                                   1.0))
        (w * 100.0).sum().backward()
        opt = S.optimizer.SGD(learning_rate=1.0, parameters=[w],
                              grad_clip=S.nn.ClipGradByGlobalNorm(1.0))
        opt.step()
        got = w.numpy()
        want = 1.0 - (0.5 if clipped else 100.0)
        assert np.allclose(got, want, rtol=1e-6), (S.__name__, got)


@contextlib.contextmanager
def _recording(module):
    seen, real = [], module.amp_cast_inputs

    def name(dt):
        return np.dtype(dt).name if not isinstance(dt, torch.dtype) \
            else dtype_name(dt)

    def spy(op_name, vals):
        out = real(op_name, vals)
        seen.append((op_name, tuple(name(v.dtype) for v in vals),
                     tuple(name(v.dtype) for v in out)))
        return out

    module.amp_cast_inputs = spy
    try:
        yield seen
    finally:
        module.amp_cast_inputs = real


def check_lenet_amp_o1_cast_sequence():
    ref, port = _lenet_pair()
    x, y = _batch(0)
    out = {}
    for S, model, amp in ((RP, ref, ramp), (PT, port, pamp)):
        with _recording(amp) as seen:
            with amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = S.nn.functional.cross_entropy(
                    model(S.to_tensor(x)), S.to_tensor(y, dtype="int64"))
            loss.backward()
        out[S] = (list(seen), float(loss),
                  {n: p.grad.numpy() for n, p in model.named_parameters()})
    (r_seen, r_loss, r_g), (p_seen, p_loss, p_g) = out[RP], out[PT]
    assert r_seen == p_seen, (r_seen, p_seen)
    assert len(r_seen) >= 6, r_seen
    assert abs(p_loss - r_loss) <= 2e-2 * abs(r_loss), (p_loss, r_loss)
    for n in r_g:
        assert p_g[n].shape == r_g[n].shape and np.isfinite(p_g[n]).all(), n


def check_layer_surface():
    ref, port = _lenet_pair()
    names = [n for n, _ in ref.named_parameters()]
    assert [n for n, _ in port.named_parameters()] == names
    assert len(port.parameters()) == len(ref.parameters()) == 10
    assert port.fc[0].weight.shape == [400, 120] == list(
        ref.fc[0].weight.shape)
    assert isinstance(port.fc[0].weight, PT.Parameter)
    assert port.parameters()[0] is port.features[0].weight
    assert list(port.state_dict()) == list(ref.state_dict())
    assert all(isinstance(t, PT.Tensor) for t in port.state_dict().values())
    # a round trip through set_state_dict
    saved = _state(port)
    other = PT.vision.models.LeNet()
    missing, unexpected = other.set_state_dict(port.state_dict())
    assert not missing and not unexpected
    for n, v in _state(other).items():
        assert np.array_equal(v, saved[n]), n
    assert [type(l).__name__ for l in port.sublayers()] == [
        type(l).__name__ for l in ref.sublayers()]
    assert len(list(port.children())) == len(list(ref.children())) == 2
    port.eval()
    assert not any(l.training for l in port.sublayers())
    port.train()
    assert all(l.training for l in port.sublayers())
    seen = []
    port.apply(lambda l: seen.append(type(l).__name__))
    assert seen[-1] == "LeNet" and len(seen) == 12
    # buffers: a persistable and a non-persistable one
    for S in (RP, PT):
        l = S.nn.Linear(2, 3)
        l.register_buffer("keep", S.to_tensor(np.ones(2, np.float32)))
        l.register_buffer("drop", S.to_tensor(np.ones(2, np.float32)),
                          persistable=False)
        assert list(l.state_dict()) == ["weight", "bias", "keep"], S
        assert len(l.buffers()) == 2
    assert port.full_name().startswith("lenet_")
    # gradients cleared, dtype moved
    x, y = _batch(0, 2)
    PT.nn.functional.cross_entropy(port(PT.to_tensor(x)),
                                   PT.to_tensor(y, dtype="int64")).backward()
    assert port.fc[2].bias.grad is not None
    port.clear_gradients()
    assert all(p.grad is None for p in port.parameters())
    w = port.fc[2].weight
    port.to(dtype="bfloat16")
    assert dtype_name(w.dtype) == "bfloat16" and w is port.fc[2].weight
    port.float()
    assert dtype_name(port.fc[2].weight.dtype) == "float32"


def check_hooks_match_reference():
    ref, port = _lenet_pair()
    x, _ = _batch(1, 2)
    outs = []
    for S, m in ((RP, ref), (PT, port)):
        calls = []
        pre = m.fc.register_forward_pre_hook(
            lambda l, inp: (inp[0] * 2.0,))
        post = m.register_forward_post_hook(
            lambda l, inp, out: calls.append(out.shape) or out + 1.0)
        a = m(S.to_tensor(x)).numpy()
        pre.remove()
        post.remove()
        b = m(S.to_tensor(x)).numpy()
        assert calls == [[2, 10]] or calls == [(2, 10)], calls
        outs.append((a, b))
    for (ra, rb), (pa, pb) in zip([outs[0]], [outs[1]]):
        assert _rel(pa, ra) <= RTOL and _rel(pb, rb) <= RTOL


def check_grad_through_layer():
    ref, port = _lenet_pair()
    x, _ = _batch(2, 2)
    res = []
    for S, m in ((RP, ref), (PT, port)):
        t = S.to_tensor(x)
        t.stop_gradient = False
        out = m(t)
        gx, gw = S.grad(out.sum(), [t, m.fc[1].weight])
        res.append((gx.numpy(), gw.numpy()))
        assert m.fc[1].weight.grad is None
    for r, p in zip(*res):
        assert _rel(p, r) <= RTOL


def check_models_path_stays_torch():
    """A ``Layer`` given ``torch.Tensor``s computes on them alone."""
    port = PT.vision.models.LeNet()
    out = port(torch.from_numpy(_batch(0, 2)[0]))
    assert type(out) is torch.Tensor
    ps = torch_parameters(port)
    assert all(type(p) is torch.nn.Parameter for p in ps) and len(ps) == 10
    assert ps[0] is port.features[0].weight._value
    lin = PT.nn.Linear(3, 2, rs=np.random.RandomState(0))
    want = np.random.RandomState(0).uniform(-np.sqrt(6 / 5), np.sqrt(6 / 5),
                                            (3, 2)).astype(np.float32)
    assert np.array_equal(lin.weight.numpy(), want)


def test_layer_training_matches_reference(fresh_mesh):
    prev = list(port_device._CURRENT)
    PT.set_device("cpu")
    try:
        opts = ("SGD", "Momentum", "Adam", "AdamW")
        run_checks([(check_lenet_trains_with_reference, (o,)) for o in opts]
                   + [(check_param_attr_mlp_trains_with_reference, (o,))
                      for o in opts]
                   + [(check_need_clip_differs, ()),
                      (check_lenet_amp_o1_cast_sequence, ()),
                      (check_layer_surface, ()),
                      (check_hooks_match_reference, ()),
                      (check_grad_through_layer, ()),
                      (check_models_path_stays_torch, ())])
    finally:
        port_device._CURRENT[:] = prev
