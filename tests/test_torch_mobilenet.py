"""The port's MobileNetV2 (``paddle_tpu_torch/vision/models/mobilenetv2.py``)
against the JAX reference's (``paddle_tpu/vision/models/mobilenetv2.py``),
eager, on the CPU, at ``scale=0.25``, 10 classes, batch 2 x 3 x 32 x 32
(inputs and labels from ``RandomState(0)``), the reference's weights
carried across (``models/convert.py`` ``load_layer_state``: 262
parameters and buffers).

- **The eval forward**: the logits within ``FWD_RTOL`` of the
  reference's (largest difference over the largest logit).
- **One training step**, with the classifier's ``Dropout`` at ``p = 0``
  on both sides (the reference's layer keeps ``p`` in ``self.p``):
  ``F.cross_entropy``'s loss within ``LOSS_RTOL``. The gradients of the
  whole model cannot be held element for element: at this size the last
  stages run at 1 x 1 pixels, so each batch norm normalises two values
  and its input gradient is ``w / |x1 - x2|``-scaled, which turns the
  frameworks' different summation orders (1e-7 of a convolution's
  output) into differences of up to half a gradient's norm by the last
  stages (0.56 at ``features.16``, read on this CPU). So the gradients,
  as ``tests/test_torch_resnet.py`` holds ResNet-50's, are held **stage
  by stage**: each of the 19 feature stages and the head fed the same
  input (the port's previous output) and cotangent on both sides, in
  training mode: the output (largest difference over the largest
  value), the input gradient and the stage's parameter gradients
  (``torch_checks.norm_rel``) and its running buffers (absolute), within
  ``STAGE_TOL``.
- **The Momentum update** (``Momentum(0.045, 0.9,
  weight_decay=L2Decay(4e-5))``, the paper's learning rate and weight
  decay) over all 158 parameters: the reference's gradients set on both
  sides, one ``step()`` each, every parameter within ``PARAM_TOL``.

The file collects one test that runs every case
(``tests/torch_checks.py`` says why). About 70 s alone on the CPU, most
of it the reference's per-op compiles.
"""
import numpy as np
import torch

import paddle_tpu as RP
import paddle_tpu_torch as PT
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.models.convert import load_layer_state
from torch_checks import mobilenet_stages, norm_rel, run_checks

torch.set_num_threads(2)

SCALE, CLASSES, B, IMG = 0.25, 10, 2, 32
LR, MOM, WD = 0.045, 0.9, 4e-5
FWD_RTOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-6
# a stage's output (largest difference over the largest value), input
# and parameter gradients (norm_rel) and running buffers (absolute);
# read on this CPU: 7.6e-6, 7.3e-6, 7.1e-6, 1.2e-6 at the worst stage
STAGE_TOL = {"out": 3e-5, "dx": 1e-4, "grads": 1e-4, "buffers": 1e-5}


def _np(t):
    return np.asarray(t.numpy())


def _state(layer):
    return {n: _np(t) for n, t in layer.state_dict().items()}


_BUILT = {}


def _pair():
    """The reference's model after ``paddle.seed(0)`` and the port's with
    its weights, built once and reset to those weights at each call."""
    if not _BUILT:
        RP.seed(0)
        ref = RP.vision.models.mobilenet_v2(scale=SCALE,
                                            num_classes=CLASSES)
        port = PT.vision.models.mobilenet_v2(scale=SCALE,
                                             num_classes=CLASSES)
        _BUILT.update(ref=ref, port=port, state=_state(ref))
    ref, port, state = _BUILT["ref"], _BUILT["port"], _BUILT["state"]
    ref.set_state_dict({n: RP.to_tensor(v) for n, v in state.items()})
    load_layer_state(port, state)
    for m in (ref, port):
        m.clear_gradients()
        m.classifier[0].p = 0.2
    return ref, port


def _batch():
    rs = np.random.RandomState(0)
    return (rs.rand(B, 3, IMG, IMG).astype(np.float32),
            rs.randint(0, CLASSES, (B,)))


def _in(name, prefixes):
    return any(name == p or name.startswith(p + ".") for p in prefixes)


def _stage_run(S, m, stage, x, ct):
    """One stage in training mode on eager ``Tensor``s: its output, the
    input gradient of ``sum(out * ct)``, its parameter gradients and its
    running buffers after the forward."""
    _, fn, prefixes = stage
    m.train()
    m.clear_gradients()
    t = S.to_tensor(x)
    t.stop_gradient = False
    out = fn(t)
    if ct is None:
        ct = np.random.RandomState(len(x.shape) + x.size % 97).normal(
            size=out.shape).astype(np.float32)
    (out * S.to_tensor(ct)).sum().backward()
    return {"out": _np(out), "ct": ct, "dx": _np(t.grad),
            "grads": {n: _np(p.grad) for n, p in m.named_parameters()
                      if _in(n, prefixes)},
            "buffers": {n: _np(b) for n, b in m.named_buffers()
                        if _in(n, prefixes)}}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def check_eval_forward():
    ref, port = _pair()
    ref.eval()
    port.eval()
    x, _ = _batch()
    want = _np(ref(RP.to_tensor(x)))
    got = _np(port(PT.to_tensor(x)))
    assert got.shape == (B, CLASSES)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= FWD_RTOL, err


def check_first_step_and_update():
    ref, port = _pair()
    x, y = _batch()
    out = {}
    for S, m in ((RP, ref), (PT, port)):
        m.train()
        m.classifier[0].p = 0.0
        loss = S.nn.functional.cross_entropy(
            m(S.to_tensor(x)), S.to_tensor(y, dtype="int64"))
        loss.backward()
        out[S] = float(loss)
    assert abs(out[PT] - out[RP]) <= LOSS_RTOL * abs(out[RP]), out
    # the update on the same gradients: the reference's, set on both sides
    grads = {n: _np(p.grad) for n, p in ref.named_parameters()}
    with torch.no_grad():
        for n, p in port.named_parameters():
            p._value.grad.copy_(torch.from_numpy(grads[n].copy()))
    before = {n: _np(p) for n, p in ref.named_parameters()}
    for S, m in ((RP, ref), (PT, port)):
        opt = S.optimizer.Momentum(
            learning_rate=LR, momentum=MOM, parameters=m.parameters(),
            weight_decay=S.regularizer.L2Decay(WD))
        opt.step()
        opt.clear_grad()
    moved = 0
    for (n, rp), (_, pp) in zip(ref.named_parameters(),
                                port.named_parameters()):
        e = norm_rel(_t(_np(pp)), _t(_np(rp)))
        assert e <= PARAM_TOL, f"{n}: {e:.2e}"
        moved += not np.array_equal(_np(rp), before[n])
    assert moved == len(before) == 158, moved


def check_stages_match_reference():
    ref, port = _pair()
    ref.classifier[0].p = port.classifier[0].p = 0.0
    x, _ = _batch()
    worst = dict.fromkeys(STAGE_TOL, 0.0)
    for rst, pst in zip(mobilenet_stages(ref), mobilenet_stages(port)):
        got = _stage_run(PT, port, pst, x, None)
        want = _stage_run(RP, ref, rst, x, got["ct"])
        errs = {
            "out": float(np.abs(got["out"] - want["out"]).max()
                         / max(np.abs(want["out"]).max(), 1e-30)),
            "dx": norm_rel(_t(got["dx"]), _t(want["dx"])),
            "grads": max([norm_rel(_t(got["grads"][n]), _t(g))
                          for n, g in want["grads"].items()]),
            "buffers": max([float(np.abs(got["buffers"][n] - b).max())
                            for n, b in want["buffers"].items()] or [0.0])}
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
            assert v <= STAGE_TOL[k], f"{pst[0]} {k}: {v:.2e}"
        x = got["out"]
    return worst


def test_mobilenet_v2_matches_reference(fresh_mesh):
    prev = list(port_device._CURRENT)
    PT.set_device("cpu")
    try:
        run_checks([(check_eval_forward, ()),
                    (check_first_step_and_update, ()),
                    (check_stages_match_reference, ())])
    finally:
        port_device._CURRENT[:] = prev
