"""Port fused optimizer update (``paddle_tpu_torch/ops/fused_update.py``,
``optimizer/fused.py``) against the JAX reference
(``paddle_tpu/ops/pallas/fused_update.py``, ``optimizer/fused.py``) on
the CPU, where the port takes its plain version.

Cases: sgd, momentum (nesterov on and off), adam, adamw; weight decay 0
and 0.01; n in {1, 127, 128, 1000}; then ``FusedFlatUpdater.step()``
over 2 steps on a several-bucket plan.

Tolerances, and why there are two:
- Against the reference's update composition run op by op
  (``reference_update_flat`` and the optimizer's ``_update`` rule,
  eager): bit-identical, beta powers included. Every op rounds once on
  both sides, which is the contract the CUDA kernel keeps on the card.
- Against compiled JAX (the Pallas kernel in interpret mode, and the
  jitted ``FusedFlatUpdater``): XLA contracts ``a*b+c`` into FMAs on
  this CPU, which moves isolated elements. Where a sum nearly cancels
  (``beta1*m + (1-beta1)*g``) that is up to ~350 ulp of the small
  result (measured; the reference's own
  ``test_fused_update_matches_bucket_fn`` fails its 8-ulp bound here for
  the same reason). So the bound is 8 ulp of the array's largest
  magnitude, ``|a - b| <= 8 * ulp(max |b|)``, with beta powers exact.

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.grad_comm import build_buckets as jax_buckets
from paddle_tpu.framework.tensor import Parameter, Tensor
from paddle_tpu.ops.pallas import fused_update as jfu
from paddle_tpu.optimizer.fused import FusedFlatUpdater as JaxUpdater
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed.grad_comm import build_buckets
from paddle_tpu_torch.ops import fused_update as tfu
from torch_checks import run_checks

torch.set_num_threads(2)

KINDS = (("sgd", False), ("momentum", False), ("momentum", True),
         ("adam", False), ("adamw", False))


def _hyper(kind, nesterov):
    if kind == "sgd":
        return {}
    if kind == "momentum":
        return {"momentum": 0.9, "nesterov": nesterov}
    return {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8}


def _case(kind, n, seed):
    rs = np.random.RandomState(seed)
    p = rs.randn(n).astype(np.float32)
    g = rs.randn(n).astype(np.float32)
    slots = {}
    for nm in tfu.slot_names(kind):
        v = (rs.randn(n) * 0.01).astype(np.float32)
        slots[nm] = np.abs(v) if nm == "moment2" else v
    if kind in ("adam", "adamw"):
        slots["beta1_pow"] = np.float32(0.9 ** 3)
        slots["beta2_pow"] = np.float32(0.999 ** 3)
    return p, g, slots


def _exact(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape)
    assert (a.view(np.int32) == b.view(np.int32)).all(), \
        f"{what}: {(a != b).sum()} of {a.size} elements differ"


def _normwise(a, b, what, ulps=8):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape)
    bound = ulps * np.spacing(np.float32(np.abs(b).max()))
    err = float(np.abs(a - b).max())
    assert err <= bound, f"{what}: max abs diff {err} > {bound}"


def check_plain_update_matches_reference(kind, nesterov, wd, n):
    hyper = _hyper(kind, nesterov)
    p, g, slots = _case(kind, n, seed=n + int(wd * 100))
    lr = np.float32(1e-3)
    js = {k: jnp.asarray(v) for k, v in slots.items()}
    ep, es = jfu.reference_update_flat(jnp.asarray(p), jnp.asarray(g), js,
                                       jnp.asarray(lr), kind=kind,
                                       hyper=hyper, lm=1.0, wd=wd)
    kp, ks = jfu.fused_update_flat(jnp.asarray(p), jnp.asarray(g), dict(js),
                                   jnp.asarray(lr), kind=kind, hyper=hyper,
                                   lm=1.0, wd=wd)
    tp = torch.from_numpy(p.copy())
    ts = {k: torch.tensor(v) for k, v in slots.items()}
    out, ts2 = tfu.fused_update_flat(tp, torch.from_numpy(g), ts,
                                     torch.tensor(lr), kind=kind,
                                     hyper=hyper, lm=1.0, wd=wd)
    assert out is tp                      # in place
    assert set(ts2) == set(es) == set(ks)
    _exact(ep, tp.numpy(), "p vs eager reference")
    _normwise(tp.numpy(), kp, "p vs Pallas interpret")
    for k in ts2:
        _exact(es[k], ts2[k].numpy(), f"{k} vs eager reference")
        if np.shape(es[k]) == ():
            _exact(ks[k], ts2[k].numpy(), f"{k} vs Pallas interpret")
        else:
            _normwise(ts2[k].numpy(), ks[k], f"{k} vs Pallas interpret")


def check_plain_update_matches_optimizer_rule(kind, nesterov, wd):
    """Flat update == the reference optimizer's per-parameter _update."""
    n = 1000
    hyper = _hyper(kind, nesterov)
    p, g, slots = _case(kind, n, seed=5)
    make = {"sgd": lambda ps: jopt.SGD(1e-3, parameters=ps),
            "momentum": lambda ps: jopt.Momentum(
                1e-3, 0.9, parameters=ps, use_nesterov=nesterov),
            "adam": lambda ps: jopt.Adam(1e-3, parameters=ps),
            "adamw": lambda ps: jopt.AdamW(1e-3, parameters=ps)}[kind]
    o = make([Parameter(jnp.zeros(1))])
    lr = np.float32(1e-3)
    js = {k: jnp.asarray(v) for k, v in slots.items()}
    ep, es = o._update(jnp.asarray(p), jnp.asarray(g), js, jnp.asarray(lr),
                       1.0, wd)
    tp = torch.from_numpy(p.copy())
    _, ts = tfu.fused_update_flat(
        tp, torch.from_numpy(g), {k: torch.tensor(v) for k, v in
                                  slots.items()},
        torch.tensor(lr), kind=kind, hyper=hyper, lm=1.0, wd=wd)
    _exact(ep, tp.numpy(), "p")
    for k, v in es.items():
        _exact(v, ts[k].numpy(), k)


def check_bucket_plan_matches_reference():
    shapes = [(40, 30), (30,), (7, 5, 3), (1,), (200, 8), (64,), (3, 3)]
    jp = [Parameter(jnp.zeros(s)) for s in shapes]
    tp = [torch.zeros(s) for s in shapes]
    for caps in ((25, 1), (0.004, 0.002)):
        a, b = jax_buckets(jp, *caps), build_buckets(tp, *caps)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert (x.index, x.param_indices, x.shapes, x.offsets, x.size) \
                == (y.index, y.param_indices, y.shapes, y.offsets, y.size)


def check_updater_steps_match_reference(kind):
    """Two FusedFlatUpdater steps on a multi-bucket plan, against the JAX
    updater with the Pallas kernel (use_kernel=True)."""
    shapes = [(40, 30), (30,), (7, 5, 3), (200, 8), (64,)]
    rs = np.random.RandomState(11)
    vals = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(2)]
    caps = (0.004, 0.002)                 # 4 KB / 2 KB: several buckets
    make = {"sgd": (jopt.SGD, topt.SGD), "adam": (jopt.Adam, topt.Adam),
            "adamw": (jopt.AdamW, topt.AdamW)}[kind]

    jp = [Parameter(jnp.asarray(v)) for v in vals]
    jo = make[0](learning_rate=1e-2, parameters=jp)
    ju = JaxUpdater(jo, jp, buckets=jax_buckets(jp, *caps), use_kernel=True)
    tp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in vals]
    to = make[1](learning_rate=1e-2, parameters=tp)
    tu = topt.FusedFlatUpdater(to, tp, buckets=build_buckets(tp, *caps))
    assert len(tu.buckets) == len(ju.buckets) >= 3
    for step in range(2):
        for p, g in zip(jp, grads[step]):
            p.grad = Tensor(jnp.asarray(g))
        ju.step()
        if step == 0:       # backward into the flat gradient buffers
            tu.zero_grad()
            for p, g in zip(tp, grads[step]):
                p.grad.copy_(torch.from_numpy(g))
        else:               # gradients the updater does not own
            for p, g in zip(tp, grads[step]):
                p.grad = torch.from_numpy(g.copy())
        tu.step()
    assert to._accumulated_steps == 2
    for p, q in zip(jp, tp):
        _normwise(q.detach().numpy(), np.asarray(p._value), "param")
    for b in tu.buckets:
        for k, v in tu._slots[b.index].items():
            ref = np.asarray(ju._slots[b.index][k])
            if v.dim() == 0:
                _exact(ref, v.numpy(), k)
            else:
                _normwise(v.numpy(), ref, k)


def check_per_param_step_equals_fused_step(kind):
    """The port's per-parameter ``Optimizer.step()`` and its fused flat
    update give the same bits (elementwise rules, same op order)."""
    shapes = [(40, 30), (30,), (7, 5, 3)]
    rs = np.random.RandomState(12)
    vals = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [rs.randn(*s).astype(np.float32) for s in shapes]
    cls = {"sgd": topt.SGD, "momentum": topt.Momentum, "adam": topt.Adam,
           "adamw": topt.AdamW}[kind]
    out = []
    for fused in (False, True):
        ps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in vals]
        o = cls(learning_rate=1e-2, parameters=ps, weight_decay=0.01)
        u = topt.FusedFlatUpdater(o, ps) if fused else None
        for _ in range(2):
            for p, g in zip(ps, grads):
                p.grad = torch.from_numpy(g.copy())
            (u or o).step()
            o.clear_grad()
            assert all(p.grad is None for p in ps)
        out.append([p.detach().numpy().copy() for p in ps])
    for a, b in zip(*out):
        _exact(a, b, f"{kind} per-param vs fused")


def check_updater_rejects_mixed_hypers():
    ps = [torch.nn.Parameter(torch.zeros(3)) for _ in range(2)]
    ps[1].optimize_attr = {"learning_rate": 0.5}
    with pytest.raises(ValueError, match="mixes"):
        topt.FusedFlatUpdater(topt.AdamW(1e-3, parameters=ps), ps)


def test_fused_update_matches_reference(fresh_mesh):
    run_checks(
        [(check_plain_update_matches_reference, (k, nv, wd, n))
         for k, nv in KINDS for wd in (0.0, 0.01) for n in (1, 127, 128,
                                                             1000)]
        + [(check_plain_update_matches_optimizer_rule, (k, nv, wd))
           for k, nv in KINDS for wd in (0.0, 0.01)]
        + [(check_bucket_plan_matches_reference, ())]
        + [(check_updater_steps_match_reference, (k,))
           for k in ("sgd", "adam", "adamw")]
        + [(check_per_param_step_equals_fused_step, (k,))
           for k in ("sgd", "momentum", "adam", "adamw")]
        + [(check_updater_rejects_mixed_hypers, ())])
