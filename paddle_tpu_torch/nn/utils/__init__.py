"""``paddle.nn.utils`` (reference: ``paddle_tpu/nn/utils/__init__.py``):
``weight_norm``/``remove_weight_norm``, ``spectral_norm``,
``parameters_to_vector``/``vector_to_parameters``, ``clip_grad_norm_``
and ``clip_grad_value_``.

**The reparameterisations** recompute the effective weight in every
forward, as the reference's do. The reference sets it as the layer's
attribute; the port's layers read their weights from
``self._parameters`` (``nn/layer/layers.py``), so the effective weight
stands there for the duration of the forward (``_substituted``), and as
the layer's attribute after it, as in the reference:

- ``weight_norm`` replaces the parameter by ``<name>_v`` (its values)
  and ``<name>_g`` (the norm over every axis but ``dim``, kept as a
  size-1 axis); the weight is ``v g / max(|v|, 1e-12)`` ("weight_norm"),
  differentiable in both. ``remove_weight_norm`` folds it back into one
  parameter. The new parameters go to the weight's device.
- ``spectral_norm`` keeps the parameter and divides it by ``sigma``, the
  largest singular value of the weight as a ``[shape[dim], -1]`` matrix
  by ``n_power_iterations`` of the power method from ``u``, a draw of
  ``RandomState(0)`` kept from forward to forward on the weight's
  device; ``sigma`` is a constant of the gradient ("spectral_norm").

``clip_grad_norm_`` is the reference's formula: each gradient's 2-norm,
combined as ``(sum norm^p)^(1/p)`` (their largest for ``inf``), and
every gradient scaled in place by ``min(max_norm / (total + 1e-6),
1)``; it returns ``total``. ``clip_grad_value_`` clamps in place.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ...framework.autograd import call_op, unwrap, wrap
from ...framework.tensor import to_tensor

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters",
           "clip_grad_norm_", "clip_grad_value_"]


def _norm_except(w: torch.Tensor, dim: int) -> torch.Tensor:
    """The 2-norm over every axis but ``dim``, kept as size-1 axes."""
    axes = tuple(i for i in range(w.dim()) if i != dim)
    if not axes:
        return torch.sqrt(w * w)
    return torch.sqrt(torch.sum(w * w, dim=axes, keepdim=True))


@contextlib.contextmanager
def _substituted(layer, name, value):
    """``value`` in ``layer._parameters[name]``, where the layer's own
    forward reads its weight, until the block ends."""
    params = layer._parameters
    had, old = name in params, params.get(name)
    params[name] = value
    try:
        yield
    finally:
        if had:
            params[name] = old
        else:
            del params[name]


def _run_with(layer, name, eff, orig_forward, args, kwargs):
    with _substituted(layer, name, eff):
        out = orig_forward(*args, **kwargs)
    object.__setattr__(layer, name, wrap(eff))
    return out


def _set(p, value: torch.Tensor) -> None:
    with torch.no_grad():
        unwrap(p).copy_(value)


def weight_norm(layer, name="weight", dim=0):
    """``layer.<name>`` reparameterised as ``g v / |v|`` (the module
    docstring)."""
    w = layer._parameters[name]
    dim = dim if dim is not None else 0
    with torch.no_grad():
        g0 = _norm_except(w, dim)
    v = layer.create_parameter(shape=list(w.shape), device=w.device)
    _set(v, w)
    g = layer.create_parameter(shape=list(g0.shape), device=w.device)
    _set(g, g0)
    setattr(layer, name + "_v", v)
    setattr(layer, name + "_g", g)
    del layer._parameters[name]
    orig_forward = layer.forward

    def forward(*args, **kwargs):
        p = layer._parameters
        eff = call_op(lambda vv, gg: vv * (gg / torch.clamp(
            _norm_except(vv, dim), min=1e-12)), p[name + "_v"],
            p[name + "_g"], op_name="weight_norm")
        return _run_with(layer, name, eff, orig_forward, args, kwargs)

    layer.forward = forward
    layer._weight_norm_state = (name, dim, orig_forward)
    return layer


def remove_weight_norm(layer, name="weight"):
    """The reparameterisation folded back into one parameter."""
    state = layer.__dict__.get("_weight_norm_state")
    if state is None:
        return layer
    pname, dim, orig_forward = state
    p = layer._parameters
    v, g = p[pname + "_v"], p[pname + "_g"]
    with torch.no_grad():
        eff = v * (g / torch.clamp(_norm_except(v, dim), min=1e-12))
    w = layer.create_parameter(shape=list(eff.shape), device=v.device)
    _set(w, eff)
    setattr(layer, pname, w)
    del p[pname + "_v"]
    del p[pname + "_g"]
    layer.forward = orig_forward
    del layer._weight_norm_state
    return layer


def _vnorm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v))


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """``layer.<name>`` divided by its power-method ``sigma`` in every
    forward (the module docstring)."""
    w = layer._parameters[name]
    if dim is None:
        dim = 0
    rows = w.shape[dim]
    rs = np.random.RandomState(0)
    u = rs.randn(rows).astype("float32")
    u /= np.linalg.norm(u) + eps
    layer._sn_u = torch.from_numpy(u).to(w.device)
    orig_forward = layer.forward

    def forward(*args, **kwargs):
        weight = layer._parameters[name]
        with torch.no_grad():
            m = weight.movedim(dim, 0).reshape(rows, -1)
            u_ = layer._sn_u
            for _ in range(n_power_iterations):
                v_ = m.T @ u_
                v_ = v_ / (_vnorm(v_) + eps)
                u_ = m @ v_
                u_ = u_ / (_vnorm(u_) + eps)
            layer._sn_u = u_
            sigma = u_ @ m @ v_
        eff = call_op(lambda W: W / sigma, weight, op_name="spectral_norm")
        return _run_with(layer, name, eff, orig_forward, args, kwargs)

    layer.forward = forward
    return layer


def parameters_to_vector(parameters, name=None):
    """The parameters flattened into one vector (differentiable)."""
    return call_op(lambda *vals: torch.cat([v.reshape(-1) for v in vals]),
                   *list(parameters), op_name="parameters_to_vector")


def vector_to_parameters(vec, parameters, name=None):
    """Consecutive pieces of ``vec`` written into the parameters."""
    params = list(parameters)
    flat = unwrap(vec)
    flat = (flat.detach().reshape(-1) if isinstance(flat, torch.Tensor)
            else torch.from_numpy(np.asarray(flat).reshape(-1)))
    pos = 0
    for p in params:
        shape = tuple(unwrap(p).shape)
        n = int(np.prod(shape))
        _set(p, flat[pos:pos + n].reshape(shape))
        pos += n
    return params


def _listed(parameters):
    return (parameters if isinstance(parameters, (list, tuple))
            else [parameters])


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Every gradient scaled in place so that their combined norm is at
    most ``max_norm`` (the module docstring); returns the norm."""
    grads = [unwrap(p).grad for p in _listed(parameters)
             if unwrap(p).grad is not None]
    if not grads:
        return to_tensor(np.zeros(()))
    norms = torch.stack([_vnorm(g.reshape(-1)) for g in grads])
    if norm_type == float("inf"):
        total = torch.max(norms)
    else:
        total = torch.sum(norms ** norm_type) ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError("non-finite gradient norm")
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    with torch.no_grad():
        for g in grads:
            g.mul_(scale.to(g.dtype))
    return wrap(total)


def clip_grad_value_(parameters, clip_value):
    """Every gradient clamped to ``[-clip_value, clip_value]`` in
    place."""
    with torch.no_grad():
        for p in _listed(parameters):
            g = unwrap(p).grad
            if g is not None:
                g.clamp_(-clip_value, clip_value)
