"""Weights carried across from the JAX models (no reference file: new).

The caller extracts the JAX model's named parameters as numpy arrays
(``{name: np.asarray(p._value)}``); this module turns them into the
port's ``state_dict``, for ``GPTForCausalLM`` (``state_dict_from_numpy``),
``BertForPretraining`` (``bert_state_dict_from_numpy``) and any layer
whose names and shapes are read off the port's own model
(``dense_state_dict_from_numpy``: the ResNet family, with the batch
norms' ``_mean``/``_variance`` buffers, from the reference's
``Layer.state_dict()``; Wide&Deep's dense arms), and any port
``nn.Layer`` by its own ``set_state_dict`` (``load_layer_state``). The names are the same
on both sides, so the mapping checks names, shapes and dtype and copies
the bytes unchanged; BERT's expected names and shapes are read off the
port's own model too (``bert_layout``). The port itself never
sees JAX.

A bf16 GPT's parameters arrive as ``ml_dtypes`` bfloat16 arrays (what
``np.asarray`` makes of a JAX bf16 array). They are recognised by
``dtype.name == "bfloat16"``, without importing ``ml_dtypes``, and their
bits cross through an ``int16`` view: no rounding. fp32 arrays (the
final LayerNorm of a bf16 model, every parameter of an fp32 one) stay
fp32. Each array must have its parameter's dtype (``expected_dtypes``).

The gradient wire's resume state carries across too
(``grad_comm_state_for_rank``, ``grad_comm_state_to_reference``): the
reference's ``TrainStep(grad_comm=...)`` keeps every rank's
error-feedback residual in one ``(world, bucket_size)`` array per bucket,
row ``r`` being rank ``r``'s; each rank of the port holds its own row.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..framework.modules import torch_buffers, torch_named_parameters
from ..nn import Linear
from .bert import BertConfig, BertForPretraining
from .gpt import PORTED_DTYPES, GPTConfig, block_shapes

__all__ = ["expected_shapes", "expected_dtypes", "state_dict_from_numpy",
           "bert_layout",
           "bert_state_dict_from_numpy", "dense_state_dict_from_numpy",
           "load_layer_state",
           "grad_comm_state_for_rank",
           "grad_comm_state_to_reference"]


def expected_shapes(cfg: GPTConfig) -> Dict[str, tuple]:
    """Parameter name -> shape, in the reference's naming."""
    h = cfg.hidden_size
    out = {
        "gpt.embeddings.word_embeddings": (cfg.vocab_size, h),
        "gpt.embeddings.position_embeddings":
            (cfg.max_position_embeddings, h),
    }
    for i in range(cfg.num_layers):
        for name, shape in block_shapes(cfg).items():
            out[f"gpt.decoder.{i}.{name}"] = shape
    out["gpt.final_norm.weight"] = (h,)
    out["gpt.final_norm.bias"] = (h,)
    return out


def expected_dtypes(cfg: GPTConfig) -> Dict[str, torch.dtype]:
    """Parameter name -> dtype: ``cfg.dtype``'s for the blocks and
    tables, fp32 for the final LayerNorm (a generic layer, as in the
    reference)."""
    dt = PORTED_DTYPES[cfg.dtype]
    return {name: torch.float32 if name.startswith("gpt.final_norm")
            else dt for name in expected_shapes(cfg)}


def _copy_checked(params: Dict[str, np.ndarray], want: Dict[str, tuple],
                  dtypes: Optional[Dict[str, torch.dtype]] = None
                  ) -> Dict[str, torch.Tensor]:
    """Check names, shapes and dtypes (``dtypes``, fp32 by default) and
    copy each array into a CPU tensor, bits kept; a bfloat16 array
    crosses through an ``int16`` view."""
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {extra}")
    out = {}
    for name, shape in want.items():
        arr = np.asarray(params[name])
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        dt = torch.float32 if dtypes is None else dtypes[name]
        if arr.dtype.name != str(dt).split(".")[-1]:
            raise TypeError(f"{name}: dtype {arr.dtype}, expected {dt}")
        copy = np.array(arr, copy=True)
        out[name] = (torch.from_numpy(copy.view(np.int16)).view(dt)
                     if dt == torch.bfloat16 else torch.from_numpy(copy))
    return out


def state_dict_from_numpy(params: Dict[str, np.ndarray],
                          cfg: GPTConfig) -> Dict[str, torch.Tensor]:
    """JAX named parameters (numpy) -> the port's ``state_dict`` (CPU
    tensors of the arrays' dtypes, fp32 or bf16; ``load_state_dict``
    moves them to the model's device)."""
    return _copy_checked(params, expected_shapes(cfg), expected_dtypes(cfg))


def bert_layout(cfg: BertConfig):
    """``BertForPretraining``'s parameter name -> shape, in its own order
    (``Linear`` weights ``[in, out]``), and the module names of its
    ``Linear`` layers, read off a model built on the CPU."""
    model = BertForPretraining(cfg, device="cpu")
    shapes = {n: tuple(p.shape) for n, p in torch_named_parameters(model)}
    linears = {n for n, m in model.named_modules() if isinstance(m, Linear)}
    return shapes, linears


def bert_state_dict_from_numpy(params: Dict[str, np.ndarray],
                               cfg: BertConfig,
                               names: Optional[Dict[str, str]] = None
                               ) -> Dict[str, object]:
    """JAX ``BertForPretraining`` named parameters (numpy) -> the port's
    ``state_dict``. ``names`` optionally maps parameter names to the
    reference's ``Parameter.name`` (``{n: p.name for n, p in
    named_parameters()}``); each ``Linear`` then takes its weight's name
    (``<linear>._extra_state``), so ``stable_seed`` gives the port the
    reference's stochastic-rounding seed. Without ``names`` each
    ``Linear`` keeps its own."""
    shapes, linears = bert_layout(cfg)
    out = {}
    for key, t in _copy_checked(params, shapes).items():
        out[key] = t
        lin = key[:-len(".bias")]
        if key.endswith(".bias") and lin in linears:   # state_dict order
            name = None if names is None else names[lin + ".weight"]
            out[lin + "._extra_state"] = {"weight_name": name}
    return out


def dense_state_dict_from_numpy(arrays: Dict[str, np.ndarray],
                                model: torch.nn.Module
                                ) -> Dict[str, object]:
    """A reference layer's ``state_dict()`` as numpy arrays (``{n:
    np.asarray(t._value)}``: parameters and buffers) -> the port's
    ``state_dict`` for ``model``, a port layer of the same layout, each
    name and shape checked against it: a ResNet of the same depth,
    width, groups and classes (with the batch norms' running buffers),
    ``WideDeep``, ``bench.py``'s deep ``Sequential`` MLP
    (``models/wide_deep.py`` ``deep_mlp``).
    A ``Linear`` weight stays ``[in, out]``; each ``Linear`` keeps its own
    weight name."""
    want = {n: tuple(t.shape) for n, t in
            [*torch_named_parameters(model),
             *torch_buffers(model, named=True)]}
    out: Dict[str, object] = dict(_copy_checked(arrays, want))
    for name, m in model.named_modules():
        if isinstance(m, Linear):
            out[f"{name}._extra_state"] = {"weight_name": None}
    return out


def load_layer_state(layer, arrays: Dict[str, np.ndarray]):
    """A reference ``Layer``'s ``state_dict()`` as numpy arrays (``{n:
    np.asarray(t._value)}``: parameters and persistable buffers) loaded
    into ``layer``, a port ``nn.Layer`` of the same structure, by its
    ``set_state_dict``: the same structured names both ways, each
    shape and dtype checked, the bits copied. Returns ``layer``."""
    own = layer.state_dict()
    tensors = _copy_checked(arrays, {n: tuple(t.shape)
                                     for n, t in own.items()},
                            {n: t.dtype for n, t in own.items()})
    missing, unexpected = layer.set_state_dict(tensors)
    assert not missing and not unexpected, (missing, unexpected)
    return layer


def grad_comm_state_for_rank(state: dict, rank: int, world: int) -> dict:
    """The reference train step's communicator ``state_dict()`` (numpy
    residuals stacked ``(world, bucket_size)``) -> rank ``rank``'s
    ``GradCommunicator.state_dict()`` in the port (its own row)."""
    out = dict(state)
    out["residuals"] = {
        int(i): np.array(np.asarray(r, np.float32).reshape(world, -1)[rank])
        for i, r in (state.get("residuals") or {}).items()}
    return out


def grad_comm_state_to_reference(states) -> dict:
    """Every rank's ``GradCommunicator.state_dict()`` (rank order) -> the
    reference train step's communicator state: residuals stacked
    ``(world, bucket_size)``. The ranks must agree on everything else."""
    states = list(states)
    first = states[0]
    for r, st in enumerate(states[1:], 1):
        for k in ("codec", "error_feedback", "block_size", "bucket_key"):
            if st.get(k) != first.get(k):
                raise ValueError(f"rank {r} has {k} {st.get(k)!r}, rank 0 "
                                 f"{first.get(k)!r}")
        if set(st["residuals"]) != set(first["residuals"]):
            raise ValueError(f"rank {r} holds residuals of other buckets")
    out = dict(first)
    out["residuals"] = {
        i: np.stack([np.asarray(st["residuals"][i], np.float32)
                     for st in states])
        for i in first["residuals"]}
    return out
