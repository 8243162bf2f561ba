"""Port BERT (``paddle_tpu_torch/models/bert.py``) and its int8 conversion
against the JAX reference (``paddle_tpu/models/bert.py``,
``paddle_tpu/quantization``) on the CPU, at ``bert-test`` size (2 layers,
hidden 64, vocab 256), on weights carried from the reference with
``bert_state_dict_from_numpy`` (a non-zero ``mlm_bias`` included).

- fp32 MLM and NSP logits within 1e-4 of the reference's, without a mask
  and with a bool padding mask (the reference adds ``x * 1e4 - 1e4``).
- After ``convert_to_int8`` on both sides, nearest and stochastic (the
  weight names carried, so ``stable_seed`` agrees): the same set of
  replaced layers by name, every layer's int8 payload and scales
  bit-identical, MLM and NSP logits within 1e-4; the int8 logits within
  a mean relative error of 0.05 of the fp32 ones (the reference's own
  criterion for int8 serving).
- One ``TransformerEncoderLayer`` with the options BERT leaves at one
  value, ``relu`` and ``normalize_before`` (pre- and post-norm), within
  1e-4 of the reference's on carried weights, with a bool padding mask.
- The weight mapping rejects wrong names, shapes and dtypes; the
  training path not ported yet (the tensor-parallel marks) and the
  ``nn`` options not ported yet raise ``NotImplementedError`` naming
  their ROADMAP item, and the ported ones (the MLM loss, fused or not,
  ``BertPretrainingCriterion``, dropout > 0 in training) run; the port's presets
  equal the reference's; importing the port's BERT and quantization
  loads neither ``jax`` nor ``paddle_tpu``.

Tolerance 1e-4 max abs in fp32: the two frameworks sum in different
orders (measured: at most 4.8e-7 fp32 and 1.2e-6 int8; int8 against
fp32 0.7-0.9% mean relative error).

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.models import BertForPretraining as JaxBert
from paddle_tpu.models import bert_presets as jax_presets
from paddle_tpu.quantization import convert_to_int8 as jax_convert
from paddle_tpu_torch.models import (BertForPretraining,
                                     BertPretrainingCriterion, bert_presets,
                                     bert_state_dict_from_numpy)
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.quantization import Int8Linear, convert_to_int8
from torch_checks import run_checks

torch.set_num_threads(2)

TOL = 1e-4
B, S = 2, 16


def _carried(seed=0):
    """A reference model (eval) and the port's model loaded with its
    weights and weight names."""
    cfg = bert_presets("bert-test")
    jm = JaxBert(jax_presets("bert-test"))
    jm.eval()
    bias = (np.random.RandomState(seed).randn(cfg.vocab_size) * 0.1
            ).astype(np.float32)
    jm.mlm_bias.set_value(bias)
    params = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    names = {n: p.name for n, p in jm.named_parameters()}
    tm = BertForPretraining(cfg, seed=seed, device="cpu").eval()
    tm.load_state_dict(bert_state_dict_from_numpy(params, cfg, names))
    return jm, tm


def _inputs():
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 256, (B, S))
    types = (np.arange(S)[None] >= S // 2).astype(np.int64).repeat(B, 0)
    mask = np.ones((B, 1, 1, S), bool)
    mask[1, ..., 11:] = False                   # padding of the 2nd row
    return ids, types, mask


def _run(jm, tm, mask=None):
    ids, types, _ = _inputs()
    jl, jn = jm(paddle.to_tensor(ids, dtype="int64"),
                paddle.to_tensor(types, dtype="int64"),
                attention_mask=None if mask is None else paddle.to_tensor(mask))
    tl, tn = tm(ids, types, attention_mask=mask)
    return (jl.numpy(), jn.numpy()), (tl.detach().numpy(), tn.detach().numpy())


def _close(a, b, what):
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= TOL, f"{what}: max abs diff {err} > {TOL}"


def check_fp32_logits_match(masked):
    jm, tm = _carried()
    mask = _inputs()[2] if masked else None
    (jl, jn), (tl, tn) = _run(jm, tm, mask)
    assert tl.shape == (B, S, 256) and tn.shape == (B, 2)
    _close(jl, tl, "MLM logits")
    _close(jn, tn, "NSP logits")
    if masked:   # the mask reaches the model: padding changes row 1 only
        (_, _), (ul, _) = _run(jm, tm, None)
        assert np.array_equal(ul[0], tl[0]) and not np.allclose(ul[1], tl[1])


def check_int8_conversion_matches(stochastic):
    jm, tm = _carried()
    _, (fp32, _) = _run(jm, tm)
    jax_convert(jm, stochastic=stochastic)
    convert_to_int8(tm, stochastic=stochastic)
    jset = {n for n, s in jm.named_sublayers()
            if type(s).__name__ == "Int8Linear"}
    tset = {n for n, s in tm.named_modules() if isinstance(s, Int8Linear)}
    assert tset == jset, tset ^ jset
    assert len(tset) == 6 * tm.config.num_layers + 3, sorted(tset)
    jsub, tsub = dict(jm.named_sublayers()), dict(tm.named_modules())
    for n in sorted(tset):
        jq, tq = jsub[n], tsub[n]
        assert np.array_equal(np.asarray(jq.qweight._value),
                              tq.qweight.numpy()), f"{n}: payload differs"
        assert np.array_equal(np.asarray(jq.scales._value).view(np.int32),
                              tq.scales.numpy().view(np.int32)), n
    assert not any(type(m).__name__ == "Linear" for m in tm.modules())
    (jl, jn), (tl, tn) = _run(jm, tm)
    _close(jl, tl, "int8 MLM logits")
    _close(jn, tn, "int8 NSP logits")
    rel = np.abs(tl - fp32).mean() / np.abs(fp32).mean()
    assert rel < 0.05, rel


def check_weight_mapping_rejects_bad_input():
    cfg = bert_presets("bert-test")
    jm = JaxBert(jax_presets("bert-test"))
    params = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    with pytest.raises(KeyError):
        bert_state_dict_from_numpy({k: v for k, v in params.items()
                                    if k != "nsp.bias"}, cfg)
    bad = dict(params)
    bad["transform.weight"] = np.zeros((64, 32), np.float32)
    with pytest.raises(ValueError):
        bert_state_dict_from_numpy(bad, cfg)
    bad["transform.weight"] = params["transform.weight"].astype(np.float64)
    with pytest.raises(TypeError):
        bert_state_dict_from_numpy(bad, cfg)
    # without names each Linear keeps its own
    tm = BertForPretraining(cfg, device="cpu")
    own = tm.transform.weight_name
    tm.load_state_dict(bert_state_dict_from_numpy(params, cfg))
    assert tm.transform.weight_name == own
    assert list(tm.state_dict()) == list(bert_state_dict_from_numpy(params,
                                                                    cfg))


def check_training_paths_raise():
    """What BERT training still leaves out raises, naming its ROADMAP
    item: the tensor-parallel marks ("parallelism"), the encoder's cache.
    The MLM loss, the fused loss, ``BertPretrainingCriterion`` and
    dropout > 0 in training, ported since, run
    (``tests/test_torch_bert_train.py`` and
    ``tests/test_torch_nn_layers.py`` hold them)."""
    cfg = bert_presets("bert-test")
    tm = BertForPretraining(cfg, device="cpu")
    ids = np.zeros((1, 4), np.int64)
    loss, nsp = tm(ids, masked_lm_labels=ids)
    assert loss.dim() == 0 and bool(torch.isfinite(loss))
    fused = BertForPretraining(bert_presets("bert-test", fused_loss_chunk=64),
                               device="cpu")
    assert bool(torch.isfinite(fused(ids, masked_lm_labels=ids)[0]))
    assert bool(torch.isfinite(BertPretrainingCriterion()(
        tm(ids)[0], nsp, ids, np.zeros(1, np.int64))))
    with pytest.raises(NotImplementedError, match="parallelism"):
        tm.bert.mark_tensor_parallel()
    drop = BertForPretraining(bert_presets("bert-test", dropout=0.1),
                              device="cpu")
    drop.eval()
    drop(ids)                                   # inference: identity
    drop.train()
    assert bool(torch.isfinite(drop(ids, masked_lm_labels=ids)[0]))
    layer = tm.bert.encoder.layers[0]
    with pytest.raises(NotImplementedError, match="cache"):
        layer(torch.zeros(1, 4, 64), cache=[])


def check_encoder_layer_matches_reference(normalize_before):
    """relu and pre-/post-norm, which BERT does not set, on one layer."""
    d, heads, ffn = 64, 4, 128
    jl = jnn.TransformerEncoderLayer(d, heads, ffn, dropout=0.0,
                                     activation="relu",
                                     normalize_before=normalize_before)
    jl.eval()
    tl = tnn.TransformerEncoderLayer(d, heads, ffn, dropout=0.0,
                                     activation="relu",
                                     normalize_before=normalize_before,
                                     device="cpu").eval()
    missing, unexpected = tl.load_state_dict(
        {n: torch.from_numpy(np.array(p._value))
         for n, p in jl.named_parameters()}, strict=False)
    assert not unexpected and all(k.endswith("_extra_state")
                                  for k in missing), (missing, unexpected)
    x = np.random.RandomState(2).randn(B, S, d).astype(np.float32)
    mask = _inputs()[2]
    want = jl(paddle.to_tensor(x), paddle.to_tensor(mask)).numpy()
    with torch.no_grad():
        got = tl(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    _close(want, got, f"encoder layer, normalize_before={normalize_before}")


def check_unported_nn_options_raise():
    item = "Transformer family and nn options"
    layer = tnn.TransformerEncoderLayer(64, 4, 128, device="cpu")
    for make in (lambda: tnn.Embedding(8, 4, padding_idx=0, device="cpu"),
                 lambda: tnn.Embedding(8, 4, sparse=True, device="cpu"),
                 lambda: tnn.MultiHeadAttention(64, 4, kdim=32, device="cpu"),
                 lambda: tnn.MultiHeadAttention(64, 4, need_weights=True,
                                                device="cpu"),
                 lambda: tnn.TransformerEncoderLayer(64, 4, 128,
                                                     activation="tanh",
                                                     device="cpu"),
                 lambda: tnn.TransformerEncoder(
                     layer, 2, norm=tnn.LayerNorm(64, device="cpu"))):
        with pytest.raises(NotImplementedError, match=item):
            make()


def check_presets_match_reference():
    for name in ("bert-test", "bert-base", "bert-large"):
        a, b = bert_presets(name), jax_presets(name)
        for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "max_position_embeddings", "type_vocab_size",
                  "layer_norm_eps", "initializer_range", "ffn"):
            assert getattr(a, f) == getattr(b, f), (name, f)


def check_importing_port_bert_loads_no_jax():
    code = ("import paddle_tpu_torch.models, paddle_tpu_torch.quantization, "
            "sys; bad = [m for m in sys.modules if m in ('jax', "
            "'paddle_tpu') or m.startswith(('jax.', 'paddle_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(__file__)))


def check_default_device_is_cuda_and_raises_without_it():
    with pytest.raises(RuntimeError, match="CUDA"):
        BertForPretraining(bert_presets("bert-test"))


def test_bert_port_matches_reference(fresh_mesh):
    checks = [(check_fp32_logits_match, (False,)),
              (check_fp32_logits_match, (True,)),
              (check_int8_conversion_matches, (False,)),
              (check_int8_conversion_matches, (True,)),
              (check_weight_mapping_rejects_bad_input, ()),
              (check_training_paths_raise, ()),
              (check_encoder_layer_matches_reference, (True,)),
              (check_encoder_layer_matches_reference, (False,)),
              (check_unported_nn_options_raise, ()),
              (check_presets_match_reference, ()),
              (check_importing_port_bert_loads_no_jax, ())]
    if not torch.cuda.is_available():   # the raise path needs no card
        checks.append((check_default_device_is_cuda_and_raises_without_it,
                       ()))
    run_checks(checks)
