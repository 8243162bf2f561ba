"""Port GPT parameters and decode model (paddle_tpu_torch) against the JAX
reference, on the CPU, at ``gpt-test`` size (2 layers, hidden 64).

- Weights: the port's numpy-seeded ``GPTForCausalLM(cfg, seed=s)``
  equals ``convert(JAX GPTForCausalLM(cfg, seed=s))`` bit for bit.
- Config: the port's ``GPTConfig`` has every field of the reference's,
  in order, with equal defaults; the fields whose other values the port
  does not run (``dtype`` other than float32, bfloat16 and float16,
  e.g. ``"float64"``, ``sequence_parallel``, ``pp_microbatches``;
  ``recompute_policy`` runs since, ``tests/test_torch_gpt_options.py``)
  build a config, and building a model from it
  raises ``NotImplementedError`` naming its ROADMAP Queue A item.
  ``bench.py``'s own ``gpt_presets("gpt-125m", dtype="bfloat16")`` is
  ported (``tests/test_torch_bf16_train.py``).
- Decode model: prefill/decode/extend/forced_logits logits and the KV
  payload match the JAX ``GPTDecodeModel`` on the same weights, and the
  port's ``forced_logits`` match the JAX training forward. Tolerance:
  max abs diff <= 1e-4 in fp32 (the two frameworks sum in different
  orders; the reference's own teacher-forced parity is ~1e-5).

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_presets as jax_presets
from paddle_tpu.serving import GPTDecodeModel as JaxDecodeModel
from paddle_tpu.serving import bucket_pow2 as jax_bucket
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, gpt_presets,
                                     state_dict_from_numpy)
from paddle_tpu_torch.serving import GPTDecodeModel, bucket_pow2
from torch_checks import run_checks

torch.set_num_threads(2)

TOL = 1e-4


def _jax_params(model):
    return {name: np.asarray(p._value) for name, p in model.named_parameters()}


def _close(a, b, tol=TOL):
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= tol, f"max abs diff {err} > {tol}"


def check_port_init_equals_converted_jax_init(seed):
    cfg = gpt_presets("gpt-test")
    jm = JaxGPT(jax_presets("gpt-test"), seed=seed)
    tm = GPTForCausalLM(cfg, seed=seed, device="cpu")
    converted = state_dict_from_numpy(_jax_params(jm), cfg)
    port = tm.state_dict()
    assert list(port) == list(converted)
    for name, t in converted.items():
        assert port[name].dtype == torch.float32
        assert torch.equal(port[name], t), name
    # and the converted weights load into the port model unchanged
    tm.load_state_dict(converted)


def check_convert_rejects_wrong_names_and_shapes():
    cfg = gpt_presets("gpt-test")
    params = _jax_params(JaxGPT(jax_presets("gpt-test"), seed=0))
    with pytest.raises(KeyError):
        state_dict_from_numpy({k: v for k, v in params.items()
                               if "final_norm" not in k}, cfg)
    bad = dict(params)
    bad["gpt.decoder.0.qkv_w"] = np.zeros((64, 192), np.float32)
    with pytest.raises(ValueError):
        state_dict_from_numpy(bad, cfg)


def check_presets_match_reference():
    for name in ("gpt-test", "gpt-125m", "gpt-1.3b"):
        a, b = gpt_presets(name), jax_presets(name)
        for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "max_position_embeddings", "layer_norm_epsilon",
                  "initializer_range", "ffn", "head_dim"):
            assert getattr(a, f) == getattr(b, f), (name, f)


def check_config_fields_match_reference():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(GPTConfig) == fields(JaxGPTConfig)


def check_unported_field_builds_config_and_model_raises(over, item):
    cfg = gpt_presets("gpt-125m" if "dtype" in over else "gpt-test", **over)
    ref = jax_presets("gpt-125m" if "dtype" in over else "gpt-test", **over)
    for name, value in over.items():
        assert getattr(cfg, name) == getattr(ref, name), name
    with pytest.raises(NotImplementedError, match=item):
        GPTForCausalLM(cfg, device="cpu")


def check_bucket_pow2_matches_reference():
    for n in (1, 3, 8, 9, 100):
        for mn, mx in ((1, 0), (8, 64), (16, 0)):
            assert bucket_pow2(n, mn, mx) == jax_bucket(n, mn, mx)


def check_prefill_logits_and_kv_match_jax(jdm, tdm):
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, 256, n) for n in (5, 17, 9)]
    j_last, j_kv = jdm.prefill(prompts)
    t_last, t_kv = tdm.prefill(prompts)
    _close(t_last, j_last)
    for a, b in zip(t_kv, j_kv):
        _close(a, b)


def check_forced_logits_match_jax_decode_model_and_forward(jm, jdm, tdm):
    import paddle_tpu as paddle

    ids = np.random.RandomState(2).randint(0, 256, (2, 12))
    t = tdm.forced_logits(ids)
    _close(t, jdm.forced_logits(ids))
    fwd = jm(paddle.to_tensor(ids.astype(np.int64)))
    _close(t, np.asarray(fwd._value))


def _ragged_past(rs, b, S, lens, ept):
    past = np.zeros((b, S, ept), np.float32)
    for i, n in enumerate(lens):
        past[i, :n] = rs.randn(n, ept).astype(np.float32) * 0.5
    return past


def check_decode_ragged_batch_matches_jax(jdm, tdm):
    rs = np.random.RandomState(3)
    lens = np.array([0, 5, 16, 11], np.int32)
    past = _ragged_past(rs, 4, 16, lens, tdm.elems_per_token)
    ids = rs.randint(0, 256, 4).astype(np.int32)
    pos = lens.copy()
    j_lg, j_kv = jdm.decode(ids, pos, past, lens)
    t_lg, t_kv = tdm.decode(ids, pos, past, lens)
    _close(t_lg, j_lg)
    _close(t_kv, j_kv)


def check_extend_matches_jax(jdm, tdm):
    rs = np.random.RandomState(4)
    lens = np.array([3, 8], np.int32)
    tails = np.array([4, 2], np.int32)
    past = _ragged_past(rs, 2, 8, lens, tdm.elems_per_token)
    ids = rs.randint(0, 256, (2, 4)).astype(np.int32)
    pos = lens[:, None] + np.arange(4)[None, :]
    j_lg, j_kv = jdm.extend(ids, pos, past, lens, tails)
    t_lg, t_kv = tdm.extend(ids, pos, past, lens, tails)
    for i, n in enumerate(tails):    # rows past tail_len are padding
        _close(t_lg[i, :n], j_lg[i, :n])
        _close(t_kv[i, :n], j_kv[i, :n])


def check_teacher_forced_prefill_decode_equals_forced_logits(tdm):
    """The port's own incremental consistency (the reference's PR-14
    invariant): prefill + decode steps reproduce the full forward."""
    ids = np.random.RandomState(5).randint(0, 256, 10)
    full = tdm.forced_logits(ids[None])[0]
    last, kvs = tdm.prefill([ids[:6]])
    _close(last[0], full[5], 1e-5)
    past = kvs[0]
    for t in range(6, 10):
        S = bucket_pow2(t, minimum=16)
        buf = torch.zeros(1, S, tdm.elems_per_token)
        buf[0, :t] = past
        lg, kv = tdm.decode([ids[t]], [t], buf, [t])
        _close(lg[0], full[t], 1e-5)
        past = torch.cat([past, kv], dim=0)


def check_default_device_is_cuda_and_raises_without_it():
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTForCausalLM(gpt_presets("gpt-test"), seed=0)


def test_gpt_port_matches_reference(fresh_mesh):
    # fresh_mesh: the JAX training forward's sharding constraints reject
    # a mesh left behind by an earlier test file on this worker
    jm = JaxGPT(jax_presets("gpt-test"), seed=0)
    tm = GPTForCausalLM(gpt_presets("gpt-test"), seed=0, device="cpu")
    jdm, tdm = JaxDecodeModel(jm), GPTDecodeModel(tm)
    checks = [(check_port_init_equals_converted_jax_init, (0,)),
              (check_port_init_equals_converted_jax_init, (7,)),
              (check_convert_rejects_wrong_names_and_shapes, ()),
              (check_presets_match_reference, ()),
              (check_config_fields_match_reference, ()),
              *((check_unported_field_builds_config_and_model_raises,
                 (over, item)) for over, item in (
                  ({"dtype": "float64"}, "other dtypes"),
                  ({"sequence_parallel": True}, "parallelism"),
                  ({"pp_microbatches": 2}, "parallelism"))),
              (check_bucket_pow2_matches_reference, ()),
              (check_prefill_logits_and_kv_match_jax, (jdm, tdm)),
              (check_forced_logits_match_jax_decode_model_and_forward,
               (jm, jdm, tdm)),
              (check_decode_ragged_batch_matches_jax, (jdm, tdm)),
              (check_extend_matches_jax, (jdm, tdm)),
              (check_teacher_forced_prefill_decode_equals_forced_logits,
               (tdm,))]
    if not torch.cuda.is_available():   # the raise path needs no card
        checks.append((check_default_device_is_cuda_and_raises_without_it,
                       ()))
    run_checks(checks)
