"""Speculative decoding of the port (``paddle_tpu_torch/serving``) against
the JAX reference, on the CPU, at ``gpt-test`` size.

- ``GPTDecodeModel.truncated(1)``: its ``prefill``, ``decode`` and
  ``extend`` logits and KV within 1e-4 of the reference's
  ``truncated(1)``; its block parameters are views of the full model's
  (no copy), ``elems_per_token = 1 * 2 * hidden``.
- Greedy speculative generation (``draft_model=dm.truncated(1)``,
  ``spec_k=4``) token for token against the reference's speculative
  engine, on an fp32 pool and on an int8_block pool with the prefix
  cache, with equal ``spec_steps`` and ``spec_emitted`` and equal pool
  stats; every sampled row's top-2 logit gap (draft proposals and
  verification rows alike) is asserted above 1e-3, so identity cannot
  hinge on a near-tie (the frameworks' fp32 logits differ by ~1e-6).
- Greedy and top_p speculation against the port's own plain engine,
  token for token (sampled tokens cannot match JAX's threefry bits).
- A self-draft (``draft_model=dm``) on an fp32 pool accepts more than k
  tokens a speculative step, as the reference's does.
- A reference fault the port does not copy: after a step that accepts
  all k drafts, the reference's draft cache forgets the row of the
  pending token it feeds first, so every later proposal is one
  position off. On a gpt-test whose random weights do not repeat one
  token (``initializer_range=0.2``) the reference's self-draft commits
  ~1.6 tokens a step; the port's commits every proposal (4.43, the most
  its 31 tokens allow); both sides' tokens equal the plain engine's.
- ``reserve``/``rollback`` leave no block leaked: after every run, and
  on a pool too small to reserve a speculative step's k+1 rows, where
  the engine falls back to a plain tick (same tokens as the plain
  engine).
- The ``spec_decode_step`` spans (and every other span of the requests'
  traces): names and non-time fields equal to the reference's.
- The near-tie rule the card holds speculation to
  (``tests/torch_serving_checks.py`` ``spec_rule``) passes equal tokens
  and refuses a token changed where the plain decision's margin is
  clear of 1e-3; ``decision_margin`` of a sampled row in logit units.

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_presets as jax_presets
from paddle_tpu.observability.tracing import get_tracer as jax_tracer
from paddle_tpu.serving import GPTDecodeModel as JaxDecodeModel
from paddle_tpu.serving import KVBlockPool as JaxPool
from paddle_tpu.serving import RequestQueue as JaxQueue
from paddle_tpu.serving import ServeRequest as JaxRequest
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import GPTForCausalLM, gpt_presets
from paddle_tpu_torch.observability.tracing import get_tracer
from paddle_tpu_torch.serving import (GPTDecodeModel, KVBlockPool,
                                      RequestQueue, SamplingParams,
                                      ServeRequest, ServingEngine)
from torch_checks import run_checks
from torch_serving_checks import GapSampler, decision_margin, drive, \
    spec_rule

torch.set_num_threads(2)

K = 4
TOL = 1e-4


def _prompts(seed=3):
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, 256, 20)
    return [np.concatenate([shared, rs.randint(0, 256, 5)]),
            rs.randint(0, 256, 7),
            np.concatenate([shared, rs.randint(0, 256, 2)]),
            rs.randint(0, 256, 13)]


def _spans(trace):
    """A trace's spans without times and ids: (name, fields)."""
    return [(s["name"], s["fields"]) for s in trace["spans"]]


def _run_port(tdm, prompts, codec="fp32", max_new=12, sampling=None,
              n_blocks=64, sampler=None, **ekw):
    q = RequestQueue()
    pool = KVBlockPool(n_blocks, 8, tdm.elems_per_token, codec=codec,
                       device="cpu")
    eng = ServingEngine(tdm, pool, q, max_batch=4, sampler=sampler, **ekw)
    reqs = [ServeRequest(prompt_ids=p, max_new_tokens=max_new,
                         request_id=f"r{i}",
                         sampling=sampling or SamplingParams())
            for i, p in enumerate(prompts)]
    drive(eng, q, reqs)
    return eng, reqs


def _run_jax(jdm, prompts, codec="fp32", max_new=12, **ekw):
    q = JaxQueue()
    eng = JaxEngine(jdm, JaxPool(64, 8, jdm.elems_per_token, codec=codec),
                    q, max_batch=4, **ekw)
    reqs = [JaxRequest(prompt_ids=p, max_new_tokens=max_new,
                       request_id=f"r{i}") for i, p in enumerate(prompts)]
    for r in reqs:
        q.submit(r)
    for _ in range(400):
        if not eng.step() and not eng.running and not q.depth:
            break
    assert all(r.outcome == "completed" for r in reqs)
    assert eng.pool.blocks_in_use == 0
    return eng, reqs


# ------------------------------------------------------------------ model

def check_truncated_steps_match_reference(dms):
    jdm, tdm = dms
    jd, td = jdm.truncated(1), tdm.truncated(1)
    assert (td.n_layers, td.elems_per_token) == (1, 2 * tdm.hidden)
    assert td.elems_per_token == jd.elems_per_token
    for name, p in td.params.items():   # views, no copy
        assert p.data_ptr() == tdm.params[name].data_ptr(), name
    with pytest.raises(ValueError):
        tdm.truncated(tdm.n_layers + 1)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 256, n) for n in (9, 4, 17)]
    jl, jkv = jd.prefill(prompts)
    tl, tkv = td.prefill(prompts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    for a, b in zip(tkv, jkv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=0)
    ept = td.elems_per_token
    B, S = 4, 16
    past = rs.randn(B, S, ept).astype(np.float32)
    past_len = np.array([3, 16, 0, 9], np.int32)
    ids = rs.randint(0, 256, B).astype(np.int32)
    pos = past_len.copy()
    jl, jkv = jd.decode(ids, pos, past, past_len)
    tl, tkv = td.decode(ids, pos, past, past_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), atol=TOL,
                               rtol=0)
    s = K + 1
    ids = rs.randint(0, 256, (B, s)).astype(np.int32)
    pos = past_len[:, None] + np.arange(s, dtype=np.int32)
    tail = np.full(B, s, np.int32)
    jl, jkv = jd.extend(ids, pos, past, past_len, tail)
    tl, tkv = td.extend(ids, pos, past, past_len, tail)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), atol=TOL,
                               rtol=0)


# ----------------------------------------------------------------- engine

def check_greedy_speculation_token_identical_to_reference(dms, codec):
    jdm, tdm = dms
    prompts = _prompts()
    jeng, jreqs = _run_jax(jdm, prompts, codec=codec,
                           draft_model=jdm.truncated(1), spec_k=K)
    gaps = GapSampler()
    eng, reqs = _run_port(tdm, prompts, codec=codec, sampler=gaps,
                          draft_model=tdm.truncated(1), spec_k=K)
    assert gaps.min_gap > 1e-3, gaps.min_gap
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert (eng.spec_steps, eng.spec_emitted) == (jeng.spec_steps,
                                                  jeng.spec_emitted)
    assert eng.spec_steps > 0
    assert eng.pool.stats() == jeng.pool.stats()
    assert eng.stats()["spec"] == jeng.stats()["spec"]


def check_speculation_lossless_against_plain_engine(dms, sampling):
    _, tdm = dms
    prompts = _prompts(4)
    _, plain = _run_port(tdm, prompts, codec="int8_block", sampling=sampling)
    eng, spec = _run_port(tdm, prompts, codec="int8_block",
                          sampling=sampling, draft_model=tdm.truncated(1),
                          spec_k=K)
    assert [r.generated for r in spec] == [r.generated for r in plain]
    assert eng.spec_steps > 0
    if sampling.temperature > 0:   # a sampled stream really samples
        _, greedy = _run_port(tdm, prompts, codec="int8_block")
        assert [r.generated for r in greedy] != [r.generated for r in plain]


def check_self_draft_accepts_more_than_k(dms):
    jdm, tdm = dms
    prompts = _prompts(5)[:2]
    eng, reqs = _run_port(tdm, prompts, max_new=16, draft_model=tdm,
                          spec_k=K)
    jeng, jreqs = _run_jax(jdm, prompts, max_new=16, draft_model=jdm,
                           spec_k=K)
    assert eng.spec_emitted / eng.spec_steps > K
    assert (eng.spec_steps, eng.spec_emitted) == (jeng.spec_steps,
                                                  jeng.spec_emitted)
    _, plain = _run_port(tdm, prompts, max_new=16)
    assert [r.generated for r in reqs] == [r.generated for r in plain]


def check_draft_cache_keeps_pending_rows():
    jdm = JaxDecodeModel(JaxGPT(jax_presets("gpt-test",
                                            initializer_range=0.2), seed=0))
    tdm = GPTDecodeModel(GPTForCausalLM(
        gpt_presets("gpt-test", initializer_range=0.2), seed=0,
        device="cpu"))
    prompts = [np.random.RandomState(i).randint(0, 256, 40)
               for i in range(2)]
    kw = dict(max_new=32, draft_model=None, spec_k=K)
    eng, spec = _run_port(tdm, prompts, **dict(kw, draft_model=tdm))
    jeng, jspec = _run_jax(jdm, prompts, **dict(kw, draft_model=jdm))
    _, plain = _run_port(tdm, prompts, max_new=32)
    assert len(set(spec[0].generated)) > 8      # not one repeated token
    assert [r.generated for r in spec] == [r.generated for r in plain] \
        == [r.generated for r in jspec]
    # 31 tokens after the prefill's: 6 steps of k+1 and one of 1
    assert eng.spec_steps == 7 * len(prompts)
    assert jeng.spec_emitted / jeng.spec_steps < 2.0 < \
        eng.spec_emitted / eng.spec_steps


def check_reserve_failure_falls_back_to_plain_tick(dms):
    """Two sequences whose reservations fill the pool but one block: the
    first sequence's k+1 scratch rows take it, the second's raise, the
    first's is rolled back and every tick is a plain decode. The tokens
    are the plain engine's and no block leaks."""
    _, tdm = dms
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, 256, 21) for _ in range(2)]
    # 21 + 3 context tokens = 3 blocks of 8 a request, 7 in the pool
    eng, spec = _run_port(tdm, prompts, max_new=4, n_blocks=7,
                          draft_model=tdm.truncated(1), spec_k=K)
    assert eng.spec_steps == 0 and eng.pool.free_blocks == 7
    _, plain = _run_port(tdm, prompts, max_new=4, n_blocks=7)
    assert [r.generated for r in spec] == [r.generated for r in plain]
    # a pool with room: speculation runs, and rollback returns the
    # scratch (drive() asserts blocks_in_use == 0)
    eng, _ = _run_port(tdm, prompts, max_new=4, n_blocks=8,
                       draft_model=tdm.truncated(1), spec_k=K)
    assert eng.spec_steps > 0 and eng.pool.free_blocks == 8


def check_spec_spans_match_reference(dms):
    jdm, tdm = dms
    prompts = _prompts(6)[:3]
    _, jreqs = _run_jax(jdm, prompts, codec="int8_block",
                        draft_model=jdm.truncated(1), spec_k=K)
    _, reqs = _run_port(tdm, prompts, codec="int8_block",
                        draft_model=tdm.truncated(1), spec_k=K)
    n_spec = 0
    for r, jr in zip(reqs, jreqs):
        got = _spans(get_tracer().store.get(r.trace.trace_id))
        want = _spans(jax_tracer().store.get(jr.trace.trace_id))
        assert got == want, (r.request_id, got, want)
        n_spec += sum(1 for name, _ in got if name == "spec_decode_step")
        spec = [f for name, f in got if name == "spec_decode_step"]
        assert all(set(f) == {"replica", "batch", "emitted", "matched"}
                   for f in spec)
    assert n_spec > 0


def check_near_tie_rule_refuses_a_clear_difference(dms):
    _, tdm = dms
    prompts = _prompts(8)[:2]
    pool_kw = dict(n_blocks=64, block_tokens=8,
                   elems_per_token=tdm.elems_per_token, codec="int8_block",
                   device="cpu")
    _, plain = _run_port(tdm, prompts, codec="int8_block")
    _, spec = _run_port(tdm, prompts, codec="int8_block",
                        draft_model=tdm.truncated(1), spec_k=K)
    assert spec_rule(tdm, plain, spec, pool_kw) == []
    spec[1].generated[5] = (spec[1].generated[5] + 1) % 256
    with pytest.raises(AssertionError, match="beyond a near-tie"):
        spec_rule(tdm, plain, spec, pool_kw)
    # a sampled row: the draw's distance to its token's interval edges
    # in logit units, or a sorted neighbour's logit gap
    row = torch.log(torch.tensor([0.5, 0.3, 0.2], dtype=torch.float64))
    sp = SamplingParams(temperature=1.0)
    assert abs(decision_margin(row, sp, 0.45) - 0.05 / 1.0) < 1e-9
    assert abs(decision_margin(row, sp, 0.6) - 0.1 / 1.6) < 1e-9
    close = torch.log(torch.tensor([0.5, 0.2501, 0.2499],
                                   dtype=torch.float64))
    assert abs(decision_margin(close, sp, 0.6)
               - float(np.log(0.2501 / 0.2499))) < 1e-9
    assert abs(decision_margin(row, SamplingParams(), 0.6)
               - float(np.log(0.5) - np.log(0.3))) < 1e-6


def test_speculative_decoding_matches_reference(fresh_mesh):
    dms = (JaxDecodeModel(JaxGPT(jax_presets("gpt-test"), seed=0)),
           GPTDecodeModel(GPTForCausalLM(gpt_presets("gpt-test"), seed=0,
                                         device="cpu")))
    run_checks(
        [(check_truncated_steps_match_reference, (dms,))]
        + [(check_greedy_speculation_token_identical_to_reference,
            (dms, c)) for c in ("fp32", "int8_block")]
        + [(check_speculation_lossless_against_plain_engine, (dms, sp))
           for sp in (SamplingParams(),
                      SamplingParams(temperature=0.8, top_k=20, top_p=0.95))]
        + [(check_self_draft_accepts_more_than_k, (dms,)),
           (check_reserve_failure_falls_back_to_plain_tick, (dms,)),
           (check_spec_spans_match_reference, (dms,)),
           (check_draft_cache_keeps_pending_rows, ()),
           (check_near_tie_rule_refuses_a_clear_difference, (dms,))])
