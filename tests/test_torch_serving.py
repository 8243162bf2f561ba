"""Port serving (paddle_tpu_torch.serving) against the JAX reference, on the
CPU, at ``gpt-test`` size, plus the port's package rules.

- Pool: append read-back, gather, payload bytes and scale bytes equal the
  JAX ``KVBlockPool``'s for int8_block and fp8_block (exact); the
  incremental mirror equals gather; COW on a shared prefix; LRU reuse
  with no leak after ``free_table``.
- Engine: greedy generation with int8_block KV and the prefix cache on is
  token-identical to the JAX ``ServingEngine``; every step's top-2 logit
  gap is asserted above 1e-3 (the two frameworks' fp32 logits differ by
  ~1e-6), so identity cannot hinge on a near-tie. Prefix cache on and off
  give the same tokens (fp32 KV, as the reference pins it). Sampled
  tokens cannot match JAX's threefry bits, so the port pins placement
  invariance instead.
- bf16 decode model: on ``gpt-test`` in bf16 (the reference's weights
  carried with ``state_dict_from_numpy``), ``prefill``'s last-position
  logits and per-token KV and ``forced_logits`` are bf16 on both sides
  and within 2 bf16 ulps of each tensor's largest value (measured 1: the
  reference's CPU tanh-gelu rounds after each op, the port's once);
  ``decode`` and ``extend`` raise ``TypeError`` on both sides (the
  reference's fp32 ``past`` promotes its scan carry).
- Package rules: the port imports neither ``jax`` nor ``paddle_tpu``.

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_presets as jax_presets
from paddle_tpu.serving import GPTDecodeModel as JaxDecodeModel
from paddle_tpu.serving import KVBlockPool as JaxPool
from paddle_tpu.serving import RequestQueue as JaxQueue
from paddle_tpu.serving import ServeRequest as JaxRequest
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import (GPTForCausalLM, gpt_presets,
                                     state_dict_from_numpy)
from paddle_tpu_torch.serving import (BatchSampler, GPTDecodeModel,
                                      KVBlockPool, KVCacheOOM, RequestQueue,
                                      SamplingParams, ServeRequest,
                                      ServingEngine)
from torch_checks import run_checks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPT = 2 * 2 * 64   # gpt-test: layers x {k,v} x hidden


def _payload_bytes(pool):
    if isinstance(pool, KVBlockPool):
        return (pool._payload.view(torch.uint8).numpy(),
                None if pool._scales is None else pool._scales.numpy())
    return (pool._payload.view(np.uint8),
            None if pool._scales is None else pool._scales)


def _same_pool_bytes(tp, jp):
    (tq, ts), (jq, js) = _payload_bytes(tp), _payload_bytes(jp)
    assert np.array_equal(tq, jq)
    if js is not None:
        assert np.array_equal(ts, js)


# --------------------------------------------------------------------- pool

def check_pool_bytes_readback_and_gather_match_jax(codec, quant_block):
    rs = np.random.RandomState(quant_block)
    tp = KVBlockPool(16, 4, EPT, codec=codec, quant_block=quant_block,
                     device="cpu")
    jp = JaxPool(16, 4, EPT, codec=codec, quant_block=quant_block)
    ta, ja = tp.alloc_table(14), jp.alloc_table(14)
    tb, jb = tp.alloc_table(6), jp.alloc_table(6)
    for t_tab, j_tab, n in ((ta, ja, 3), (tb, jb, 2), (ta, ja, 1),
                            (ta, ja, 6), (tb, jb, 4), (ta, ja, 4)):
        kv = rs.randn(n, EPT).astype(np.float32) * rs.uniform(0.1, 10)
        if n == 2:
            kv[0] = 0.0                      # all-zero token: scale floor
        got = tp.append(t_tab, kv)
        want = jp.append(j_tab, kv)
        assert np.array_equal(got.numpy(), want)
    _same_pool_bytes(tp, jp)
    for t_tab, j_tab in ((ta, ja), (tb, jb)):
        assert np.array_equal(tp.gather(t_tab).numpy(), jp.gather(j_tab))
    assert tp.stats() == jp.stats()


def check_pool_append_batch_matches_jax_appends_one_table_at_a_time(codec):
    """A decode step's batched append (one encode for every table's rows)
    stores the bytes and returns the read-back of per-table appends."""
    rs = np.random.RandomState(11)
    tp = KVBlockPool(16, 4, EPT, codec=codec, quant_block=128, device="cpu")
    jp = JaxPool(16, 4, EPT, codec=codec, quant_block=128)
    t_tabs = [tp.alloc_table(n) for n in (9, 6, 12)]
    j_tabs = [jp.alloc_table(n) for n in (9, 6, 12)]
    for counts in ((1, 1, 1), (2, 0, 3), (1, 1, 1), (4, 3, 5)):
        kv = rs.randn(sum(counts), EPT).astype(np.float32)
        got = tp.append_batch(t_tabs, kv, list(counts))
        ends = np.cumsum((0,) + counts)
        want = [jp.append(j, kv[a:b])
                for j, a, b in zip(j_tabs, ends[:-1], ends[1:]) if b > a]
        assert np.array_equal(got.numpy(), np.concatenate(want))
    assert [t.n_tokens for t in t_tabs] == [8, 5, 10]
    _same_pool_bytes(tp, jp)
    for t_tab, j_tab in zip(t_tabs, j_tabs):
        assert np.array_equal(tp.gather(t_tab).numpy(), jp.gather(j_tab))
    with pytest.raises(ValueError, match="each table once"):
        tp.append_batch([t_tabs[0], t_tabs[0]],
                        np.zeros((2, EPT), np.float32), [1, 1])


def check_pool_mirror_equals_gather_and_cow_keeps_sharer_bytes():
    rs = np.random.RandomState(5)
    tp = KVBlockPool(16, 4, EPT, codec="int8_block", device="cpu")
    jp = JaxPool(16, 4, EPT, codec="int8_block")
    prompt = np.arange(10, dtype=np.int32)   # 2 full blocks + 2 rows
    kv = rs.randn(10, EPT).astype(np.float32)
    tabs = {}
    for name, pool in (("t", tp), ("j", jp)):
        a = pool.alloc_table(16, prefix_tokens=prompt)
        mirror = np.asarray(pool.append(a, kv))
        pool.register_prefix(a, prompt)
        b = pool.alloc_table(16, prefix_tokens=prompt)
        assert (b.n_tokens, b.n_shared) == (10, 3) and b.cow_spare is not None
        shared = b.block_ids[2]
        new = rs.randn(3, EPT).astype(np.float32)
        pool.append(b, new)                  # frontier in a shared block
        assert b.block_ids[2] != shared and b.n_shared == 2
        np.testing.assert_array_equal(np.asarray(pool.gather(a)), mirror)
        np.testing.assert_array_equal(np.asarray(pool.gather(b))[:10],
                                      mirror)
        tabs[name] = (a, b)
        rs = np.random.RandomState(5)        # same draws for the JAX pool
        kv = rs.randn(10, EPT).astype(np.float32)
    assert tabs["t"][1].block_ids == tabs["j"][1].block_ids
    _same_pool_bytes(tp, jp)
    for pool in (tp, jp):
        for tab in tabs["t" if pool is tp else "j"]:
            pool.free_table(tab)
        assert pool.blocks_in_use == 0


def check_pool_lru_reuse_without_leak():
    tp = KVBlockPool(8, 8, EPT, codec="int8_block", device="cpu")
    rs = np.random.RandomState(0)
    prompts = [np.full((8,), i, np.int32) for i in range(11)]
    for p in prompts:
        t = tp.alloc_table(8, prefix_tokens=p)
        tp.append(t, rs.randn(8, EPT).astype(np.float32))
        tp.register_prefix(t, p)
        tp.free_table(t)
        assert tp.blocks_in_use == 0
    assert tp.cached_blocks == 8 and tp.prefix_evictions == 3
    assert tp.probe_prefix(prompts[-1]) == 8
    assert tp.probe_prefix(prompts[0]) == 0
    big = tp.alloc_table(64)                 # every block, LRU included
    assert tp.free_blocks == 0
    with pytest.raises(KVCacheOOM):
        tp.alloc_table(1)
    tp.free_table(big)
    assert tp.blocks_in_use == 0 and tp.free_blocks == 8


def check_pool_reserve_rollback_leak_free():
    tp = KVBlockPool(16, 4, EPT, codec="fp32", device="cpu")
    t = tp.alloc_table(10)
    tp.append(t, np.zeros((10, EPT), np.float32))
    base = len(t.block_ids)
    tp.reserve(t, 9)
    assert len(t.block_ids) > base
    tp.append(t, np.ones((9, EPT), np.float32))
    tp.rollback(t, 7)
    assert t.n_tokens == 12
    assert len(t.block_ids) == max(base, tp.blocks_needed(12))
    tp.free_table(t)
    assert tp.blocks_in_use == 0


# ------------------------------------------------------------------- engine

class _GapSampler(BatchSampler):
    """Records the smallest top-2 logit gap over every row it samples."""

    min_gap = float("inf")

    def sample(self, logits, params, identities, positions):
        top2 = logits.topk(2, dim=-1).values
        self.min_gap = min(self.min_gap,
                           float((top2[:, 0] - top2[:, 1]).min()))
        return super().sample(logits, params, identities, positions)


def _prompts(seed=0):
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, 256, 20)
    return [np.concatenate([shared, rs.randint(0, 256, 3)]),
            rs.randint(0, 256, 11),
            np.concatenate([shared, rs.randint(0, 256, 9)]),
            shared.copy(),
            rs.randint(0, 256, 29)]


def _drive(engine, queue, reqs, max_steps=400):
    for r in reqs:
        assert queue.submit(r)
    for _ in range(max_steps):
        if not engine.step() and not engine.running and not queue.depth:
            break
    assert all(r.outcome == "completed" for r in reqs)
    assert engine.pool.blocks_in_use == 0


def _run_port(tdm, prompts, codec="int8_block", prefix_cache=True,
              sampling=None, max_new=16, ids=None, sampler=None):
    q = RequestQueue()
    pool = KVBlockPool(64, 8, tdm.elems_per_token, codec=codec, device="cpu")
    eng = ServingEngine(tdm, pool, q, max_batch=4, prefix_cache=prefix_cache,
                        sampler=sampler)
    reqs = [ServeRequest(prompt_ids=p, max_new_tokens=max_new,
                         sampling=(sampling[i] if sampling else
                                   SamplingParams()),
                         **({"request_id": ids[i]} if ids else {}))
            for i, p in enumerate(prompts)]
    _drive(eng, q, reqs)
    return eng, reqs


def check_greedy_int8_prefix_cached_engine_token_identical_to_jax(dms):
    jdm, tdm = dms
    prompts = _prompts()
    jq = JaxQueue()
    jeng = JaxEngine(jdm, JaxPool(64, 8, jdm.elems_per_token,
                                  codec="int8_block"), jq, max_batch=4,
                     prefix_cache=True)
    jreqs = [JaxRequest(prompt_ids=p, max_new_tokens=16) for p in prompts]
    _drive(jeng, jq, jreqs)
    gaps = _GapSampler()
    eng, reqs = _run_port(tdm, prompts, sampler=gaps)
    assert gaps.min_gap > 1e-3, gaps.min_gap
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == 16 for r in reqs)
    # the prefix cache was exercised on both sides, identically
    assert eng.pool.stats() == jeng.pool.stats()
    assert eng.pool.cached_blocks > 0


def check_prefix_cache_on_off_same_tokens(dms):
    _, tdm = dms
    prompts = _prompts(1)
    _, on = _run_port(tdm, prompts, codec="fp32", prefix_cache=True)
    _, off = _run_port(tdm, prompts, codec="fp32", prefix_cache=False)
    assert [r.generated for r in on] == [r.generated for r in off]


def check_sampled_request_placement_invariant(dms):
    _, tdm = dms
    prompts = _prompts(2)
    sp = SamplingParams(temperature=0.8, top_p=0.95)
    greedy = SamplingParams()
    target = prompts[1]
    _, alone = _run_port(tdm, [target], sampling=[sp], ids=["probe"])
    others = [prompts[0], prompts[2], prompts[4]]
    _, first = _run_port(tdm, [target] + others,
                         sampling=[sp, greedy, greedy, greedy],
                         ids=["probe", "a", "b", "c"])
    _, last = _run_port(tdm, others + [target],
                        sampling=[greedy, sp, greedy, sp],
                        ids=["a", "b2", "c", "probe"])
    assert alone[0].generated == first[0].generated == last[3].generated
    # a sampled stream really samples: another identity diverges
    assert last[1].generated != first[1].generated


def check_sampler_greedy_topk_and_determinism():
    rs = np.random.RandomState(0)
    logits = torch.from_numpy(rs.randn(5, 50).astype(np.float32))
    s = BatchSampler(seed=0)
    argmax = logits.argmax(-1)
    assert torch.equal(s.sample(logits, [SamplingParams()] * 5,
                                list("abcde"), [0] * 5), argmax)
    top1 = [SamplingParams(temperature=1.5, top_k=1)] * 5
    assert torch.equal(s.sample(logits, top1, list("abcde"), [3] * 5), argmax)
    hot = [SamplingParams(temperature=1.0)] * 5
    a = s.sample(logits, hot, list("abcde"), [1, 2, 3, 4, 5])
    b = s.sample(logits.flip(0), hot[::-1], list("edcba"), [5, 4, 3, 2, 1])
    assert torch.equal(a, b.flip(0))
    # a nucleus of one token is the argmax
    assert torch.equal(s.sample(logits * 100, [SamplingParams(
        temperature=1.0, top_p=1e-6)] * 5, list("abcde"), [0] * 5), argmax)


def check_queue_rejects_at_depth_and_engine_drain_frees_blocks(dms):
    _, tdm = dms
    q = RequestQueue(max_depth=2)
    reqs = [ServeRequest(prompt_ids=np.arange(n)) for n in (5, 6, 7)]
    assert q.submit(reqs[0]) and q.submit(reqs[1])
    assert not q.submit(reqs[2])
    pool = KVBlockPool(32, 8, tdm.elems_per_token, codec="int8_block",
                       device="cpu")
    eng = ServingEngine(tdm, pool, q, max_batch=4)
    eng.step()
    assert len(eng.running) == 2 and pool.blocks_in_use > 0
    back = eng.drain()
    assert [r.request_id for r in back] == [r.request_id for r in reqs[:2]]
    assert all(not r.generated and r.t_submit for r in back)
    assert pool.blocks_in_use == 0 and not eng.step()


# ------------------------------------------------------ bf16 decode model
BF16_ULPS = 2   # of each tensor's largest value


def _bf16_dms():
    """The reference's bf16 gpt-test decode model and the port's over
    the same weights."""
    jm = JaxGPT(jax_presets("gpt-test", dtype="bfloat16"), seed=0)
    cfg = gpt_presets("gpt-test", dtype="bfloat16")
    tm = GPTForCausalLM(cfg, seed=0, device="cpu")
    tm.load_state_dict(state_dict_from_numpy(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()}, cfg))
    return JaxDecodeModel(jm), GPTDecodeModel(tm)


def _within_bf16_ulps(got, want, what):
    assert got.dtype == torch.bfloat16, (what, got.dtype)
    assert str(np.asarray(want).dtype) == "bfloat16", what
    want = np.asarray(want).astype(np.float32)
    err = float(np.abs(got.float().numpy() - want).max())
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert err <= BF16_ULPS * ulp, f"{what}: {err / ulp:.1f} bf16 ulps"


def check_bf16_prefill_and_forced_logits_match_reference(bf16_dms):
    jdm, tdm = bf16_dms
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 256, n) for n in (5, 13, 9)]
    jl, jkv = jdm.prefill(prompts)
    tl, tkv = tdm.prefill(prompts)
    _within_bf16_ulps(tl, jl, "prefill logits")
    for i, (a, b) in enumerate(zip(tkv, jkv)):
        assert tuple(a.shape) == b.shape, (a.shape, b.shape)
        _within_bf16_ulps(a, b, f"prefill kv {i}")
    ids = rs.randint(0, 256, (2, 16))
    _within_bf16_ulps(tdm.forced_logits(ids), jdm.forced_logits(ids),
                      "forced_logits")


def check_bf16_decode_and_extend_raise_on_both_sides(bf16_dms):
    ept = bf16_dms[0].elems_per_token
    z = np.zeros(2, np.int32)
    past = np.zeros((2, 8, ept), np.float32)
    for dm in bf16_dms:
        with pytest.raises(TypeError):
            dm.decode(z, z, past, z)
        with pytest.raises(TypeError):
            dm.extend(np.zeros((2, 4), np.int32), np.zeros((2, 4), np.int32),
                      past, z, z + 4)
    with pytest.raises(TypeError, match="scan carry"):
        bf16_dms[1].decode(z, z, past, z)


# ------------------------------------------------------------ package rules

def _port_files():
    root = os.path.join(REPO, "paddle_tpu_torch")
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(root):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def check_port_sources_import_no_jax_or_reference_package():
    banned = ("jax", "paddle_tpu")
    for path in _port_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in banned, f"{path} imports {n}"


def check_importing_port_serving_loads_no_jax():
    code = ("import paddle_tpu_torch.serving, sys; "
            "bad = [m for m in sys.modules if m in ('jax', 'paddle_tpu') or "
            "m.startswith(('jax.', 'paddle_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def check_default_device_pool_raises_without_cuda():
    with pytest.raises(RuntimeError, match="CUDA"):
        KVBlockPool(4, 4, EPT, codec="int8_block")


def test_serving_port_matches_reference(fresh_mesh):
    # fresh_mesh: the JAX model must not inherit a mesh left behind by an
    # earlier test file on this worker
    dms = (JaxDecodeModel(JaxGPT(jax_presets("gpt-test"), seed=0)),
           GPTDecodeModel(GPTForCausalLM(gpt_presets("gpt-test"), seed=0,
                                         device="cpu")))
    checks = (
        [(check_pool_bytes_readback_and_gather_match_jax, (c, qb))
         for c in ("int8_block", "fp8_block") for qb in (128, 256)]
        + [(check_pool_append_batch_matches_jax_appends_one_table_at_a_time,
            (c,)) for c in ("int8_block", "fp8_block")]
        + [(check_pool_mirror_equals_gather_and_cow_keeps_sharer_bytes, ()),
           (check_pool_lru_reuse_without_leak, ()),
           (check_pool_reserve_rollback_leak_free, ()),
           (check_greedy_int8_prefix_cached_engine_token_identical_to_jax,
            (dms,)),
           (check_prefix_cache_on_off_same_tokens, (dms,)),
           (check_sampled_request_placement_invariant, (dms,)),
           (check_sampler_greedy_topk_and_determinism, ()),
           (check_queue_rejects_at_depth_and_engine_drain_frees_blocks,
            (dms,)),
           (check_port_sources_import_no_jax_or_reference_package, ()),
           (check_importing_port_serving_loads_no_jax, ())])
    bf16_dms = _bf16_dms()
    checks += [(check_bf16_prefill_and_forced_logits_match_reference,
                (bf16_dms,)),
               (check_bf16_decode_and_extend_raise_on_both_sides,
                (bf16_dms,))]
    if not torch.cuda.is_available():   # the raise path needs no card
        checks.append((check_default_device_pool_raises_without_cuda, ()))
    run_checks(checks)
