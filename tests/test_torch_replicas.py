"""The replica set of the port (``paddle_tpu_torch/serving/replica.py``)
and its robustness parts against the JAX reference, on the CPU, at
``gpt-test`` size.

- A ``pump``-driven 2-replica set (int8_block pools, the prefix cache,
  ``draft_model=dm.truncated(1)``, ``spec_k=4``): tokens, each replica's
  completions, speculation counts and pool stats equal to the
  reference's ``pump``-driven set (greedy); with an eviction mid-run the
  same, plus the eviction ledger and the requests' attempts.
- Chaos on worker threads, each losing zero requests, outputs equal to a
  clean run and no live pool leaking a block (the reference's
  ``tests/test_serving.py`` ``TestReplicaSet`` and
  ``tests/test_serving_prefix_spec.py`` chaos cases): a hang injected by
  a ``pre_step`` hook, evicted by the 0.3 s watchdog; a crash; a corrupt
  replica (one weight changed) caught by the ``ReplicaGuard`` against
  the boot-time digest; a crash mid-speculation.
- ``drain()`` during a mid-admission intake: the popped requests come
  back reincarnated (attempts + 1, the same trace), a request in both
  intake and running once; the drained engine's ``_finish`` does
  nothing; the pool is abandoned, not freed; ``_intake_discard`` matches
  by identity.
- The ``boot -> compiling -> serving`` states, the compile guard on a
  first bucket, ``seen_buckets`` equal to the reference's, ``warm`` and
  its budget (``ReplicaBootBudgetExceeded``).
- ``scale_down``/``scale_up(warm=True)``/``replace`` with the boot ledger,
  and ``FLAGS_replica_boot_budget_s`` exceeded falling back to a cold
  boot, against the reference's set doing the same.
- ``params_digest`` equal to the reference's on the same fp32, bf16 and
  fp16 arrays and on the decode models' ``param_list``.
- The codec wrappers' launch counters, hammered from two threads
  (``ops/codec.py`` ``_count_encode``/``_count_decode``, the code a
  launch runs on the card; switch interval 1 us): every count kept.

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import sys
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.framework import flags as jflags
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_presets as jax_presets
from paddle_tpu.robustness.distributed_ft import params_digest as jax_digest
from paddle_tpu.serving import GPTDecodeModel as JaxDecodeModel
from paddle_tpu.serving import ReplicaSet as JaxReplicaSet
from paddle_tpu.serving import RequestQueue as JaxQueue
from paddle_tpu.serving import ServeRequest as JaxRequest
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import KVBlockPool as JaxPool
from paddle_tpu_torch.framework.flags import flag, set_flags
from paddle_tpu_torch.models import GPTForCausalLM, gpt_presets
from paddle_tpu_torch.observability.metrics import get_registry
from paddle_tpu_torch.observability.tracing import get_tracer
from paddle_tpu_torch.ops import codec
from paddle_tpu_torch.robustness import params_digest
from paddle_tpu_torch.serving import (GPTDecodeModel, KVBlockPool,
                                      ReplicaBootBudgetExceeded, ReplicaSet,
                                      RequestQueue, ServeRequest,
                                      ServingEngine)
from torch_checks import run_checks
from torch_serving_checks import drive

torch.set_num_threads(2)

K = 4


def _prompts(n, seed):
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, 256, 12)
    return [np.concatenate([shared, rs.randint(0, 256, 3 + i)]) if i % 3 == 0
            else rs.randint(0, 256, 5 + i) for i in range(n)]


def _set(cls, dm, **kw):
    args = dict(n_replicas=2, n_blocks=32, block_tokens=8, max_batch=2)
    args.update(kw)
    return cls(dm, **args)


def _submit(rset, req_cls, prompts, max_new=6):
    reqs = [req_cls(prompt_ids=p, max_new_tokens=max_new, request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    for r in reqs:
        assert rset.submit(r)
    return [r.request_id for r in reqs]


def _pump_all(rset, ids, limit=400):
    for _ in range(limit):
        if set(ids) <= set(rset.results):
            return rset.results
        rset.pump()
    raise AssertionError(f"lost: {set(ids) - set(rset.results)}")


def _clean(tdm, prompts, max_new=6, **ekw):
    """A clean single-engine run of ``prompts``: id -> tokens."""
    q = RequestQueue()
    eng = ServingEngine(tdm, KVBlockPool(64, 8, tdm.elems_per_token,
                                         device="cpu"), q, max_batch=4,
                        **ekw)
    reqs = [ServeRequest(prompt_ids=p, max_new_tokens=max_new,
                         request_id=f"r{i}") for i, p in enumerate(prompts)]
    drive(eng, q, reqs)
    return {r.request_id: r.generated for r in reqs}


def _no_live_leak(rset):
    live = [e for e in rset.engines if e.alive]
    assert live
    for e in live:
        assert e.pool.blocks_in_use == 0, (e.name, e.pool.stats())


# ------------------------------------------------------------ pump mode

def check_pumped_set_matches_reference(dms, evict_at):
    jdm, tdm = dms
    prompts = _prompts(7, 1)
    kw = dict(codec="int8_block", draft_model=None, spec_k=K)
    sets = []
    for cls, dm, req_cls in ((JaxReplicaSet, jdm, JaxRequest),
                             (ReplicaSet, tdm, ServeRequest)):
        rset = _set(cls, dm, **dict(kw, draft_model=dm.truncated(1)))
        ids = _submit(rset, req_cls, prompts, max_new=16)
        if evict_at:
            rset.pump(evict_at)
            rset.evict(0, "hang")
        _pump_all(rset, ids)
        sets.append(rset)
    jset, tset = sets
    tok = {i: r.generated for i, r in tset.results.items()}
    assert tok == {i: r.generated for i, r in jset.results.items()}
    assert tok == _clean(tdm, prompts, max_new=16,
                         draft_model=tdm.truncated(1), spec_k=K)
    assert {i: r.attempts for i, r in tset.results.items()} == \
        {i: r.attempts for i, r in jset.results.items()}
    for te, je in zip(tset.engines, jset.engines):
        assert (te.completed, te.spec_steps, te.spec_emitted, te.alive) == \
            (je.completed, je.spec_steps, je.spec_emitted, je.alive)
        assert te.pool.stats() == je.pool.stats()
    strip = [{k: v for k, v in e.items() if k != "t"} for e in
             tset.evictions]
    assert strip == [{k: v for k, v in e.items() if k != "t"}
                     for e in jset.evictions]
    assert len(strip) == (1 if evict_at else 0)
    if evict_at:
        assert strip[0]["drained"] >= 1


# ---------------------------------------------------------------- chaos

def check_hang_evicted_by_watchdog_zero_lost(dms):
    _, tdm = dms
    prompts = _prompts(8, 2)
    gate, hung = threading.Event(), threading.Event()

    def hang_hook(eng):
        if eng.running and not gate.is_set():
            hung.set()
            gate.wait(30)   # "stuck inside a step"

    rset = _set(ReplicaSet, tdm, watchdog_timeout=0.3,
                pre_step_hooks={0: hang_hook})
    try:
        with rset:
            ids = _submit(rset, ServeRequest, prompts)
            assert hung.wait(20), "replica 0 never picked up work"
            res = rset.wait(ids, timeout=60)
            deadline = time.monotonic() + 10
            while not rset.evictions and time.monotonic() < deadline:
                time.sleep(0.02)
            gate.set()      # the zombie wakes into a fenced engine
    finally:
        gate.set()
    assert len(res) == len(ids), f"lost: {set(ids) - set(res)}"
    assert all(r.outcome == "completed" for r in res.values())
    assert [e["reason"] for e in rset.evictions] == ["hang"]
    assert rset.evictions[0]["drained"] >= 1
    assert not rset.engines[0].alive and rset.engines[1].alive
    assert any(r.attempts > 0 for r in res.values())
    assert {i: r.generated for i, r in res.items()} == _clean(tdm, prompts)
    _no_live_leak(rset)


def check_crash_evicted_zero_lost(dms, spec):
    _, tdm = dms
    prompts = _prompts(6, 3)
    state = {"armed": True}

    def crash_hook(eng):
        if eng.running and state["armed"]:
            state["armed"] = False
            raise RuntimeError("injected replica crash")

    ekw = dict(draft_model=tdm.truncated(1), spec_k=K) if spec else {}
    rset = _set(ReplicaSet, tdm, pre_step_hooks={0: crash_hook}, **ekw)
    with rset:
        ids = _submit(rset, ServeRequest, prompts, max_new=8)
        res = rset.wait(ids, timeout=60)
    assert len(res) == len(ids)
    assert all(r.outcome == "completed" for r in res.values())
    assert [e["reason"] for e in rset.evictions] == ["error"]
    assert {i: r.generated for i, r in res.items()} == \
        _clean(tdm, prompts, max_new=8, **ekw)
    _no_live_leak(rset)


def check_corrupt_replica_evicted_by_guard(dms):
    _, tdm = dms
    bad = GPTDecodeModel.__new__(GPTDecodeModel)
    bad.__dict__.update(tdm.__dict__)
    bad.params = dict(tdm.params)
    w = bad.params["fc1_w"].clone()
    w[0, 0, 0] += 1.0   # SDC: one changed weight
    bad.params["fc1_w"] = w
    prompts = _prompts(6, 4)
    rset = _set(ReplicaSet, tdm, guard_every=1, models=[bad, tdm])
    with rset:
        ids = _submit(rset, ServeRequest, prompts)
        res = rset.wait(ids, timeout=60)
    assert len(res) == len(ids)
    assert all(r.outcome == "completed" for r in res.values())
    assert [e["reason"] for e in rset.evictions] == ["corrupt"]
    assert not rset.engines[0].alive
    assert {i: r.generated for i, r in res.items()} == _clean(tdm, prompts)
    _no_live_leak(rset)


# ---------------------------------------------------------------- drain

def _engine(tdm, **kw):
    q = RequestQueue()
    pool = KVBlockPool(32, 8, tdm.elems_per_token, codec="int8_block",
                       device="cpu")
    return ServingEngine(tdm, pool, q, max_batch=4, **kw), q


def check_drain_mid_admission_reincarnates_and_fences(dms):
    _, tdm = dms
    done = get_registry().get("serve_requests_total").labels(
        outcome="completed")
    finished = []
    # (a) drained while the batch is mid-prefill: the intake ledger
    eng, q = _engine(tdm, on_finish=lambda e, r: finished.append(r))
    reqs = [ServeRequest(prompt_ids=p, max_new_tokens=1, request_id=f"a{i}")
            for i, p in enumerate(_prompts(2, 5))]
    for r in reqs:
        q.submit(r)
    seen = {}
    prefill = eng._prefill

    def drained_mid_prefill(batch):
        seen["intake"] = list(eng._intake)
        seen["drained"] = eng.drain()
        prefill(batch)

    eng._prefill = drained_mid_prefill
    n0 = done.get()
    assert eng.step()
    assert [r.request_id for r in seen["intake"]] == ["a0", "a1"]
    back = seen["drained"]
    assert [r.request_id for r in back] == ["a0", "a1"]
    assert all(b is not r and b.attempts == r.attempts + 1
               and b.trace is r.trace and not b.generated
               for b, r in zip(back, reqs))
    # a drained engine's _finish does nothing: both hit max_new at their
    # first token and neither is counted, timed, traced or handed on
    assert all(r.outcome == "" and r.t_done == 0.0 for r in reqs)
    assert done.get() == n0 and not finished and eng._intake == []
    spans = [s["name"] for s in get_tracer().store.get(
        reqs[0].trace.trace_id)["spans"]]
    assert spans == ["queue_wait", "drain", "prefill"]
    assert not eng.alive and not eng.step()
    # (b) drained after the batch landed in running but before its intake
    # entries were released: each request once
    eng, q = _engine(tdm)
    reqs = [ServeRequest(prompt_ids=p, max_new_tokens=5, request_id=f"b{i}")
            for i, p in enumerate(_prompts(2, 6))]
    for r in reqs:
        q.submit(r)
    start = eng._start_seq

    def drained_after_landing(*a):
        start(*a)
        if len(eng.running) == 2:
            seen["both"] = (len(eng._intake), eng.drain())

    eng._start_seq = drained_after_landing
    eng.step()
    n_intake, back = seen["both"]
    assert n_intake == 2
    assert [r.request_id for r in back] == ["b0", "b1"]
    # the pool is abandoned with the engine, not freed
    assert eng.pool.blocks_in_use > 0
    # (c) _intake_discard matches by identity, never by equality
    a = ServeRequest(prompt_ids=np.arange(4), request_id="same")
    b = ServeRequest(prompt_ids=np.arange(4), request_id="same")
    eng, _ = _engine(tdm)
    eng._intake = [a, b]
    assert eng._intake_discard(b) and eng._intake[0] is a
    assert len(eng._intake) == 1 and not eng._intake_discard(b)


# --------------------------------------------------------- boot, warm

class _StateProbe:
    """Delegates to a decode model, recording the engine's state at each
    call."""

    def __init__(self, dm):
        self._dm = dm
        self.engine = None
        self.calls = []

    def __getattr__(self, name):
        attr = getattr(self._dm, name)
        if name in ("prefill", "decode", "extend"):
            def call(*a, **k):
                self.calls.append((name, self.engine.state))
                return attr(*a, **k)
            return call
        return attr


def check_boot_compiling_serving_and_warm(dms):
    jdm, tdm = dms
    eng, q = _engine(tdm)
    probe = _StateProbe(tdm)
    probe.engine, eng.model = eng, probe
    assert eng.state == "boot"
    assert not eng.step()                  # idle tick: still compiling
    assert eng.state == "compiling"
    prompts = _prompts(3, 7)
    reqs = [ServeRequest(prompt_ids=p, max_new_tokens=6, request_id=f"w{i}")
            for i, p in enumerate(prompts)]
    drive(eng, q, reqs)
    assert eng.state == "serving"
    # every first call of a bucket ran under "compiling", every repeat
    # under "serving"
    assert probe.calls[0] == ("prefill", "compiling")
    assert ("decode", "serving") in probe.calls
    assert sum(1 for _, st in probe.calls if st == "compiling") \
        == len(eng.seen_buckets())
    jq = JaxQueue()
    jeng = JaxEngine(jdm, JaxPool(32, 8, jdm.elems_per_token,
                                  codec="int8_block"), jq, max_batch=4)
    jreqs = [JaxRequest(prompt_ids=p, max_new_tokens=6, request_id=f"w{i}")
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jq.submit(r)
    for _ in range(100):
        if not jeng.step() and not jeng.running and not jq.depth:
            break
    assert eng.seen_buckets() == jeng.seen_buckets()
    # a warmed engine runs the same traffic without a compiling state
    warm, q2 = _engine(tdm)
    assert warm.warm(eng.seen_buckets()) == len(eng.seen_buckets())
    assert warm.state == "serving" and warm._warm
    probe2 = _StateProbe(tdm)
    probe2.engine, warm.model = warm, probe2
    drive(warm, q2, [ServeRequest(prompt_ids=p, max_new_tokens=6)
                     for p in prompts])
    assert probe2.calls and all(st == "serving" for _, st in probe2.calls)
    cold, _ = _engine(tdm)
    with pytest.raises(ReplicaBootBudgetExceeded):
        cold.warm(eng.seen_buckets(), deadline=time.monotonic() - 1.0)


def check_scaling_and_warm_handoff_match_reference(dms):
    jdm, tdm = dms
    prompts = _prompts(6, 8)
    ledgers = []
    prev = (flag("FLAGS_replica_boot_budget_s"),
            jflags.flag("FLAGS_replica_boot_budget_s"))
    try:
        for cls, dm, req_cls, setf in (
                (JaxReplicaSet, jdm, JaxRequest, jflags.set_flags),
                (ReplicaSet, tdm, ServeRequest, set_flags)):
            setf({"FLAGS_replica_boot_budget_s": 300.0})
            rset = _set(cls, dm, codec="int8_block")
            ids = _submit(rset, req_cls, prompts)
            rset.pump(3)
            down = rset.scale_down()
            rset.pump(2)
            up = rset.scale_up(warm=True)
            swap = rset.replace(0)
            setf({"FLAGS_replica_boot_budget_s": 0.0})
            late = rset.scale_up(warm=True)
            res = _pump_all(rset, ids)
            assert all(r.outcome == "completed" for r in res.values())
            ledgers.append({
                "tokens": {i: r.generated for i, r in res.items()},
                "down": {k: v for k, v in down.items() if k != "t"},
                "up": (up, late),
                "swap": {k: v for k, v in swap.items() if k != "t"},
                "boots": [(b["replica"], b["mode"], b["outcome"])
                          for b in rset.boots],
                "counts": rset.warm_boot_counts(),
                "events": [{k: v for k, v in e.items() if k != "t"}
                           for e in rset.scale_events],
                "alive": [e.alive for e in rset.engines],
                "warm": [e._warm for e in rset.engines]})
            for e in rset.engines:
                if e.alive:
                    assert e.pool.blocks_in_use == 0
    finally:
        set_flags({"FLAGS_replica_boot_budget_s": prev[0]})
        jflags.set_flags({"FLAGS_replica_boot_budget_s": prev[1]})
    jl, tl = ledgers
    assert tl == jl
    assert tl["down"]["drained"] >= 1
    assert [b[1:] for b in tl["boots"]] == [
        ("warm", "ok"), ("warm", "ok"), ("warm", "warm_boot_timeout"),
        ("cold", "ok")]
    assert tl["counts"] == {"warm_boots": 2, "warm_boot_timeouts": 1}
    assert tl["tokens"] == _clean(tdm, prompts)


# --------------------------------------------------------------- digest

def check_params_digest_matches_reference(dms):
    jdm, tdm = dms
    rs = np.random.RandomState(9)
    arrays = [rs.randn(3, 5).astype(np.float32),
              rs.randn(7).astype(np.float32) * 1e3,
              np.zeros((2, 2), np.float32)]
    assert np.array_equal(params_digest([torch.from_numpy(a)
                                         for a in arrays]),
                          jax_digest(arrays))
    for tdt, mdt in ((torch.bfloat16, ml_dtypes.bfloat16),
                     (torch.float16, np.float16)):
        ts = [torch.from_numpy(a).to(tdt) for a in arrays]
        ref = [t.view(torch.int16).numpy().view(mdt) for t in ts]
        assert np.array_equal(params_digest(ts), jax_digest(ref)), tdt
    assert np.array_equal(params_digest(tdm.param_list()),
                          jax_digest(jdm.param_list()))
    bad = [p.clone() for p in tdm.param_list()]
    bad[3].view(-1)[0] += 1.0
    assert not np.array_equal(params_digest(bad),
                              params_digest(tdm.param_list()))


def check_codec_counts_kept_under_two_threads():
    saved = (codec.block_encode.launches, dict(codec.block_encode.shapes),
             dict(codec.block_encode.dtypes), codec.block_decode.launches,
             dict(codec.block_decode.dtypes))
    interval = sys.getswitchinterval()
    n = 100_000
    shape = (4, 1024, "int8_block", False)

    def work():
        for _ in range(n):
            codec._count_encode(shape, torch.float32)
            codec._count_decode(torch.float32)

    try:
        codec.reset_launch_counts()
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        sys.setswitchinterval(interval)
        assert codec.launch_counts() == {"codec_encode": 2 * n,
                                         "codec_decode": 2 * n}
        assert codec.block_encode.shapes[shape] == 2 * n
        assert codec.block_decode.dtypes[torch.float32] == 2 * n
    finally:
        sys.setswitchinterval(interval)
        codec.reset_launch_counts()
        codec.block_encode.launches = saved[0]
        codec.block_encode.shapes.update(saved[1])
        codec.block_encode.dtypes.update(saved[2])
        codec.block_decode.launches = saved[3]
        codec.block_decode.dtypes.update(saved[4])


def test_replica_set_matches_reference(fresh_mesh):
    dms = (JaxDecodeModel(JaxGPT(jax_presets("gpt-test"), seed=0)),
           GPTDecodeModel(GPTForCausalLM(gpt_presets("gpt-test"), seed=0,
                                         device="cpu")))
    run_checks(
        [(check_pumped_set_matches_reference, (dms, at)) for at in (0, 1)]
        + [(check_hang_evicted_by_watchdog_zero_lost, (dms,))]
        + [(check_crash_evicted_zero_lost, (dms, spec))
           for spec in (False, True)]
        + [(check_corrupt_replica_evicted_by_guard, (dms,)),
           (check_drain_mid_admission_reincarnates_and_fences, (dms,)),
           (check_boot_compiling_serving_and_warm, (dms,)),
           (check_scaling_and_warm_handoff_match_reference, (dms,)),
           (check_params_digest_matches_reference, (dms,)),
           (check_codec_counts_kept_under_two_threads, ())])
