"""Continuous-batching decode engine (reference:
``paddle_tpu/serving/engine.py``).

Each ``step()`` re-forms the decode batch: finished sequences leave
between any two decode steps and waiting requests are prefilled straight
into the freed slots (no head-of-line blocking, the Orca/vLLM model).

Split per step:
  1. admit: pop waiting requests while batch slots and KV blocks allow;
     match each prompt against the pool's prefix cache; prefill the
     un-cached prompts together (one bucketed ``prefill``) and the
     prefix-cached tails together (one bucketed ``extend``); first
     token out.
  2. decode: one bucketed incremental step over every running sequence.
  3. retire: sequences hitting EOS / max_new_tokens leave the batch and
     return their KV blocks to the pool at once.

Every token goes through ``BatchSampler.sample`` and every commitment
through ``_commit_token``. A request's full context budget is reserved
at admission, so decode never runs out of blocks mid-flight.

Device residency: each sequence's fp32 working copy (``mirror``) of its
dequantized KV, the batched ``past`` a decode step reads, the logits and
the sampled tokens stay on the engine's device; ``past`` is assembled by
device copies from the mirrors (the reference copies it from the host
every step). Host data (token ids, positions, lengths, block indices)
goes to the device through pinned memory without blocking, so the one
point where the host waits for the device is where sampled token ids
come back: once per decode step and once per prefill or extend batch.
A decode step appends every running sequence's new KV row in one
``append_batch`` (one encode and one read-back launch). The mirror is
exactly the dequantized at-rest cache: every append writes through the
pool's codec and keeps only the read-back.

Not in this slice (still in the reference): speculative decoding,
request tracing spans, warm boot and the replica watchdog.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..framework.device import to_device
from ..framework.flags import flag
from ..observability.metrics import get_registry as _get_registry
from .kv_cache import BlockTable, KVBlockPool, KVCacheOOM
from .model import GPTDecodeModel, bucket_pow2
from .sampler import BatchSampler, default_sampler
from .scheduler import RequestQueue, ServeRequest, count_outcome

__all__ = ["ServingEngine"]

_MS_BUCKETS = (1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
               10000, 30000)
_m_latency = _get_registry().histogram(
    "serve_request_latency_ms", "end-to-end request latency (submit->done)",
    buckets=_MS_BUCKETS)
_m_ttft = _get_registry().histogram(
    "serve_ttft_ms", "time to first token (submit->first sampled token)",
    buckets=_MS_BUCKETS)
_m_occupancy = _get_registry().gauge(
    "serve_batch_occupancy", "running sequences / max decode batch",
    labels=("replica",))
_m_kv_blocks = _get_registry().gauge(
    "serve_kv_blocks_in_use", "allocated KV blocks", labels=("replica",))
_m_prefill_tok = _get_registry().counter(
    "serve_prefill_tokens_total",
    "prompt tokens actually prefilled (cache misses compute; hits don't)")
_m_decode_tok = _get_registry().counter(
    "serve_decode_tokens_total", "tokens generated by decode steps")
_m_prefix_hit = _get_registry().counter(
    "serve_prefix_cache_hit_tokens_total",
    "prompt tokens served from shared prefix-cache blocks")
_m_prefix_miss = _get_registry().counter(
    "serve_prefix_cache_miss_tokens_total",
    "prompt tokens that missed the prefix cache and were prefilled")
_m_decode_step = _get_registry().histogram(
    "serve_decode_step_ms",
    "host wall time of one batched decode step, sampled tokens on the host",
    buckets=(1, 2.5, 5, 10, 25, 50, 100, 250, 1000))


class _Seq:
    """One running sequence: request + block table + dequantized mirror."""

    __slots__ = ("req", "table", "mirror", "n_past", "next_token")

    def __init__(self, req: ServeRequest, table: BlockTable,
                 mirror: torch.Tensor, n_past: int, next_token: int):
        self.req = req
        self.table = table
        self.mirror = mirror          # [context_budget, ept] fp32, device
        self.n_past = n_past          # valid mirror prefix == table tokens
        self.next_token = next_token  # last sampled, next decode input


class ServingEngine:
    """One engine: model + KV pool + the continuous-batching loop."""

    def __init__(self, model: GPTDecodeModel, pool: KVBlockPool,
                 queue: RequestQueue, max_batch: Optional[int] = None,
                 max_prefill_per_step: int = 2, name: str = "replica-0",
                 sampler: Optional[BatchSampler] = None,
                 prefix_cache: Optional[bool] = None):
        if pool.device != model.device:
            raise ValueError(f"pool on {pool.device}, model on "
                             f"{model.device}")
        if pool.elems_per_token != model.elems_per_token:
            raise ValueError("pool and model disagree on elems_per_token")
        self.model = model
        self.pool = pool
        self.queue = queue
        self.device = model.device
        self.max_batch = int(max_batch or flag("FLAGS_serving_max_batch"))
        self.max_prefill_per_step = int(max_prefill_per_step)
        self.name = name
        self.sampler = sampler or default_sampler()
        if prefix_cache is None:
            prefix_cache = bool(flag("FLAGS_serving_prefix_cache"))
        self.prefix_cache = bool(prefix_cache)
        self.alive = True
        self.running: List[_Seq] = []
        self.steps = 0
        self.completed = 0
        self._g_occ = _m_occupancy.labels(replica=name)
        self._g_kv = _m_kv_blocks.labels(replica=name)

    # ------------------------------------------------------------- sampling
    def _sample(self, reqs: List[ServeRequest], logits: torch.Tensor,
                positions: List[int]) -> List[int]:
        """One row of ``logits`` per request, each drawn from the
        request's stream at its generation ``position``; the token ids
        come to the host here (the one point where the host waits for
        the device)."""
        return self.sampler.sample(
            logits, [r.sampling for r in reqs],
            [r.request_id for r in reqs], positions).tolist()

    def _commit_token(self, req: ServeRequest, token: int) -> bool:
        """Append a sampled token; True when the request just finished
        (EOS or max_new). The one retirement-policy site."""
        req.generated.append(int(token))
        return (len(req.generated) >= req.max_new_tokens
                or token == req.eos_id)

    # ------------------------------------------------------------- stepping
    def step(self) -> bool:
        """One scheduler tick: admit+prefill, then one decode step for the
        whole batch. Returns True when any work was done."""
        admitted = self._admit()
        decoded = self._decode_step()
        self.steps += 1
        self._g_occ.set(len(self.running) / max(1, self.max_batch))
        self._g_kv.set(self.pool.blocks_in_use)
        return bool(admitted or decoded)

    def _admit(self) -> int:
        batch: List[Tuple[ServeRequest, BlockTable]] = []
        while (self.alive
               and len(self.running) + len(batch) < self.max_batch
               and len(batch) < self.max_prefill_per_step):
            req = self.queue.pop_nowait()
            if req is None:
                break
            if req.n_prompt > self.model.max_context \
                    or req.context_budget > self.model.max_context \
                    or self.pool.blocks_needed(req.context_budget) \
                    > self.pool.n_blocks:
                req.error = "request exceeds model context or pool capacity"
                self._finish(req, "failed")
                continue
            # reserve the full context budget now (shared prefix blocks
            # count once); at least one prompt token always prefills so
            # the first-token logits exist
            prefix = (np.asarray(req.prompt_ids)[:req.n_prompt - 1]
                      if self.prefix_cache else None)
            try:
                table = self.pool.alloc_table(req.context_budget,
                                              prefix_tokens=prefix)
            except KVCacheOOM:
                # no room this tick: back at the head, no outcome counted
                self.queue.requeue_front([req])
                break
            batch.append((req, table))
        if batch:
            self._prefill(batch)
        return len(batch)

    def _new_mirror(self, req: ServeRequest) -> torch.Tensor:
        return torch.zeros((req.context_budget, self.model.elems_per_token),
                           dtype=torch.float32, device=self.device)

    def _start_seq(self, req: ServeRequest, table: BlockTable,
                   mirror: torch.Tensor, token: int):
        """Commit a prefilled request's first token; retire or enter the
        decode batch."""
        req.t_first_token = time.monotonic()
        _m_ttft.observe(req.ttft_ms)
        if self.prefix_cache:
            self.pool.register_prefix(table, req.prompt_ids)
        if self._commit_token(req, token):
            self.pool.free_table(table)
            self._finish(req, "completed")
            return
        self.running.append(_Seq(req, table, mirror, req.n_prompt, token))

    def _prefill(self, batch: List[Tuple[ServeRequest, BlockTable]]):
        plain = [(r, t) for r, t in batch if t.n_tokens == 0]
        cached = [(r, t) for r, t in batch if t.n_tokens > 0]

        if plain:
            logits, kvs = self.model.prefill([r.prompt_ids for r, _ in plain])
            toks = self._sample([r for r, _ in plain], logits,
                                [0] * len(plain))
            for i, (req, table) in enumerate(plain):
                _m_prefill_tok.inc(req.n_prompt)
                _m_prefix_miss.inc(req.n_prompt)
                mirror = self._new_mirror(req)
                mirror[:req.n_prompt] = self.pool.append(table, kvs[i])
                self._start_seq(req, table, mirror, toks[i])

        if cached:
            # tail prefill: attend the un-cached prompt tails to their
            # shared prefix blocks in ONE bucketed extend
            n = len(cached)
            ept = self.model.elems_per_token
            tails = [np.asarray(r.prompt_ids[t.n_tokens:], np.int64)
                     for r, t in cached]
            pasts = [self.pool.gather(t) for _, t in cached]
            B = bucket_pow2(n)
            S = bucket_pow2(max(p.shape[0] for p in pasts), minimum=8,
                            maximum=self.model.max_context)
            s_tail = bucket_pow2(max(len(t) for t in tails), minimum=1,
                                 maximum=self.model.max_context)
            ids = np.zeros((B, s_tail), np.int64)
            pos = np.zeros((B, s_tail), np.int64)
            past = torch.zeros((B, S, ept), dtype=torch.float32,
                               device=self.device)
            past_len = np.zeros((B,), np.int64)
            tail_len = np.ones((B,), np.int64)
            for i, ((req, table), tl, p) in enumerate(
                    zip(cached, tails, pasts)):
                ids[i, :len(tl)] = tl
                pos[i, :len(tl)] = table.n_tokens + np.arange(len(tl))
                past[i, :p.shape[0]] = p
                past_len[i] = p.shape[0]
                tail_len[i] = len(tl)
            logits, kv = self.model.extend(ids, pos, past, past_len,
                                           tail_len)
            rows = torch.arange(n, device=self.device)
            last = logits[rows, to_device(tail_len[:n] - 1, self.device,
                                          torch.long)]
            toks = self._sample([r for r, _ in cached], last, [0] * n)
            for i, (req, table) in enumerate(cached):
                n_cached = table.n_tokens
                _m_prefill_tok.inc(len(tails[i]))
                _m_prefix_hit.inc(n_cached)
                _m_prefix_miss.inc(len(tails[i]))
                mirror = self._new_mirror(req)
                mirror[:n_cached] = pasts[i]
                mirror[n_cached:req.n_prompt] = self.pool.append(
                    table, kv[i, :len(tails[i])])
                self._start_seq(req, table, mirror, toks[i])

    # ---------------------------------------------------------------- decode
    def _decode_step(self) -> bool:
        if not self.running or not self.alive:
            return False
        t0 = time.perf_counter()
        seqs = self.running
        B = bucket_pow2(len(seqs))
        S = bucket_pow2(max(s.n_past for s in seqs), minimum=16,
                        maximum=self.model.max_context)
        past = torch.zeros((B, S, self.model.elems_per_token),
                           dtype=torch.float32, device=self.device)
        past_len = np.zeros((B,), np.int64)
        ids = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int64)
        for i, s in enumerate(seqs):
            past[i, :s.n_past] = s.mirror[:s.n_past]
            past_len[i] = s.n_past
            ids[i] = s.next_token
            pos[i] = s.n_past
        logits, kv = self.model.decode(ids, pos, past, past_len)
        toks = self._sample([s.req for s in seqs], logits[:len(seqs)],
                            [len(s.req.generated) for s in seqs])
        deq = self.pool.append_batch([s.table for s in seqs],
                                     kv[:len(seqs)], [1] * len(seqs))
        still_running: List[_Seq] = []
        for i, s in enumerate(seqs):
            s.mirror[s.n_past] = deq[i]
            s.n_past += 1
            s.next_token = toks[i]
            _m_decode_tok.inc()
            if self._commit_token(s.req, toks[i]):
                self.pool.free_table(s.table)
                self._finish(s.req, "completed")
            else:
                still_running.append(s)
        self.running = still_running
        _m_decode_step.observe((time.perf_counter() - t0) * 1e3)
        return True

    # ------------------------------------------------------------ lifecycle
    def _finish(self, req: ServeRequest, outcome: str):
        req.t_done = time.monotonic()
        req.outcome = outcome
        count_outcome(outcome)
        if outcome == "completed":
            _m_latency.observe(req.latency_ms)
            self.completed += 1

    def drain(self) -> List[ServeRequest]:
        """Stop this engine: its running sequences give their KV blocks
        back to the pool, and fresh copies of their requests (same id and
        submit time, clean generation state) come back for re-dispatch."""
        self.alive = False
        drained = []
        for s in self.running:
            self.pool.free_table(s.table)
            drained.append(ServeRequest(
                prompt_ids=s.req.prompt_ids,
                max_new_tokens=s.req.max_new_tokens, eos_id=s.req.eos_id,
                request_id=s.req.request_id, sampling=s.req.sampling,
                t_submit=s.req.t_submit))
        self.running = []
        return drained
