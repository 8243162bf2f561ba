"""Continuous-batching decode engine, one replica's inner loop
(reference: ``paddle_tpu/serving/engine.py``).

Each ``step()`` re-forms the decode batch: finished sequences leave
between any two decode steps and waiting requests are prefilled straight
into the freed slots (no head-of-line blocking, the Orca/vLLM model).

Split per step:
  1. admit: pop waiting requests while batch slots and KV blocks allow;
     match each prompt against the pool's prefix cache; prefill the
     un-cached prompts together (one bucketed ``prefill``) and the
     prefix-cached tails together (one bucketed ``extend``); first
     token out.
  2. decode: one bucketed incremental step over every running sequence,
     or, with a draft model, one speculative step: the draft proposes
     ``spec_k`` tokens a sequence, the target scores all of them in one
     bucketed ``extend`` over ``[next_token, d_1..d_k]``, and the
     exact-match rule commits the agreed prefix plus one corrective or
     bonus token.
  3. retire: sequences hitting EOS / max_new_tokens leave the batch and
     return their KV blocks to the pool at once.

Every token goes through ``BatchSampler.sample`` and every commitment
through ``_commit_token``. Speculative acceptance is lossless by
construction: position i's verification token is drawn from the
target's logits with the request's position-i stream, the token the
plain engine would emit after the same committed prefix, and draft
tokens are kept only while they equal it. A request's full context
budget is reserved at admission; the speculative scratch rides the
pool's ``reserve``/``rollback``.

Device residency: each sequence's fp32 working copy (``mirror``) of its
dequantized KV, the draft model's dense fp32 cache (``draft_past``, not
paged, no codec), the batched ``past`` a step reads, the logits and the
sampled tokens stay on the engine's device; ``past`` is assembled by
device copies. Host data (token ids, positions, lengths, block indices)
goes to the device through pinned memory without blocking, so the host
waits for the device only where sampled token ids come back: once per
prefill or extend batch, once per decode step, and in a speculative step
once for the proposals of each draft iteration and once for the
verification. A decode step appends every running sequence's new KV row
in one ``append_batch`` (one encode and one read-back launch), a
speculative step the k+1 rows of every sequence in one. The mirror is
exactly the dequantized at-rest cache.

Lifecycle: ``boot -> compiling -> serving``. A first call of a shape
bucket runs under ``state == "compiling"`` (``_compile_guard``): on the
card it may pay the codec library's build, cuBLAS's first-use setup and
the allocator's growth, which the replica watchdog must not read as a
hang. ``warm(buckets)`` pre-runs buckets before any traffic. Engines are
driven by one worker thread each (``serving/replica.py``); the ``alive``
flag, checked under ``_admit_lock`` and in ``_finish``, fences a zombie
thread after eviction: a hung step that wakes later commits nothing,
finishes nothing and hands no block to a live pool. ``drain()``
abandons the pool with the replica and reincarnates every in-flight
request, those mid-admission included (the intake ledger).

Request tracing (``observability/tracing.py``): ``queue_wait``,
``prefill``, ``decode_step``, ``spec_decode_step``, ``retire`` and
``drain`` spans with the reference's fields; the TTFT and latency
histograms carry the trace id as an exemplar.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..framework.device import to_device
from ..framework.flags import flag
from ..observability.metrics import get_registry as _get_registry
from ..observability.tracing import get_tracer as _get_tracer
from ..ops import codec as _codec
from .kv_cache import BlockTable, KVBlockPool, KVCacheOOM
from .model import GPTDecodeModel, bucket_pow2
from .sampler import BatchSampler, default_sampler
from .scheduler import RequestQueue, ServeRequest, count_outcome

__all__ = ["ServingEngine", "ReplicaBootBudgetExceeded"]


class ReplicaBootBudgetExceeded(TimeoutError):
    """A warm boot overran FLAGS_replica_boot_budget_s mid-warm: the
    replacement protocol abandons the standby and falls back to a cold
    boot instead of hanging the fleet."""


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
_m_spec_accepted = _get_registry().gauge(
    "serve_spec_accepted_per_step",
    "mean tokens committed per speculative decode step",
    labels=("replica",))
_STEP_BUCKETS = (1, 2.5, 5, 10, 25, 50, 100, 250, 1000)
_m_decode_step = _get_registry().histogram(
    "serve_decode_step_ms",
    "host wall time of one batched decode step, sampled tokens on the host",
    buckets=_STEP_BUCKETS)
_m_spec_step = _get_registry().histogram(
    "serve_spec_step_ms",
    "host wall time of one speculative decode step (draft proposals, "
    "verification and commit), sampled tokens on the host",
    buckets=_STEP_BUCKETS)


class _Seq:
    """One running sequence: request + block table + dequantized mirror
    (+ the draft model's dense KV cache when decoding speculatively)."""

    __slots__ = ("req", "table", "mirror", "n_past", "next_token",
                 "draft_past", "draft_n", "draft_pending")

    def __init__(self, req: ServeRequest, table: BlockTable,
                 mirror: torch.Tensor, n_past: int, next_token: int):
        self.req = req
        self.table = table
        self.mirror = mirror          # [context_budget(+spec), ept] fp32
        self.n_past = n_past          # valid mirror prefix == table tokens
        self.next_token = next_token  # last sampled, next decode input
        self.draft_past = None        # [cap, draft_ept] fp32 (spec only)
        self.draft_n = 0              # valid draft cache prefix
        self.draft_pending = []       # committed tokens the draft hasn't seen


class ServingEngine:
    """One replica: model + KV pool + the continuous-batching loop."""

    def __init__(self, model: GPTDecodeModel, pool: KVBlockPool,
                 queue: RequestQueue, max_batch: Optional[int] = None,
                 max_prefill_per_step: int = 2, name: str = "replica-0",
                 pre_step: Optional[Callable] = None,
                 on_finish: Optional[Callable] = None,
                 sampler: Optional[BatchSampler] = None,
                 prefix_cache: Optional[bool] = None,
                 draft_model: Optional[GPTDecodeModel] = None,
                 spec_k: Optional[int] = None):
        if pool.device != model.device:
            raise ValueError(f"pool on {pool.device}, model on "
                             f"{model.device}")
        if pool.elems_per_token != model.elems_per_token:
            raise ValueError("pool and model disagree on elems_per_token")
        if draft_model is not None and draft_model.device != model.device:
            raise ValueError(f"draft model on {draft_model.device}, model "
                             f"on {model.device}")
        self.model = model
        self.pool = pool
        self.queue = queue
        self.device = model.device
        self.max_batch = int(max_batch or flag("FLAGS_serving_max_batch"))
        self.max_prefill_per_step = int(max_prefill_per_step)
        self.name = name
        self.pre_step = pre_step
        self.on_finish = on_finish
        self.sampler = sampler or default_sampler()
        if prefix_cache is None:
            prefix_cache = bool(flag("FLAGS_serving_prefix_cache"))
        self.prefix_cache = bool(prefix_cache)
        self.draft = draft_model
        self.spec_k = int(spec_k if spec_k is not None
                          else flag("FLAGS_serving_spec_k"))
        if self.draft is not None and self.spec_k < 1:
            raise ValueError("spec_k must be >= 1 with a draft model")
        self.alive = True
        # boot -> compiling -> serving: "compiling" holds until the first
        # step that does real work completes (an idle tick before the
        # first request must not burn the watchdog's compile grace)
        self.state = "boot"
        self._warm = False
        self.running: List[_Seq] = []
        # requests popped from the queue but not yet in `running`
        # (mid-prefill): drain() must see them, or a scale-down racing a
        # healthy engine's _admit() loses the batch it is building.
        # _admit_lock makes fence + pop atomic; it is held only for the
        # pop and the ledger, never across model compute, so evicting a
        # hung step cannot block on it.
        self._intake: List[ServeRequest] = []
        self._admit_lock = threading.Lock()
        # shape buckets this engine has executed; a first call of a
        # bucket runs under state="compiling" (_compile_guard)
        self._seen_buckets: set = set()
        self.steps = 0
        self.completed = 0
        self.spec_steps = 0           # sequence-steps of speculation
        self.spec_emitted = 0
        self._g_occ = _m_occupancy.labels(replica=name)
        self._g_kv = _m_kv_blocks.labels(replica=name)
        self._g_spec = _m_spec_accepted.labels(replica=name)

    # ------------------------------------------------------------- sampling
    def _sample(self, reqs: List[ServeRequest], logits: torch.Tensor,
                positions: List[int]) -> List[int]:
        """One row of ``logits`` per request, each drawn from the
        request's stream at its generation ``position``; the token ids
        come to the host here (where the host waits for the device)."""
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
        """One scheduler tick: admit+prefill, then one decode step (plain
        or speculative) for the whole batch. Returns True when any work
        was done."""
        if not self._warm:
            self.state = "compiling"
        if self.pre_step is not None:
            self.pre_step(self)
        admitted = self._admit()
        if self.draft is not None and self.running:
            decoded = self._spec_decode_step()
        else:
            decoded = self._decode_step()
        self.steps += 1
        if admitted or decoded:
            self._warm = True
        if self._warm:
            self.state = "serving"
        self._g_occ.set(len(self.running) / max(1, self.max_batch))
        self._g_kv.set(self.pool.blocks_in_use)
        return bool(admitted or decoded)

    def _spec_scratch(self) -> int:
        """Extra mirror/table rows a speculative step may append."""
        return self.spec_k + 1 if self.draft is not None else 0

    # -------------------------------------------------------------- warming
    def seen_buckets(self) -> set:
        """The shape buckets this engine has executed: the work list a
        warm-handoff standby pre-runs."""
        return set(self._seen_buckets)

    def warm(self, buckets, deadline: Optional[float] = None) -> int:
        """Pre-run every shape bucket in ``buckets`` before any traffic:
        the model's ``prefill``/``decode``/``extend`` on zero inputs at
        exactly each bucket's shapes on this engine's device, after the
        pool's codec library is built (no pool state is touched). On
        return the engine reports ``state="serving"`` with ``_warm`` set,
        so the watchdog needs no compile grace for it.

        ``deadline`` (``time.monotonic()`` terms) is checked between
        buckets, a cooperative budget: past it,
        :class:`ReplicaBootBudgetExceeded` is raised. Returns the number
        of buckets run (already-seen buckets are skipped)."""
        if self.pool.codec != "fp32" and self.device.type == "cuda":
            _codec._lib(self.device.index)
        ept = self.model.elems_per_token
        dev = self.device
        warmed = 0
        for key in sorted(set(buckets), key=repr):
            if key in self._seen_buckets or not self.alive:
                continue
            if deadline is not None and time.monotonic() > deadline:
                raise ReplicaBootBudgetExceeded(
                    f"{self.name}: warm boot exceeded its budget with "
                    f"bucket {key!r} (and possibly more) still cold")
            kind = key[0]
            if kind == "prefill":
                _, B, S = key
                self.model.prefill([np.zeros(S, np.int64)] * B)
            elif kind == "decode":
                _, B, S = key
                self.model.decode(
                    np.zeros(B, np.int64), np.zeros(B, np.int64),
                    torch.zeros((B, S, ept), device=dev),
                    np.zeros(B, np.int64))
            elif kind == "extend":
                _, B, S, s_tail = key
                self.model.extend(
                    np.zeros((B, s_tail), np.int64),
                    np.zeros((B, s_tail), np.int64),
                    torch.zeros((B, S, ept), device=dev),
                    np.zeros(B, np.int64), np.ones(B, np.int64))
            else:  # unknown bucket kinds are skipped, never fatal
                continue
            self._seen_buckets.add(key)
            warmed += 1
        self._warm = True
        self.state = "serving"
        return warmed

    @contextmanager
    def _compile_guard(self, *key):
        """Hold ``state="compiling"`` across a model call whose shape
        bucket this engine has never executed. The step loop restores
        "serving" at tick end (restoring here would open a stale-beat
        window between two first-bucket calls of one step). The key is
        added only on success, so an interrupted first call retries under
        grace."""
        if key in self._seen_buckets:
            yield
            return
        self.state = "compiling"
        yield
        self._seen_buckets.add(key)

    def _intake_discard(self, req: ServeRequest) -> bool:
        """Release an intake entry; False means a concurrent drain()
        already took it, so its reincarnation is authoritative and the
        caller must not finish or requeue the original. Matched by
        identity: two distinct requests must never alias."""
        for i, r in enumerate(self._intake):
            if r is req:
                del self._intake[i]
                return True
        return False

    def _admit(self) -> int:
        batch: List[Tuple[ServeRequest, BlockTable]] = []
        while (len(self.running) + len(batch) < self.max_batch
               and len(batch) < self.max_prefill_per_step):
            with self._admit_lock:
                # fence + pop are atomic: once drain() has run, no
                # request can be popped into a dead engine
                if not self.alive:
                    break
                req = self.queue.pop_nowait()
                if req is not None:
                    self._intake.append(req)
            if req is None:
                break
            # the queue-wait edge closes here: waited since the last
            # enqueue (submit, or requeue at the head after an eviction)
            _get_tracer().record_span(
                req.trace, "queue_wait",
                t_start=req.t_enqueue or req.t_submit,
                replica=self.name, attempt=req.attempts)
            if req.n_prompt > self.model.max_context \
                    or req.context_budget > self.model.max_context \
                    or self.pool.blocks_needed(req.context_budget) \
                    > self.pool.n_blocks:
                if self._intake_discard(req):
                    req.error = ("request exceeds model context or pool "
                                 "capacity")
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
                # (unless a concurrent drain already re-admitted it)
                if self._intake_discard(req):
                    self.queue.requeue_front([req], count=False)
                break
            batch.append((req, table))
        if batch:
            self._prefill(batch)
            # landed in running (or finished): release the intake entries
            # after that, so drain's intake-then-running snapshot can
            # never miss one
            for req, _ in batch:
                self._intake_discard(req)
        return len(batch)

    def _new_mirror(self, req: ServeRequest) -> torch.Tensor:
        return torch.zeros(
            (req.context_budget + self._spec_scratch(),
             self.model.elems_per_token),
            dtype=torch.float32, device=self.device)

    def _start_seq(self, req: ServeRequest, table: BlockTable,
                   mirror: torch.Tensor, token: int,
                   draft_rows: Optional[torch.Tensor]):
        """Commit a prefilled request's first token; retire or enter the
        decode batch."""
        req.t_first_token = time.monotonic()
        _m_ttft.observe(req.ttft_ms,
                        exemplar=req.trace.trace_id if req.trace else None)
        if self.prefix_cache:
            self.pool.register_prefix(table, req.prompt_ids)
        if self._commit_token(req, token):
            self.pool.free_table(table)
            self._finish(req, "completed")
            return
        seq = _Seq(req, table, mirror, req.n_prompt, int(token))
        if self.draft is not None:
            cap = req.context_budget + self._spec_scratch()
            seq.draft_past = torch.zeros(
                (cap, self.draft.elems_per_token), dtype=torch.float32,
                device=self.device)
            seq.draft_past[:draft_rows.shape[0]] = draft_rows
            seq.draft_n = int(draft_rows.shape[0])
        self.running.append(seq)

    def _prefill(self, batch: List[Tuple[ServeRequest, BlockTable]]):
        plain = [(r, t) for r, t in batch if t.n_tokens == 0]
        cached = [(r, t) for r, t in batch if t.n_tokens > 0]
        tracer = _get_tracer()
        t0 = time.monotonic()
        # the draft model (not paged, not prefix-cached) prefills every
        # admitted prompt in one batched call
        draft_of = {}
        if self.draft is not None:
            _, draft_kvs = self.draft.prefill(
                [r.prompt_ids for r, _ in batch])
            draft_of = {id(r): draft_kvs[i] for i, (r, _) in enumerate(batch)}

        if plain:
            with self._compile_guard(
                    "prefill", bucket_pow2(len(plain)),
                    bucket_pow2(max(r.n_prompt for r, _ in plain),
                                minimum=8, maximum=self.model.max_context)):
                logits, kvs = self.model.prefill(
                    [r.prompt_ids for r, _ in plain])
            toks = self._sample([r for r, _ in plain], logits,
                                [0] * len(plain))
            for i, (req, table) in enumerate(plain):
                _m_prefill_tok.inc(req.n_prompt)
                _m_prefix_miss.inc(req.n_prompt)
                mirror = self._new_mirror(req)
                mirror[:req.n_prompt] = self.pool.append_batch(
                    [table], kvs[i], [req.n_prompt])
                tracer.record_span(
                    req.trace, "prefill", t_start=t0, replica=self.name,
                    n_prompt=req.n_prompt, cached_tokens=0,
                    batch=len(plain))
                self._start_seq(req, table, mirror, toks[i],
                                draft_of.get(id(req)))

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
            with self._compile_guard("extend", B, S, s_tail):
                logits, kv = self.model.extend(ids, pos, past, past_len,
                                               tail_len)
            rows = torch.arange(n, device=self.device)
            last = logits[rows, to_device(tail_len[:n] - 1, self.device,
                                          torch.long)]
            toks = self._sample([r for r, _ in cached], last, [0] * n)
            for i, (req, table) in enumerate(cached):
                n_cached = table.n_tokens
                shared0 = table.n_shared
                _m_prefill_tok.inc(len(tails[i]))
                _m_prefix_hit.inc(n_cached)
                _m_prefix_miss.inc(len(tails[i]))
                mirror = self._new_mirror(req)
                mirror[:n_cached] = pasts[i]
                mirror[n_cached:req.n_prompt] = self.pool.append_batch(
                    [table], kv[i, :len(tails[i])], [len(tails[i])])
                tracer.record_span(
                    req.trace, "prefill", t_start=t0, replica=self.name,
                    n_prompt=req.n_prompt, cached_tokens=n_cached,
                    shared_blocks=shared0,
                    cow_blocks=shared0 - table.n_shared,
                    batch=len(cached))
                self._start_seq(req, table, mirror, toks[i],
                                draft_of.get(id(req)))

    # ---------------------------------------------------------- plain decode
    def _decode_step(self) -> bool:
        if not self.running or not self.alive:
            return False
        tracer = _get_tracer()
        t0 = time.monotonic()
        tp0 = time.perf_counter()
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
        with self._compile_guard("decode", B, S):
            logits, kv = self.model.decode(ids, pos, past, past_len)
        toks = self._sample([s.req for s in seqs], logits[:len(seqs)],
                            [len(s.req.generated) for s in seqs])
        shared0 = [s.table.n_shared for s in seqs]
        deq = self.pool.append_batch([s.table for s in seqs],
                                     kv[:len(seqs)], [1] * len(seqs))
        still_running: List[_Seq] = []
        for i, s in enumerate(seqs):
            s.mirror[s.n_past] = deq[i]
            s.n_past += 1
            s.next_token = toks[i]
            _m_decode_tok.inc()
            if s.req.trace is not None:
                fields = {"replica": self.name, "batch": len(seqs),
                          "token_index": len(s.req.generated)}
                if shared0[i] and s.table.n_shared < shared0[i]:
                    fields["cow_blocks"] = shared0[i] - s.table.n_shared
                tracer.record_span(s.req.trace, "decode_step",
                                   t_start=t0, **fields)
            if self._commit_token(s.req, toks[i]):
                self.pool.free_table(s.table)
                self._finish(s.req, "completed")
            else:
                still_running.append(s)
        self.running = still_running
        _m_decode_step.observe((time.perf_counter() - tp0) * 1e3)
        return True

    # ---------------------------------------------------- speculative decode
    def _propose(self, seqs: List[_Seq], k: int) -> List[List[int]]:
        """Draft proposal: feed each sequence's pending tokens, then
        autoregress ``k`` draft tokens, one batched draft ``decode`` an
        iteration. A draft row is written for a sequence only while it is
        fed a real token. The batched ``past`` is assembled once and the
        new rows are written into it as they come (a masked row reads
        nothing, so this is the reference's rebuild each iteration)."""
        queues = [list(s.draft_pending) + [s.next_token] for s in seqs]
        drafts: List[List[int]] = [[] for _ in seqs]
        steps = max(len(q) - 1 for q in queues) + k
        B = bucket_pow2(len(seqs))
        S = bucket_pow2(max(s.draft_n for s in seqs) + steps, minimum=16,
                        maximum=self.draft.max_context)
        past = torch.zeros((B, S, self.draft.elems_per_token),
                           dtype=torch.float32, device=self.device)
        for i, s in enumerate(seqs):
            past[i, :s.draft_n] = s.draft_past[:s.draft_n]
        for t in range(steps):
            ids = np.zeros((B,), np.int64)
            pos = np.zeros((B,), np.int64)
            past_len = np.zeros((B,), np.int64)
            active = []
            for i, s in enumerate(seqs):
                q = queues[i]
                fed = (q[t] if t < len(q)
                       else drafts[i][t - len(q)]
                       if t - len(q) < len(drafts[i]) else None)
                if fed is None:
                    continue
                active.append(i)
                ids[i] = fed
                pos[i] = s.draft_n
                past_len[i] = s.draft_n
            if not active:
                break
            logits, kv = self.draft.decode(ids, pos, past, past_len)
            want = [i for i in active
                    if t >= len(queues[i]) - 1 and len(drafts[i]) < k]
            if want:
                rows = logits[to_device(np.asarray(want, np.int64),
                                        self.device, torch.long)]
                toks = self._sample(
                    [seqs[i].req for i in want], rows,
                    [len(seqs[i].req.generated) + len(drafts[i])
                     for i in want])
                for j, i in enumerate(want):
                    drafts[i].append(toks[j])
            for i in active:
                s = seqs[i]
                s.draft_past[s.draft_n] = kv[i]
                past[i, s.draft_n] = kv[i]
                s.draft_n += 1
        for s in seqs:
            s.draft_pending = []
        return drafts

    def _spec_decode_step(self) -> bool:
        if not self.running or not self.alive:
            return False
        tracer = _get_tracer()
        t0 = time.monotonic()
        tp0 = time.perf_counter()
        seqs = self.running
        k = self.spec_k
        # scratch reservation first: if the pool cannot back a
        # speculative step for every sequence, take a plain decode tick
        reserved: List[_Seq] = []
        try:
            for s in seqs:
                self.pool.reserve(s.table, k + 1)
                reserved.append(s)
        except KVCacheOOM:
            for s in reserved:
                self.pool.rollback(s.table, 0)
            return self._decode_step()
        # the draft cache's rows past its base: the pending tokens, then
        # next_token, then d_1..d_{k-1}
        draft_bases = [s.draft_n + len(s.draft_pending) for s in seqs]
        drafts = self._propose(seqs, k)
        # the target scores [next_token, d_1..d_k] in ONE bucketed extend
        n = len(seqs)
        ept = self.model.elems_per_token
        B = bucket_pow2(n)
        S = bucket_pow2(max(s.n_past for s in seqs), minimum=16,
                        maximum=self.model.max_context)
        ids = np.zeros((B, k + 1), np.int64)
        pos = np.zeros((B, k + 1), np.int64)
        past = torch.zeros((B, S, ept), dtype=torch.float32,
                           device=self.device)
        past_len = np.zeros((B,), np.int64)
        tail_len = np.full((B,), k + 1, np.int64)
        for i, s in enumerate(seqs):
            ids[i] = [s.next_token] + drafts[i]
            pos[i] = np.minimum(s.n_past + np.arange(k + 1),
                                self.model.max_context - 1)
            past[i, :s.n_past] = s.mirror[:s.n_past]
            past_len[i] = s.n_past
        with self._compile_guard("extend", B, S, k + 1):
            logits, kv = self.model.extend(ids, pos, past, past_len,
                                           tail_len)
        # verification tokens: every row drawn from the request's stream
        # at the position it would occupy, flattened into one call
        flat_reqs, flat_pos = [], []
        for s in seqs:
            p0 = len(s.req.generated)
            flat_reqs += [s.req] * (k + 1)
            flat_pos += [p0 + j for j in range(k + 1)]
        verify = self._sample(flat_reqs,
                              logits[:n].reshape(n * (k + 1), -1), flat_pos)
        # the k+1 rows of every sequence in one append
        deq = self.pool.append_batch([s.table for s in seqs],
                                     kv[:n].reshape(n * (k + 1), ept),
                                     [k + 1] * n)
        still_running: List[_Seq] = []
        for i, s in enumerate(seqs):
            s.mirror[s.n_past:s.n_past + k + 1] = \
                deq[i * (k + 1):(i + 1) * (k + 1)]
            s.n_past += k + 1
            row = verify[i * (k + 1):(i + 1) * (k + 1)]
            emitted = 0
            matches = 0
            fin = False
            for j in range(k):
                tok = row[j]
                emitted += 1
                _m_decode_tok.inc()
                fin = self._commit_token(s.req, tok)
                s.next_token = tok
                if fin or tok != drafts[i][j]:
                    break
                matches += 1
            else:
                if not fin:
                    tok = row[k]                            # bonus token
                    emitted += 1
                    _m_decode_tok.inc()
                    fin = self._commit_token(s.req, tok)
                    s.next_token = tok
            self.spec_steps += 1
            self.spec_emitted += emitted
            tracer.record_span(s.req.trace, "spec_decode_step",
                               t_start=t0, replica=self.name,
                               batch=n, emitted=emitted, matched=matches)
            if fin:
                self.pool.free_table(s.table)
                self._finish(s.req, "completed")
                continue
            # unwind rejected rows: keep next_token's row + the matched
            # drafts; the corrective/bonus token's own KV row lands on
            # the next step (it is the new next_token)
            keep = 1 + matches
            self.pool.rollback(s.table, (k + 1) - keep)
            s.n_past -= (k + 1) - keep
            # the draft cache holds rows for [.., pending, next_token,
            # d_1..d_{k-1}]; a full accept commits d_k, whose draft row
            # was never fed
            s.draft_n = draft_bases[i] + 1 + min(matches, k - 1)
            s.draft_pending = [drafts[i][k - 1]] if matches == k else []
            still_running.append(s)
        self.running = still_running
        self._g_spec.set(self.spec_emitted / max(1, self.spec_steps))
        _m_spec_step.observe((time.perf_counter() - tp0) * 1e3)
        return True

    # ------------------------------------------------------------ lifecycle
    def _finish(self, req: ServeRequest, outcome: str):
        if not self.alive:
            return  # zombie fencing: the request was drained elsewhere
        req.t_done = time.monotonic()
        req.outcome = outcome
        count_outcome(outcome)
        _get_tracer().record_span(
            req.trace, "retire", replica=self.name, outcome=outcome,
            n_generated=len(req.generated), attempt=req.attempts)
        if outcome == "completed":
            # the exemplar ties this observation's latency bucket to the
            # request's trace: a scraped bucket names a /traces/<id>
            _m_latency.observe(
                req.latency_ms,
                exemplar=req.trace.trace_id if req.trace else None)
            self.completed += 1
        if self.on_finish is not None:
            self.on_finish(self, req)

    def drain(self) -> List[ServeRequest]:
        """Eviction path: mark dead and hand back fresh copies of every
        in-flight request for re-dispatch, the decode batch and requests
        mid-admission (popped from the queue, not yet in ``running``)
        alike. The pool is abandoned with the replica, not freed: a
        zombie thread may still be writing into it, and its blocks must
        never reach a live sequence.

        Ordering with _admit(): the fence + intake snapshot is atomic
        under _admit_lock (no pop can land after it), and intake is
        snapshotted before running while the worker moves a request
        intake -> running in the opposite order, so a request in flight
        between the two appears in both snapshots (deduped here), never
        in neither."""
        with self._admit_lock:
            self.alive = False
            intake = list(self._intake)
            self._intake = []   # rebind: the worker's _intake_discard
            # on the stale list returns False = "drain owns it"
        running = [s.req for s in self.running]
        self.running = []
        seen, drained = set(), []
        tracer = _get_tracer()
        for req in intake + running:
            if id(req) not in seen:
                seen.add(id(req))
                tracer.record_span(req.trace, "drain", replica=self.name,
                                   attempt=req.attempts,
                                   n_generated=len(req.generated))
                drained.append(req.reincarnate())
        return drained

    def stats(self) -> dict:
        return {
            "name": self.name,
            "alive": self.alive,
            "state": self.state,
            "steps": self.steps,
            "completed": self.completed,
            "running": len(self.running),
            "max_batch": self.max_batch,
            "prefix_cache": self.prefix_cache,
            "spec": {"k": self.spec_k if self.draft is not None else 0,
                     "steps": self.spec_steps,
                     "accepted_per_step": (
                         self.spec_emitted / self.spec_steps
                         if self.spec_steps else 0.0)},
            "kv": self.pool.stats(),
        }
