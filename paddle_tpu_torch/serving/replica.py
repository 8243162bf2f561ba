"""Multi-replica dispatch: N engines behind one queue, with eviction
(reference: ``paddle_tpu/serving/replica.py``).

Each replica is a ``ServingEngine`` driven by its own daemon worker
thread; all replicas share the decode model's (and the draft model's)
parameter tensors without a copy, so a replica's own state is its KV
pool (built on the model's device) and its batch. The replicas race for
work on one admission-controlled ``RequestQueue``. On one card their
threads launch on the same default stream, so their kernels serialize;
the host work between launches overlaps.

A replica leaves the set, its work does not:

  hang     a per-replica ``robustness.watchdog.HangDetector`` beats once
           a scheduler tick; a tick stuck past the timeout evicts the
           replica from the detector's poll thread (its deadline
           stretches to the compile grace while the engine reports
           "compiling"; a warm-booted engine gets no grace).
  corrupt  a ``robustness.distributed_ft.ReplicaGuard`` (policy "raise")
           digests the replica's parameters every ``guard_every`` ticks
           against the set's boot-time digest.
  error    any exception escaping ``engine.step()``.

Eviction is ``engine.drain()`` (the engine's ``alive`` fence: a stuck
step that wakes later commits nothing; the pool is abandoned with it)
plus every in-flight request, reincarnated, re-admitted at the head of
the queue for the surviving replicas: an accepted request is never
lost. ``scale_down`` takes the same path. ``scale_up(warm=True)`` and
``replace()`` boot a ``StandbyReplica`` that pre-runs every shape
bucket the set has executed (``ServingEngine.warm``) under
``FLAGS_replica_boot_budget_s`` before it joins, falling back to a cold
boot past the budget; each boot is recorded in the boot ledger
(``boots``). ``pump()`` steps the replicas in index order on the
caller's thread (deterministic harnesses); ``start()`` arms the workers
and mounts the ``/serving`` and ``/traces`` exposition sections until
``stop()``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..framework.flags import flag
from ..observability import exposition
from ..observability.events import get_event_log
from ..observability.metrics import get_registry as _get_registry
from ..observability.tracing import get_tracer as _get_tracer
from ..robustness.distributed_ft import (
    ReplicaDivergenceError, ReplicaGuard, params_digest,
)
from ..robustness.watchdog import HangDetector
from .engine import (ReplicaBootBudgetExceeded, ServingEngine, _m_latency,
                     _m_ttft)
from .kv_cache import KVBlockPool
from .model import GPTDecodeModel
from .scheduler import RequestQueue, ServeRequest

__all__ = ["ReplicaSet", "StandbyReplica"]

_m_evictions = _get_registry().counter(
    "serve_replica_evictions_total", "replicas evicted from the set",
    labels=("reason",))
_m_scale_events = _get_registry().counter(
    "serve_scale_events_total",
    "policy-driven replica scale events",
    labels=("direction",))
_m_boots = _get_registry().counter(
    "replica_boots_total",
    "replica boots by mode (warm = standby pre-compiled every seen "
    "shape bucket before admission) and outcome",
    labels=("mode", "outcome"))
_m_boot_ms = _get_registry().histogram(
    "replica_boot_ms",
    "wall time from boot request to readiness (warm: standby warm + "
    "promote; cold: engine construction — compiles land in-traffic)",
    buckets=(1, 5, 10, 50, 100, 250, 500, 1000, 2500, 5000, 10000,
             30000, 120000))


class StandbyReplica:
    """A replica acquired for warm handoff but not yet in the set.

    Its lifecycle is either/or: every path from
    :meth:`ReplicaSet.acquire_standby` either promotes the standby
    into the set (:meth:`promote`) or tears it down
    (:meth:`abandon`);
    a dropped standby leaks its KV pool. ``warm()`` runs on the caller's
    thread (the outgoing replica keeps serving meanwhile); ``ready()`` is
    the readiness probe the replacement protocol requires before it
    fences the old replica.
    """

    def __init__(self, rset: "ReplicaSet", engine: ServingEngine,
                 model: GPTDecodeModel):
        self._set = rset
        self.engine = engine
        self.model = model
        self.promoted = False
        self.abandoned = False

    def warm(self, buckets, deadline: Optional[float] = None) -> int:
        """Pre-compile every bucket; raises ReplicaBootBudgetExceeded
        past ``deadline`` (see ServingEngine.warm)."""
        return self.engine.warm(buckets, deadline=deadline)

    def ready(self) -> bool:
        """The readiness probe: warmed, alive, and reporting "serving":
        admitting traffic now cannot open a compile window."""
        return (self.engine.alive and self.engine._warm
                and self.engine.state == "serving")

    def promote(self, reason: str = "warm_handoff") -> int:
        """Swap into the set (worker + watchdog arm if the set runs).
        Returns the new replica index."""
        if self.abandoned:
            raise RuntimeError(f"{self.engine.name}: promote after abandon")
        idx = self._set._join(self.engine, self.model, reason, warm=True)
        self.promoted = True
        return idx

    def abandon(self):
        """Tear down an unpromoted standby: fence the engine so its pool
        can never admit work. Idempotent; a no-op after promote."""
        if not self.promoted:
            self.engine.alive = False
            self.abandoned = True


class ReplicaSet:
    """N serving replicas behind one request queue."""

    def __init__(self, model: GPTDecodeModel, n_replicas: int = 2,
                 queue: Optional[RequestQueue] = None,
                 n_blocks: int = 64, block_tokens: Optional[int] = None,
                 codec: Optional[str] = None,
                 max_batch: Optional[int] = None,
                 watchdog_timeout: Optional[float] = None,
                 guard_every: int = 0,
                 models: Optional[List[GPTDecodeModel]] = None,
                 pre_step_hooks: Optional[Dict[int, Callable]] = None,
                 prefix_cache: Optional[bool] = None,
                 draft_model: Optional[GPTDecodeModel] = None,
                 spec_k: Optional[int] = None,
                 sampler=None,
                 compile_grace: Optional[float] = None):
        self.model = model
        # `is not None`, not truthiness: an empty RequestQueue is falsy
        # (__len__ == 0), and `queue or ...` would replace the caller's
        # queue with a private one
        self.queue = queue if queue is not None else RequestQueue(
            max_depth=int(flag("FLAGS_serving_queue_depth")))
        block_tokens = int(block_tokens
                           or flag("FLAGS_serving_block_tokens"))
        self.codec = codec or str(flag("FLAGS_serving_kv_codec"))
        self.watchdog_timeout = float(
            watchdog_timeout or flag("FLAGS_serving_watchdog_s"))
        self.compile_grace = float(
            compile_grace if compile_grace is not None
            else flag("FLAGS_serving_compile_grace_s"))
        self.guard_every = int(guard_every)
        # kept for scale_up: a policy-grown replica gets the same pool
        # and batch geometry as the boot-time ones
        self._n_blocks = int(n_blocks)
        self._block_tokens = block_tokens
        self._max_batch = max_batch
        self._sampler = sampler
        self._prefix_cache = prefix_cache
        self._draft = draft_model
        self._spec_k = spec_k
        self._models = list(models) if models else [model] * n_replicas
        if len(self._models) != n_replicas:
            raise ValueError("models override must have one entry per "
                             "replica")
        self._hooks = dict(pre_step_hooks or {})
        self.engines: List[ServingEngine] = []
        for i in range(n_replicas):
            self.engines.append(self._new_engine(i, self._models[i]))
        self.results: Dict[str, ServeRequest] = {}
        self.evictions: List[dict] = []
        self.scale_events: List[dict] = []
        # boot ledger: one record per replica boot with mode (warm|cold),
        # outcome (ok|warm_boot_timeout) and the window [t_start, t]
        self.boots: List[dict] = []
        # monotonic name sequence: standbys may be abandoned without
        # joining the set, so names come from a counter, not len(engines)
        self._name_seq = n_replicas
        self._results_cond = threading.Condition()
        self._evict_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._hds: list = []
        self._ref_digest = None

    def _new_engine(self, idx: int, model: GPTDecodeModel) -> ServingEngine:
        pool = KVBlockPool(n_blocks=self._n_blocks,
                           block_tokens=self._block_tokens,
                           elems_per_token=model.elems_per_token,
                           codec=self.codec, device=model.device)
        # the draft model, like the target, is parameters shared without
        # a copy; a replica's draft state is the per-sequence dense caches
        # inside its engine
        return ServingEngine(
            model, pool, self.queue, max_batch=self._max_batch,
            name=f"replica-{idx}", pre_step=self._hooks.get(idx),
            on_finish=self._on_finish, sampler=self._sampler,
            prefix_cache=self._prefix_cache, draft_model=self._draft,
            spec_k=self._spec_k)

    def _alloc_seq(self) -> int:
        s = self._name_seq
        self._name_seq += 1
        return s

    # ------------------------------------------------------------ lifecycle
    def _spawn_worker(self, idx: int):
        """Arm a compile-grace-aware watchdog + daemon worker for one
        engine (boot-time and scale_up share this path)."""
        eng = self.engines[idx]
        # a warm-booted engine has already executed every known bucket:
        # its first poll needs no compile grace
        grace = 0.0 if eng._warm else self.compile_grace
        hd = HangDetector(
            timeout=self.watchdog_timeout,
            on_hang=lambda age, i=idx: self.evict(i, "hang"),
            state_fn=lambda e=eng: e.state,
            compile_grace=grace)
        self._hds.append(hd)
        hd.start()
        t = threading.Thread(target=self._worker, args=(idx,),
                             daemon=True, name=f"serve-{eng.name}")
        self._threads.append(t)
        t.start()

    def start(self) -> "ReplicaSet":
        if self._threads:
            return self
        if self.guard_every:
            self._ref_digest = params_digest(self.model.param_list())
        for i in range(len(self.engines)):
            self._spawn_worker(i)
        exposition.register_section("serving", self.stats)
        # /traces (index) + /traces/<id> (one request's full span list),
        # read-only over the bounded trace store, mounted for the set's
        # lifetime like /serving
        exposition.register_section(
            "traces", lambda: _get_tracer().store.index(),
            lambda tid: _get_tracer().store.get(tid))
        return self

    def stop(self):
        self._stop.set()
        self.queue.close()
        for hd in self._hds:
            hd.stop()
        for t in self._threads:
            t.join(timeout=5)
        exposition.unregister_section("serving")
        exposition.unregister_section("traces")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -------------------------------------------------------------- workers
    def _worker(self, idx: int):
        eng = self.engines[idx]
        hd = self._hds[idx]
        guard = None
        if self.guard_every:
            ref = self._ref_digest

            def against_ref(digest):
                return (np.minimum(digest, ref), np.maximum(digest, ref))

            guard = ReplicaGuard(policy="raise", every_n=self.guard_every,
                                 reduce_fn=against_ref)
        while not self._stop.is_set() and eng.alive:
            try:
                if guard is not None:
                    guard.maybe_check(self._models[idx].param_list(),
                                      step=eng.steps)
                worked = eng.step()
            except ReplicaDivergenceError:
                self.evict(idx, "corrupt")
                return
            except Exception as e:  # any escaped step error evicts
                get_event_log().error("serving", "replica step failed",
                                      replica=eng.name, error=repr(e))
                self.evict(idx, "error")
                return
            hd.beat()
            if not worked:
                self.queue.wait_nonempty(0.02)

    # ------------------------------------------------------------- eviction
    def _retire(self, idx: int, span: str,
                **fields) -> Optional[List[ServeRequest]]:
        """Fence replica ``idx``, drain its in-flight requests (a ``span``
        each) and re-admit them at the queue head, then disarm its
        watchdog. Returns the drained requests, or None when the replica
        was already dead (every caller is idempotent per replica)."""
        eng = self.engines[idx]
        with self._evict_lock:
            if not eng.alive:
                return None
            drained = eng.drain()
        tracer = _get_tracer()
        for r in drained:
            tracer.record_span(r.trace, span, replica=eng.name,
                               attempt=r.attempts, **fields)
        # requeue first: nothing below may stand between a drained
        # request and its re-admission. The detector is disarmed without
        # a join: eviction often runs on its poll thread (on_hang).
        self.queue.requeue_front(drained)
        if idx < len(self._hds):
            self._hds[idx]._stop.set()
        return drained

    def evict(self, idx: int, reason: str):
        """Remove a replica: fence it, drain its in-flight requests, and
        re-admit them at the queue head. Idempotent per replica."""
        eng = self.engines[idx]
        drained = self._retire(idx, "eviction", reason=reason)
        if drained is None:
            return
        _m_evictions.labels(reason=reason).inc()
        self.evictions.append({"replica": eng.name, "reason": reason,
                               "drained": len(drained),
                               "t": time.monotonic()})
        get_event_log().error(
            "serving", "replica evicted", replica=eng.name, reason=reason,
            drained=len(drained))

    # ------------------------------------------------------------- scaling
    # Policy-driven capacity changes. Scale down goes through the
    # eviction mechanics (fence + drain + requeue_front), so the
    # zero-lost-requests guarantee is the same path, with a "scale"
    # ledger entry instead of a failure reason.
    def scale_down(self, idx: Optional[int] = None,
                   reason: str = "scale_down") -> Optional[dict]:
        """Retire one replica without losing work. Defaults to the
        highest-index alive replica (deterministic for trace replay).
        Returns the scale-event record, or None if nothing was alive."""
        if idx is None:
            alive = [i for i, e in enumerate(self.engines) if e.alive]
            if not alive:
                return None
            idx = alive[-1]
        eng = self.engines[idx]
        drained = self._retire(idx, "scale_down", reason=reason)
        if drained is None:
            return None
        _m_scale_events.labels(direction="down").inc()
        ev = {"replica": eng.name, "direction": "down", "reason": reason,
              "drained": len(drained), "t": time.monotonic()}
        self.scale_events.append(ev)
        get_event_log().info(
            "serving", "replica scaled down", replica=eng.name,
            reason=reason, drained=len(drained))
        return ev

    # -------------------------------------------- zero-cold-start plane
    def warm_buckets(self) -> set:
        """Union of every shape bucket any replica has executed: the set
        a standby must pre-run to answer its readiness probe."""
        buckets: set = set()
        for e in self.engines:
            buckets |= e.seen_buckets()
        return buckets

    def acquire_standby(self, model: Optional[GPTDecodeModel] = None
                        ) -> StandbyReplica:
        """A fresh engine + KV pool outside the set; every path from here
        must promote it or tear it down."""
        model = model if model is not None else self.model
        eng = self._new_engine(self._alloc_seq(), model)
        return StandbyReplica(self, eng, model)

    def _join(self, eng: ServingEngine, model: GPTDecodeModel, reason: str,
              warm: bool) -> int:
        """Add ``eng`` to the set (worker + watchdog armed if the set
        runs) and record the scale-up, warm (a promoted standby) or
        cold; returns its index."""
        idx = len(self.engines)
        self.engines.append(eng)
        self._models.append(model)
        if self._threads:  # live set: arm watchdog + worker like start()
            self._spawn_worker(idx)
        _m_scale_events.labels(direction="up").inc()
        ev = {"replica": eng.name, "direction": "up", "reason": reason,
              "drained": 0, "t": time.monotonic()}
        if warm:
            ev["warm"] = True
        self.scale_events.append(ev)
        get_event_log().info(
            "serving", "standby promoted" if warm else "replica scaled up",
            replica=eng.name, reason=reason, replicas=self.alive_replicas)
        return idx

    def _record_boot(self, name: str, mode: str, outcome: str,
                     ms: float, t_start: float) -> dict:
        _m_boots.labels(mode=mode, outcome=outcome).inc()
        _m_boot_ms.observe(ms)
        rec = {"replica": name, "mode": mode, "outcome": outcome,
               "ms": round(ms, 3), "t_start": t_start,
               "t": time.monotonic()}
        self.boots.append(rec)
        return rec

    @property
    def last_boot(self) -> Optional[dict]:
        return self.boots[-1] if self.boots else None

    def warm_boot_counts(self) -> dict:
        """Cumulative warm-boot outcomes."""
        return {
            "warm_boots": sum(1 for b in self.boots
                              if b["mode"] == "warm"
                              and b["outcome"] == "ok"),
            "warm_boot_timeouts": sum(1 for b in self.boots
                                      if b["outcome"]
                                      == "warm_boot_timeout"),
        }

    def scale_up(self, model: Optional[GPTDecodeModel] = None,
                 reason: str = "scale_up", warm: bool = False) -> int:
        """Boot one more replica (fresh engine + KV pool; weights shared
        without a copy).

        ``warm=False`` (cold): the replica joins at once and reports
        ``compiling`` on its first step; the watchdog's compile grace
        covers its first calls in traffic. ``warm=True``: a standby
        pre-runs every bucket the set has executed, under
        ``FLAGS_replica_boot_budget_s``, and joins only once its
        readiness probe answers: no compile window, no grace needed.
        Past the budget the standby is abandoned, a ``warm_boot_timeout``
        outcome is recorded, and the boot falls back to the cold path.

        Returns the new replica index."""
        model = model if model is not None else self.model
        if warm:
            t0 = time.monotonic()
            budget = float(flag("FLAGS_replica_boot_budget_s"))
            standby = self.acquire_standby(model)
            ok = False
            try:
                standby.warm(self.warm_buckets(), deadline=t0 + budget)
                ok = standby.ready()
            except ReplicaBootBudgetExceeded:
                ok = False
            except BaseException:
                standby.abandon()  # unexpected failure: never leak it
                raise
            ms = (time.monotonic() - t0) * 1e3
            if ok:
                idx = standby.promote(reason)
                self._record_boot(self.engines[idx].name, "warm", "ok",
                                  ms, t0)
                return idx
            standby.abandon()
            self._record_boot(standby.engine.name, "warm",
                              "warm_boot_timeout", ms, t0)
            get_event_log().error(
                "serving", "warm boot budget exceeded — cold fallback",
                budget_s=budget, reason=reason)
            # fall through: capacity still arrives, cold, in traffic
            # under compile_grace
        t0 = time.monotonic()
        eng = self._new_engine(self._alloc_seq(), model)
        idx = self._join(eng, model, reason, warm=False)
        self._record_boot(eng.name, "cold", "ok",
                          (time.monotonic() - t0) * 1e3, t0)
        return idx

    def replace(self, idx: Optional[int] = None,
                reason: str = "warm_handoff") -> Optional[dict]:
        """Warm-handoff replacement: the standby boots and answers its
        readiness probe before the outgoing replica is fenced, so
        fence -> drain -> requeue never exposes a compile window to
        traffic. Past the boot budget the replacement arrives cold
        (recorded as such) and the handoff still completes. Defaults to
        the highest-index alive replica (deterministic, as
        scale_down)."""
        if idx is None:
            alive = [i for i, e in enumerate(self.engines) if e.alive]
            if not alive:
                return None
            idx = alive[-1]
        old = self.engines[idx]
        if not old.alive:
            return None
        new_idx = self.scale_up(model=self._models[idx], reason=reason,
                                warm=True)
        boot = self.last_boot or {}
        drained = self._retire(idx, "warm_handoff",
                               standby=self.engines[new_idx].name,
                               reason=reason, boot_mode=boot.get("mode"),
                               boot_ms=boot.get("ms"))
        if drained is None:
            return None
        _m_scale_events.labels(direction="down").inc()
        ev = {"replica": old.name, "direction": "down", "reason": reason,
              "drained": len(drained),
              "standby": self.engines[new_idx].name,
              "boot_mode": boot.get("mode"), "t": time.monotonic()}
        self.scale_events.append(ev)
        get_event_log().info(
            "serving", "replica replaced (warm handoff)",
            replica=old.name, standby=self.engines[new_idx].name,
            reason=reason, drained=len(drained),
            boot_mode=boot.get("mode"))
        return ev

    def pump(self, ticks: int = 1) -> int:
        """Synchronous driving mode: step every alive engine in index
        order on the caller's thread, no workers. Deterministic harnesses
        drive the set through this instead of ``start()``; both modes
        share admit/decode/drain. Returns how many engine steps did
        work."""
        worked = 0
        for _ in range(int(ticks)):
            for eng in self.engines:
                if eng.alive and eng.step():
                    worked += 1
        return worked

    @property
    def alive_replicas(self) -> int:
        return sum(1 for e in self.engines if e.alive)

    def heartbeat_ages(self) -> List[float]:
        """Seconds since each armed watchdog last saw its replica beat
        (disarmed or evicted detectors excluded): an age nearing the
        watchdog timeout is a replica about to be evicted."""
        now = time.monotonic()
        return [now - hd._last for hd in self._hds
                if not hd._stop.is_set()]

    # -------------------------------------------------------------- serving
    def submit(self, req: ServeRequest) -> bool:
        return self.queue.submit(req)

    def _on_finish(self, engine: ServingEngine, req: ServeRequest):
        with self._results_cond:
            self.results[req.request_id] = req
            self._results_cond.notify_all()

    def wait(self, request_ids, timeout: float = 60.0
             ) -> Dict[str, ServeRequest]:
        """Block until every id has a terminal result (or timeout);
        returns the results seen so far either way."""
        deadline = time.monotonic() + timeout
        want = set(request_ids)
        with self._results_cond:
            while not want.issubset(self.results):
                left = deadline - time.monotonic()
                if left <= 0 or self.alive_replicas == 0:
                    break
                self._results_cond.wait(min(left, 0.1))
            return {rid: self.results[rid]
                    for rid in want & set(self.results)}

    # ----------------------------------------------------------- exposition
    def stats(self) -> dict:
        h = _m_latency.get()
        t = _m_ttft.get()
        return {
            "replicas": [e.stats() for e in self.engines],
            "alive_replicas": self.alive_replicas,
            "queue_depth": self.queue.depth,
            "completed": len(self.results),
            "evictions": list(self.evictions),
            "scale_events": list(self.scale_events),
            "boots": list(self.boots),
            "latency_ms": {k: h[k] for k in ("count", "p50", "p95", "p99")},
            "ttft_ms": {k: t[k] for k in ("count", "p50", "p95", "p99")},
        }
