"""Overlapped gradient communication: each bucket's collective launches
the moment backward completes it (reference:
``paddle_tpu/distributed/overlap.py``: ``communicator_for``,
``BucketFuture``, ``GatherFuture``, ``CollectiveLane``,
``OverlappedGradCommunicator``, ``overlap_report``).

    comm.prepare(params, world)      # before backward: install the hooks
    loss.backward()                  # buckets launch as they complete
    comm.sync(params, world)         # == flush(): the step barrier

``prepare`` registers PyTorch's grad-ready hook,
``Tensor.register_post_accumulate_grad_hook``, on every parameter. The
hook runs where the autograd engine accumulates the gradient (for CUDA
tensors the engine's device thread, while the card may still be running
backward's kernels). When the last gradient of a bucket is in, the hook
records a CUDA event on the engine's current stream and submits the
bucket to a ``CollectiveLane``: one worker thread draining a FIFO, so
the collectives keep one total order per rank, the order backward
completes the buckets, which is the same on every rank. The lane makes
its own stream wait for that event before it reads the gradients, runs
``GradCommunicator``'s own flatten, encode, collective, decode and
scatter for the bucket (``_sync_bucket``), and records a second event,
which ``flush`` makes the caller's stream wait for. So the results are
bit-identical to the serial ``sync``: the bucket plan, the codecs and
the per-bucket residuals are the serial path's.

``flush`` launches the buckets whose gradients appeared after backward
(``find_unused_parameters`` zero-fills), waits for the lane, raises the
first error a lane job met, and records the overlap accounting:
``stats["overlap_efficiency"]`` is the share of the lane's comm time
that ran before the flush began, into the ``grad_comm_overlap_efficiency``
gauge and the ``grad_comm_overlapped_syncs_total`` and
``grad_comm_buckets_launched_early_total`` counters. ``abandon`` disarms
a prepared step without syncing (the raw micro-batches of gradient
accumulation). Each bucket writes the reference's flight-recorder lane
entries (launch, then start, end or error, with the bucket and group),
so a hang's postmortem names the bucket that never completed. The
reference's ``RecordEvent`` spans wait for the port of ``profiler``
(ROADMAP Queue A 14).

``sync_async`` is the reference's per-bucket futures; eager, as here,
they are resolved at once (``FusedFlatUpdater.step(futures=...)`` takes
them). ``GatherFuture`` is the same handle for the ZeRO-3 store's
parameter gathers (``sharding/stage3.py``), its second lane client.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..framework.autograd import unwrap
from ..observability.flight_recorder import get_flight_recorder
from ..observability.metrics import get_registry as _get_registry
from .grad_comm import (EF_CODECS, GradBucket, GradCommConfig,
                        GradCommunicator)

__all__ = ["BucketFuture", "CollectiveLane", "GatherFuture",
           "OverlappedGradCommunicator", "communicator_for",
           "overlap_report"]

_m_overlap_eff = _get_registry().gauge(
    "grad_comm_overlap_efficiency",
    help="hidden_comm_time / total_comm_time of the last overlapped sync")
_m_overlap_syncs = _get_registry().counter(
    "grad_comm_overlapped_syncs_total",
    help="gradient syncs that ran in bucket-ready overlapped mode")
_m_early = _get_registry().counter(
    "grad_comm_buckets_launched_early_total",
    help="buckets whose collective launched before backward finished")


def communicator_for(config: Optional[GradCommConfig] = None, group=None):
    """``GradCommunicator``, or ``OverlappedGradCommunicator`` when
    ``config.overlap``."""
    config = config or GradCommConfig()
    cls = OverlappedGradCommunicator if config.overlap else GradCommunicator
    return cls(config, group=group)


def _record_event(device: torch.device):
    """An event on ``device``'s current stream of this thread (None off
    the card)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _wait_event(ev) -> None:
    """Make this thread's current stream (of the event's device) wait for
    ``ev``."""
    if ev is not None:
        torch.cuda.current_stream().wait_event(ev)


class BucketFuture:
    """Handle of one bucket reduction: resolved by the lane (``wait()``
    blocks) or at once by ``sync_async``."""

    __slots__ = ("bucket", "_value", "_error", "_done", "launch_ns",
                 "start_ns", "end_ns", "scatter", "residual", "ready",
                 "event")

    def __init__(self, bucket: GradBucket, value=None, resolved=False):
        self.bucket = bucket
        self._value = value
        self._error = None
        self._done = threading.Event()
        if resolved:
            self._done.set()
        self.launch_ns = None   # submit time (the hook's thread)
        self.start_ns = None    # the lane's work window
        self.end_ns = None
        self.residual = None    # the bucket's new error-feedback residual
        self.scatter = None
        self.ready = None       # CUDA event: the gradients are written
        self.event = None       # CUDA event: the lane's work is queued

    def _resolve(self, value):
        self._value = value
        self._done.set()

    def _fail(self, err):
        self._error = err
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout=None):
        """Block until resolved; the reduced flat buffer (or the lane's
        error, raised), ready on this thread's stream."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"bucket {self.bucket.index} collective did not complete "
                f"within {timeout}s")
        if self._error is not None:
            raise self._error
        _wait_event(self.event)
        return self._value

    result = wait

    def __repr__(self):
        state = ("error" if self._error is not None
                 else "done" if self.done() else "pending")
        return f"BucketFuture(bucket={self.bucket.index}, {state})"


class GatherFuture(BucketFuture):
    """Handle of one ZeRO-3 parameter-bucket all_gather on the store's
    lane: shards in, the full flat parameter buffer out."""

    __slots__ = ()


class CollectiveLane:
    """One daemon worker thread draining a FIFO of jobs: a total order
    over the collectives it runs. The worker exits when idle and is
    started again on demand."""

    def __init__(self, name="grad-comm-lane"):
        self.name = name
        self._lock = threading.Lock()
        self._jobs = deque()
        self._thread: Optional[threading.Thread] = None

    def submit(self, fn) -> threading.Event:
        """Queue ``fn``; returns its completion event."""
        done = threading.Event()
        with self._lock:
            self._jobs.append((fn, done))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name=self.name)
                self._thread.start()
        return done

    def _run(self):
        while True:
            with self._lock:
                if not self._jobs:
                    if self._thread is threading.current_thread():
                        self._thread = None
                    return
                fn, done = self._jobs.popleft()
            try:
                fn()
            finally:
                done.set()


class OverlappedGradCommunicator(GradCommunicator):
    """``GradCommunicator`` whose buckets launch as backward completes
    them (module docstring). ``sync()`` on a prepared step is the flush
    barrier; on an unprepared one the serial sync. Each gradient's dtype
    must be its parameter's (the bucket plan is made before backward, on
    the parameters' dtypes); the hook refuses another at flush."""

    def __init__(self, config: Optional[GradCommConfig] = None, group=None):
        super().__init__(config, group)
        self._lane = CollectiveLane()
        self._step = None            # the prepared backward; None: not
        self._handles: List = []     # the grad-ready hooks' handles
        self.last_timeline: List[dict] = []

    # ------------------------------------------------------------- prepare
    def prepare(self, params, world: Optional[int] = None,
                use_reduce_scatter: bool = False):
        """Arm the next backward: the bucket plan of ``params`` (those
        with ``requires_grad``) and a grad-ready hook on each. A no-op
        (returns self) when ``world <= 1`` or there is nothing to sync."""
        self.abandon()
        params = [t for t in map(unwrap, params) if t.requires_grad]
        if world is None:
            from .env import get_world_size

            world = get_world_size()
        if world <= 1 or not params:
            return self
        buckets = self.buckets_for(params, [p.dtype for p in params])
        by_param: Dict[int, GradBucket] = {}
        for b in buckets:
            for pi in b.param_indices:
                by_param[id(params[pi])] = b
        self._step = {
            "params": params,
            "world": int(world),
            "use_reduce_scatter": bool(use_reduce_scatter),
            "buckets": buckets,
            "by_param": by_param,
            "remaining": {b.index: len(b.param_indices) for b in buckets},
            "futures": {},           # bucket index -> BucketFuture
            "dtype_error": None,
        }
        self.stats = {"codec": self.config.codec, "path": "eager",
                      "n_params": len(params), "n_buckets": len(buckets),
                      "collectives": 0, "comm_bytes": 0}
        self._handles = [p.register_post_accumulate_grad_hook(
            self._on_grad_ready) for p in params]
        return self

    def _unhook(self):
        for h in self._handles:
            h.remove()
        self._handles = []

    # ---------------------------------------------------------- hook + lane
    def _on_grad_ready(self, tensor):
        st = self._step
        if st is None:
            return
        b = st["by_param"].get(id(tensor))
        if b is None:
            return
        grad = tensor.grad
        if grad is not None and grad.dtype != b.dtype:
            st["dtype_error"] = (
                f"overlapped grad sync: a parameter of shape "
                f"{tuple(tensor.shape)} produced a {grad.dtype} grad in a "
                f"{b.dtype} bucket; overlap requires grad dtype == param "
                f"dtype (disable grad_comm_configs['overlap'] for "
                f"mixed-dtype grads)")
            return
        st["remaining"][b.index] -= 1
        if st["remaining"][b.index] == 0 and st["dtype_error"] is None:
            self._launch(b, st)

    def _launch(self, bucket: GradBucket, st):
        """Submit one completed bucket to the lane, from the thread that
        produced its last gradient (backward's, or flush's for the
        stragglers)."""
        fut = BucketFuture(bucket)
        fut.launch_ns = time.perf_counter_ns()
        params, world = st["params"], st["world"]
        fut.ready = _record_event(params[bucket.param_indices[0]].grad.device)
        st["futures"][bucket.index] = fut
        use_rs = st["use_reduce_scatter"]
        # flight-recorder lane entries: a hang postmortem must name the
        # bucket and group that launched and never completed
        flightrec = get_flight_recorder()
        group = repr(self.group) if self.group is not None else "world"
        flightrec.lane(f"comm_launch:bucket{bucket.index}",
                       bucket=bucket.index, group=group, phase="launch")

        def job():
            fut.start_ns = time.perf_counter_ns()
            flightrec.lane(f"comm:bucket{bucket.index}", bucket=bucket.index,
                           group=group, phase="start")
            try:
                _wait_event(fut.ready)
                with torch.no_grad():
                    flat = self._flatten_bucket(bucket, params)
                    reduced = self._sync_bucket(bucket, flat, world, use_rs)
                    self._scatter_bucket(bucket, params, reduced)
                fut.event = _record_event(reduced.device)
                if fut.event is not None:
                    # the transfer's window, not its queueing
                    fut.event.synchronize()
            except BaseException as e:  # raised by flush()
                fut._fail(e)
                flightrec.lane(f"comm:bucket{bucket.index}",
                               bucket=bucket.index, group=group,
                               phase="error", error=repr(e))
            else:
                fut._resolve(reduced)
                flightrec.lane(f"comm:bucket{bucket.index}",
                               bucket=bucket.index, group=group, phase="end")
            fut.end_ns = time.perf_counter_ns()

        self._lane.submit(job)

    def abandon(self):
        """Disarm without syncing: remove the hooks and drop the step
        (after the buckets already launched have finished)."""
        st, self._step = self._step, None
        self._unhook()
        if st is None:
            return
        for fut in st["futures"].values():
            fut._done.wait()

    # ----------------------------------------------------------------- sync
    def sync(self, params, world: Optional[int] = None,
             use_reduce_scatter: bool = False, **kwargs):
        """A prepared step: ``flush()``; else the serial sync."""
        if self._step is None:
            return super().sync(params, world,
                                use_reduce_scatter=use_reduce_scatter,
                                **kwargs)
        return self.flush()

    def flush(self):
        """The step barrier: launch the stragglers, wait for the lane
        (the lane wrote every bucket back), account, remove the hooks.
        Raises the first lane error once the lane is drained."""
        st, self._step = self._step, None
        self._unhook()
        if st is None:
            return
        if st["dtype_error"]:
            for fut in st["futures"].values():
                fut._done.wait()
            raise RuntimeError(st["dtype_error"])
        flush_t0 = time.perf_counter_ns()
        for b in st["buckets"]:
            if b.index in st["futures"]:
                continue
            if any(st["params"][pi].grad is None for pi in b.param_indices):
                for fut in st["futures"].values():
                    fut._done.wait()
                raise RuntimeError(
                    f"overlapped grad sync: bucket {b.index} still has "
                    f"parameters with no gradient at flush time — "
                    f"DataParallel(find_unused_parameters=True) "
                    f"zero-fills them before the sync")
            self._launch(b, st)
        error = None
        for b in st["buckets"]:
            fut = st["futures"][b.index]
            fut._done.wait()
            if fut._error is not None and error is None:
                error = fut._error
        if error is not None:
            raise error
        for b in st["buckets"]:
            _wait_event(st["futures"][b.index].event)
        self._account(st, flush_t0)

    def _account(self, st, flush_t0):
        """The step's overlap accounting: how much of the lane's comm
        time ran before the flush began."""
        timeline, total, hidden = [], 0.0, 0.0
        for b in st["buckets"]:
            fut = st["futures"][b.index]
            dur = max(0, (fut.end_ns or 0) - (fut.start_ns or 0))
            hid = max(0, min(fut.end_ns or 0, flush_t0)
                      - min(fut.start_ns or 0, flush_t0))
            total += dur
            hidden += hid
            timeline.append({
                "bucket": b.index,
                "launched_early": fut.launch_ns < flush_t0,
                "launch_ns": fut.launch_ns,
                "start_ns": fut.start_ns,
                "end_ns": fut.end_ns,
                "comm_s": dur / 1e9,
                "hidden_s": hid / 1e9,
            })
        self.last_timeline = timeline
        eff = hidden / total if total else 0.0
        early = sum(1 for row in timeline if row["launched_early"])
        self.stats.update({
            "overlapped": True,
            "hidden_comm_s": hidden / 1e9,
            "exposed_comm_s": (total - hidden) / 1e9,
            "overlap_efficiency": eff,
            "buckets_launched_early": early,
        })
        _m_overlap_syncs.inc()
        _m_early.inc(early)
        _m_overlap_eff.set(round(eff, 6))
        self._record_metrics(st["buckets"])

    # ------------------------------------------------------------- futures
    def sync_async(self, params, world: Optional[int] = None,
                   use_reduce_scatter: bool = False,
                   residuals=None) -> List[BucketFuture]:
        """Reduce every bucket now and return one resolved future a
        bucket (``fut.wait()`` the reduced flat buffer, ``fut.scatter()``
        its write-back into ``.grad``, ``fut.residual`` its new
        error-feedback residual). ``residuals`` ({bucket index: fp32
        flat}) replaces the carried ones, which are then left as they
        are; without it the communicator keeps them as ``sync`` does."""
        params = [p for p in map(unwrap, params) if p.grad is not None]
        if world is None:
            from .env import get_world_size

            world = get_world_size()
        self.stats = {"codec": self.config.codec, "path": "eager",
                      "n_params": len(params), "n_buckets": 0,
                      "collectives": 0, "comm_bytes": 0}
        if world <= 1 or not params:
            return []
        buckets = self.buckets_for(params, [p.grad.dtype for p in params])
        self.stats["n_buckets"] = len(buckets)
        ef = self.config.error_feedback and self.config.codec in EF_CODECS
        futures = []
        with torch.no_grad():
            for b in buckets:
                flat = self._flatten_bucket(b, params)
                res_in = None
                if ef:
                    res_in = (residuals.get(b.index) if residuals is not None
                              else self.residual(b, flat.device))
                reduced, new_res, wire_bytes, n_coll = self.reduce_bucket(
                    b, flat, world, use_reduce_scatter=use_reduce_scatter,
                    residual=res_in)
                if new_res is not None and residuals is None:
                    self._residuals[b.index] = new_res
                self.stats["collectives"] += n_coll
                self.stats["comm_bytes"] += wire_bytes
                fut = BucketFuture(b, value=reduced, resolved=True)
                fut.residual = new_res
                fut.scatter = (lambda bb=b, rr=reduced:
                               self._scatter_bucket(bb, params, rr))
                futures.append(fut)
        self._record_metrics(buckets)
        return futures


# ---------------------------------------------------------------------------
# measurement helper
# ---------------------------------------------------------------------------

def _fake_params(shapes_dtypes, seed=0, device="cpu"):
    rs = np.random.RandomState(seed)
    params = []
    for shape, dt in shapes_dtypes:
        p = torch.zeros(shape, dtype=dt, device=device, requires_grad=True)
        p.grad = (torch.from_numpy(rs.standard_normal(shape).astype(
            np.float32)) * 1e-2).to(device, dt)
        params.append(p)
    return params


def overlap_report(params, config: Optional[GradCommConfig] = None,
                   world: int = 2, compute_s: float = 0.02,
                   seed: int = 0) -> dict:
    """Serial against overlapped exposed comm time of one sync of
    ``params``' shapes and dtypes, on detached fakes with random
    gradients (the live model is not touched), in this process's world:
    with no process group the collectives leave their tensors as they
    are, so the times are the host's encode and copy costs. The
    overlapped run hands the fakes to the grad-ready hook in reverse
    order, ``compute_s`` of emulated backward spread between them."""
    config = config or GradCommConfig()
    shapes_dtypes = [(tuple(p.shape), p.dtype) for p in map(unwrap, params)
                     if p.requires_grad]
    device = next(iter(map(unwrap, params))).device

    serial = GradCommunicator(GradCommConfig(
        config.codec, config.comm_buffer_size, config.last_comm_buffer_size,
        config.error_feedback, block_size=config.block_size))
    serial.sync(_fake_params(shapes_dtypes, seed, device), world=world)
    fakes = _fake_params(shapes_dtypes, seed, device)
    t0 = time.perf_counter()
    serial.sync(fakes, world=world)
    serial_exposed_s = time.perf_counter() - t0

    fakes = _fake_params(shapes_dtypes, seed, device)
    comm = OverlappedGradCommunicator(GradCommConfig(
        config.codec, config.comm_buffer_size, config.last_comm_buffer_size,
        config.error_feedback, overlap=True, block_size=config.block_size))
    comm.prepare(fakes, world=world)
    per_param = compute_s / max(1, len(fakes))
    for p in reversed(fakes):
        time.sleep(per_param)
        comm._on_grad_ready(p)
    t0 = time.perf_counter()
    comm.flush()
    flush_wait_s = time.perf_counter() - t0
    return {
        "codec": config.codec,
        "world": int(world),
        "n_buckets": comm.stats["n_buckets"],
        "serial_exposed_comm_ms": round(serial_exposed_s * 1e3, 3),
        "overlapped_exposed_comm_ms": round(
            comm.stats["exposed_comm_s"] * 1e3, 3),
        "overlapped_flush_wait_ms": round(flush_wait_s * 1e3, 3),
        "hidden_comm_ms": round(comm.stats["hidden_comm_s"] * 1e3, 3),
        "overlap_efficiency": round(comm.stats["overlap_efficiency"], 4),
        "buckets_launched_early": comm.stats["buckets_launched_early"],
        "emulated_backward_ms": round(compute_s * 1e3, 3),
    }
