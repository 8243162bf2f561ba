"""The port's overlapped gradient communicator
(``paddle_tpu_torch.distributed.overlap``: ``OverlappedGradCommunicator``,
``CollectiveLane``, ``BucketFuture``, ``communicator_for``,
``overlap_report``; ``FusedFlatUpdater.step(futures=...)``) on the CPU.

The reference's contract (``paddle_tpu/distributed/overlap.py``): the
overlapped sync is bit-identical to the serial one, only the wall clock
moves. Held here:

- On 2 gloo ranks (``tests/torch_dp_workers.py``, one spawn for the
  file): two rounds of the MLP's gradients through the reduce_scatter
  sync, fp32 and int8_block (the error-feedback residual carried), and
  ``gpt-test`` through ``DataParallel`` on a ``DistributedStrategy``'s
  wire with ``overlap`` on, backward launching the buckets from the
  grad-ready hooks: reduced gradients, residuals and the wire accounting
  bit for bit against the serial communicator, the buckets launched
  before the flush.
- ``FusedFlatUpdater.step(futures=sync_async(...))`` equal to
  ``sync`` then ``step()``, bit for bit, the residuals committed.
- ``abandon()``: a disarmed backward launches nothing and accumulates
  raw; the re-armed step then equals the serial sync of the accumulated
  gradients.
- A lane error (a collective that raises) surfaces at ``flush()`` after
  the lane is drained, and the communicator is disarmed; a gradient of
  another dtype than its bucket's raises there too.
- ``overlap_report`` and the ``grad_comm_overlap_efficiency`` gauge.

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch.distributed.collective as tcoll
from paddle_tpu_torch.distributed import grad_comm as tgc
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.overlap import (
    OverlappedGradCommunicator, communicator_for, overlap_report)
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.observability.metrics import get_registry
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.fused import FusedFlatUpdater
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_presets as jax_presets
from torch_checks import run_checks
import torch_dp_workers as workers

torch.set_num_threads(2)

X, Y = workers.ZERO_X, workers.ZERO_Y
IDS, LABELS = workers.ZERO_IDS, workers.ZERO_LABELS
MLP_ROUNDS = workers.ZERO_ROUNDS
_mlp = workers.seeded_mlp


def _gpt_params():
    """The reference's ``gpt-test`` weights (seed 7)."""
    return {n: np.asarray(p._value) for n, p in
            JaxGPT(jax_presets("gpt-test"), seed=7).named_parameters()}


_port = {}


def _port_runs():
    if not _port:
        _port["ranks"] = spawn(workers.overlap_cases,
                               args=(MLP_ROUNDS, _gpt_params(), IDS, LABELS),
                               nprocs=2, timeout=300)
    return _port["ranks"]


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), what


def check_overlapped_reduce_scatter_sync_is_serial(codec):
    for rank in _port_runs():
        ser, ovl = rank[("rs", codec, False)], rank[("rs", codec, True)]
        for k, (a, b) in enumerate(zip(ovl["reduced"], ser["reduced"])):
            for i, (x, y) in enumerate(zip(a, b)):
                _same(x, y, f"{codec} round {k} grad {i}")
        assert sorted(ovl["residuals"]) == sorted(ser["residuals"])
        for i, r in ser["residuals"].items():
            _same(ovl["residuals"][i], r, f"{codec} residual {i}")
        for key in ("codec", "n_buckets", "collectives", "comm_bytes"):
            assert ovl["stats"][key] == ser["stats"][key], key
        assert ovl["stats"]["overlapped"]


def check_data_parallel_overlap_is_serial(codec):
    r0, r1 = _port_runs()
    for rank in (r0, r1):
        ser, ovl = rank[("dp", codec, False)], rank[("dp", codec, True)]
        assert (ser["type"], ovl["type"]) == (
            "GradCommunicator", "OverlappedGradCommunicator")
        for k, (a, b) in enumerate(zip(ovl["rounds"], ser["rounds"])):
            for i, (x, y) in enumerate(zip(a, b)):
                _same(x, y, f"{codec} dp round {k} grad {i}")
        for i, r in ser["residuals"].items():
            _same(ovl["residuals"][i], r, f"{codec} dp residual {i}")
        assert ovl["stats"] == ser["stats"], (ovl["stats"], ser["stats"])
        # backward launched every bucket before the flush
        assert ovl["early"] == ser["stats"]["n_buckets"] > 1
    for a, b in zip(r0[("dp", codec, True)]["rounds"][1],
                    r1[("dp", codec, True)]["rounds"][1]):
        _same(a, b, f"{codec} ranks")


def _mse(out, y):
    return torch.nn.functional.mse_loss(out, y)


def _backward(net, scale=1.0):
    _mse(net(torch.from_numpy(X) * scale), torch.from_numpy(Y)).backward()


def check_step_futures_equals_step():
    cfg = workers._zero_config("int8_block")
    runs = []
    for use_futures in (False, True):
        net = _mlp()
        opt = AdamW(learning_rate=1e-2, parameters=net.parameters())
        comm = OverlappedGradCommunicator(
            tgc.GradCommConfig(cfg.codec, cfg.comm_buffer_size,
                               cfg.last_comm_buffer_size, overlap=True,
                               block_size=cfg.block_size))
        fused = FusedFlatUpdater(opt, list(net.parameters()),
                                 communicator=comm)
        for k in range(2):
            fused.zero_grad()
            _backward(net, 1 + k)
            if use_futures:
                futures = comm.sync_async(fused.params, world=2)
                assert all(f.done() for f in futures)
                fused.step(futures=futures)
            else:
                comm.sync(fused.params, world=2)
                fused.step()
        runs.append(([p.detach().clone() for p in net.parameters()],
                     {i: r.clone() for i, r in comm._residuals.items()},
                     fused.table_builds))
    (p0, r0, b0), (p1, r1, b1) = runs
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
    assert sorted(r0) == sorted(r1) and r0
    for i in r0:
        assert torch.equal(r0[i], r1[i])
    assert b0 == b1 == 1


def check_abandon_and_rearm():
    cfg = tgc.GradCommConfig("int8_block", comm_buffer_size=0.0002,
                             last_comm_buffer_size=0.0001, block_size=16,
                             overlap=True)
    net, ref = _mlp(), _mlp()
    comm = communicator_for(cfg)
    serial = tgc.GradCommunicator(cfg)
    params, ref_params = list(net.parameters()), list(ref.parameters())
    comm.prepare(params, world=2)
    comm.abandon()
    _backward(net)                  # raw accumulation: nothing launched
    assert comm._step is None and comm.last_timeline == []
    comm.prepare(params, world=2)
    _backward(net, 2.0)
    comm.sync(params, world=2)
    _backward(ref)
    _backward(ref, 2.0)
    serial.sync(ref_params, world=2)
    for a, b in zip(params, ref_params):
        assert torch.equal(a.grad, b.grad)
    assert comm.stats["buckets_launched_early"] == len(comm._buckets)


def check_lane_error_surfaces_at_flush():
    cfg = tgc.GradCommConfig("fp32", comm_buffer_size=0.0002,
                             last_comm_buffer_size=0.0001, overlap=True)
    net = _mlp()
    params = list(net.parameters())
    comm = OverlappedGradCommunicator(cfg)
    boom = RuntimeError("the wire fell out")

    def bad(t, *a, **k):
        raise boom

    saved = tcoll.all_reduce
    tcoll.all_reduce = bad
    try:
        comm.prepare(params, world=2)
        _backward(net)              # the lane meets the error; backward not
        with pytest.raises(RuntimeError, match="wire fell out"):
            comm.flush()
    finally:
        tcoll.all_reduce = saved
    assert comm._step is None and comm._handles == []
    for p in params:
        p.grad = None
    comm.prepare(params, world=2)
    _backward(net)
    comm.sync(params, world=2)      # healthy again
    # a gradient of another dtype than its bucket's
    comm.prepare(params, world=2)
    for p in params:
        p.grad = None
    params[0].grad_dtype = torch.float64
    try:
        _backward(net)
        with pytest.raises(RuntimeError, match="grad dtype == param"):
            comm.flush()
    finally:
        params[0].grad = None
        params[0].grad_dtype = params[0].dtype


def check_overlap_report_and_gauge():
    rep = overlap_report(list(_mlp().parameters()),
                         workers._zero_config("int8_block"), world=2,
                         compute_s=0.02)
    assert rep["n_buckets"] >= 3
    assert rep["buckets_launched_early"] == rep["n_buckets"]
    assert 0.0 <= rep["overlap_efficiency"] <= 1.0
    snap = get_registry().snapshot()
    assert snap["grad_comm_overlap_efficiency"] == pytest.approx(
        rep["overlap_efficiency"], abs=1e-4)
    assert snap["grad_comm_overlapped_syncs_total"] >= 1


def check_gpt_overlapped_matches_serial_in_one_process():
    """``gpt-test``'s backward driving the hooks in one process (the
    collectives of one rank leave their tensors as they are), int8_block
    with error feedback over two rounds."""
    out = []
    for overlap in (False, True):
        model = workers.gpt_test(_gpt_params())
        comm = communicator_for(tgc.GradCommConfig(
            "int8_block", comm_buffer_size=0.05, last_comm_buffer_size=0.01,
            block_size=64, overlap=overlap))
        params = [p for p in model.parameters() if p.requires_grad]
        rounds = []
        for k in range(2):
            for p in params:
                p.grad = None
            if overlap:
                comm.prepare(params, world=2)
            GPTPretrainingCriterion()(model(torch.from_numpy(IDS)),
                                      torch.from_numpy(LABELS)).backward()
            comm.sync(params, world=2)
            rounds.append([p.grad.clone() for p in params])
        out.append(rounds)
    for a, b in zip(out[0], out[1]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_overlap_port_is_serial(fresh_mesh):
    try:
        run_checks(
            [(check_overlapped_reduce_scatter_sync_is_serial, (c,))
             for c in ("fp32", "int8_block")]
            + [(check_data_parallel_overlap_is_serial, (c,))
               for c in ("fp32", "int8_block")]
            + [(check_step_futures_equals_step, ()),
               (check_abandon_and_rearm, ()),
               (check_lane_error_surfaces_at_flush, ()),
               (check_overlap_report_and_gauge, ()),
               (check_gpt_overlapped_matches_serial_in_one_process, ())])
    finally:
        _port.clear()
