"""Port data-parallel training on the quantized gradient wire
(``paddle_tpu_torch``: ``TrainStep(grad_comm=...)``, ``GradCommunicator``,
``FusedFlatUpdater.step_dequant``, ``DataParallel``, ``spawn``) against
the JAX reference's ``TrainStep(grad_comm=...)`` on the CPU, at world 2.

The reference runs on a 2-device ``data`` mesh of the suite's 8-device
CPU platform, once with ``FLAGS_kernel_autotune`` on (the fused
dequantize-and-update Pallas kernel, interpret mode) and once off (the
jnp decode, then the per-parameter update); the flag is restored after
each run. The port runs 2 gloo ranks through its own ``spawn``, each on
its contiguous half of the batch, all cases in one spawn
(``tests/torch_dp_workers.py``).

- MLP (the reference's ``_mlp``, ``X``, ``Y``, ``AdamW(lr=1e-2)``,
  ``int8_block`` with 128-element blocks and 0.0002 / 0.0001 MB buckets,
  4 steps) and ``gpt-test`` (``int8_block`` at its defaults, ids
  ``(4, 16)``, ``AdamW(lr=1e-3)``, 2 steps), each against both reference
  runs: losses within rtol 1e-5; parameters and Adam moments within
  rtol 1e-6 / atol 1e-7 on at least 99.9% of their elements and
  everywhere within ``2 * lr * steps``. Why not everywhere: the local
  gradients of the two frameworks differ by ulps (tanh, matmul sums), so
  an element at a rounding edge of the quantizer lands one step apart,
  and Adam turns that into a different step. ``gpt-test``'s wire bytes
  per step equal the reference's ``comm_stats["comm_bytes"]``.
- The port's two ranks end with bit-identical parameters.
- World 1 (no process group): ``grad_comm`` is inert, the step is
  bit-identical to the step without it and ``comm_stats`` is None.
- The fp32 codec at world 2 against the reference's fp32 wire: losses
  and parameters within 1e-6 absolute (the losses differ by ulps of
  tanh and the mean, up to 1.3e-6 relative at 0.87).
- ``DataParallel.apply_collective_grads`` on the MLP (int8_block over
  two rounds, carrying the error-feedback residual, and the default fp32
  wire) against the reference's eager ``GradCommunicator.sync`` of the
  same local gradients, its two ranks emulated by two threads that meet
  in ``collective.all_reduce``: bit-identical.
- ``grad_accum_steps=2`` and an unknown codec raise the reference's
  ``ValueError``.

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import threading

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed.collective as jcoll
import paddle_tpu.distributed.mesh as mesh_mod
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import grad_comm as jgc
from paddle_tpu.framework import flags as jflags
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt_presets as jax_presets
from paddle_tpu_torch.distributed import GradCommConfig, spawn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import AdamW
from torch_checks import run_checks
import torch_dp_workers as workers

torch.set_num_threads(2)

_rng = np.random.RandomState(0)
X = _rng.standard_normal((16, 8)).astype(np.float32)
Y = _rng.standard_normal((16, 1)).astype(np.float32)
_ids_rs = np.random.RandomState(0)
IDS = _ids_rs.randint(0, 256, (4, 16)).astype(np.int64)
LABELS = _ids_rs.randint(0, 256, (4, 16)).astype(np.int64)
MLP_GC = dict(comm_buffer_size=0.0002, last_comm_buffer_size=0.0001)
SHARE = 0.999


def _ref_mlp():
    paddle.seed(7)
    return jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 1))


def _mlp_weights():
    return [np.asarray(p._value) for p in _ref_mlp().parameters()]


def _ref_gpt():
    return JaxGPT(jax_presets("gpt-test"), seed=7)


def _gpt_params():
    return {n: np.asarray(p._value) for n, p in _ref_gpt().named_parameters()}


def _ref_run(make, loss_fn, lr, gc, inputs, labels, steps, fused):
    """The reference's TrainStep on a 2-device data mesh, with the fused
    dequantize-and-update kernel on or off; the flag and mesh restored."""
    prev = jflags.flag("FLAGS_kernel_autotune")
    prev_mesh = mesh_mod.get_mesh()
    jflags.set_flags({"FLAGS_kernel_autotune": bool(fused)})
    try:
        mesh_mod.set_mesh(mesh_mod.build_mesh({"data": 2},
                                              devices=jax.devices()[:2]))
        net = make()
        opt = jopt.AdamW(learning_rate=lr, weight_decay=0.01,
                         parameters=net.parameters())
        step = JaxTrainStep(net, loss_fn, opt, grad_comm=gc)
        losses = [float(step(inputs=tuple(paddle.to_tensor(x)
                                          for x in inputs),
                             labels=tuple(paddle.to_tensor(y)
                                          for y in labels)))
                  for _ in range(steps)]
        return {"losses": losses,
                "params": [np.asarray(p._value) for p in net.parameters()],
                "slots": [{k: np.asarray(v) for k, v in s.items()}
                          for s in step._slots],
                "comm_stats": step.comm_stats}
    finally:
        jflags.set_flags({"FLAGS_kernel_autotune": prev})
        mesh_mod.set_mesh(prev_mesh)


def _gpt_loss():
    crit = JaxCriterion()
    return lambda lg, lb: crit(lg, lb)


_port = {}


def _port_runs():
    """Every world-2 port run, once (two gloo ranks, one spawn)."""
    if not _port:
        ranks = spawn(workers.dp_train_cases,
                      args=(_mlp_weights(), X, Y, _gpt_params(), IDS,
                            LABELS),
                      nprocs=2, timeout=240)
        _port.update(ranks=ranks)
    return _port["ranks"]


def _held(port, ref, lr, steps, what):
    """Losses within 1e-5 relative; parameters and moments within rtol
    1e-6 / atol 1e-7 on >= 99.9% of the elements and everywhere within
    2 lr steps. Returns the share of elements within rtol/atol."""
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5,
                               err_msg=f"{what} losses")
    arrays = list(zip(port["params"], ref["params"]))
    for ps, rs in zip(port["slots"], ref["slots"]):
        assert set(ps) == set(rs), (what, set(ps), set(rs))
        arrays += [(ps[k], rs[k]) for k in rs]
    close = total = 0
    for a, b in arrays:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (what, a.shape, b.shape)
        ok = np.abs(a - b) <= 1e-7 + 1e-6 * np.abs(b)
        close += int(ok.sum())
        total += ok.size
        worst = float(np.abs(a - b).max())
        assert worst <= 2 * lr * steps, f"{what}: max abs diff {worst}"
    share = close / total
    assert share >= SHARE, f"{what}: only {share:.5f} of elements close"
    return share


def check_mlp_int8_block_matches_reference(fused):
    ranks = _port_runs()
    port = ranks[0]["mlp_int8"]
    assert port["fused"] and port["comm_stats"]["n_buckets"] == 3
    gc = jgc.GradCommConfig("int8_block", block_size=128, **MLP_GC)
    ref = _ref_run(_ref_mlp, JF.mse_loss, 1e-2, gc, (X,), (Y,), 4, fused)
    _held(port, ref, 1e-2, 4, f"mlp fused={fused}")
    assert port["comm_stats"] == {**ref["comm_stats"], "world": 2}


def check_gpt_test_int8_block_matches_reference(fused):
    ranks = _port_runs()
    port = ranks[0]["gpt_int8"]
    ref = _ref_run(_ref_gpt, _gpt_loss(), 1e-3,
                   jgc.GradCommConfig("int8_block"), (IDS,), (LABELS,), 2,
                   fused)
    _held(port, ref, 1e-3, 2, f"gpt-test fused={fused}")
    assert port["comm_stats"]["comm_bytes"] == \
        ref["comm_stats"]["comm_bytes"]
    assert port["comm_stats"] == ref["comm_stats"]


def check_ranks_end_bit_identical():
    r0, r1 = _port_runs()
    for case in ("mlp_int8", "mlp_fp32", "gpt_int8"):
        for a, b in zip(r0[case]["params"], r1[case]["params"]):
            assert a.view(np.int32).tobytes() == b.view(np.int32).tobytes(), \
                case
        assert r0[case]["losses"] == r1[case]["losses"], case
        # the error-feedback residuals are each rank's own
        if r0[case]["residuals"]:
            assert any(not np.array_equal(r0[case]["residuals"][i],
                                          r1[case]["residuals"][i])
                       for i in r0[case]["residuals"])


def check_fp32_wire_matches_reference():
    port = _port_runs()[0]["mlp_fp32"]
    assert not port["fused"]
    ref = _ref_run(_ref_mlp, JF.mse_loss, 1e-2,
                   jgc.GradCommConfig("fp32", **MLP_GC), (X,), (Y,), 4,
                   False)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=0,
                               atol=1e-6)
    for a, b in zip(port["params"], ref["params"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def check_world_1_is_inert():
    def run(gc):
        net = workers.mlp(_mlp_weights())
        opt = AdamW(learning_rate=1e-2, parameters=net.parameters())
        step = TrainStep(net, workers._mse, opt, grad_comm=gc)
        losses = [float(step(inputs=(X,), labels=(Y,))) for _ in range(3)]
        return losses, [p.detach().clone() for p in net.parameters()], step

    l_off, p_off, _ = run(None)
    l_on, p_on, step = run(GradCommConfig("int8_block", block_size=128,
                                          **MLP_GC))
    assert l_on == l_off
    for a, b in zip(p_on, p_off):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert step.comm_stats is None


def _ref_eager_sync(cfg, local):
    """The reference's eager ``GradCommunicator.sync`` at world 2: one
    thread per rank, each with its own communicator, meeting in
    ``collective.all_reduce``. ``local[r][k]`` is rank r's gradient list
    in round k; returns rank 0's reduced gradients per round."""
    barrier = threading.Barrier(2)
    seen = [None, None]
    tls = threading.local()

    def all_reduce(t, op=jcoll.ReduceOp.SUM, group=None, **kw):
        seen[tls.rank] = t._value
        barrier.wait()
        a, b = seen
        if op == jcoll.ReduceOp.MAX:
            v = jax.numpy.maximum(a, b)
        elif op == jcoll.ReduceOp.AVG:
            v = (a + b) / 2
        else:
            v = a + b
        barrier.wait()
        t._value = v
        return t

    out = [None, None]
    errors = []

    def rank_main(r):
        try:
            tls.rank = r
            comm = jgc.GradCommunicator(cfg)
            rounds = []
            for grads in local[r]:
                params = []
                for g in grads:
                    p = Tensor(np.zeros(g.shape, np.float32))
                    p.stop_gradient = False
                    p.grad = Tensor(g)
                    params.append(p)
                comm.sync(params, world=2)
                rounds.append([np.asarray(p.grad._value) for p in params])
            out[r] = (rounds, dict(comm.stats))
        except BaseException as e:   # surfaced below
            errors.append(e)
            barrier.abort()

    saved = jcoll.all_reduce
    jcoll.all_reduce = all_reduce
    try:
        threads = [threading.Thread(target=rank_main, args=(r,))
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        jcoll.all_reduce = saved
    if errors:
        raise errors[0]
    return out[0]


def check_data_parallel_matches_reference_eager_sync(codec):
    r0, r1 = _port_runs()
    p0, p1 = r0["dp"][codec], r1["dp"][codec]
    cfg = (jgc.GradCommConfig("fp32") if codec == "fp32" else
           jgc.GradCommConfig(codec, block_size=128, **MLP_GC))
    rounds, stats = _ref_eager_sync(cfg, [p0["local"], p1["local"]])
    assert len(rounds) == len(p0["reduced"])
    for ref_round, port_round, other in zip(rounds, p0["reduced"],
                                            p1["reduced"]):
        for a, b, c in zip(port_round, ref_round, other):
            assert np.array_equal(a, b), codec
            assert np.array_equal(a, c), codec
    assert p0["stats"] == stats


def check_unsupported_compositions_raise():
    net = workers.mlp(_mlp_weights())
    opt = AdamW(learning_rate=0.1, parameters=net.parameters())
    with pytest.raises(ValueError, match="grad_accum") as port_err:
        TrainStep(net, workers._mse, opt, grad_accum_steps=2,
                  grad_comm="int8_block")
    jnet = _ref_mlp()
    jo = jopt.SGD(learning_rate=0.1, parameters=jnet.parameters())
    with pytest.raises(ValueError) as ref_err:
        JaxTrainStep(jnet, JF.mse_loss, jo, grad_accum_steps=2,
                     grad_comm="int8_block")
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="unknown grad_comm codec") as pe:
        TrainStep(net, workers._mse, opt, grad_comm="fp8")
    with pytest.raises(ValueError) as re_:
        JaxTrainStep(jnet, JF.mse_loss, jo, grad_comm="fp8")
    assert str(pe.value) == str(re_.value)
    with pytest.raises(TypeError, match="GradCommConfig"):
        TrainStep(net, workers._mse, opt, grad_comm=object())


def test_dp_train_port_matches_reference(fresh_mesh):
    try:
        run_checks(
            [(check_mlp_int8_block_matches_reference, (f,))
             for f in (True, False)]
            + [(check_gpt_test_int8_block_matches_reference, (f,))
               for f in (True, False)]
            + [(check_ranks_end_bit_identical, ()),
               (check_fp32_wire_matches_reference, ()),
               (check_world_1_is_inert, ())]
            + [(check_data_parallel_matches_reference_eager_sync, (c,))
               for c in ("int8_block", "fp32")]
            + [(check_unsupported_compositions_raise, ())])
    finally:
        _port.clear()
