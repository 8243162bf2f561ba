"""Port data-parallel training of a bf16 model on the quantized gradient
wire (``paddle_tpu_torch``: ``TrainStep(grad_comm=...)`` over bf16
buckets, ``GradCommunicator`` encoding bf16 buckets, the one-launch
``FusedFlatUpdater.step_dequant``, ``DataParallel`` decoding to bf16)
against the JAX reference on the CPU, at world 2.

The reference runs ``TrainStep(grad_comm=...)`` on a 2-device ``data``
mesh of the suite's 8-device CPU platform, once with
``FLAGS_kernel_autotune`` on (the fused dequantize-and-update Pallas
kernel, interpret mode) and once off (the jnp decode to bf16, then the
per-parameter update); the flag and the mesh are restored after each run
and again at the end. The port runs 2 gloo ranks through its own
``spawn``, all cases in one spawn (``tests/torch_dp_workers.py``
``bf16_dp_cases``).

- ``gpt-test`` in bf16 (the reference's weights, seed 7; bf16 blocks and
  tables, the fp32 final norm: 2 buckets), ``int8_block`` at its
  defaults, ids ``(4, 16)``, ``AdamW(lr=1e-3, wd=0.01)``, 2 steps, with
  error feedback (the default: the first step encodes from bf16, the
  second from the fp32 sum with the residual) and without (every step
  encodes from bf16), each against both reference runs:
  - losses within 3e-4 relative (the bf16 rule of
    ``tests/test_torch_bf16_train.py``);
  - ``comm_stats`` the reference's: 2 buckets, 4 collectives, 125,164
    wire bytes;
  - every parameter and Adam moment within ``2 * lr * steps`` of the
    reference's;
  - the share of bf16 parameter elements within one bf16 ulp of the
    reference's, and the share of the fp32 elements (the final norm and
    the moments) within rtol 1e-6 / atol 1e-7, each at least the share
    the same two steps reach *without the wire* (each framework's plain
    ``TrainStep`` on the whole batch in one process, the control) less
    2 points. Why not 99.9% of the elements, as
    ``tests/test_torch_dp_train.py`` holds the fp32 model: a bf16
    model's local gradients differ between the two frameworks by up to
    a bf16 ulp on many elements (XLA rounds the bf16 GEMMs and the
    tanh-gelu after each op, the port once), so the control itself
    reaches only ~95% of the bf16 parameters and ~60% of the fp32
    elements; the wire adds no disagreement of its own (measured: 94-95%
    and 65-70% with it). The wire itself is held bit for bit where the
    local gradients are the same: below, and bucket by bucket in
    ``tests/test_torch_codec.py`` and
    ``tests/test_torch_dequant_update.py``;
  - the update table built once for the two steps.
- The port's two ranks end with bit-identical parameters and losses;
  each rank's residuals are its own, fp32, and come back unchanged
  through ``state_dict`` / ``load_state_dict``.
- ``DataParallel.apply_collective_grads`` on the reference's MLP in bf16
  (``int8_block``, 128-element blocks, two rounds carrying the
  error-feedback residual) against the reference's eager
  ``GradCommunicator.sync`` of the same local bf16 gradients, its two
  ranks emulated by two threads meeting in ``collective.all_reduce``:
  the reduced bf16 gradients bit-identical.

The bucket-level bf16 forms (the codecs, the dequantizing update) are
held bit for bit in ``tests/test_torch_codec.py`` and
``tests/test_torch_dequant_update.py``. The file collects one test that
runs every case (``tests/torch_checks.py`` says why).
"""
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed.mesh as mesh_mod
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import grad_comm as jgc
from paddle_tpu.framework import flags as jflags
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_presets as jax_presets
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.optimizer import AdamW
from test_torch_dp_train import (IDS, LABELS, MLP_GC, X, Y, _gpt_loss,
                                 _mlp_weights, _ref_eager_sync, _ref_run)
from torch_checks import bf16_ulp, run_checks
import torch_dp_workers as workers

torch.set_num_threads(2)

LR, STEPS = 1e-3, 2
LOSS_RTOL = 3e-4
WIRE_BYTES = 125_164
MARGIN = 0.02          # points of share below the no-wire control


def _ref_gpt():
    return JaxGPT(jax_presets("gpt-test", dtype="bfloat16"), seed=7)


def _gpt_bits():
    """The reference's bf16 ``gpt-test`` weights as the workers take
    them: int16 bits of a bf16 array, fp32 values of the final norm."""
    out = {}
    for n, p in _ref_gpt().named_parameters():
        a = np.asarray(p._value)
        out[n] = a.view(np.int16) if a.dtype.itemsize == 2 else a
    return out


_port = {}


def _port_runs():
    """Every world-2 port run, once (two gloo ranks, one spawn)."""
    if not _port:
        _port["ranks"] = spawn(workers.bf16_dp_cases,
                               args=(_gpt_bits(), IDS, LABELS,
                                     _mlp_weights(), X, Y),
                               nprocs=2, timeout=240)
    return _port["ranks"]


def _f32(a) -> np.ndarray:
    a = np.asarray(a)
    return a if a.dtype == np.float32 else np.asarray(
        jnp.asarray(a).astype(jnp.float32))


def _shares(port, ref, what):
    """The share of bf16 parameter elements within one bf16 ulp of the
    reference's and of fp32 elements (the final norm, the moments)
    within rtol 1e-6 / atol 1e-7; asserts every element within
    ``2 * lr * steps``."""
    arrays = list(zip(port["params"], ref["params"], port["dtypes"]))
    for ps, rs in zip(port["slots"], ref["slots"]):
        assert set(ps) == set(rs), (what, set(ps), set(rs))
        arrays += [(ps[k], rs[k], "torch.float32") for k in rs]
    close = {"torch.bfloat16": [0, 0], "torch.float32": [0, 0]}
    for a, b, dt in arrays:
        a, b = _f32(a), _f32(b)
        assert a.shape == b.shape, (what, a.shape, b.shape)
        diff = np.abs(a - b)
        worst = float(diff.max())
        assert worst <= 2 * LR * STEPS, f"{what}: max abs diff {worst}"
        if dt == "torch.bfloat16":
            lim = bf16_ulp(torch.from_numpy(np.maximum(np.abs(a),
                                                       np.abs(b)))).numpy()
        else:
            lim = 1e-7 + 1e-6 * np.abs(b)
        close[dt][0] += int((diff <= lim).sum())
        close[dt][1] += diff.size
    return {dt: c / n for dt, (c, n) in close.items()}


_control = {}


def _no_wire_shares():
    """The control: the same two steps without the wire, each framework's
    plain ``TrainStep`` on the whole batch in one process, and the shares
    its results reach against each other."""
    if not _control:
        jm = _ref_gpt()
        jstep = JaxTrainStep(jm, _gpt_loss(), jopt.AdamW(
            learning_rate=LR, weight_decay=0.01, parameters=jm.parameters()))
        tm = workers.gpt_test_bf16(_gpt_bits())
        tstep = TrainStep(tm, GPTPretrainingCriterion(), AdamW(
            learning_rate=LR, weight_decay=0.01, parameters=tm.parameters()))
        for _ in range(STEPS):
            jstep(inputs=(paddle.to_tensor(IDS),),
                  labels=(paddle.to_tensor(LABELS),))
            tstep(inputs=(IDS,), labels=(LABELS,))
        port = {"params": [workers._np(p) for p in tm.parameters()],
                "dtypes": [str(p.dtype) for p in tm.parameters()],
                "slots": workers._param_slots(tstep.updater)}
        ref = {"params": [np.asarray(p._value) for p in jm.parameters()],
               "slots": [{k: np.asarray(v) for k, v in s.items()}
                         for s in jstep._slots]}
        _control.update(_shares(port, ref, "no-wire control"))
    return _control


def check_gpt_bf16_int8_block_matches_reference(case, fused):
    port = _port_runs()[0][case]
    gc = jgc.GradCommConfig("int8_block", error_feedback=case == "ef")
    ref = _ref_run(_ref_gpt, _gpt_loss(), LR, gc, (IDS,), (LABELS,), STEPS,
                   fused)
    what = f"gpt-test bf16 {case} fused={fused}"
    np.testing.assert_allclose(port["losses"], ref["losses"],
                               rtol=LOSS_RTOL, err_msg=f"{what} losses")
    assert port["fused"] and port["table_builds"] == 1, what
    assert port["comm_stats"] == ref["comm_stats"], what
    assert (port["comm_stats"]["n_buckets"], port["comm_stats"]["collectives"],
            port["comm_stats"]["comm_bytes"]) == (2, 4, WIRE_BYTES), what
    assert set(port["dtypes"]) == {"torch.bfloat16", "torch.float32"}
    shares, control = _shares(port, ref, what), _no_wire_shares()
    for dt, share in shares.items():
        assert share >= control[dt] - MARGIN, \
            (f"{what}: {share:.4f} of the {dt} elements close, the no-wire "
             f"control {control[dt]:.4f}")


def check_ranks_end_bit_identical():
    r0, r1 = _port_runs()
    for case in ("ef", "no_ef"):
        for a, b in zip(r0[case]["params"], r1[case]["params"]):
            assert a.view(np.int32).tobytes() == b.view(np.int32).tobytes(), \
                case
        assert r0[case]["losses"] == r1[case]["losses"], case
    res0, res1 = r0["ef"]["residuals"], r1["ef"]["residuals"]
    assert set(res0) == {0, 1} and all(r.dtype == np.float32
                                       for r in res0.values())
    assert r0["ef"]["state_round_trip"] and r1["ef"]["state_round_trip"]
    assert any(not np.array_equal(res0[i], res1[i]) for i in res0)
    assert not r0["no_ef"]["residuals"]


def check_data_parallel_bf16_matches_reference_eager_sync():
    r0, r1 = _port_runs()
    p0, p1 = r0["dp"], r1["dp"]
    assert set(p0["dtypes"]) == {"torch.bfloat16"}

    def bf16(rounds):
        return [[np.asarray(jnp.asarray(g).astype(jnp.bfloat16)) for g in r]
                for r in rounds]

    cfg = jgc.GradCommConfig("int8_block", block_size=128, **MLP_GC)
    rounds, stats = _ref_eager_sync(cfg, [bf16(p0["local"]),
                                          bf16(p1["local"])])
    assert len(rounds) == len(p0["reduced"]) == 2
    for ref_round, port_round, other in zip(rounds, p0["reduced"],
                                            p1["reduced"]):
        for a, b, c in zip(port_round, ref_round, other):
            assert b.dtype == jnp.bfloat16
            assert np.array_equal(a, _f32(b))
            assert np.array_equal(a, c)
    assert p0["stats"] == stats


def test_bf16_dp_port_matches_reference(fresh_mesh):
    prev_flag = jflags.flag("FLAGS_kernel_autotune")
    prev_mesh = mesh_mod.get_mesh()
    try:
        run_checks(
            [(check_gpt_bf16_int8_block_matches_reference, (case, f))
             for case in ("ef", "no_ef") for f in (True, False)]
            + [(check_ranks_end_bit_identical, ()),
               (check_data_parallel_bf16_matches_reference_eager_sync, ())])
    finally:
        jflags.set_flags({"FLAGS_kernel_autotune": prev_flag})
        mesh_mod.set_mesh(prev_mesh)
        _port.clear()
        _control.clear()
