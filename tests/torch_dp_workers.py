"""Rank workers for the port's data-parallel tests on the CPU
(``tests/test_torch_grad_comm.py``, ``tests/test_torch_dp_train.py``,
``tests/test_torch_bf16_dp.py``, ``tests/test_torch_train_options.py``).

``paddle_tpu_torch.distributed.spawn`` starts each rank in a fresh
process that imports the worker's module, so the workers live here, in a
module that imports neither JAX nor ``paddle_tpu``. Each worker joins
the process group (gloo, two threads per rank), runs every case of its
test file on this rank and returns plain numpy results; the test holds
them against the reference, which runs in the test's own process.
"""
import numpy as np
import torch

from paddle_tpu_torch.distributed import (DataParallel, GradCommConfig,
                                          GradCommunicator, get_rank,
                                          init_parallel_env)
from paddle_tpu_torch.distributed import grad_comm as tgc
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_presets, state_dict_from_numpy)
from paddle_tpu_torch.models.convert import grad_comm_state_for_rank
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import AdamW


def _np(t):
    """A tensor as numpy, a bf16 one as its fp32 values (exact: numpy has
    no bf16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy().copy()


def _join():
    torch.set_num_threads(2)
    env = init_parallel_env()
    assert env.backend == "gloo", env.backend
    return get_rank()


# ------------------------------------------------------------ communicator
def communicator_cases(g, res, n, bs, ref_state):
    """``reduce_bucket`` for every codec and ``reduce_bucket_payload`` for
    the blockwise ones on this rank's row of ``g`` (residual: its row of
    ``res`` for the error-feedback codecs), then ``ref_state`` carried
    into a communicator and read back."""
    rank = _join()
    flat = torch.from_numpy(g[rank])
    residual = torch.from_numpy(res[rank])
    out = {}
    for codec in tgc.CODECS:
        comm = GradCommunicator(GradCommConfig(codec, block_size=bs))
        b = tgc.GradBucket(0, torch.float32)
        b.add(0, (n,))
        r = residual if codec in tgc.EF_CODECS else None
        reduced, nr, wire, ncoll = comm.reduce_bucket(b, flat, 2,
                                                      residual=r)
        case = {"reduced": _np(reduced), "wire": wire, "ncoll": ncoll,
                "residual": None if nr is None else _np(nr)}
        if codec in tgc.BLOCK_CODECS:
            q, sc, nr2, wire2, ncoll2 = comm.reduce_bucket_payload(
                b, flat, 2, residual=r)
            case.update(q_sum=_np(q), scales=_np(sc), wire2=wire2,
                        ncoll2=ncoll2, residual2=_np(nr2))
        out[codec] = case
    comm = GradCommunicator(GradCommConfig("int8_block", block_size=bs))
    comm.load_state_dict(grad_comm_state_for_rank(ref_state, rank, 2))
    out["state"] = comm.state_dict()
    return out


# ------------------------------------------------------------------ models
def mlp(weights):
    """The reference's ``_mlp`` (Linear 8->16, Tanh, Linear 16->1) on the
    reference's weights, in parameter order."""
    net = torch.nn.Sequential(Linear(8, 16, device="cpu"), torch.nn.Tanh(),
                              Linear(16, 1, device="cpu"))
    with torch.no_grad():
        for p, w in zip(net.parameters(), weights):
            p.copy_(torch.from_numpy(np.array(w)))
    return net


def gpt_test(params):
    cfg = gpt_presets("gpt-test")
    m = GPTForCausalLM(cfg, seed=0, device="cpu")
    m.load_state_dict(state_dict_from_numpy(params, cfg))
    return m


def gpt_test_bf16(bits):
    """``gpt-test`` in bf16 on the reference's weights, given as their
    bits (int16 for a bf16 array, fp32 values for the final norm): the
    workers import no bf16 numpy type."""
    m = GPTForCausalLM(gpt_presets("gpt-test", dtype="bfloat16"), seed=0,
                       device="cpu")
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.copy_(torch.from_numpy(bits[name].copy()).view(p.dtype))
    return m


def _mse(out, y):
    return torch.nn.functional.mse_loss(out, y)


def _param_slots(updater):
    """Each parameter's slots, cut out of its bucket's flat slots (the
    scalar slots shared bucket-wide), in parameter order."""
    out = [{} for _ in updater.params]
    for b in updater.buckets:
        for pi, off, n, shape in zip(b.param_indices, b.offsets, b.numels,
                                     b.shapes):
            out[pi] = {k: _np(v if v.dim() == 0 else
                              v[off:off + n].view(shape))
                       for k, v in updater._slots[b.index].items()}
    return out


def _train(model, loss_fn, lr, gc, inputs, labels, steps):
    opt = AdamW(learning_rate=lr, weight_decay=0.01,
                parameters=model.parameters())
    step = TrainStep(model, loss_fn, opt, grad_comm=gc)
    losses = [float(step(inputs=inputs, labels=labels))
              for _ in range(steps)]
    comm = step.grad_comm_communicator
    again = GradCommunicator(comm.config)       # the resume surface
    again.load_state_dict(comm.state_dict())
    return {"losses": losses,
            "state_round_trip": set(again._residuals) == set(
                comm._residuals) and all(
                torch.equal(again._residuals[i], r.cpu())
                for i, r in comm._residuals.items()),
            "params": [_np(p) for p in model.parameters()],
            "dtypes": [str(p.dtype) for p in model.parameters()],
            "slots": _param_slots(step.updater),
            "comm_stats": step.comm_stats,
            "fused": step._gc_fused,
            "table_builds": step.updater.table_builds,
            "residuals": {i: _np(r) for i, r in comm._residuals.items()}}


def dp_train_cases(mlp_w, X, Y, gpt_params, ids, labels):
    """Every world-2 run of ``test_torch_dp_train.py`` on this rank."""
    _join()
    out = {}
    mlp_gc = GradCommConfig("int8_block", comm_buffer_size=0.0002,
                            last_comm_buffer_size=0.0001, block_size=128)
    out["mlp_int8"] = _train(mlp(mlp_w), _mse, 1e-2, mlp_gc, (X,), (Y,), 4)
    fp32 = GradCommConfig("fp32", comm_buffer_size=0.0002,
                          last_comm_buffer_size=0.0001)
    out["mlp_fp32"] = _train(mlp(mlp_w), _mse, 1e-2, fp32, (X,), (Y,), 4)
    out["gpt_int8"] = _train(gpt_test(gpt_params), GPTPretrainingCriterion(),
                             1e-3, GradCommConfig("int8_block"), (ids,),
                             (labels,), 2)
    out["dp"] = {"int8_block": data_parallel_grads(mlp_w, X, Y, MLP_BLOCK, 2),
                 "fp32": data_parallel_grads(mlp_w, X, Y, None, 1)}
    return out


MLP_BLOCK = GradCommConfig("int8_block", comm_buffer_size=0.0002,
                           last_comm_buffer_size=0.0001, block_size=128)


def data_parallel_grads(mlp_w, X, Y, gc, rounds, dtype=torch.float32):
    """``DataParallel.apply_collective_grads`` on the MLP (in ``dtype``)
    with the wire ``gc`` (None: the default fp32 wire) over ``rounds``
    backward passes (each after the first carries the last one's
    error-feedback residual): this rank's local gradients and the
    reduced ones, and the communicator's stats."""
    rank = get_rank()
    xs = torch.from_numpy(X).chunk(2)[rank].to(dtype)
    ys = torch.from_numpy(Y).chunk(2)[rank].to(dtype)
    model = DataParallel(mlp(mlp_w).to(dtype), grad_comm=gc)
    local, reduced = [], []
    for k in range(rounds):
        for p in model.parameters():
            p.grad = None
        loss = model.scale_loss(_mse(model(xs * (1 + k)), ys))
        loss.backward()
        local.append([_np(p.grad) for p in model.parameters()])
        model.apply_collective_grads()
        reduced.append([_np(p.grad) for p in model.parameters()])
    return {"local": local, "reduced": reduced,
            "dtypes": [str(p.grad.dtype) for p in model.parameters()],
            "stats": dict(model.grad_communicator.stats)}


def bf16_dp_cases(gpt_bits, ids, labels, mlp_w, X, Y):
    """Every world-2 run of ``test_torch_bf16_dp.py`` on this rank: bf16
    ``gpt-test`` on the int8_block wire for two steps, with error
    feedback and without, and ``DataParallel`` on the MLP in bf16."""
    _join()
    out = {}
    for name, ef in (("ef", True), ("no_ef", False)):
        out[name] = _train(gpt_test_bf16(gpt_bits),
                           GPTPretrainingCriterion(), 1e-3,
                           GradCommConfig("int8_block", error_feedback=ef),
                           (ids,), (labels,), 2)
    out["dp"] = data_parallel_grads(mlp_w, X, Y, MLP_BLOCK, 2,
                                    torch.bfloat16)
    return out


def clip_dp_case(gpt_params, ids, labels):
    """The world-2 run of ``test_torch_train_options.py`` on this rank:
    fp32 ``gpt-test`` on the int8_block wire with a global-norm clip,
    two SGD steps (the clip turns the fused dequantizing update off)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD

    _join()
    model = gpt_test(gpt_params)
    opt = SGD(learning_rate=0.1, parameters=model.parameters(),
              grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(model, GPTPretrainingCriterion(), opt,
                     grad_comm="int8_block")
    losses = [float(step(inputs=(ids,), labels=(labels,)))
              for _ in range(2)]
    return {"losses": losses, "fused": step._gc_fused,
            "params": [_np(p) for p in model.parameters()]}
