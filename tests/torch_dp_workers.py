"""Rank workers for the port's data-parallel tests on the CPU
(``tests/test_torch_grad_comm.py``, ``tests/test_torch_dp_train.py``,
``tests/test_torch_bf16_dp.py``, ``tests/test_torch_fp16_wire.py``,
``tests/test_torch_train_options.py``).

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
    """A tensor as numpy, a 16-bit one as its fp32 values (exact: numpy
    has no bf16)."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
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


def gpt_test_bf16(bits, dtype="bfloat16"):
    """``gpt-test`` in bf16 (or ``dtype``, fp16) on the reference's
    weights, given as their bits (int16 for a 16-bit array, fp32 values
    for the final norm): the workers import no bf16 numpy type."""
    m = GPTForCausalLM(gpt_presets("gpt-test", dtype=dtype), seed=0,
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


def fp16_dp_cases(gpt_bits, ids, labels):
    """Every world-2 run of ``test_torch_fp16_wire.py`` on this rank: fp16
    ``gpt-test`` on the int8_block wire for two steps, with error
    feedback and without."""
    _join()
    return {name: _train(gpt_test_bf16(gpt_bits, "float16"),
                         GPTPretrainingCriterion(), 1e-3,
                         GradCommConfig("int8_block", error_feedback=ef),
                         (ids,), (labels,), 2)
            for name, ef in (("ef", True), ("no_ef", False))}


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


# ------------------------------------------------------------------ ZeRO
ZERO_MLP_BLOCK = 16        # block size of the MLP's blockwise wire
MLP_SHAPES = [(8, 16), (16,), (16, 1), (1,)]
_rng = np.random.RandomState(0)
ZERO_X = _rng.standard_normal((16, 8)).astype(np.float32)
ZERO_Y = _rng.standard_normal((16, 1)).astype(np.float32)
_ids_rs = np.random.RandomState(0)
ZERO_IDS = _ids_rs.randint(0, 256, (4, 16)).astype(np.int64)
ZERO_LABELS = _ids_rs.randint(0, 256, (4, 16)).astype(np.int64)


def mlp_rounds(seed):
    """Two rounds of MLP-shaped gradients of one rank."""
    rs = np.random.RandomState(seed)
    return [[(rs.standard_normal(s) * 0.1).astype(np.float32)
             for s in MLP_SHAPES] for _ in range(2)]


ZERO_ROUNDS = [mlp_rounds(11), mlp_rounds(12)]


def seeded_mlp(seed=3):
    """The MLP on weights drawn from ``seed``."""
    rs = np.random.RandomState(seed)
    return mlp([rs.standard_normal(s).astype(np.float32)
                for s in MLP_SHAPES])


def _zero_config(codec, **caps):
    caps = caps or dict(comm_buffer_size=0.0002, last_comm_buffer_size=0.0001)
    return GradCommConfig(codec, block_size=ZERO_MLP_BLOCK, **caps)


def _collective_cases(x):
    """``reduce_scatter`` (tensor form SUM and AVG, list form) and
    ``all_gather`` (stacked and into a list) of this rank's ``x``."""
    from paddle_tpu_torch.distributed import collective as coll

    t = torch.from_numpy(x)
    half = t.shape[0] // 2
    out = {"rs_sum": coll.reduce_scatter(t.clone()),
           "rs_avg": coll.reduce_scatter(t.clone(), op=coll.ReduceOp.AVG),
           "rs_list": coll.reduce_scatter(torch.empty_like(t[:half]),
                                          [t[:half], t[half:]]),
           "ag": coll.all_gather(None, t),
           "ag_list": torch.stack(coll.all_gather([], t))}
    return {k: _np(v) for k, v in out.items()}


def rs_sync_rounds(codec, rounds_grads, world=2, overlap=False):
    """``GradCommunicator.sync(use_reduce_scatter=True)`` (or, with
    ``overlap``, the overlapped communicator's flush after the grad-ready
    hooks fire) over this rank's gradient lists, one sync a round, the
    error-feedback residual carried: the reduced gradients of each
    round, the last stats and the residuals."""
    from paddle_tpu_torch.distributed.overlap import communicator_for

    cfg = _zero_config(codec)
    if overlap:
        cfg = GradCommConfig(cfg.codec, cfg.comm_buffer_size,
                             cfg.last_comm_buffer_size, overlap=True,
                             block_size=cfg.block_size)
    comm = communicator_for(cfg)
    reduced = []
    for grads in rounds_grads:
        params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
        if overlap:
            comm.prepare(params, world=world, use_reduce_scatter=True)
        for p, g in zip(reversed(params), reversed(grads)):
            p.grad = torch.from_numpy(g.copy())
            if overlap:
                comm._on_grad_ready(p)
        comm.sync(params, world=world, use_reduce_scatter=True)
        reduced.append([_np(p.grad) for p in params])
    return {"reduced": reduced, "stats": dict(comm.stats),
            "residuals": {i: _np(r) for i, r in comm._residuals.items()}}


def _traced_cases(cases, rank):
    """``traced_reduce_scatter_quantized`` on this rank's row of each
    case's flats (and residuals)."""
    out = {}
    for name, (flats, residuals, codec, bs) in cases.items():
        r = None if residuals is None else torch.from_numpy(residuals[rank])
        full, shard, res, wire, ncoll = tgc.traced_reduce_scatter_quantized(
            torch.from_numpy(flats[rank]), None, 2,
            GradCommConfig(codec, block_size=bs), residual=r)
        out[name] = {"full": _np(full), "shard": _np(shard),
                     "residual": None if res is None else _np(res),
                     "wire": wire, "ncoll": ncoll}
    return out


def zero_gpt(gpt_params, ids, labels, level, codec, steps=3,
             overlap=False):
    """``gpt-test`` through ``group_sharded_parallel(level,
    fuse_update=True)`` on ``codec`` (test-size caps: several buckets),
    this rank's half of the batch, AdamW: each step forward, backward,
    the reduce_scatter sync and ``step_sharded``. Returns the losses, the
    full parameters, this rank's shard slots, the residuals and the
    stage-3 store's gather counts and at-rest bytes."""
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel

    rank = get_rank()
    model = gpt_test(gpt_params)
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                parameters=model.parameters())
    cfg = GradCommConfig(codec, comm_buffer_size=0.05,
                         last_comm_buffer_size=0.01, block_size=64)
    model, opt, _ = group_sharded_parallel(model, opt, level,
                                           overlap_comm=overlap,
                                           fuse_update=True, grad_comm=cfg)
    store = getattr(model, "_zero3", None)
    if store is not None:
        store.register_external_use(model,
                                    model.gpt.embeddings.word_embeddings)
    fused, comm = model._fused_update, model._grad_comm
    params = fused.params
    b = ids.shape[0] // 2
    x = torch.from_numpy(ids[rank * b:(rank + 1) * b])
    y = torch.from_numpy(labels[rank * b:(rank + 1) * b])
    crit = GPTPretrainingCriterion()
    losses = []
    for _ in range(steps):
        fused.zero_grad()
        if overlap:
            comm.prepare(params, world=2, use_reduce_scatter=True)
        loss = crit(model(x), y)
        loss.backward()
        comm.sync(params, world=2, use_reduce_scatter=True)
        fused.step_sharded(rank, 2, param_store=store)
        losses.append(float(loss.detach()))
    out = {"losses": losses,
           "slots": {i: {k: _np(v) for k, v in s.items()}
                     for i, s in fused._shard_slots.items()},
           "residuals": {i: _np(r) for i, r in comm._residuals.items()},
           "table_builds": fused.table_builds}
    if store is not None:
        out.update(gathers=dict(store.gathers),
                   at_rest=store.param_bytes_per_rank(),
                   resident=store.resident_buckets())
        with store.materialize():
            out["params"] = [_np(p) for p in model.parameters()]
    else:
        out["params"] = [_np(p) for p in model.parameters()]
    return out


def zero_cases(coll_x, mlp_rounds, traced, gpt_params, ids, labels):
    """Every world-2 run of ``test_torch_zero.py`` on this rank."""
    rank = _join()
    out = {"collectives": _collective_cases(coll_x[rank]),
           "rs_sync": {c: rs_sync_rounds(c, mlp_rounds[rank])
                       for c in ("fp32", "bf16", "int8", "int8_block")},
           "traced": _traced_cases(traced, rank)}
    for level in ("os_g", "p_g_os"):
        for codec in ("int8_block", "fp32"):
            out[(level, codec)] = zero_gpt(gpt_params, ids, labels, level,
                                           codec)
    return out


def overlap_cases(mlp_rounds, gpt_params, ids, labels):
    """Every world-2 run of ``test_torch_overlap.py`` on this rank: the
    MLP's gradient rounds through the serial and the overlapped
    reduce_scatter sync and all-reduce sync, and ``gpt-test`` through
    ``DataParallel`` on a strategy's wire with overlap on and off."""
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy

    rank = _join()
    out = {}
    for codec in ("fp32", "int8_block"):
        for ov in (False, True):
            out[("rs", codec, ov)] = rs_sync_rounds(codec, mlp_rounds[rank],
                                                    overlap=ov)
    b = ids.shape[0] // 2
    x = torch.from_numpy(ids[rank * b:(rank + 1) * b])
    y = torch.from_numpy(labels[rank * b:(rank + 1) * b])
    for codec in ("fp32", "int8_block"):
        for ov in (False, True):
            st = DistributedStrategy()
            st.grad_comm = True
            st.grad_comm_configs = {"codec": codec, "overlap": ov,
                                    "comm_buffer_size_MB": 0.05,
                                    "last_comm_buffer_size_MB": 0.01,
                                    "block_size": 64}
            model = DataParallel(gpt_test(gpt_params), strategy=st)
            rounds = []
            for k in range(2):
                for p in model.parameters():
                    p.grad = None
                loss = GPTPretrainingCriterion()(model(x), y)
                loss.backward()
                model.apply_collective_grads()
                rounds.append([_np(p.grad) for p in model.parameters()])
            comm = model.grad_communicator
            out[("dp", codec, ov)] = {
                "rounds": rounds, "type": type(comm).__name__,
                "stats": {k: v for k, v in comm.stats.items()
                          if not k.endswith("_s") and k not in (
                              "overlapped", "overlap_efficiency",
                              "buckets_launched_early")},
                "early": comm.stats.get("buckets_launched_early"),
                "residuals": {i: _np(r)
                              for i, r in comm._residuals.items()}}
    return out
