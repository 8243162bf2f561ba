"""The port's ZeRO path (``paddle_tpu_torch.distributed``: ``reduce_scatter``
/ ``all_gather``, ``GradCommunicator.sync(use_reduce_scatter=True)``,
``traced_reduce_scatter_quantized``, ``FusedFlatUpdater.step_sharded``,
``sharding.Stage3ParamShards``, ``sharding.group_sharded_parallel``,
``sharding.reshard``, ``config_from_strategy``, ``comm_plan``,
``DataParallel(strategy=)``, the env's backend and card rules) against
the JAX reference on the CPU.

- ``reduce_scatter`` and ``all_gather`` on 2 gloo ranks with distinct
  data a rank (``tests/torch_dp_workers.py``, one spawn for the file):
  the sums, the AVG (``div_rn``), the list forms, exactly.
- ``sync(use_reduce_scatter=True)`` for fp32, bf16, int8 and int8_block
  over two rounds of the MLP's gradients (the error-feedback residual
  carried) against the reference's eager ``GradCommunicator.sync``, its
  two ranks emulated by two threads that meet in its ``all_reduce``,
  ``reduce_scatter`` and ``all_gather``: reduced gradients and residuals
  bit for bit, ``stats`` equal.
- ``traced_reduce_scatter_quantized`` (int8_block and fp8_block, a
  ragged length with a residual, a block-aligned one without) against
  the reference's inside a 2-device ``shard_map``: ``full``, ``shard``,
  the residual and the wire bytes bit for bit.
- ``step_sharded`` at stage 2 and stage 3 on ``gpt-test`` (the
  reference's weights, AdamW, 3 steps, int8_block) in one process
  emulating two ranks, as the reference's ``tests/test_zero3.py`` does
  (its ``all_reduce`` replaced on both sides: an integer SUM doubles,
  the rest is the identity): stage 2 against the reference's replicated
  ``os_g`` step, stage 3 against its emulated store. Losses within
  1e-5 relative, parameters and shard slots within the dp rule of
  ``tests/test_torch_dp_train.py`` (rtol 1e-6 / atol 1e-7 on 99.9% of
  the elements, everywhere within ``2 * lr * steps``).
- The port's own stage 3 bit for bit against its replicated ``os_g``
  (losses, parameters, residuals), emulated and on 2 gloo ranks through
  ``group_sharded_parallel`` (int8_block and fp32); the ranks end with
  the same parameters.
- ``Stage3ParamShards`` at rest: every parameter a one-element
  placeholder, ``param_bytes_per_rank`` the shards' bytes, a ``no_grad``
  forward leaves it at rest, ``state_dict``/``load_state_dict`` round
  trip (also from world 4 with ``allow_reshard=True``) and the geometry
  guards' messages; ``save_group_sharded_model`` writes full weights.
- ``reshard``'s functions against the reference's on the same numpy
  states: equal arrays.
- ``config_from_strategy``, ``comm_plan`` and ``DataParallel(strategy=)``
  against the reference's for each codec and toggle.
- ``group_sharded_parallel``: the level check's message, ``offload=True``
  raising, ``os`` and a world-1 ``p_g_os`` leaving the model as it is.
- The env repair: the card is ``LOCAL_RANK`` (``rank % device_count``
  only without it) and nccl is picked when every local rank has a card.

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.distributed.collective as jcoll
import paddle_tpu.distributed.mesh as mesh_mod
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed import grad_comm as jgc
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.parallel import DataParallel as JDataParallel
from paddle_tpu.distributed.sharding import Stage3ParamShards as JStore
from paddle_tpu.distributed.sharding import reshard as jreshard
from paddle_tpu.distributed.sharding import (
    group_sharded_parallel as j_group_sharded_parallel)
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt_presets as jax_presets
from paddle_tpu.optimizer.fused import FusedFlatUpdater as JFused
import paddle_tpu_torch.distributed.collective as tcoll
from paddle_tpu_torch.distributed import DataParallel, env as tenv, spawn
from paddle_tpu_torch.distributed import grad_comm as tgc
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.sharding import (
    Stage3ParamShards, group_sharded_parallel, reshard as treshard,
    save_group_sharded_checkpoint, save_group_sharded_model)
from paddle_tpu_torch.distributed.sharding.stage3 import zero3_gather_report
from paddle_tpu_torch.framework.io import load as tload
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.fused import FusedFlatUpdater
from torch_checks import run_checks
import torch_dp_workers as workers

torch.set_num_threads(2)

X, Y = workers.ZERO_X, workers.ZERO_Y
IDS, LABELS = workers.ZERO_IDS, workers.ZERO_LABELS
MLP_ROUNDS = workers.ZERO_ROUNDS
SHARE = 0.999
LR = 1e-3
COLL_X = [np.arange(12, dtype=np.float32).reshape(4, 3) * (r + 1) + 0.5
          for r in range(2)]


def _traced_cases():
    rs = np.random.RandomState(3)
    out = {}
    for name, n, bs, codec, res in (("ragged", 5001, 96, "int8_block", True),
                                    ("aligned", 4096, 64, "int8_block",
                                     False),
                                    ("fp8", 3000, 64, "fp8_block", True)):
        flats = (rs.standard_normal((2, n)) * 2).astype(np.float32)
        residuals = ((rs.standard_normal((2, n)) * 1e-3).astype(np.float32)
                     if res else None)
        out[name] = (flats, residuals, codec, bs)
    return out


TRACED = _traced_cases()


def _ref_gpt():
    return JaxGPT(jax_presets("gpt-test"), seed=7)


def _gpt_params():
    return {n: np.asarray(p._value) for n, p in _ref_gpt().named_parameters()}


_port = {}


def _port_runs():
    if not _port:
        _port["ranks"] = spawn(workers.zero_cases,
                               args=(COLL_X, MLP_ROUNDS, TRACED,
                                     _gpt_params(), IDS, LABELS),
                               nprocs=2, timeout=300)
    return _port["ranks"]


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(_bits(a.astype(b.dtype)), _bits(b)), \
        f"{what}: {int((_bits(a.astype(b.dtype)) != _bits(b)).sum())} " \
        f"elements differ"


# ------------------------------------------------------------ collectives
def check_collectives_at_world_2():
    r0, r1 = (r["collectives"] for r in _port_runs())
    s = COLL_X[0] + COLL_X[1]
    for r, got in enumerate((r0, r1)):
        _same(got["rs_sum"], s[2 * r:2 * r + 2], "reduce_scatter SUM")
        _same(got["rs_avg"], s[2 * r:2 * r + 2] / np.float32(2),
              "reduce_scatter AVG")
        _same(got["rs_list"], s[2 * r:2 * r + 2], "reduce_scatter list")
        _same(got["ag"], np.stack(COLL_X), "all_gather")
        _same(got["ag_list"], np.stack(COLL_X), "all_gather list")
    # one rank: the reference's eager degradations
    t = torch.arange(6.0).reshape(2, 3)
    assert tcoll.reduce_scatter(t) is t
    assert torch.equal(tcoll.all_gather(None, t), t)
    with pytest.raises(ValueError, match="SUM/AVG"):
        tcoll.reduce_scatter(t, op=tcoll.ReduceOp.MAX)


# ------------------------------------------------ reduce_scatter sync
def _ref_threads(fn, args_per_rank):
    """``fn(rank, *args)`` on two threads that meet in the reference's
    ``all_reduce``, ``reduce_scatter`` and ``all_gather`` (patched);
    returns each rank's result."""
    barrier = threading.Barrier(2)
    seen = [None, None]
    tls = threading.local()

    def meet(v):
        seen[tls.rank] = v
        barrier.wait()
        a, b = seen
        barrier.wait()
        return a, b

    def all_reduce(t, op=jcoll.ReduceOp.SUM, group=None, **kw):
        a, b = meet(t._value)
        if op == jcoll.ReduceOp.MAX:
            t._value = jnp.maximum(a, b)
        elif op == jcoll.ReduceOp.AVG:
            t._value = (a + b) / 2
        else:
            t._value = a + b
        return t

    def reduce_scatter(t, tensor_list=None, op=jcoll.ReduceOp.SUM,
                       group=None, **kw):
        a, b = meet(t._value)
        s = a + b
        if op == jcoll.ReduceOp.AVG:
            s = s / 2
        c = s.shape[0] // 2
        return Tensor(s[tls.rank * c:(tls.rank + 1) * c], _internal=True)

    def all_gather(tensor_list, t, group=None, **kw):
        a, b = meet(t._value)
        return Tensor(jnp.stack([a, b]), _internal=True)

    out, errors = [None, None], []

    def rank_main(r):
        try:
            tls.rank = r
            out[r] = fn(r, *args_per_rank[r])
        except BaseException as e:   # surfaced below
            errors.append(e)
            barrier.abort()

    saved = jcoll.all_reduce, jcoll.reduce_scatter, jcoll.all_gather
    jcoll.all_reduce, jcoll.reduce_scatter, jcoll.all_gather = \
        all_reduce, reduce_scatter, all_gather
    try:
        threads = [threading.Thread(target=rank_main, args=(r,))
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        jcoll.all_reduce, jcoll.reduce_scatter, jcoll.all_gather = saved
    if errors:
        raise errors[0]
    return out


def _ref_config(codec):
    return jgc.GradCommConfig(codec, comm_buffer_size=0.0002,
                              last_comm_buffer_size=0.0001,
                              block_size=workers.ZERO_MLP_BLOCK)


def _ref_rs_rounds(rank, codec, rounds):
    comm = jgc.GradCommunicator(_ref_config(codec))
    reduced = []
    for grads in rounds:
        params = []
        for g in grads:
            p = Tensor(np.zeros(g.shape, np.float32))
            p.stop_gradient = False
            p.grad = Tensor(g)
            params.append(p)
        comm.sync(params, world=2, use_reduce_scatter=True)
        reduced.append([np.asarray(p.grad._value) for p in params])
    return {"reduced": reduced, "stats": dict(comm.stats),
            "residuals": {i: np.asarray(r)
                          for i, r in comm._residuals.items()}}


def check_rs_sync_matches_reference(codec):
    ranks = _port_runs()
    ref = _ref_threads(_ref_rs_rounds, [(codec, MLP_ROUNDS[r])
                                        for r in range(2)])
    for r in range(2):
        port = ranks[r]["rs_sync"][codec]
        for k, (pr, rr) in enumerate(zip(port["reduced"],
                                         ref[r]["reduced"])):
            for i, (a, b) in enumerate(zip(pr, rr)):
                _same(a, b, f"{codec} rank {r} round {k} grad {i}")
        assert port["stats"] == ref[r]["stats"], (port["stats"],
                                                  ref[r]["stats"])
        assert sorted(port["residuals"]) == sorted(ref[r]["residuals"])
        for i, res in ref[r]["residuals"].items():
            _same(port["residuals"][i], res, f"{codec} residual {i}")
    if codec in ("int8", "int8_block"):
        assert ranks[0]["rs_sync"][codec]["residuals"]


# -------------------------------------------- quantized reduce_scatter
def _ref_traced(flats, residuals, codec, bs):
    cfg = jgc.GradCommConfig(codec, block_size=bs)
    mesh = mesh_mod.build_mesh({"data": 2}, devices=jax.devices()[:2])
    info = {}

    def body(x, *r):
        full, shard, res, wire, ncoll = jgc.traced_reduce_scatter_quantized(
            x[0], "data", 2, cfg, residual=r[0][0] if r else None)
        info.update(wire=wire, ncoll=ncoll)
        return full[None], shard[None], res[None]

    args = (jnp.asarray(flats),) + (
        () if residuals is None else (jnp.asarray(residuals),))
    f = mesh_mod.compat_shard_map(body, mesh, (P("data"),) * len(args),
                                  (P("data"),) * 3)
    full, shard, res = f(*args)
    return np.asarray(full), np.asarray(shard), np.asarray(res), info


def check_traced_reduce_scatter_quantized_matches_reference(name):
    flats, residuals, codec, bs = TRACED[name]
    full, shard, res, info = _ref_traced(flats, residuals, codec, bs)
    for r, rank in enumerate(_port_runs()):
        got = rank["traced"][name]
        _same(got["full"], full[r], f"{name} rank {r} full")
        _same(got["shard"], shard[r], f"{name} rank {r} shard")
        _same(got["residual"], res[r], f"{name} rank {r} residual")
        assert (got["wire"], got["ncoll"]) == (info["wire"], info["ncoll"])


# ------------------------------------------------------- step_sharded
def _two_rank_fake(integer):
    """The reference's emulated ``all_reduce`` (``tests/test_zero3.py``):
    an integer SUM doubles, everything else is the identity."""
    def fake(t, op=None, group=None, **kw):
        if integer(t) and op in (jcoll.ReduceOp.SUM, tcoll.ReduceOp.SUM):
            if isinstance(t, Tensor):
                t._value = t._value * 2
            else:
                t.mul_(2)
        return t
    return fake


def _ref_train(stage3, codec, steps=3):
    paddle.seed(1234)
    m = _ref_gpt()
    crit = JaxCriterion()
    o = jopt.AdamW(learning_rate=LR, parameters=m.parameters())
    comm = jgc.GradCommunicator(jgc.GradCommConfig(
        codec, comm_buffer_size=0.05, last_comm_buffer_size=0.01,
        block_size=64))
    params = [p for p in m.parameters() if not p.stop_gradient]
    fused = JFused(o, params, communicator=comm)
    store = None
    if stage3:
        store = JStore(params, comm, rank=0, world=2)
        store.shard_()
        store.install_hooks(m)
    losses = []
    for _ in range(steps):
        loss = crit(m(paddle.to_tensor(IDS[:2], dtype="int64")),
                    paddle.to_tensor(LABELS[:2], dtype="int64"))
        loss.backward()
        comm.sync(params, world=2, use_reduce_scatter=True)
        if stage3:
            fused.step_sharded(rank=0, world=2, param_store=store)
        else:
            fused.step()
        o.clear_grad()
        losses.append(float(loss.numpy()))
    if stage3:
        with store.materialize():
            ps = [np.asarray(p._value).copy() for p in m.parameters()]
        slots = fused._shard_slots
    else:
        ps = [np.asarray(p._value).copy() for p in m.parameters()]
        slots = {b.index: {k: (v if np.shape(v) == () else
                               np.asarray(v)[:-(-b.size // 2)])
                           for k, v in fused._slots[b.index].items()}
                 for b in fused.buckets}
    return {"losses": losses, "params": ps,
            "slots": {i: {k: np.asarray(v) for k, v in s.items()}
                      for i, s in slots.items()},
            "residuals": {i: np.asarray(r)
                          for i, r in comm._residuals.items()}}


def _port_train(stage, codec, steps=3):
    m = workers.gpt_test(_gpt_params())
    o = AdamW(learning_rate=LR, parameters=m.parameters())
    comm = tgc.GradCommunicator(tgc.GradCommConfig(
        codec, comm_buffer_size=0.05, last_comm_buffer_size=0.01,
        block_size=64))
    params = [p for p in m.parameters() if p.requires_grad]
    fused = FusedFlatUpdater(o, params, communicator=comm)
    store = None
    if stage == 3:
        store = Stage3ParamShards(params, comm, rank=0, world=2)
        store.shard_()
        store.install_hooks(m)
        store.register_external_use(m, m.gpt.embeddings.word_embeddings)
    crit = GPTPretrainingCriterion()
    x, y = torch.from_numpy(IDS[:2]), torch.from_numpy(LABELS[:2])
    losses = []
    for _ in range(steps):
        fused.zero_grad()
        loss = crit(m(x), y)
        loss.backward()
        comm.sync(params, world=2, use_reduce_scatter=True)
        if stage == 1:
            fused.step()
        else:
            fused.step_sharded(0, 2, param_store=store)
        losses.append(float(loss.detach()))
    if store is not None:
        assert store.resident_buckets() == []
        with store.materialize():
            ps = [p.detach().numpy().copy() for p in m.parameters()]
    else:
        ps = [p.detach().numpy().copy() for p in m.parameters()]
    return {"losses": losses, "params": ps, "builds": fused.table_builds,
            "slots": {i: {k: v.numpy().copy() for k, v in s.items()}
                      for i, s in fused._shard_slots.items()},
            "residuals": {i: r.numpy().copy()
                          for i, r in comm._residuals.items()},
            "store": store}


def _held(port, ref, what):
    """Losses within 1e-5 relative; parameters and shard slots within the
    dp rule (module docstring)."""
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5,
                               err_msg=f"{what} losses")
    arrays = list(zip(port["params"], ref["params"]))
    assert sorted(port["slots"]) == sorted(ref["slots"]), what
    for i, rs in ref["slots"].items():
        assert set(port["slots"][i]) == set(rs), (what, i)
        arrays += [(port["slots"][i][k], rs[k]) for k in rs]
    close = total = 0
    for a, b in arrays:
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, (what, a.shape, b.shape)
        ok = np.abs(a - b) <= 1e-7 + 1e-6 * np.abs(b)
        close += int(ok.sum())
        total += ok.size
        worst = float(np.abs(a - b).max()) if a.size else 0.0
        assert worst <= 2 * LR * 3, f"{what}: max abs diff {worst}"
    assert close / total >= SHARE, f"{what}: {close / total:.5f} close"


def _emulated(fn):
    saved = jcoll.all_reduce, tcoll.all_reduce
    jcoll.all_reduce = _two_rank_fake(
        lambda t: jnp.issubdtype(t._value.dtype, jnp.integer))
    tcoll.all_reduce = _two_rank_fake(lambda t: not t.is_floating_point())
    try:
        return fn()
    finally:
        jcoll.all_reduce, tcoll.all_reduce = saved


def check_step_sharded_matches_reference(stage):
    def run():
        ref = _ref_train(stage == 3, "int8_block")
        port = _port_train(stage, "int8_block")
        return ref, port

    ref, port = _emulated(run)
    _held(port, ref, f"stage {stage}")
    assert port["builds"] == 1
    assert sorted(port["residuals"]) == sorted(ref["residuals"])


def check_stage3_bit_identical_to_replicated(codec):
    rep, z2, z3 = _emulated(lambda: [_port_train(s, codec)
                                     for s in (1, 2, 3)])
    for run, what in ((z2, "stage 2"), (z3, "stage 3")):
        assert run["losses"] == rep["losses"], (codec, what)
        for a, b in zip(run["params"], rep["params"]):
            _same(a, b, f"{codec} {what} params")
        for i, r in rep["residuals"].items():
            _same(run["residuals"][i], r, f"{codec} {what} residual")
    assert z3["store"].gathers["prefetched"] > 0


def check_ranks_stage3_equals_stage2(codec):
    r0, r1 = _port_runs()
    for rank in (r0, r1):
        z2, z3 = rank[("os_g", codec)], rank[("p_g_os", codec)]
        assert z3["losses"] == z2["losses"], (codec, z2["losses"],
                                              z3["losses"])
        for a, b in zip(z3["params"], z2["params"]):
            _same(a, b, f"{codec} stage 3 against stage 2")
        assert z3["resident"] == [] and z3["table_builds"] == 1
        assert z3["gathers"].get("prefetched", 0) > 0
        assert not z3["gathers"].get("fallback")
    for level in ("os_g", "p_g_os"):
        for a, b in zip(r0[(level, codec)]["params"],
                        r1[(level, codec)]["params"]):
            _same(a, b, f"{level} {codec} ranks")
    full = sum(p.size * 4 for p in r0[("os_g", codec)]["params"])
    at_rest = r0[("p_g_os", codec)]["at_rest"]
    assert full / 2 <= at_rest <= full / 2 + 4 * 64, (full, at_rest)


# ---------------------------------------------------- the at-rest store
_mlp = workers.seeded_mlp


def _store(net, world=2, rank=0):
    params = [p for p in net.parameters() if p.requires_grad]
    comm = tgc.GradCommunicator(workers._zero_config("fp32"))
    return Stage3ParamShards(params, comm, rank=rank, world=world)


def check_stage3_at_rest_and_state_dict(tmp):
    net = _mlp()
    want = [p.detach().clone() for p in net.parameters()]
    store = _store(net)
    store.shard_()
    store.install_hooks(net)
    for p in net.parameters():
        assert p.untyped_storage().nbytes() == p.element_size(), p.shape
        assert all(s == 0 for s in p.stride())
    chunks = sum(-(-b.size // 2) * 4 for b in store.buckets)
    assert store.param_bytes_per_rank() == chunks
    assert len(store.buckets) >= 3
    with torch.no_grad():
        out = net(torch.from_numpy(X))
    assert torch.isfinite(out).all() and store.resident_buckets() == []
    state = store.state_dict()
    assert set(state["shards"]) == {b.index for b in store.buckets}
    net2 = _mlp(seed=55)
    store2 = _store(net2)
    store2.shard_()
    store2.load_state_dict(state)
    with store2.materialize():
        for w, p in zip(want, net2.parameters()):
            assert torch.equal(w, p)
    assert store2.resident_buckets() == []
    with pytest.raises(ValueError, match="world mismatch"):
        store2.load_state_dict({**state, "world": 4})
    meta = store2.meta_state()
    store2.check_meta(meta)
    with pytest.raises(ValueError, match="geometry mismatch"):
        store2.check_meta({**meta, "world": 8})
    # a world-4 snapshot resharded into a world-2 store, from rank 1
    net4 = _mlp()
    store4 = _store(net4, world=4)
    store4.shard_()
    net5 = _mlp(seed=77)
    store5 = _store(net5, world=2, rank=1)
    store5.shard_()
    store5.load_state_dict(store4.state_dict(), allow_reshard=True)
    with store5.materialize():
        for w, p in zip(want, net5.parameters()):
            assert torch.equal(w, p)
    # the full weights written, the store back at rest
    net._zero3 = store
    save_group_sharded_model(net, str(tmp))
    assert store.resident_buckets() == []
    fresh = _mlp(seed=99)
    saved = tload(str(tmp / "model.pdparams"))
    fresh.load_state_dict({k: torch.as_tensor(v) if isinstance(
        v, np.ndarray) else v for k, v in saved.items()})
    for w, p in zip(want, fresh.parameters()):
        assert torch.equal(w, p)
    with pytest.raises(ValueError, match="world > 1"):
        _store(_mlp(), world=1)
    rep = zero3_gather_report(list(_mlp().parameters()),
                              workers._zero_config("fp32"), world=2,
                              compute_s=0.01)
    assert rep["n_buckets"] >= 3 and len(rep["per_bucket"]) == \
        rep["n_buckets"]
    assert rep["zero3_param_bytes_per_rank"] <= \
        rep["param_bytes_full"] / 2 + 4 * rep["n_buckets"]


# --------------------------------------------------------------- reshard
def _states(world, seed):
    rs = np.random.RandomState(seed)
    sizes = {0: 37, 1: 64, 2: 5}
    full = {i: rs.standard_normal(n).astype(np.float32)
            for i, n in sizes.items()}
    chunks = {i: jreshard.rechunk_flat(f, sizes[i], world)
              for i, f in full.items()}
    z3 = [{"bucket_key": None, "rank": r, "world": world,
           "bucket_sizes": sizes,
           "shards": {i: chunks[i][r] for i in sizes}}
          for r in range(world)]
    emulated = [{**z3[0], "peer_shards": {
        i: {r: chunks[i][r] for r in range(1, world)} for i in sizes}}]
    slots = [{"own": {i: {"moment1": chunks[i][r] * 2, "beta1_pow": 0.9}
                      for i in sizes}, "peer": {}, "bucket_sizes": sizes}
             for r in range(world)]
    res = [{i: rs.standard_normal(n).astype(np.float32)
            for i, n in sizes.items()} for _ in range(world)]
    return z3, emulated, slots, res


def _equal_tree(a, b, what):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (what, a, b)
        for k in a:
            _equal_tree(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_tree(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        _same(a, b, what)
    else:
        assert a == b, (what, a, b)


def check_reshard_matches_reference():
    z3, emulated, slots, res = _states(4, 5)
    for name, args in (("chunk_of", (37, 4)),
                       ("rechunk_flat", (np.arange(37.0), 37, 3)),
                       ("assemble_full_buckets", (z3,)),
                       ("assemble_full_buckets", (emulated,)),
                       ("reshard_zero3_states", (z3, 2)),
                       ("reshard_zero3_states", (emulated, 3)),
                       ("reshard_slot_states", (slots, 2)),
                       ("reshard_residual_maps", (res, 2)),
                       ("reshard_residual_maps", ([res[0]], 1))):
        _equal_tree(getattr(treshard, name)(*args),
                    getattr(jreshard, name)(*args), name)
    payloads = [{"zero3": z, "fused_shard_slots": s,
                 "job_state": {"rank": r, "grad_comm": {"residuals": m}}}
                for r, (z, s, m) in enumerate(zip(z3, slots, res))]
    _equal_tree(treshard.reshard_payloads(payloads, 2),
                jreshard.reshard_payloads(payloads, 2), "payloads")
    rep = treshard.reshard_report(list(_mlp().parameters()),
                                  workers._zero_config("fp32"))
    assert rep["bit_identical"] and rep["from_world"] == 4


# ------------------------------------------ strategy, plan, DataParallel
def _strategies(cls):
    out = {"none": None}
    s = cls()
    s.fp16_allreduce = True
    out["fp16_allreduce"] = s
    for codec in jgc.CODECS:
        for overlap in (False, True):
            s = cls()
            s.grad_comm = True
            s.grad_comm_configs = {"codec": codec, "overlap": overlap,
                                   "comm_buffer_size_MB": 0.5,
                                   "last_comm_buffer_size_MB": 0.25,
                                   "error_feedback": codec != "int8",
                                   "block_size": 128}
            out[f"{codec} overlap={overlap}"] = s
    return out


def _ref_mlp():
    paddle.seed(7)
    return jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 1))


def check_strategy_plan_and_data_parallel_match_reference():
    ours, theirs = _strategies(DistributedStrategy), _strategies(JStrategy)
    assert DistributedStrategy().to_dict() == JStrategy().to_dict()
    with pytest.raises(ValueError) as pe:
        DistributedStrategy().no_such_field = 1
    with pytest.raises(ValueError) as re_:
        JStrategy().no_such_field = 1
    assert str(pe.value) == str(re_.value)
    jnet = _ref_mlp()
    tnet = workers.mlp([np.asarray(p._value) for p in jnet.parameters()])
    for name in ours:
        cfg = tgc.config_from_strategy(ours[name], 3, 0.5)
        ref = jgc.config_from_strategy(theirs[name], 3, 0.5)
        assert repr(cfg) == repr(ref), name
        plan = tgc.comm_plan(tnet.parameters(), cfg, world=2)
        assert plan == jgc.comm_plan(jnet.parameters(), ref, world=2), name
        dp = DataParallel(tnet, strategy=ours[name])
        jdp = JDataParallel(jnet, strategy=theirs[name])
        got, want = dp.grad_communicator, jdp._grad_communicator()
        assert repr(got.config) == repr(want.config), name
        assert type(got).__name__ == type(want).__name__, name
    # a toggle changed on the strategy rebuilds the communicator
    s = DistributedStrategy()
    dp = DataParallel(tnet, strategy=s)
    first = dp.grad_communicator
    assert first.config.codec == "fp32"
    s.fp16_allreduce = True
    assert dp.grad_communicator is not first
    assert dp.grad_communicator.config.codec == "bf16"
    with pytest.raises(ValueError, match="not both"):
        DataParallel(tnet, strategy=s, grad_comm="fp32")


def check_group_sharded_parallel_levels():
    net = _mlp()
    opt = AdamW(learning_rate=0.01, parameters=net.parameters())
    jnet = _ref_mlp()
    jo = jopt.Adam(learning_rate=0.01, parameters=jnet.parameters())
    with pytest.raises(ValueError) as pe:
        group_sharded_parallel(net, opt, "stage2")
    with pytest.raises(ValueError) as re_:
        j_group_sharded_parallel(jnet, jo, "stage2")
    assert str(pe.value) == str(re_.value)
    with pytest.raises(NotImplementedError, match="offload"):
        group_sharded_parallel(net, opt, "os", offload=True)
    with pytest.raises(NotImplementedError, match="offload"):
        j_group_sharded_parallel(jnet, jo, "os", offload=True)
    m, o, sc = group_sharded_parallel(net, opt, "os")
    assert m is net and o is opt and sc is None
    assert not hasattr(m, "_grad_comm")
    before = [p.detach().clone() for p in net.parameters()]
    m, o, _ = group_sharded_parallel(net, opt, "p_g_os", fuse_update=True)
    assert getattr(m, "_zero3", None) is None       # world 1: unsharded
    assert m._grad_comm.config.codec == "bf16"      # the reference's wire
    assert isinstance(m._fused_update, FusedFlatUpdater)
    for a, b in zip(before, net.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="item 14"):
        save_group_sharded_checkpoint(net, "unused", 0)


# ------------------------------------------------------------- env repair
def check_env_picks_card_by_local_rank(monkeypatch):
    for k in ("LOCAL_RANK", "PADDLE_LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "PADDLE_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "16")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "13")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    # no local rank: one host of 16 ranks on 8 cards, rank % count
    assert tenv.device_index() == 5
    assert tenv.default_backend() == "gloo"
    # two hosts of 8: every local rank has a card
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert tenv.default_backend() == "nccl"
    assert tenv.device_index() == 2 and tenv.get_local_rank() == 2
    assert tenv.ParallelEnv().local_rank == 2
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.setenv("PADDLE_LOCAL_RANK", "3")
    assert tenv.device_index() == 3
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "9")
    assert tenv.default_backend() == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert tenv.default_backend() == "gloo"


def test_zero_port_matches_reference(fresh_mesh, monkeypatch, tmp_path):
    try:
        run_checks(
            [(check_collectives_at_world_2, ())]
            + [(check_rs_sync_matches_reference, (c,))
               for c in ("fp32", "bf16", "int8", "int8_block")]
            + [(check_traced_reduce_scatter_quantized_matches_reference,
                (n,)) for n in TRACED]
            + [(check_step_sharded_matches_reference, (s,)) for s in (2, 3)]
            + [(check_stage3_bit_identical_to_replicated, (c,))
               for c in ("int8_block", "fp32")]
            + [(check_ranks_stage3_equals_stage2, (c,))
               for c in ("int8_block", "fp32")]
            + [(check_stage3_at_rest_and_state_dict, (tmp_path,)),
               (check_reshard_matches_reference, ()),
               (check_strategy_plan_and_data_parallel_match_reference, ()),
               (check_group_sharded_parallel_levels, ()),
               (check_env_picks_card_by_local_rank, (monkeypatch,))])
    finally:
        _port.clear()
