"""Port gradient wire (``paddle_tpu_torch.distributed.grad_comm``: codecs,
``GradCommConfig``, ``GradCommunicator``; ``models/convert.py``'s
communicator state) against the JAX reference
(``paddle_tpu.distributed.grad_comm``) on the CPU.

- ``GradCommConfig``'s validation errors: the reference's, message for
  message.
- Codecs on the same numpy flat buffer: ``block_encode`` carriers (int8
  in int32, fp8 in fp32), ``block_residual``, ``block_decode`` of the
  carrier, ``int8_scale``/``int8_encode``/``int8_decode``/
  ``int8_residual`` and ``encode_bf16``/``decode_bf16``: bit-identical.
  The wrapper in ``ops/codec.py`` on a CPU tensor is the plain version
  and launches nothing.
- ``reduce_bucket`` (every codec, with the error-feedback residual where
  the codec carries one) and ``reduce_bucket_payload`` (blockwise) at
  world 2, each rank with its own gradient: the reference inside a
  2-device ``shard_map``, the port on 2 gloo ranks
  (``tests/torch_dp_workers.py``). Summed payloads, scales, residuals
  and reduced gradients bit-identical; wire bytes and collective counts
  equal.
- ``state_dict`` round trip and the codec and ``block_size`` mismatch
  errors (the reference's messages); ``grad_comm_state_for_rank`` /
  ``grad_comm_state_to_reference`` carry a reference train step's
  ``(world, bucket_size)`` residuals into the port's two ranks and back
  unchanged.
- The not-ported options raise ``NotImplementedError`` naming their
  ROADMAP item (``sync_op=False`` among them), while ``use_reduce_scatter``
  and ``overlap=True`` run (``tests/test_torch_zero.py`` and
  ``tests/test_torch_overlap.py`` hold them against the reference);
  ``DataParallel`` refuses bucket caps given beside a ``GradCommConfig``.

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import paddle_tpu.distributed.mesh as mesh_mod
from paddle_tpu.distributed import grad_comm as jgc
from paddle_tpu_torch.distributed import DataParallel
from paddle_tpu_torch.distributed import collective as tcoll
from paddle_tpu_torch.distributed import grad_comm as tgc
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.models.convert import (grad_comm_state_for_rank,
                                             grad_comm_state_to_reference)
from paddle_tpu_torch.ops import codec as tcodec
from torch_checks import run_checks
import torch_dp_workers as workers

torch.set_num_threads(2)

N, BS = 5000, 96           # a ragged bucket: 53 blocks, the last partial


def _flat(seed, n=N, scale=3.0):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else
                  {2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(_bits(a), _bits(b)), \
        f"{what}: {int((_bits(a) != _bits(b)).sum())} elements differ"


def _t(x):
    """A torch tensor as numpy, bf16 widened to fp32 bits-exactly."""
    if x.dtype == torch.bfloat16:
        return x.to(torch.float32).numpy()
    return x.numpy()


def check_config_validation_matches_reference():
    bad = [dict(codec="fp8"), dict(codec="int4"),
           dict(comm_buffer_size=0), dict(comm_buffer_size="big"),
           dict(last_comm_buffer_size=-1), dict(block_size=0),
           dict(block_size="big"), dict(block_size=1.5)]
    for kw in bad:
        with pytest.raises(ValueError) as ref:
            jgc.GradCommConfig(**kw)
        with pytest.raises(ValueError) as port:
            tgc.GradCommConfig(**kw)
        assert str(port.value) == str(ref.value), kw
    ok = tgc.GradCommConfig("int8_block", 2, 0.5, False, False, 512)
    assert repr(ok) == repr(jgc.GradCommConfig("int8_block", 2, 0.5, False,
                                               False, 512))
    assert tgc.CODECS == jgc.CODECS and tgc.EF_CODECS == jgc.EF_CODECS
    assert tgc._WIRE_ITEMSIZE == jgc._WIRE_ITEMSIZE
    for n, bs in ((N, BS), (1024, 1024), (1, 7)):
        assert tgc.scale_bytes(n, bs) == jgc.scale_bytes(n, bs)


def check_block_carriers_and_residual_match_reference(codec, bs):
    x = _flat(bs)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    js = jgc.block_scales(jgc.block_absmax(jx, bs), codec)
    ts = tgc.block_scales(tgc.block_absmax(tx, bs), codec)
    _same(ts.numpy(), js, "scales")
    jq = jgc.block_encode(jx, js, bs, codec)
    tq = tgc.block_encode(tx, ts, bs, codec, carrier=True)
    _same(tq.numpy(), jq, f"{codec} carrier")
    before = tcodec.launch_counts()
    _same(tcodec.block_encode(tx, ts, bs, codec, carrier=True).numpy(), jq,
          f"{codec} carrier through the wrapper")
    assert tcodec.launch_counts() == before
    # the carrier holds the wire values: narrowing it gives the wire bytes
    wire = tgc.block_encode(tx, ts, bs, codec)
    assert torch.equal(tq.to(wire.dtype).view(torch.uint8),
                       wire.view(torch.uint8))
    _same(tgc.block_residual(tx, tq, ts, N).numpy(),
          jgc.block_residual(jx, jq, js, N), f"{codec} residual")
    qsum = jq + jq                       # a sum of two ranks' payloads
    _same(tgc.block_decode(torch.from_numpy(np.array(qsum)), ts, 2,
                           N).numpy(),
          jgc.block_decode(qsum, js, 2, jnp.float32, N), f"{codec} decode")
    _same(tcodec.block_decode(torch.from_numpy(np.array(qsum)), ts, 2,
                              N).numpy(),
          jgc.block_decode(qsum, js, 2, jnp.float32, N),
          f"{codec} decode through the wrapper")


def check_int8_and_bf16_codecs_match_reference():
    x = _flat(11)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    js, ts = jgc.int8_scale(jx), tgc.int8_scale(tx)
    _same(ts.numpy(), js, "int8 scale")
    jq, tq = jgc.int8_encode(jx, js), tgc.int8_encode(tx, ts)
    _same(tq.numpy(), jq, "int8 payload")
    _same(tgc.int8_residual(tx, tq, ts).numpy(),
          jgc.int8_residual(jx, jq, js), "int8 residual")
    for world in (1, 2, 3):
        _same(tgc.int8_decode(tq * world, ts, world, torch.float32).numpy(),
              jgc.int8_decode(jq * world, js, world, jnp.float32),
              f"int8 decode world {world}")
    jw, tw = jgc.encode_bf16(jx), tgc.encode_bf16(tx)
    _same(_t(tw), np.asarray(jw.astype(jnp.float32)), "bf16 wire")
    _same(tgc.decode_bf16(tw, torch.float32).numpy(),
          jgc.decode_bf16(jw, jnp.float32), "bf16 decode")


_port = {}


def _ref_state():
    rs = np.random.RandomState(5)
    return {"codec": "int8_block", "error_feedback": True, "block_size": BS,
            "bucket_key": (((N,), "float32"),),
            "residuals": {0: (rs.randn(2, N) * 1e-3).astype(np.float32),
                          1: (rs.randn(2, 64) * 1e-3).astype(np.float32)}}


def _world2():
    """The port's world-2 reductions (two gloo ranks, one spawn) and the
    reference's of the same per-rank gradients (a 2-device shard_map)."""
    if _port:
        return _port["port"], _port["ref"]
    rs = np.random.RandomState(1)
    g = (rs.randn(2, N) * 3).astype(np.float32)
    g[1, :BS] *= 40                      # ranks whose block maxima differ
    res = (rs.randn(2, N) * 1e-3).astype(np.float32)
    port = spawn(workers.communicator_cases,
                 args=(g, res, N, BS, _ref_state()), nprocs=2, timeout=180)
    prev = mesh_mod.get_mesh()
    m = mesh_mod.set_mesh(mesh_mod.build_mesh({"data": 2},
                                              devices=jax.devices()[:2]))
    ref = {}
    try:
        for codec in jgc.CODECS:
            comm = jgc.GradCommunicator(jgc.GradCommConfig(codec,
                                                           block_size=BS))
            b = jgc.GradBucket(0, np.dtype(np.float32))
            b.add(0, (N,))
            ef = codec in jgc.EF_CODECS
            blockwise = codec in jgc.BLOCK_CODECS

            def body(x, r, comm=comm, b=b, ef=ef, blockwise=blockwise):
                x, r = x.reshape(N), r.reshape(N)
                red, nr, wire, ncoll = comm.reduce_bucket(
                    b, x, 2, residual=r if ef else None)
                outs = [red, (nr if ef else r * 0).reshape(1, N)]
                if blockwise:
                    q, sc, nr2, _w, _c = comm.reduce_bucket_payload(
                        b, x, 2, residual=r)
                    outs += [q, sc, nr2.reshape(1, N)]
                meta[codec] = (wire, ncoll)
                return tuple(outs)

            meta = {}
            specs = (P(), P("data")) + ((P(), P(), P("data"))
                                        if blockwise else ())
            outs = mesh_mod.compat_shard_map(
                body, m, (P("data"), P("data")), specs)(g, res)
            ref[codec] = ([np.asarray(o) for o in outs], meta[codec])
    finally:
        mesh_mod.set_mesh(prev)
    _port.update(port=port, ref=ref)
    return port, ref


def check_reduce_bucket_matches_reference_at_world_2(codec):
    port, ref = _world2()
    outs, (wire, ncoll) = ref[codec]
    for rank, p in enumerate(port):
        c = p[codec]
        _same(c["reduced"], outs[0], f"{codec} reduced, rank {rank}")
        assert (c["wire"], c["ncoll"]) == (wire, ncoll), codec
        if codec in tgc.EF_CODECS:
            _same(c["residual"], outs[1][rank], f"{codec} residual {rank}")
        else:
            assert c["residual"] is None
        if codec in tgc.BLOCK_CODECS:
            _same(c["q_sum"], outs[2], f"{codec} summed payload")
            _same(c["scales"], outs[3], f"{codec} scales")
            _same(c["residual2"], outs[4][rank], f"{codec} payload residual")
            assert (c["wire2"], c["ncoll2"]) == (wire, ncoll)


def check_state_dict_round_trip_and_guards():
    comm = tgc.GradCommunicator(tgc.GradCommConfig("int8_block",
                                                   block_size=BS))
    p = torch.zeros(N)
    comm.buckets_for([p])
    comm._residuals[0] = torch.from_numpy(_flat(3) * 1e-3)
    state = comm.state_dict()
    ref = jgc.GradCommunicator(jgc.GradCommConfig("int8_block",
                                                  block_size=BS))
    assert set(state) == set(ref.state_dict())
    fresh = tgc.GradCommunicator(tgc.GradCommConfig("int8_block",
                                                    block_size=BS))
    fresh.load_state_dict(state)
    # a restored communicator keeps its residuals through its first plan
    fresh.buckets_for([p])
    assert torch.equal(fresh._residuals[0], comm._residuals[0])
    assert state["bucket_key"] == (((N,), "float32"),)
    for cfg, match in ((dict(codec="fp8_block", block_size=BS),
                        "codec mismatch"),
                       (dict(codec="int8_block", block_size=BS * 2),
                        "block_size mismatch")):
        with pytest.raises(ValueError, match=match) as port_err:
            tgc.GradCommunicator(tgc.GradCommConfig(**cfg)).load_state_dict(
                state)
        with pytest.raises(ValueError) as ref_err:
            jgc.GradCommunicator(jgc.GradCommConfig(**cfg)).load_state_dict(
                state)
        assert str(port_err.value) == str(ref_err.value)


def check_state_carries_to_ranks_and_back():
    port, _ = _world2()
    ref_state = _ref_state()
    back = grad_comm_state_to_reference([p["state"] for p in port])
    assert set(back) == set(ref_state)
    for k in ("codec", "error_feedback", "block_size", "bucket_key"):
        assert back[k] == ref_state[k], k
    for i, r in ref_state["residuals"].items():
        _same(back["residuals"][i], r, f"residual {i}")
        for rank in range(2):
            _same(port[rank]["state"]["residuals"][i], r[rank],
                  f"rank {rank} residual {i}")
    one = grad_comm_state_for_rank(ref_state, 1, 2)
    assert one["residuals"][1].shape == (64,)
    # the reference's communicator takes the carried state as it is
    jcomm = jgc.GradCommunicator(jgc.GradCommConfig("int8_block",
                                                    block_size=BS))
    jcomm.load_state_dict(back)
    for i, r in ref_state["residuals"].items():
        _same(jcomm.state_dict()["residuals"][i], r, f"reference {i}")


def check_not_ported_options_raise():
    comm = tgc.GradCommunicator(tgc.GradCommConfig("int8_block"))
    b = tgc.GradBucket(0, torch.float32)
    b.add(0, (8,))
    # ported since: one process, so the reduce_scatter -> all_gather pair
    # leaves the payload as it is
    reduced, _, wire, ncoll = comm.reduce_bucket(b, torch.ones(8), 2,
                                                 use_reduce_scatter=True)
    assert ncoll == 3 and wire == 2 * 8 + 4
    assert tgc.GradCommConfig("int8_block", overlap=True).overlap
    for name in ("alltoall", "send", "recv", "split", "in_trace_psum"):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A 5"):
            getattr(tcoll, name)(torch.zeros(2))
    for name in ("all_reduce", "broadcast"):
        with pytest.raises(NotImplementedError, match="sync_op=False"):
            getattr(tcoll, name)(torch.zeros(2), sync_op=False)
    # the bucket caps have one source: the config, when one is given
    with pytest.raises(ValueError, match="comm_buffer_size"):
        DataParallel(torch.nn.Linear(2, 2), comm_buffer_size=5,
                     grad_comm=tgc.GradCommConfig("int8_block"))
    dp = DataParallel(torch.nn.Linear(2, 2), grad_comm="int8_block",
                      comm_buffer_size=5)
    assert dp.grad_communicator.config.comm_buffer_size == 5.0
    # one process, no process group: the collectives leave tensors as
    # they are
    t = torch.arange(4.0)
    assert torch.equal(tcoll.all_reduce(t.clone(), tcoll.ReduceOp.AVG), t)


def test_grad_comm_port_matches_reference(fresh_mesh):
    try:
        run_checks(
            [(check_config_validation_matches_reference, ())]
            + [(check_block_carriers_and_residual_match_reference, (c, bs))
               for c in tgc.BLOCK_CODECS for bs in (BS, 1024)]
            + [(check_int8_and_bf16_codecs_match_reference, ())]
            + [(check_reduce_bucket_matches_reference_at_world_2, (c,))
               for c in tgc.CODECS]
            + [(check_state_dict_round_trip_and_guards, ()),
               (check_state_carries_to_ranks_and_back, ()),
               (check_not_ported_options_raise, ())])
    finally:
        _port.clear()
