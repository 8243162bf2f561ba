"""Port Wide&Deep on the parameter server (``paddle_tpu_torch``: the host
sparse table ``core``, ``distributed.ps`` (``LocalPs``, ``DenseTable``,
``TheOnePSRuntime``, the communicators, ``distributed_lookup_table``,
``DevicePassCache``, ``heter_embedding``, ``CompiledPassStep``),
``metric``, the BCE losses and ``sigmoid``, ``models.wide_deep``)
against the JAX reference on the CPU, on the same numpy inputs.

Cases and tolerances (the measured value beside each):

- Host table, bit for bit: fresh pulls of SGD, Adagrad and Momentum
  tables (the port builds its own copy of the reference's C++ source),
  push sequences with duplicate keys and both learning rates,
  ``assign``, ``add``, ``keys``, ``len``, the SSD tier (spill, fault-in,
  compaction); a table saved by the reference and loaded by the port
  takes an Adagrad push as the reference's does, and the reverse.
- PS plumbing, bit for bit: ``merge_sparse``; the sync ``Communicator``;
  ``AsyncCommunicator`` fed the same pushes with a ``flush`` after each
  (one push a merge window, so timing cannot change the result);
  ``GeoCommunicator``; ``Communicator.create``; ``DenseTable``'s three
  rules. The reference's ``flush`` returns before a push that was
  enqueued while its send loop saw an empty queue has reached the table
  (confirmed here with the enqueue held until the loop has looked); the
  port's does not. ``ps_rpcs_total`` counts; ``FLAGS_enable_rpc_profiler``
  writes the reference's "ps_rpc" event; the TCP wire and graph tables
  raise, naming their item.
- The lookup: ``distributed_lookup_table``'s rows, and the table after
  its backward pushed through the communicator and through a client.
- The pass cache: ``slots``, the ``KeyError`` for an id outside the
  pass, duplicate ids summing in ``push_grads``, ``end_pass`` in both
  modes, and ``heter_embedding``'s accumulated gradient: bit for bit, or
  within 1e-6 of the largest where the reference's compiled scatter
  sums (measured 0 here).
- ``CompiledPassStep`` at batch 32, 4 slots, vocab 200 (``WideDeep(4,
  8)``, Adam 1e-3, an Adagrad host table), each table rule (None,
  "sgd", "adagrad"). The first step: the loss within 1e-6 relative
  (measured 0), the dense gradients (against the reference's eager
  backward) and the slab's gradient within 1e-6 of the largest
  (measured 1.6e-7 and 2.0e-7), Adam's step held by
  ``torch_checks.adam_step_parity``, and the table rule applied to the
  port's own slab gradient as numpy's fp32 applies it, bit for bit. The
  Adagrad update itself is not held at 1e-6 against the reference's: at
  ``g ~ 0`` it moves by ``lr / sqrt(1e-8) = 1e3`` times a gradient's
  difference (measured 6.9e-6 of the largest; sgd's 5.1e-7). Then two
  passes of 3 steps: every loss, the dense parameters and the host
  table's rows within ``TRAJ_TOL`` of the largest (measured, port
  against reference: losses 8.6e-8, parameters 1.5e-6, rows 4.0e-6; the
  reference against itself with the deep arm's first weights one ulp
  up, the yardstick: 8.5e-8, 1.4e-6, 2.0e-6).
- Metrics on the same predictions, bit for bit; ``ctr_batches`` and
  ``zipf_ids`` bit for bit; BCE-with-logits (weight, ``pos_weight``,
  each reduction), BCE and ``sigmoid`` within 1e-6 (measured 6e-8), and
  their cast sequence under O1 and O2 op for op; ``WideDeep``'s logits
  within 1e-6.
- The slice: ``WideDeepBench.run()`` at ``bench.py``'s CPU sizes (batch
  128, 8 slots, 30 steps, vocab 2000), the deep MLP's weights carried
  from the reference, against the reference's ``measure_widedeep`` flow:
  every loss within 1e-6 relative (measured 1.7e-7), the table's rows
  within 1e-5 of the largest (measured 8.2e-7), the AUC within 1e-5
  (measured 4.8e-7), the same table size.

About 20 s on the CPU (two threads). The file collects one test that
runs every case (``tests/torch_checks.py`` says why).
"""
import os
import tempfile
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.nn.functional as JF
import paddle_tpu.distributed.ps as jps
import paddle_tpu.distributed.ps.communicator as jcomm
import paddle_tpu.metric as jmetric
from paddle_tpu.core.table import SparseTable as JTable
from paddle_tpu.distributed.ps.heter_cache import DevicePassCache as JCache
from paddle_tpu.distributed.ps.heter_trainer import (
    CompiledPassStep as JStep, heter_embedding as jheter)
from paddle_tpu.models import wide_deep as jwd
import paddle_tpu_torch.amp as tamp
import paddle_tpu_torch.distributed.ps as tps
import paddle_tpu_torch.distributed.ps.communicator as tcomm
import paddle_tpu_torch.metric as tmetric
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.core.table import SparseTable as TTable
from paddle_tpu_torch.distributed.ps.heter_trainer import (
    CompiledPassStep as TStep, heter_embedding as theter)
from paddle_tpu_torch.framework.flags import flag, set_flags
from paddle_tpu_torch.models import wide_deep as twd
from paddle_tpu_torch.models.convert import dense_state_dict_from_numpy
from paddle_tpu_torch.observability.metrics import get_registry
from paddle_tpu_torch.optimizer import Adam
from test_torch_bert_train import _ctx, _diff, _recording
from torch_checks import adam_step_parity, run_checks

torch.set_num_threads(2)

DIM = 8
STEP_B, STEP_SLOTS, STEP_VOCAB = 32, 4, 200
LR = 1e-3
FIRST_RTOL = 1e-6      # first step: loss, gradients, row update
TRAJ_TOL = 1e-5        # two passes of 3 steps: losses, params, rows
SLICE_LOSS_RTOL = 1e-6
SLICE_ROW_TOL = 1e-5   # of the table's largest value
SLICE_AUC_TOL = 1e-5
BCE_TOL = 1e-6


# ------------------------------------------------------------ helpers
def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape,
                                                       b.shape)
    if a.dtype == np.float32:
        ok = np.array_equal(a.view(np.uint32), b.view(np.uint32))
    else:
        ok = np.array_equal(a, b)
    assert ok, f"{what}: differ, max {np.abs(a - b).max()}"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._value).astype(np.float32)


def _keys(rs, n, vocab=None):
    if vocab is None:
        return rs.randint(0, 2 ** 62, n, dtype=np.int64).astype(np.uint64)
    return rs.randint(0, vocab, n).astype(np.uint64)


def _table_pair(opt, **kw):
    cfg = dict(dim=DIM, optimizer=opt, init_range=0.05, lr=0.2, seed=11)
    cfg.update(kw)
    return JTable(**cfg), TTable(**cfg)


def _all_rows(table):
    keys = np.sort(table.keys())
    return keys, table.pull(keys, create_if_missing=False)


def _same_tables(jt, tt, what):
    jk, jr = _all_rows(jt)
    tk, tr = _all_rows(tt)
    _same(jk, tk, f"{what}: keys")
    _same(jr, tr, f"{what}: rows")
    assert len(jt) == len(tt), (what, len(jt), len(tt))


class _Strategy:
    def __init__(self, a_sync, **cfg):
        self.a_sync = a_sync
        self.a_sync_configs = cfg


# ------------------------------------------------------------ host table
def check_fresh_pulls(opt):
    jt, tt = _table_pair(opt)
    keys = _keys(np.random.RandomState(1), 300)
    _same(jt.pull(keys), tt.pull(keys), f"{opt} fresh pull")
    other = keys + np.uint64(1)
    _same(jt.pull(other, create_if_missing=False),
          tt.pull(other, create_if_missing=False), f"{opt} missing pull")
    assert len(jt) == len(tt) == len(np.unique(keys))


def check_push_sequence(opt):
    jt, tt = _table_pair(opt)
    rs = np.random.RandomState(2)
    for i in range(6):
        keys = _keys(rs, 64, vocab=40)          # duplicates fold in order
        grads = rs.randn(64, DIM).astype(np.float32)
        lr = -1.0 if i % 2 else 0.3
        jt.push(keys, grads, lr=lr)
        tt.push(keys, grads, lr=lr)
    _same_tables(jt, tt, f"{opt} pushes")
    keys = _keys(rs, 10, vocab=60)
    vals = rs.randn(10, DIM).astype(np.float32)
    jt.assign(keys, vals)
    tt.assign(keys, vals)
    jt.add(keys[:5], vals[:5])
    tt.add(keys[:5], vals[:5])
    _same_tables(jt, tt, f"{opt} assign, add")


def check_ssd_tier():
    with tempfile.TemporaryDirectory() as d:
        jt, tt = _table_pair("adagrad", ssd_path=os.path.join(d, "j.log"))
        tt.enable_ssd(os.path.join(d, "t.log"))
        rs = np.random.RandomState(3)
        keys = _keys(rs, 100, vocab=1000)
        for t in (jt, tt):
            t.pull(keys)
            t.push(keys[:50], np.ones((50, DIM), np.float32))
        assert jt.spill(20) == tt.spill(20)
        assert jt.ssd_rows() == tt.ssd_rows() and jt.mem_rows() == \
            tt.mem_rows()
        _same(jt.pull(keys), tt.pull(keys), "ssd fault-in")
        assert jt.ssd_compact() == tt.ssd_compact()
        _same_tables(jt, tt, "ssd tier")


def check_save_load_carries_state():
    rs = np.random.RandomState(4)
    keys = _keys(rs, 80, vocab=30)
    g1, g2 = (rs.randn(80, DIM).astype(np.float32) for _ in range(2))
    with tempfile.TemporaryDirectory() as d:
        for src_cls, dst_cls in ((JTable, TTable), (TTable, JTable)):
            cfg = dict(dim=DIM, optimizer="adagrad", lr=0.2, seed=5)
            src, dst, ctl = src_cls(**cfg), dst_cls(**cfg), src_cls(**cfg)
            for t in (src, ctl):
                t.push(keys, g1)
            path = os.path.join(d, f"{src_cls.__module__}.bin")
            src.save(path)
            dst.load(path)
            dst.push(keys, g2)      # Adagrad's G carried across
            ctl.push(keys, g2)
            _same_tables(ctl, dst, f"saved by {src_cls.__module__}")


# ------------------------------------------------------------ PS plumbing
def check_merge_sparse():
    rs = np.random.RandomState(5)
    keys = _keys(rs, 200, vocab=50)
    grads = rs.randn(200, DIM).astype(np.float32)
    (jk, jg), (tk, tg) = (jcomm.merge_sparse(keys, grads),
                          tcomm.merge_sparse(keys, grads))
    _same(jk, tk, "merged keys")
    _same(jg, tg, "merged rows")


def _pushes(seed, n=5):
    rs = np.random.RandomState(seed)
    return [(_keys(rs, 48, vocab=30), rs.randn(48, DIM).astype(np.float32),
             -1.0 if i % 2 else 0.05) for i in range(n)]


def _ps_pair():
    j, t = jps.LocalPs(), tps.LocalPs()
    for ps in (j, t):
        ps.create_table(0, dim=DIM, optimizer="adagrad", lr=0.1, seed=1)
    return j, t


def check_communicators(kind):
    j, t = _ps_pair()
    if kind == "sync":
        jc, tc = jcomm.Communicator(j), tcomm.Communicator(t)
    elif kind == "async":
        jc, tc = jcomm.AsyncCommunicator(j), tcomm.AsyncCommunicator(t)
    else:
        jc, tc = (jcomm.GeoCommunicator(j, k_steps=2),
                  tcomm.GeoCommunicator(t, k_steps=2))
    for c in (jc, tc):
        c.start()
    try:
        for keys, grads, lr in _pushes(6):
            for c in (jc, tc):
                c.push_sparse(0, keys, grads, lr=lr)
                if kind == "async":
                    c.flush()
            _same(jc.pull_sparse(0, keys), tc.pull_sparse(0, keys),
                  f"{kind}: pull after a push")
        for c in (jc, tc):
            c.flush()
    finally:
        for c in (jc, tc):
            c.stop()
    _same_tables(j.tables[0], t.tables[0], f"{kind} communicator")


def check_communicator_create():
    t = tps.LocalPs()
    assert type(tcomm.Communicator.create(t)) is tcomm.Communicator
    geo = tcomm.Communicator.create(t, _Strategy(True, k_steps=4))
    assert isinstance(geo, tcomm.GeoCommunicator) and geo.k_steps == 4
    a = tcomm.Communicator.create(t, _Strategy(True, max_merge_var_num=3))
    j = jcomm.Communicator.create(jps.LocalPs(),
                                  _Strategy(True, max_merge_var_num=3))
    assert isinstance(a, tcomm.AsyncCommunicator)
    assert (a.max_merge, a.wait, a._q.maxsize) == (j.max_merge, j.wait,
                                                   j._q.maxsize)
    d = tcomm.Communicator.create(t, _Strategy(True))
    assert (d.max_merge, d.wait) == (
        flag("FLAGS_communicator_max_merge_var_num"),
        flag("FLAGS_communicator_send_wait_times")) == (20, 0.005)


class _SlowClient:
    """A client whose push lands ``delay`` s after it is called."""

    def __init__(self, ps, delay=0.3):
        self.ps, self.delay = ps, delay

    def push(self, *a, **kw):
        time.sleep(self.delay)
        self.ps.push(*a, **kw)


def _held_put(comm, hold):
    """Hold each enqueue of ``comm`` until ``hold(comm)`` returns."""
    real = comm._q.put

    def put(item, *a, **kw):
        if item is not None:
            hold(comm)
        return real(item, *a, **kw)

    comm._q.put = put


def check_async_flush_race():
    """The reference's push clears its drained event, then enqueues; its
    send loop sets the event whenever it sees the queue empty. An
    enqueue held until the loop has looked (the event set again) leaves
    the event set with a push queued: ``flush`` returns before the push
    reaches the table. The port counts unsent pushes under a lock."""
    keys = np.arange(4, dtype=np.uint64)
    grads = np.ones((4, DIM), np.float32)
    j, t = _ps_pair()
    jc = jcomm.AsyncCommunicator(_SlowClient(j))
    _held_put(jc, lambda c: c._drained.wait(2.0))
    before = j.pull(0, keys)
    jc.start()
    try:
        jc.push_sparse(0, keys, grads)
        jc.flush()
        early = j.pull(0, keys)
    finally:
        jc.stop()
    assert np.array_equal(early, before), \
        "the reference's flush waited: the race did not show"
    assert not np.array_equal(j.pull(0, keys), before)
    tc = tcomm.AsyncCommunicator(_SlowClient(t))
    _held_put(tc, lambda c: time.sleep(0.05))
    before = t.pull(0, keys)
    tc.start()
    try:
        tc.push_sparse(0, keys, grads)
        tc.flush()
        after = t.pull(0, keys)
    finally:
        tc.stop()
    assert not np.array_equal(after, before), \
        "the port's flush returned before the push reached the table"


def check_dense_table(opt):
    rs = np.random.RandomState(7)
    jt = jps.DenseTable((3, 5), opt=opt, lr=0.1, init_value=0.5)
    tt = tps.DenseTable((3, 5), opt=opt, lr=0.1, init_value=0.5)
    for i in range(4):
        g = rs.randn(3, 5).astype(np.float32)
        lr = -1.0 if i % 2 else 0.02
        jt.push(g, lr)
        tt.push(g, lr)
    _same(jt.pull(), tt.pull(), f"dense table {opt}")
    v = rs.randn(15).astype(np.float32)
    jt.assign(v)
    tt.assign(v)
    _same(jt.pull(), tt.pull(), "dense assign")


def check_counters_flags_and_what_raises():
    fam = get_registry().get("ps_rpcs_total")
    _, t = _ps_pair()
    c = tcomm.Communicator(t)
    n0 = fam.labels(op="push_sparse").get()
    p0 = fam.labels(op="pull_sparse").get()
    c.push_sparse(0, np.arange(3, dtype=np.uint64), np.ones((3, DIM)))
    c.pull_sparse(0, np.arange(3, dtype=np.uint64))
    assert fam.labels(op="push_sparse").get() == n0 + 1
    assert fam.labels(op="pull_sparse").get() == p0 + 1
    # FLAGS_enable_rpc_profiler: the reference's per-RPC event record
    from paddle_tpu_torch.observability import EventLog, set_event_log

    saved = flag("FLAGS_enable_rpc_profiler")
    prev = set_event_log(EventLog())
    try:
        set_flags({"FLAGS_enable_rpc_profiler": True})
        c.pull_sparse(0, np.arange(3, dtype=np.uint64))
        from paddle_tpu_torch.observability import get_event_log
        ev = get_event_log().events(kind="ps_rpc")
        assert [(e["op"], e["table_id"], e["n_keys"], e["bytes"],
                 e["severity"]) for e in ev] == [
            ("pull_sparse", 0, 3, None, "debug")]
    finally:
        set_flags({"FLAGS_enable_rpc_profiler": saved})
        set_event_log(prev)
    rt = tps.TheOnePSRuntime()
    for call in (rt.init_server, rt.run_server,
                 lambda: rt.init_worker(["127.0.0.1:1"]),
                 lambda: t.create_graph_table(1),
                 lambda: t.graph_add_edges(1, [0], [1])):
        with pytest.raises(NotImplementedError, match="the PS remainder"):
            call()


# ------------------------------------------------------------ lookup
def check_lookup(route):
    """Rows on both sides, then the backward's push: through the
    runtime's async communicator (flushed) or straight to a client."""
    j, t = _ps_pair()
    rs = np.random.RandomState(8)
    ids = rs.randint(0, 25, (6, 3))
    ct = rs.randn(6, 3, DIM).astype(np.float32)
    jrt, trt = jps.TheOnePSRuntime(), tps.TheOnePSRuntime()
    jrt.client, trt.client = j, t
    kw_j, kw_t = {}, {"device": "cpu"}
    if route == "communicator":
        jrt.communicator = jcomm.AsyncCommunicator(j)
        trt.communicator = tcomm.AsyncCommunicator(t)
        jrt.communicator.start()
        trt.communicator.start()
    else:
        kw_j["client"], kw_t["client"] = j, t
    try:
        jrows = jps.distributed_lookup_table(
            paddle.to_tensor(ids, dtype="int64"), table_id=0, lr=0.3, **kw_j)
        trows = tps.distributed_lookup_table(ids, table_id=0, lr=0.3, **kw_t)
        _same(_np(jrows), _np(trows), f"lookup rows ({route})")
        assert trows.requires_grad and trows.shape == (6, 3, DIM)
        (jrows * paddle.to_tensor(ct)).sum().backward()
        (trows * torch.from_numpy(ct)).sum().backward()
        if route == "communicator":
            jrt.communicator.flush()
            trt.communicator.flush()
    finally:
        if route == "communicator":
            jrt.communicator.stop()
            trt.communicator.stop()
    _same_tables(j.tables[0], t.tables[0], f"table after the push "
                                           f"({route})")
    with torch.no_grad():
        assert not tps.distributed_lookup_table(
            ids, client=t, device="cpu").requires_grad
    tps.distributed_push_sparse(ids[:2], ct[:2], client=t, lr=0.1)
    jps.distributed_push_sparse(ids[:2], ct[:2], client=j, lr=0.1)
    _same_tables(j.tables[0], t.tables[0], "distributed_push_sparse")


# ------------------------------------------------------------ pass cache
def _cache_pair(pad_to=None, lr=0.2):
    j, t = _ps_pair()
    jc, tc = JCache(j, 0, lr=lr), tps.DevicePassCache(t, 0, lr=lr,
                                                      device="cpu")
    return j, t, jc, tc


def check_pass_cache(assign):
    rs = np.random.RandomState(9)
    pass_ids = rs.randint(0, 60, 90)
    j, t, jc, tc = _cache_pair()
    jc.begin_pass(pass_ids, pad_to=64)
    tc.begin_pass(pass_ids, pad_to=64)
    _same(np.asarray(jc._rows), _np(tc._rows), "the slab")
    ids = rs.randint(0, 60, (7, 5))
    ids[0, 0] = ids[1, 1] = ids[2, 2]           # duplicates
    ids = np.where(np.isin(ids, pass_ids), ids, pass_ids[0])
    _same(jc.slots(ids), tc.slots(ids), "slots")
    for c in (jc, tc):
        with pytest.raises(KeyError, match="not in this pass"):
            c.slots(np.array([61]))
    _same(np.asarray(jc.lookup(ids)), _np(tc.lookup(ids)), "lookup")
    g = rs.randn(35, DIM).astype(np.float32)
    jc.push_grads(ids, g)
    tc.push_grads(ids, g)
    assert _rel(_np(tc._gacc), np.asarray(jc._gacc)) <= 1e-6
    if assign:
        vals = rs.randn(64, DIM).astype(np.float32)
        jc._rows = jc._rows * 0 + vals
        tc._rows = torch.from_numpy(vals.copy())
    jc.end_pass(assign=assign)
    tc.end_pass(assign=assign)
    _same_tables(j.tables[0], t.tables[0], f"end_pass(assign={assign})")
    assert (jc.pulls, jc.pushes) == (tc.pulls, tc.pushes) == (1, 1)


def check_heter_embedding():
    rs = np.random.RandomState(10)
    pass_ids = rs.randint(0, 40, 60)
    _, _, jc, tc = _cache_pair()
    jc.begin_pass(pass_ids)
    tc.begin_pass(pass_ids)
    ids = pass_ids[rs.randint(0, 60, (5, 4))]
    ct = rs.randn(5, 4, DIM).astype(np.float32)
    for _ in range(2):          # two backward passes accumulate
        jo, to = jheter(jc, ids), theter(tc, ids)
        _same(_np(jo), _np(to), "heter_embedding rows")
        (jo * paddle.to_tensor(ct)).sum().backward()
        (to * torch.from_numpy(ct)).sum().backward()
    assert _rel(_np(tc._gacc), np.asarray(jc._gacc)) <= 1e-6


# ------------------------------------------------------------ pass step
def _carried_wide_deep(seed=0, nudge=False):
    paddle.seed(seed)
    jm = jwd.WideDeep(STEP_SLOTS, DIM)
    arrays = {n: np.asarray(p._value).copy()
              for n, p in jm.state_dict().items()}
    if nudge:        # the first Linear's weights one ulp up
        w = arrays["deep.0.weight"]
        arrays["deep.0.weight"] = np.nextafter(w, np.float32(np.inf))
        jm.deep[0].weight.set_value(arrays["deep.0.weight"])
    tm = twd.WideDeep(STEP_SLOTS, DIM, device="cpu")
    tm.load_state_dict(dense_state_dict_from_numpy(arrays, tm))
    return jm, tm


def _step_batches(n, seed=12):
    rs = np.random.RandomState(seed)
    true_w = rs.randn(STEP_VOCAB)
    out = []
    for _ in range(n):
        ids = rs.randint(0, STEP_VOCAB, (STEP_B, STEP_SLOTS))
        out.append((ids, (true_w[ids].sum(1) > 0).astype(np.float32)))
    return out


def _ref_grads(jm, rows, slots, labels):
    """The reference's eager backward of one step: the dense gradients
    and the slab's gradient (its rows' gradients summed per slot)."""
    emb = paddle.to_tensor(rows[slots.reshape(-1)].reshape(STEP_B, -1))
    emb.stop_gradient = False
    jwd.wide_deep_loss(jm(emb), paddle.to_tensor(labels)).backward()
    grads = {n: _np(p.grad).copy() for n, p in jm.named_parameters()}
    g_rows = np.zeros_like(rows)
    np.add.at(g_rows, slots.reshape(-1), _np(emb.grad).reshape(-1, DIM))
    jm.clear_gradients()
    return grads, g_rows


def _run_steps(side, table_opt, batches, nudge=False, first=None):
    """Two passes of 3 steps; ``first`` collects the first step's
    (loss, params before/after, grads, rows before/after, gacc)."""
    ps = (jps.LocalPs() if side == "ref" else tps.LocalPs())
    ps.create_table(0, dim=DIM, optimizer="adagrad", lr=0.1, seed=1)
    jm, tm = _carried_wide_deep(nudge=nudge)
    if side == "ref":
        model, cache = jm, JCache(ps, 0, lr=0.1)
        opt = paddle.optimizer.Adam(learning_rate=LR,
                                    parameters=jm.parameters())
        step = JStep(cache, jm, opt, jwd.wide_deep_loss,
                     table_optimizer=table_opt, table_lr=0.1)
    else:
        model, cache = tm, tps.DevicePassCache(ps, 0, lr=0.1, device="cpu")
        step = TStep(cache, tm, Adam(learning_rate=LR,
                                     parameters=tm.parameters()),
                     twd.wide_deep_loss, table_optimizer=table_opt,
                     table_lr=0.1)
        if first is not None:       # the slab's gradient of step 1
            rule = step._table_rule

            def spy(cache_, rows, g):
                first.setdefault("g_rows", g.numpy().copy())
                rule(cache_, rows, g)

            step._table_rule = spy

    def params():
        return {n: _np(p).copy() for n, p in model.named_parameters()}

    losses = []
    for p in range(2):
        bs = batches[3 * p:3 * p + 3]
        cache.begin_pass(np.concatenate([b[0].reshape(-1) for b in bs]),
                         pad_to=256)
        for i, b in enumerate(bs):
            if first is not None and p == i == 0:
                rows0, before = _np(cache._rows).copy(), params()
                if side == "ref":
                    grads, g_rows = _ref_grads(
                        jm, rows0, cache.slots(b[0]), b[1])
            loss = step(cache, b)
            losses.append(float(loss))
            if first is not None and p == i == 0:
                if side == "port":
                    grads = {n: q.grad.numpy().copy()
                             for n, q in tm.named_parameters()}
                    g_rows = first["g_rows"]
                first.update(loss=losses[0], before=before, after=params(),
                             grads=grads, g_rows=g_rows, rows0=rows0,
                             rows1=_np(cache._rows).copy(),
                             gacc=_np(cache._gacc).copy())
        cache.end_pass(assign=table_opt is not None)
    keys = np.sort(ps.tables[0].keys())
    return {"losses": np.array(losses), "params": params(),
            "rows": ps.pull(0, keys)}


def check_compiled_pass_step(table_opt):
    batches = _step_batches(6)
    jf, tf = {}, {}
    ref = _run_steps("ref", table_opt, batches, first=jf)
    port = _run_steps("port", table_opt, batches, first=tf)
    noisy = _run_steps("ref", table_opt, batches, nudge=True)
    # the first step
    assert abs(tf["loss"] - jf["loss"]) <= FIRST_RTOL * abs(jf["loss"])
    for n in jf["grads"]:
        assert _rel(tf["grads"][n], jf["grads"][n]) <= FIRST_RTOL, n
    adam_step_parity(
        {n: tuple(torch.from_numpy(d[n]) for d in
                  (tf["before"], tf["after"], tf["grads"]))
         for n in tf["grads"]},
        {n: tuple(torch.from_numpy(d[n]) for d in
                  (jf["before"], jf["after"], jf["grads"]))
         for n in jf["grads"]}, LR, grad_rtol=FIRST_RTOL)
    _same(tf["rows0"], jf["rows0"], "the slab before the first step")
    g, rows0 = tf["g_rows"], tf["rows0"]
    first = {"loss": abs(tf["loss"] - jf["loss"]) / abs(jf["loss"]),
             "grads": max(_rel(tf["grads"][n], jf["grads"][n])
                          for n in jf["grads"]),
             "g_rows": _rel(g, jf["g_rows"]),
             "update": _rel(tf["rows1"] - rows0, jf["rows1"] - rows0)}
    print(f"pass step {table_opt}, first step: {first}")
    assert first["g_rows"] <= FIRST_RTOL
    # the rule on the port's own gradient, in numpy's fp32: bit for bit
    lr = np.float32(0.1)
    if table_opt is None:
        _same(tf["gacc"], g, "gacc after one step")
        _same(tf["rows1"], rows0, "the slab under downpour")
    elif table_opt == "sgd":
        _same(tf["rows1"], rows0 - lr * g, "the sgd rule")
    else:
        gacc = g * g
        _same(tf["gacc"], gacc, "gacc after one step")
        _same(tf["rows1"], rows0 - lr * g / np.sqrt(gacc + np.float32(1e-8)),
              "the adagrad rule")
    # two passes: the port against the reference, within TRAJ_TOL; the
    # reference's own one-ulp move beside it
    errs = {"losses": _rel(port["losses"], ref["losses"]),
            "params": max(_rel(port["params"][n], ref["params"][n])
                          for n in ref["params"]),
            "rows": _rel(port["rows"], ref["rows"])}
    noise = {"losses": _rel(noisy["losses"], ref["losses"]),
             "params": max(_rel(noisy["params"][n], ref["params"][n])
                           for n in ref["params"]),
             "rows": _rel(noisy["rows"], ref["rows"])}
    print(f"pass step {table_opt}: port vs reference {errs}; reference "
          f"one ulp up {noise}")
    for k, e in errs.items():
        assert e <= TRAJ_TOL, (table_opt, k, e, noise[k])


# ------------------------------------------------------------ metrics, data
def check_metrics():
    rs = np.random.RandomState(13)
    prob = rs.rand(500).astype(np.float32)
    labels = (rs.rand(500) < prob).astype(np.float32)
    preds = np.stack([1 - prob, prob], 1)
    for cls, args in (("Auc", (preds, labels[:, None])),
                      ("Precision", (prob, labels)),
                      ("Recall", (prob, labels))):
        jm, tm = getattr(jmetric, cls)(), getattr(tmetric, cls)()
        for _ in range(2):
            jm.update(*args)
            tm.update(*args)
        assert jm.accumulate() == tm.accumulate(), cls
        assert jm.name() == tm.name()
    ta, tb = tmetric.Auc(), tmetric.Auc()
    ta.update(torch.from_numpy(preds), torch.from_numpy(labels[:, None]))
    tb.update(preds, labels[:, None])
    assert ta.accumulate() == tb.accumulate()
    logits = rs.randn(60, 7).astype(np.float32)
    lbl = rs.randint(0, 7, (60, 1))
    ja, ta = jmetric.Accuracy(topk=(1, 3)), tmetric.Accuracy(topk=(1, 3))
    assert ja.update(ja.compute(logits, lbl)) == ta.update(
        ta.compute(torch.from_numpy(logits), torch.from_numpy(lbl)))
    assert ja.accumulate() == ta.accumulate() and ja.name() == ta.name()
    _same(np.asarray(jmetric.accuracy(paddle.to_tensor(logits),
                                      paddle.to_tensor(lbl), k=2)._value),
          tmetric.accuracy(torch.from_numpy(logits), torch.from_numpy(lbl),
                           k=2).numpy(), "accuracy")


def check_data():
    for alpha in (1.1, 0.0):
        for a, b in zip(jwd.ctr_batches(3, 16, 4, 500, alpha=alpha, seed=2),
                        twd.ctr_batches(3, 16, 4, 500, alpha=alpha, seed=2)):
            _same(a[0], b[0], "ctr ids")
            _same(a[1], b[1], "ctr labels")
    _same(jwd.zipf_ids(np.random.RandomState(3), 100, (40,)),
          twd.zipf_ids(np.random.RandomState(3), 100, (40,)), "zipf ids")


def check_bce():
    rs = np.random.RandomState(14)
    z = (rs.randn(4, 33) * 4).astype(np.float32)
    y = (rs.rand(4, 33) > 0.5).astype(np.float32)
    w = rs.rand(4, 33).astype(np.float32)
    pw = (rs.rand(33) * 3).astype(np.float32)
    p = (1 / (1 + np.exp(-z))).astype(np.float32)
    cases = []
    for red in ("mean", "sum", "none"):
        for kw in ({}, {"weight": w}, {"pos_weight": pw},
                   {"weight": w, "pos_weight": pw}):
            cases.append(("binary_cross_entropy_with_logits", z, red, kw))
        cases.append(("binary_cross_entropy", p, red, {"weight": w}))
        cases.append(("binary_cross_entropy", p, red, {}))
    for name, x, red, kw in cases:
        jx, tx = paddle.to_tensor(x), torch.from_numpy(x.copy())
        jx.stop_gradient = False
        tx.requires_grad_(True)
        jo = getattr(JF, name)(jx, paddle.to_tensor(y), reduction=red,
                               **{k: paddle.to_tensor(v)
                                  for k, v in kw.items()})
        to = getattr(F, name)(tx, torch.from_numpy(y), reduction=red,
                              **{k: torch.from_numpy(v)
                                 for k, v in kw.items()})
        assert _rel(_np(to), _np(jo)) <= BCE_TOL, (name, red, list(kw))
        jo.sum().backward()
        to.sum().backward()
        assert _rel(tx.grad.numpy(), _np(jx.grad)) <= BCE_TOL, (name, red)
    assert _rel(_np(F.sigmoid(torch.from_numpy(z))),
                _np(JF.sigmoid(paddle.to_tensor(z)))) <= BCE_TOL
    from paddle_tpu_torch import nn as tnn
    assert _rel(_np(tnn.BCEWithLogitsLoss(pos_weight=torch.from_numpy(pw))(
        torch.from_numpy(z), torch.from_numpy(y))), _np(
        paddle.nn.BCEWithLogitsLoss(pos_weight=paddle.to_tensor(pw))(
            paddle.to_tensor(z), paddle.to_tensor(y)))) <= BCE_TOL
    assert _rel(_np(tnn.Sigmoid()(torch.from_numpy(z))),
                _np(JF.sigmoid(paddle.to_tensor(z)))) <= BCE_TOL


def check_casts(level):
    """WideDeep's forward, the loss and ``sigmoid`` under amp: the cast
    sequence op for op."""
    jm, tm = _carried_wide_deep()
    rs = np.random.RandomState(15)
    x = rs.randn(8, STEP_SLOTS * DIM).astype(np.float32)
    y = (rs.rand(8) > 0.5).astype(np.float32)
    with _recording(jamp) as want, _ctx(jamp, level):
        jo = jm(paddle.to_tensor(x))
        jwd.wide_deep_loss(jo, paddle.to_tensor(y))
        JF.sigmoid(jo)
    with _recording(tamp) as got, _ctx(tamp, level):
        to = tm(torch.from_numpy(x))
        twd.wide_deep_loss(to, torch.from_numpy(y))
        F.sigmoid(to)
    assert want == got, _diff(want, got)
    if level is None:
        assert _rel(_np(to), _np(jo)) <= BCE_TOL


# ------------------------------------------------------------ the slice
def _reference_bench(sizes):
    """``bench.py``'s ``measure_widedeep`` flow on the reference, at
    ``sizes``: every loss, the deep MLP's initial weights, the table and
    the AUC."""
    batch, slots, steps, vocab = sizes
    runtime = jps.TheOnePSRuntime()
    ps = jps.LocalPs()
    ps.create_table(0, dim=8, init_range=0.01, lr=0.1, optimizer="adagrad")
    runtime.client = ps
    runtime.communicator = jcomm.AsyncCommunicator(ps)
    runtime.communicator.start()
    paddle.seed(0)
    deep = paddle.nn.Sequential(paddle.nn.Linear(8 * slots, 64),
                                paddle.nn.ReLU(), paddle.nn.Linear(64, 1))
    w0 = {n: np.asarray(t._value).copy()
          for n, t in deep.state_dict().items()}
    optim = paddle.optimizer.Adam(learning_rate=1e-3,
                                  parameters=deep.parameters())
    rs = np.random.RandomState(0)
    true_w = rs.randn(vocab)

    def make_batch(n):
        ids = rs.randint(0, vocab, (n, slots))
        return ids, (true_w[ids].sum(1) > 0).astype("float32")

    cache = JCache(ps, 0, lr=0.1)
    step = JStep(cache, deep, optim,
                 lambda out, labels: JF.binary_cross_entropy_with_logits(
                     out[:, 0], labels),
                 table_optimizer="adagrad", table_lr=0.1)
    losses = []

    def run_pass(bs):
        cache.begin_pass(np.concatenate([b[0].reshape(-1) for b in bs]),
                         pad_to=vocab)
        for b in bs:
            losses.append(float(step(cache, b)))
        cache.end_pass(assign=True)

    run_pass([make_batch(batch) for _ in range(2)])
    batches = [make_batch(batch) for _ in range(steps)]
    for i in range(0, steps, 10):
        run_pass(batches[i:i + 10])
    auc = jmetric.Auc()
    ids, labels = make_batch(4096)
    with paddle.no_grad():
        rows = jps.distributed_lookup_table(
            paddle.to_tensor(ids, dtype="int64"), table_id=0, lr=0.0)
        prob = JF.sigmoid(deep(rows.reshape([4096, -1]))[:, 0]).numpy()
    auc.update(np.stack([1.0 - prob, prob], axis=1), labels[:, None])
    runtime.communicator.stop()
    keys = np.sort(ps.tables[0].keys())
    return {"w0": w0, "losses": np.array(losses), "auc": auc.accumulate(),
            "keys": keys, "rows": ps.pull(0, keys),
            "size": ps.table_size(0)}


def check_slice_matches_reference():
    sizes = twd.CPU_SIZES
    ref = _reference_bench(sizes)
    w = dense_state_dict_from_numpy(
        ref["w0"], twd.deep_mlp(sizes.slots, device="cpu"))
    with twd.WideDeepBench(sizes, "cpu", weights=w) as bench:
        port = bench.run()
    ps = bench.ps
    keys = np.sort(ps.tables[0].keys())
    _same(keys, ref["keys"], "the table's keys")
    assert port["table_rows"] == ref["size"] == sizes.vocab
    assert len(port["losses"]) == sizes.steps + 2
    errs = {"losses": _rel(port["losses"], ref["losses"]),
            "rows": _rel(ps.pull(0, keys), ref["rows"]),
            "auc": abs(port["auc"] - ref["auc"])}
    print(f"widedeep at {tuple(sizes)}: {errs}; examples/s on this CPU "
          f"{port['examples_per_s']:.0f}")
    assert errs["losses"] <= SLICE_LOSS_RTOL, errs
    assert errs["rows"] <= SLICE_ROW_TOL, errs
    assert errs["auc"] <= SLICE_AUC_TOL, errs
    assert port["loss"] == port["losses"][-1]
    # the warm pass, then the timed steps in passes of STEPS_PER_PASS
    assert bench.cache.pulls == 1 + sizes.steps // twd.STEPS_PER_PASS


@pytest.fixture
def _fresh_runtimes():
    saved = (jps.TheOnePSRuntime._current, tps.TheOnePSRuntime._current)
    jps.TheOnePSRuntime._current = tps.TheOnePSRuntime._current = None
    yield
    jps.TheOnePSRuntime._current, tps.TheOnePSRuntime._current = saved


def test_widedeep_port_matches_reference(fresh_mesh, _fresh_runtimes):
    run_checks(
        [(check_fresh_pulls, (o,)) for o in ("sgd", "adagrad", "momentum")]
        + [(check_push_sequence, (o,))
           for o in ("sgd", "adagrad", "momentum")]
        + [(check_ssd_tier, ()), (check_save_load_carries_state, ()),
           (check_merge_sparse, ())]
        + [(check_communicators, (k,)) for k in ("sync", "async", "geo")]
        + [(check_communicator_create, ()), (check_async_flush_race, ())]
        + [(check_dense_table, (o,)) for o in ("sgd", "adagrad", "momentum")]
        + [(check_counters_flags_and_what_raises, ())]
        + [(check_lookup, (r,)) for r in ("communicator", "client")]
        + [(check_pass_cache, (a,)) for a in (False, True)]
        + [(check_heter_embedding, ())]
        + [(check_compiled_pass_step, (t,)) for t in (None, "sgd", "adagrad")]
        + [(check_metrics, ()), (check_data, ()), (check_bce, ())]
        + [(check_casts, (level,)) for level in (None, "O1", "O2")]
        + [(check_slice_matches_reference, ())])
