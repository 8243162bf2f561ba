"""Port multi-bucket fused update (``paddle_tpu_torch/ops/fused_update.py``
``BucketTable`` / ``fused_update_buckets``, ``optimizer/fused.py``
``FusedFlatUpdater.step``) against the JAX reference, on the CPU, where
the port walks the table through its plain version.

The reference updates bucket by bucket (``paddle_tpu/optimizer/fused.py``
``FusedFlatUpdater.step``: one ``reference_update_flat`` /
``fused_update_flat`` per bucket); the port updates every bucket of a
step in one call over a table. Cases:

- the table's plain walk against the reference's eager
  ``reference_update_flat`` and the port's, per bucket, three steps with
  fresh gradients: sgd, momentum (nesterov on and off), adam, adamw;
  buckets of mixed weight decay and lr_mult (the decay and no-decay
  groups), ragged sizes, n = 1; parameters, slots and the stepped beta
  powers bit-identical;
- the packed table the CUDA kernel reads (``BucketTable.words``):
  pointers, sizes, first chunks, the fp32 bits of wd and lr_mult, and the
  beta-power pointers swapping between the two parities;
- ``FusedFlatUpdater`` on the ``gpt-test`` parameters (AdamW, a no-decay
  group and an lr_mult group, so several buckets), three steps, the last
  on gradients it does not own (the ``torch.cat`` fallback, which
  rebuilds the table), against the reference's ``FusedFlatUpdater`` on
  the same buckets: run op by op (``jax.disable_jit``) bit for bit, and
  compiled with the Pallas kernel in interpret mode within 8 ulp of each
  array's largest value (XLA contracts FMAs on this CPU; see
  ``tests/test_torch_fused_update.py``), beta powers exact.

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu.distributed.grad_comm import GradBucket as JaxBucket
from paddle_tpu.framework.tensor import Parameter, Tensor
from paddle_tpu.ops.pallas import fused_update as jfu
from paddle_tpu.optimizer.fused import FusedFlatUpdater as JaxUpdater
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import uniform_buckets
from paddle_tpu_torch.models import gpt_presets
from paddle_tpu_torch.models.convert import expected_shapes
from paddle_tpu_torch.ops import fused_update as tfu
from torch_checks import run_checks

torch.set_num_threads(2)

KINDS = (("sgd", False), ("momentum", False), ("momentum", True),
         ("adam", False), ("adamw", False))
SIZES = (1000, 1, 127, 128, 5, 64)
WDS = (0.01, 0.0)
LMS = (1.0, 0.5)


def _hyper(kind, nesterov):
    if kind == "sgd":
        return {}
    if kind == "momentum":
        return {"momentum": 0.9, "nesterov": nesterov}
    return {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8}


def _exact(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape)
    assert (a.view(np.int32) == b.view(np.int32)).all(), \
        f"{what}: {(a != b).sum()} of {a.size} elements differ"


def _normwise(a, b, what, ulps=8):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape)
    bound = ulps * np.spacing(np.float32(np.abs(b).max()))
    err = float(np.abs(a - b).max())
    assert err <= bound, f"{what}: max abs diff {err} > {bound}"


def _inputs(kind, seed):
    rs = np.random.RandomState(seed)
    buckets = []
    for n in SIZES:
        slots = [(rs.randn(n) * 0.01).astype(np.float32)
                 for _ in tfu.slot_names(kind)]
        if kind in ("adam", "adamw"):
            slots[1] = np.abs(slots[1])
        buckets.append((rs.randn(n).astype(np.float32), slots))
    grads = [[rs.randn(n).astype(np.float32) for n in SIZES]
             for _ in range(3)]
    return buckets, grads


def check_table_walk_matches_reference(kind, nesterov):
    hyper = _hyper(kind, nesterov)
    names = tfu.slot_names(kind)
    buckets, grads = _inputs(kind, seed=len(kind) + nesterov)
    lr = np.float32(1e-3)
    pow0 = (np.float32(0.9 ** 3), np.float32(0.999 ** 3))
    entries = [(torch.from_numpy(p.copy()), torch.zeros(len(p)),
                [torch.from_numpy(s.copy()) for s in slots],
                WDS[b % 2], LMS[b % 2])
               for b, (p, slots) in enumerate(buckets)]
    table = tfu.BucketTable(kind, hyper, entries)
    if table.adam:
        table.load_powers([tuple(torch.tensor(x) for x in pow0)] *
                          len(SIZES))
    # the reference's and the port's per-bucket update, carried over steps
    jax_state, port_state = [], []
    for p, slots in buckets:
        st = dict(zip(names, slots))
        if table.adam:
            st.update(beta1_pow=pow0[0], beta2_pow=pow0[1])
        jax_state.append((jnp.asarray(p), {k: jnp.asarray(v)
                                           for k, v in st.items()}))
        port_state.append((torch.from_numpy(p.copy()),
                           {k: torch.tensor(v) for k, v in st.items()}))
    for step in range(3):
        for b, (e, g) in enumerate(zip(entries, grads[step])):
            e[1].copy_(torch.from_numpy(g))
            wd, lm = WDS[b % 2], LMS[b % 2]
            jp, js = jax_state[b]
            jax_state[b] = jfu.reference_update_flat(
                jp, jnp.asarray(g), js, jnp.asarray(lr), kind=kind,
                hyper=hyper, lm=lm, wd=wd)
            tp, ts = port_state[b]
            port_state[b] = tfu.reference_update_flat(
                tp, torch.from_numpy(g), ts, torch.tensor(lr), kind=kind,
                hyper=hyper, lm=lm, wd=wd)
        tfu.fused_update_buckets(table, torch.tensor(lr))
        for b, (p, _, arrs, _, _) in enumerate(entries):
            what = f"{kind} nesterov={nesterov} step {step + 1} bucket {b}"
            for ref, (rp, rs_) in (("reference", jax_state[b]),
                                   ("port per bucket", port_state[b])):
                rs_ = {k: np.asarray(v) for k, v in rs_.items()}
                _exact(np.asarray(rp), p.numpy(), f"{what} p vs {ref}")
                for nm, a in zip(names, arrs):
                    _exact(rs_[nm], a.numpy(), f"{what} {nm} vs {ref}")
                if table.adam:
                    b1, b2 = table.powers()[b]
                    _exact(rs_["beta1_pow"], b1.numpy(), f"{what} beta1")
                    _exact(rs_["beta2_pow"], b2.numpy(), f"{what} beta2")


def check_packed_table(kind):
    hyper = _hyper(kind, False)
    buckets, _ = _inputs(kind, seed=3)
    entries = [(torch.from_numpy(p), torch.zeros(len(p)),
                [torch.from_numpy(s) for s in slots], WDS[b % 2],
                LMS[b % 2]) for b, (p, slots) in enumerate(buckets)]
    table = tfu.BucketTable(kind, hyper, entries)
    assert table.words.shape == (2, len(SIZES), tfu.TABLE_WORDS)
    assert table.words.dtype == torch.int64
    assert table.total_chunks == sum((n + 3) // 4 for n in SIZES)
    start = 0
    for b, (p, g, arrs, wd, lm) in enumerate(entries):
        for q in (0, 1):
            w = [int(x) for x in table.words[q, b]]
            slots = [s.data_ptr() for s in arrs] + [0] * (2 - len(arrs))
            assert w[:4] == [p.data_ptr(), g.data_ptr(), *slots]
            if table.adam:
                assert w[4:6] == [table.pows[q, b].data_ptr(),
                                  table.pows[1 - q, b].data_ptr()]
            else:
                assert w[4:6] == [0, 0]
            assert w[6:8] == [p.numel(), start]
            assert struct.unpack("<ff", struct.pack("<q", w[8])) == (
                np.float32(wd), np.float32(lm))
        start += (p.numel() + 3) // 4
    key = tfu.BucketTable.pointers(table.entries)
    assert table.key == key


class _Coeff:
    def __init__(self, coeff):
        self._coeff = coeff


def _gpt_test_params():
    shapes = list(expected_shapes(gpt_presets("gpt-test")).items())
    rs = np.random.RandomState(21)
    vals = [(rs.randn(*sh) * 0.02).astype(np.float32) for _, sh in shapes]
    grads = [[(rs.randn(*sh) * 1e-2).astype(np.float32) for _, sh in shapes]
             for _ in range(3)]
    # biases and norms decay-free; position embeddings at lr_mult 0.5
    attrs = []
    for name, sh in shapes:
        a = {}
        if len(sh) == 1:
            a["regularizer"] = _Coeff(0.0)
        if "position_embeddings" in name:
            a["optimize_attr"] = {"learning_rate": 0.5}
        attrs.append(a)
    return vals, grads, attrs


def _jax_updater(vals, attrs, buckets, use_kernel):
    jp = [Parameter(jnp.asarray(v)) for v in vals]
    for p, a in zip(jp, attrs):
        for k, v in a.items():
            setattr(p, k, v)
    jo = jopt.AdamW(learning_rate=1e-3, weight_decay=0.01, parameters=jp)
    jb = []
    for b in buckets:
        x = JaxBucket(b.index, np.float32)
        for pi, sh in zip(b.param_indices, b.shapes):
            x.add(pi, sh)
        jb.append(x)
    return jp, JaxUpdater(jo, jp, buckets=jb, use_kernel=use_kernel)


def check_updater_matches_reference_at_gpt_test():
    vals, grads, attrs = _gpt_test_params()
    tp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in vals]
    for p, a in zip(tp, attrs):
        for k, v in a.items():
            setattr(p, k, v)
    to = topt.AdamW(learning_rate=1e-3, weight_decay=0.01, parameters=tp)
    buckets = uniform_buckets(tp, to)
    assert len(buckets) >= 3
    tu = topt.FusedFlatUpdater(to, tp, buckets=buckets)
    eager = _jax_updater(vals, attrs, buckets, use_kernel=False)
    pallas = _jax_updater(vals, attrs, buckets, use_kernel=True)
    tables = []
    for step in range(3):
        for jp, ju in (eager, pallas):
            for p, g in zip(jp, grads[step]):
                p.grad = Tensor(jnp.asarray(g))
        with jax.disable_jit():          # the reference op by op
            eager[1].step()
        pallas[1].step()
        if step < 2:                     # backward into the flat buffers
            tu.zero_grad()
            for p, g in zip(tp, grads[step]):
                p.grad.copy_(torch.from_numpy(g))
        else:                            # the torch.cat fallback
            for p, g in zip(tp, grads[step]):
                p.grad = torch.from_numpy(g.copy())
        tu.step()
        tables.append(tu._table)
    assert tables[0] is tables[1] is not tables[2]
    assert to._accumulated_steps == 3
    for i, (p, e, k) in enumerate(zip(tp, eager[0], pallas[0])):
        _exact(np.asarray(e._value), p.detach().numpy(), f"param {i} eager")
        _normwise(p.detach().numpy(), np.asarray(k._value),
                  f"param {i} Pallas")
    for b in tu.buckets:
        for key, v in tu._slots[b.index].items():
            e = np.asarray(eager[1]._slots[b.index][key])
            k = np.asarray(pallas[1]._slots[b.index][key])
            _exact(e, v.numpy(), f"bucket {b.index} {key} eager")
            if v.dim() == 0:
                _exact(k, v.numpy(), f"bucket {b.index} {key} Pallas")
            else:
                _normwise(v.numpy(), k, f"bucket {b.index} {key} Pallas")


def test_fused_buckets_match_reference(fresh_mesh):
    run_checks(
        [(check_table_walk_matches_reference, (k, nv)) for k, nv in KINDS]
        + [(check_packed_table, (k,))
           for k in ("sgd", "momentum", "adam", "adamw")]
        + [(check_updater_matches_reference_at_gpt_test, ())])
