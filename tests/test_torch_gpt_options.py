"""GPT's remaining training options in the port (``paddle_tpu_torch``:
dropout, ``attn_dropout``, ``recompute_policy`` and ``jit.TrainStep``
with Lamb, Lars and DGCMomentum) against the JAX reference on the CPU, at
``gpt-test`` size (2 layers, hidden 64), batch 2 x 32 from numpy.

- Dropout acts on the embeddings' output only, as the reference's
  (``paddle_tpu/models/gpt.py`` ``GPTEmbeddings.forward``; no block
  applies residual dropout): one mask a forward, of the embeddings'
  shape, none in eval mode. The port draws from its own generator, so
  its masks are replayed into a reference *instance*: its embeddings'
  ``Dropout`` is replaced by a layer that multiplies by the given mask
  over (1 - p), the mask a buffer set before each step (a test-side
  substitution; ``paddle_tpu`` is not edited). 3 ``TrainStep`` steps at
  ``dropout=0.1`` (AdamW lr 1e-3, wd 0.01): the loss within 1e-5
  relative at each (``tests/test_torch_train.py``'s fp32 tolerance).
  The port's mask drops its share (within 6 standard errors of p) and
  scales the kept entries by 1 / (1 - p), bit for bit, as
  ``tests/torch_nn_checks.py`` ``dropout_properties`` holds it.
- ``attn_dropout > 0`` only takes attention off flash, on both sides: the
  port makes no flash call and no draw, and its logits equal the einsum
  path's at ``attn_dropout=0`` bit for bit; the reference, told it runs
  on a TPU, routes ``attn_dropout=0`` to its flash kernel and
  ``attn_dropout=0.1`` to the einsum path, whose logits equal
  ``attn_dropout=0``'s einsum logits bit for bit (it drops nothing).
- ``recompute_policy``: ``_resolve_policies`` and the config's checks as
  the reference's, value for value and error message for error
  message, every tiling rule; each block takes its resolved policy;
  "none", "remat", "offload" and a mixed vector give the same loss and
  gradients bit for bit on the CPU (where "offload" parks nothing: the
  activations already lie in host memory, and no bytes are counted);
  against the reference's ``TrainStep`` at the same vector, 2 steps,
  the loss within 1e-4 relative: its scan mode where it runs the
  vector, its loop mode (which runs every block whole) for "offload",
  whose scan lowering fails on this JAX (``TransferToMemoryKind`` is
  gone; ROADMAP Queue C).
- ``TrainStep`` with Lamb, Lars and DGCMomentum runs the rule parameter
  by parameter (``optimizer.PerParameterUpdater``), the fusable rules
  keep ``FusedFlatUpdater``; against the reference's ``TrainStep`` 3
  steps, the loss within 1e-5 relative at each and every parameter
  within 1e-6 of its tensor's largest magnitude plus 2e-5 (the fp32
  step tolerance of ``tests/test_torch_train.py``: the two frameworks'
  gradients differ by fp32 rounding). DGCMomentum where both agree:
  ``rampup_begin_step=0`` and one sparsity level. The reference's
  ``TrainStep`` reads ``_accumulated_steps`` once, when it is traced, as
  its eager ``step()`` does: with ``rampup_begin_step=1`` its DGC stays
  dense (its losses equal its Momentum's) where the port's sparsifies
  from the second step (pinned both ways: ROADMAP Queue C).

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.framework import target as jtarget
from paddle_tpu.framework.autograd import call_op
from paddle_tpu.framework.tensor import Tensor as JaxTensor
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import gpt_presets as jax_presets
from paddle_tpu.nn import Layer as JaxLayer
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTPretrainingCriterion, gpt_presets)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn.functional import common as tcommon
from paddle_tpu_torch.optimizer.fused import (FusedFlatUpdater,
                                              PerParameterUpdater)
from torch_checks import run_checks
from torch_nn_checks import _share_ok

torch.set_num_threads(2)

SEED = 3
LR = 1e-3
LOSS_RTOL = 1e-5           # fp32 steps (tests/test_torch_train.py)
POLICY_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-6, 2e-5


def _batch(seed=2, b=2, s=32, vocab=256):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, (b, s)).astype(np.int64),
            rs.randint(0, vocab, (b, s)).astype(np.int64))


def _jt(x):
    return paddle.to_tensor(x)


@contextlib.contextmanager
def _masks():
    """Record every dropout mask the port draws (``keep_mask``)."""
    seen, real = [], tcommon.keep_mask

    def spy(v, p, shape):
        m = real(v, p, shape)
        seen.append(m.clone())
        return m

    tcommon.keep_mask = spy
    try:
        yield seen
    finally:
        tcommon.keep_mask = real


class _Replay(JaxLayer):
    """The reference's dropout with a given mask: ``where(mask, x / (1 -
    p), 0)``, the mask a buffer the test sets before each step."""

    def __init__(self, p, shape):
        super().__init__()
        self.p = p
        self.register_buffer("mask", JaxTensor(np.ones(shape, np.float32)))

    def forward(self, x):
        p = self.p
        return call_op(lambda v, m: jnp.where(m > 0, v / (1.0 - p), 0.0)
                       .astype(v.dtype), x, self.mask, op_name="dropout")


def _steps(jstep, tstep, ids, labels, n, before_ref=None):
    out = []
    for i in range(n):
        tl = float(tstep(inputs=(ids,), labels=(labels,)))
        if before_ref is not None:
            before_ref(i)
        jl = float(jstep(inputs=(_jt(ids),), labels=(_jt(labels),)))
        out.append((tl, jl))
    return out


def _pair(over, make_opt=None, prepare=None):
    """A reference model and the port's of the same seed (the numpy draws
    are the same) with their TrainSteps (AdamW by default); ``prepare``
    edits the reference model before its step is built (the step reads
    the buffers it finds then)."""
    jm = JaxGPT(jax_presets("gpt-test", **over), seed=SEED)
    if prepare is not None:
        prepare(jm)
    tm = GPTForCausalLM(gpt_presets("gpt-test", **over), seed=SEED,
                        device="cpu")
    if make_opt is None:
        jo = jopt.AdamW(learning_rate=LR, weight_decay=0.01,
                        parameters=jm.parameters())
        to = topt.AdamW(learning_rate=LR, weight_decay=0.01,
                        parameters=tm.parameters())
    else:
        jo, to = make_opt(jopt, jm), make_opt(topt, tm)
    jc = JaxCriterion()
    return (jm, tm, JaxTrainStep(jm, lambda a, b: jc(a, b), jo),
            TrainStep(tm, GPTPretrainingCriterion(), to))


# ------------------------------------------------------------------ dropout
def check_dropout_replayed_into_reference():
    p = 0.1
    ids, labels = _batch()

    def replace(jm):
        jm.gpt.embeddings.dropout = _Replay(p, (2, 32, 64))

    jm, tm, jstep, tstep = _pair({"dropout": p}, prepare=replace)
    with _masks() as seen:
        def replay(i):
            assert len(seen) == i + 1, f"{len(seen)} masks by step {i}"
            jm.gpt.embeddings.dropout.mask.set_value(
                seen[i].numpy().astype(np.float32))
        losses = _steps(jstep, tstep, ids, labels, 3, replay)
    for i, (tl, jl) in enumerate(losses):
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (i, tl, jl)
    # a different mask moves the loss: the replay reaches the step
    assert len({round(tl, 6) for tl, _ in losses}) == 3, losses


def check_dropout_at_the_embedding_only():
    p = 0.25
    tm = GPTForCausalLM(gpt_presets("gpt-test", dropout=p), seed=SEED,
                        device="cpu")
    ids = torch.from_numpy(_batch(5, b=16, s=128)[0])
    seen_io = []
    real = tgpt.dropout

    def spy(x, prob, *a, **kw):
        out = real(x, prob, *a, **kw)
        seen_io.append((x.detach().clone(), out.detach().clone()))
        return out

    tgpt.dropout = spy
    try:
        with _masks() as seen:
            tm(ids)
            assert len(seen) == 1 and len(seen_io) == 1, len(seen)
            mask = seen[0]
            assert tuple(mask.shape) == (16, 128, 64), mask.shape
            x, out = seen_io[0]
            tm.eval()
            tm(ids)
            assert len(seen) == 1, "eval mode drew a mask"
    finally:
        tgpt.dropout = real
    _share_ok(int((~mask).sum()), mask.numel(), p, "GPT embedding dropout")
    want = torch.where(mask, x / torch.tensor(1 - p), torch.zeros(()))
    assert torch.equal(out, want), "kept entries are not x / (1 - p)"


# ------------------------------------------------------------- attn_dropout
def check_attn_dropout_only_leaves_flash():
    ids = torch.from_numpy(_batch()[0])
    calls = []
    real = tgpt.flash_attention_val
    tgpt.flash_attention_val = lambda *a, **k: calls.append(1) or real(
        *a, **k)
    try:
        with _masks() as seen:
            drop = GPTForCausalLM(gpt_presets("gpt-test", attn_dropout=0.1),
                                  seed=SEED, device="cpu")(ids)
        assert not calls and not seen, (len(calls), len(seen))
    finally:
        tgpt.flash_attention_val = real
    einsum = GPTForCausalLM(gpt_presets("gpt-test",
                                        use_flash_attention=False),
                            seed=SEED, device="cpu")(ids)
    assert torch.equal(drop, einsum)
    # the reference, told it runs on a TPU: flash at attn_dropout 0, the
    # einsum path (dropping nothing) at 0.1
    routed = []

    def flash(*a, **k):
        routed.append(1)
        raise _Flash()

    saved = (jtarget.target_platform, jfa.flash_attention_sharded_ok,
             jgpt._flash_sharded)
    jtarget.target_platform = lambda: "tpu"
    jfa.flash_attention_sharded_ok = lambda shape: True
    jgpt._flash_sharded = flash
    try:
        with pytest.raises(_Flash):
            JaxGPT(jax_presets("gpt-test"), seed=SEED)(_jt(ids.numpy()))
        jd = JaxGPT(jax_presets("gpt-test", attn_dropout=0.1),
                    seed=SEED)(_jt(ids.numpy()))
    finally:
        (jtarget.target_platform, jfa.flash_attention_sharded_ok,
         jgpt._flash_sharded) = saved
    assert routed == [1], routed
    j0 = JaxGPT(jax_presets("gpt-test"), seed=SEED)(_jt(ids.numpy()))
    assert np.array_equal(np.asarray(jd._value), np.asarray(j0._value))
    assert float(np.abs(np.asarray(jd._value) - drop.detach().numpy())
                 .max()) <= 1e-4


class _Flash(Exception):
    pass


# --------------------------------------------------------- recompute_policy
def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("error", str(e))


def check_policies_resolve_as_reference():
    cases = [(None, False, 4), (None, True, 4),
             (("remat", "none", "offload", "remat"), False, 4),
             (("remat", "none"), False, 4),
             (("remat", "offload") * 4, False, 4),
             (("remat", "none", "remat", "remat", "remat", "none",
               "remat", "remat"), False, 4),
             (("remat", "none", "none", "remat", "none", "none", "none",
               "none"), False, 4),
             (("remat", "none", "offload", "none"), False, 2),
             (("none",) * 8, False, 3)]
    for pol, recompute, n in cases:
        layers = len(pol) if pol and len(pol) > 4 else 4
        tcfg = GPTConfig(num_layers=layers, recompute=recompute,
                         recompute_policy=pol)
        jcfg = JaxGPTConfig(num_layers=layers, recompute=recompute,
                            recompute_policy=pol)
        got = _outcome(lambda: tgpt._resolve_policies(tcfg, n))
        want = _outcome(lambda: jgpt._resolve_policies(jcfg, n))
        assert got == want, (pol, n, got, want)
    for pol, layers in ((("remat", "bogus"), 2), (("remat",) * 3, 4)):
        got = _outcome(lambda: GPTConfig(num_layers=layers,
                                         recompute_policy=pol))
        want = _outcome(lambda: JaxGPTConfig(num_layers=layers,
                                             recompute_policy=pol))
        assert got[0] == want[0] == "error" and got == want, (got, want)


def _loss_and_grads(pol):
    tm = GPTForCausalLM(gpt_presets("gpt-test", recompute_policy=pol),
                        seed=SEED, device="cpu")
    ids, labels = _batch()
    loss = GPTPretrainingCriterion()(tm(torch.from_numpy(ids)),
                                     torch.from_numpy(labels))
    loss.backward()
    return tm, loss.detach(), {n: p.grad for n, p in tm.named_parameters()}


def check_policies_same_bits():
    tgpt.reset_offload_bytes()
    _, base_loss, base = _loss_and_grads(("none",))
    for pol in (("remat",), ("offload",), ("offload", "remat"),
                ("none", "offload")):
        tm, loss, grads = _loss_and_grads(pol)
        assert [b.policy for b in tm.gpt.decoder] == list(
            tgpt._resolve_policies(tm.config, 2)), pol
        assert torch.equal(loss, base_loss), pol
        for n, g in grads.items():
            assert torch.equal(g, base[n]), (pol, n)
    assert tgpt._offload_kind() == "unpinned_host"
    assert tgpt.offload_bytes == 0


def check_policies_against_reference_train_step():
    ids, labels = _batch()
    for pol in (("none", "remat"), ("offload", "remat")):
        mode = "loop" if "offload" in pol else "scan"
        jm = JaxGPT(jax_presets("gpt-test", recompute_policy=pol,
                                mode=mode), seed=SEED)
        jo = jopt.AdamW(learning_rate=LR, weight_decay=0.01,
                        parameters=jm.parameters())
        jc = JaxCriterion()
        jstep = JaxTrainStep(jm, lambda a, b: jc(a, b), jo)
        tm = GPTForCausalLM(gpt_presets("gpt-test", recompute_policy=pol),
                            seed=SEED, device="cpu")
        tstep = TrainStep(tm, GPTPretrainingCriterion(),
                          topt.AdamW(learning_rate=LR, weight_decay=0.01,
                                     parameters=tm.parameters()))
        for i, (tl, jl) in enumerate(_steps(jstep, tstep, ids, labels, 2)):
            assert abs(tl - jl) <= POLICY_RTOL * abs(jl), (pol, i, tl, jl)


# ---------------------------------------------------------------- optimizers
OPTS = {
    "Lamb": lambda m, ps: m.Lamb(learning_rate=LR, parameters=ps),
    "Lars": lambda m, ps: m.Lars(learning_rate=LR, parameters=ps),
    "DGCMomentum": lambda m, ps: m.DGCMomentum(
        learning_rate=LR, parameters=ps, rampup_begin_step=0,
        sparsity=(0.999,)),
}


def _params_close(jm, tm, what):
    jp = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        a, b = p.detach().numpy(), jp[n]
        lim = PARAM_RTOL * float(np.abs(b).max()) + PARAM_ATOL
        err = float(np.abs(a - b).max())
        assert err <= lim, f"{what} {n}: {err:.3e} > {lim:.3e}"


def check_unfusable_in_train_step(name):
    make = OPTS[name]
    jm, tm, jstep, tstep = _pair(
        {}, lambda mod, model: make(mod, model.parameters()))
    assert isinstance(tstep.updater, PerParameterUpdater), tstep.updater
    ids, labels = _batch()
    for i, (tl, jl) in enumerate(_steps(jstep, tstep, ids, labels, 3)):
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (name, i, tl, jl)
    _params_close(jm, tm, name)
    assert tstep.optimizer._accumulated_steps == 3


def check_fusable_keep_the_one_launch():
    for name in ("SGD", "Momentum", "Adam", "AdamW", "Adagrad", "RMSProp"):
        tm = GPTForCausalLM(gpt_presets("gpt-test"), device="cpu")
        o = getattr(topt, name)(learning_rate=LR,
                                parameters=tm.parameters())
        step = TrainStep(tm, GPTPretrainingCriterion(), o)
        assert isinstance(step.updater, FusedFlatUpdater), name


def check_dgc_train_step_traced_once():
    """Reference caveat: its TrainStep reads ``_accumulated_steps`` at
    its trace, so ``rampup_begin_step=1`` never sparsifies there (its
    losses are its Momentum's); the port's sparsifies from step 2."""
    def dgc(mod, model):
        return mod.DGCMomentum(learning_rate=0.1, parameters=model.parameters(),
                               rampup_begin_step=1, sparsity=(0.999,))

    def momentum(mod, model):
        return mod.Momentum(learning_rate=0.1, momentum=0.9,
                            parameters=model.parameters())

    ids, labels = _batch()
    runs = {}
    for name, make in (("dgc", dgc), ("momentum", momentum)):
        _, _, jstep, tstep = _pair({}, make)
        runs[name] = _steps(jstep, tstep, ids, labels, 3)
    ref_dgc = [jl for _, jl in runs["dgc"]]
    ref_mom = [jl for _, jl in runs["momentum"]]
    port_dgc = [tl for tl, _ in runs["dgc"]]
    port_mom = [tl for tl, _ in runs["momentum"]]
    assert np.allclose(ref_dgc, ref_mom, rtol=LOSS_RTOL, atol=0), \
        "the reference's DGC TrainStep now ramps: drop this caveat"
    assert abs(port_dgc[2] - port_mom[2]) > 1e-3 * abs(port_mom[2]), \
        (port_dgc, port_mom)
    assert abs(port_dgc[1] - port_mom[1]) <= LOSS_RTOL * abs(port_mom[1])


def test_gpt_options_port_matches_reference(fresh_mesh):
    run_checks([
        (check_dropout_replayed_into_reference, ()),
        (check_dropout_at_the_embedding_only, ()),
        (check_attn_dropout_only_leaves_flash, ()),
        (check_policies_resolve_as_reference, ()),
        (check_policies_same_bits, ()),
        (check_policies_against_reference_train_step, ()),
        *((check_unfusable_in_train_step, (name,)) for name in OPTS),
        (check_fusable_keep_the_one_launch, ()),
        (check_dgc_train_step_traced_once, ()),
    ])
