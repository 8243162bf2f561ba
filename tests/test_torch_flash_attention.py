"""Port flash attention (``paddle_tpu_torch/ops/flash_attention.py``)
against the JAX reference (``paddle_tpu/ops/flash_attention.py``) on the
CPU, where the port takes its plain versions and the reference runs its
Pallas kernels in interpret mode.

- ``flash_fwd`` (out, lse) against the reference's ``_fwd``, and
  ``flash_dq``/``flash_dkv`` and ``flash_bwd_split_tf32`` (the plain
  model of the CUDA backward's 3xTF32 operand rounding) against
  ``_bwd``, on ``[b, n, s, d]`` inputs made with numpy: causal and full,
  s in {16, 48}, d in {8, 16}, the reference with uneven blocks
  (block_q, block_k) = (8, 16) and (16, 8).
- ``flash_attention_val`` on ``[b, s, n, d]`` (autograd through the
  flash backward) against ``jax.vjp`` of the reference's
  ``flash_attention_val``: output and the three input gradients.

Tolerance: max abs diff <= 5e-6 on unit-scale inputs. The plain
versions take whole [s, s] score matrices while the reference streams
blocks with an online softmax; measured differences are <= 1.2e-6.

The file collects one test that runs every case (``tests/torch_checks.py``
says why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa
from torch_checks import run_checks

torch.set_num_threads(2)

TOL = 5e-6


def _close(a, b, what):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= TOL, f"{what}: max abs diff {err} > {TOL}"


def _inputs(shape, seed, n=4):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(n)]


def check_kernels_match_reference_pallas(s, d, causal, bq, bk):
    q, k, v, do = _inputs((2, 3, s, d), seed=s * d + bq)
    jo, jl = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal, bq, bk)
    jdq, jdk, jdv = jfa._bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jo, jl, jnp.asarray(do), causal, bq, bk)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    to, tl = tfa.flash_fwd(tq, tk, tv, causal)
    assert tl.shape == (2, 3, s, 1) and tl.dtype == torch.float32
    _close(jo, to, "out")
    _close(jl, tl, "lse")
    delta = (tdo * to).sum(-1, keepdim=True)
    _close(jdq, tfa.flash_dq(tq, tk, tv, tdo, tl, delta, causal), "dq")
    tdk, tdv = tfa.flash_dkv(tq, tk, tv, tdo, tl, delta, causal)
    _close(jdk, tdk, "dk")
    _close(jdv, tdv, "dv")
    # the model of the CUDA backward's 3xTF32 operand rounding
    split = tfa.flash_bwd_split_tf32(tq, tk, tv, tdo, tl, delta, causal)
    for name, jg, tg in zip(("dq", "dk", "dv"), (jdq, jdk, jdv), split):
        _close(jg, tg, f"{name} (3xTF32 model)")


def check_autograd_matches_reference_vjp(s, d, causal):
    q, k, v, do = _inputs((2, s, 3, d), seed=7 * s + d)
    out, vjp = jax.vjp(
        lambda q_, k_, v_: jfa.flash_attention_val(
            q_, k_, v_, causal=causal, block_q=8, block_k=16),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    to = tfa.flash_attention_val(tq, tk, tv, causal=causal)
    _close(out, to, "out")
    to.backward(torch.from_numpy(do))
    for name, jg, t in zip(("dq", "dk", "dv"), jgrads, (tq, tk, tv)):
        _close(jg, t.grad, name)


def check_plain_path_counts_no_launch():
    before = tfa.launch_counts()
    q = torch.randn(1, 2, 9, 16)
    tfa.flash_fwd(q, q, q, True)
    assert tfa.launch_counts() == before
    assert tfa.kernel_supported((1, 2, 9, 16))
    assert not tfa.kernel_supported((1, 2, 9, 8))
    assert not tfa.kernel_supported((1, 2, 9, 144))
    assert tfa.flash_attention_supported((2, 1024, 12, 64))


def test_flash_attention_matches_reference(fresh_mesh):
    run_checks(
        [(check_kernels_match_reference_pallas, (s, d, c, bq, bk))
         for s in (16, 48) for d in (8, 16) for c in (True, False)
         for bq, bk in ((8, 16), (16, 8))]
        + [(check_autograd_matches_reference_vjp, (s, 16, c))
           for s in (16, 48) for c in (True, False)]
        + [(check_plain_path_counts_no_launch, ())])
