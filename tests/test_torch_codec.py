"""Port codec (paddle_tpu_torch) against the JAX reference, on the CPU.

The same numpy inputs go through
  - the port's plain PyTorch codec (``paddle_tpu_torch.distributed.grad_comm``
    and the dispatching wrappers ``paddle_tpu_torch.ops.codec``), and
  - the reference's jnp pair (``paddle_tpu.distributed.grad_comm``) and its
    Pallas kernels in interpret mode (``paddle_tpu.ops.pallas.codec``).
Tolerance: none. Payload bits (int8 and float8_e4m3fn) and decoded fp32
values are compared for exact equality. The bf16 forms: a bf16 flat's
abs-max, payload (wire dtype and carrier, ``out=`` too) and residual,
and a decode to bf16 at world 2 and 3, bit for bit the reference's.

The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``
(``requires_cuda``, no JAX import) and ``chip_smoke.py`` hold them
against the plain versions. The file collects one test that runs every
case (``tests/torch_checks.py`` says why).
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import grad_comm as jgc
from paddle_tpu.ops.pallas import codec as jpc
from paddle_tpu_torch.distributed import grad_comm as tgc
from paddle_tpu_torch.ops import codec as tcodec
from torch_checks import run_checks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODECS = ("int8_block", "fp8_block")
CASES = [(5000, 1024), (4096, 1024), (777, 128), (1024, 128), (3000, 256),
         (2 * 256 + 3, 256)]


def _inputs(n, bs, codec, seed):
    """randn with the codec's edge cases planted: an all-zero block (scale
    floor 1e-12), a block whose scale is exactly 1 with x.5 ties (int8)
    or whose abs-max maps to |q| = 448 (fp8), and a ragged tail when
    ``n`` is not a multiple of ``bs``."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n).astype(np.float32)
    if n >= 3 * bs:
        x[:bs] = 0.0                                  # all-zero block
        blk = x[bs:2 * bs]
        qmax = tgc.QMAX[codec]
        blk[:] = np.clip(blk, -1, 1) * (qmax - 1)
        blk[0] = qmax                                 # scale == 1.0 exactly
        blk[1] = -qmax                                # hits the +-qmax bound
        blk[2:10] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    return x


def _bytes_jax(q, codec):
    q = np.asarray(q)
    if codec == "int8_block":
        return q.astype(np.int8).view(np.uint8)
    return np.asarray(jnp.asarray(q).astype(jnp.float8_e4m3fn)).view(np.uint8)


def _bytes_torch(q):
    return q.contiguous().view(torch.uint8).numpy()


def check_encode_bits_match_jnp_pair_and_pallas_kernel(codec, n, bs):
    x = _inputs(n, bs, codec, seed=n + bs)
    t_x = torch.from_numpy(x)
    t_s = tgc.block_scales(tgc.block_absmax(t_x, bs), codec)
    j_s = jgc.block_scales(jgc.block_absmax(jnp.asarray(x), bs), codec)
    assert np.array_equal(t_s.numpy(), np.asarray(j_s))
    t_q = tgc.block_encode(t_x, t_s, bs, codec)
    assert t_q.dtype == tgc.WIRE_DTYPE[codec]
    assert tuple(t_q.shape) == (-(-n // bs), bs)
    ref = jgc.block_encode(jnp.asarray(x), j_s, bs, codec)
    kern = jpc.block_encode(jnp.asarray(x), j_s, bs, codec)  # interpret mode
    assert np.array_equal(_bytes_torch(t_q), _bytes_jax(ref, codec))
    assert np.array_equal(_bytes_torch(t_q), _bytes_jax(kern, codec))
    # the wrapper on a CPU tensor is the plain version, and launches nothing
    before = tcodec.launch_counts()
    assert torch.equal(tcodec.block_encode(t_x, t_s, bs, codec).view(
        torch.uint8), t_q.view(torch.uint8))
    assert tcodec.launch_counts() == before


def check_decode_matches_jnp_pair_and_pallas_kernel(codec, n, bs, world):
    x = _inputs(n, bs, codec, seed=3 * n + bs)
    t_x = torch.from_numpy(x)
    t_s = tgc.block_scales(tgc.block_absmax(t_x, bs), codec)
    t_q = tgc.block_encode(t_x, t_s, bs, codec)
    j_s = jnp.asarray(t_s.numpy())
    j_q = jgc.block_encode(jnp.asarray(x), j_s, bs, codec)
    t_d = tcodec.block_decode(t_q, t_s, world, n)
    ref = jgc.block_decode(j_q, j_s, world, jnp.float32, n)
    kern = jpc.block_decode(j_q, j_s, world, jnp.float32, n)
    assert t_d.dtype == torch.float32 and t_d.shape == (n,)
    assert np.array_equal(t_d.numpy(), np.asarray(ref))
    if world & (world - 1) == 0:
        assert np.array_equal(t_d.numpy(), np.asarray(kern))
    else:
        # compiled, the reference kernel's divide by a constant world
        # becomes a multiply by its reciprocal; the port (like the jnp
        # pair) divides correctly rounded, so they agree to one rounding
        vals = (t_q.to(torch.float32) * t_s[:, None]).reshape(-1)[:n]
        assert np.array_equal(np.asarray(kern),
                              (vals * np.float32(1.0 / world)).numpy())
        assert np.allclose(t_d.numpy(), np.asarray(kern), rtol=2e-7, atol=0)


def _bf16_input(n, bs, codec, seed):
    """``_inputs`` rounded to bf16: the torch tensor and the same values
    as a JAX bf16 array."""
    t = torch.from_numpy(_inputs(n, bs, codec, seed)).to(torch.bfloat16)
    return t, jnp.asarray(t.to(torch.float32).numpy()).astype(jnp.bfloat16)


def check_bf16_encode_matches_reference(codec, n, bs, carrier):
    """A bf16 flat, encoded where it lies: abs-max, scales, the payload
    (wire dtype or carrier) and the error-feedback residual bit for bit
    the reference's, which lifts the bucket to fp32 first."""
    t_x, j_x = _bf16_input(n, bs, codec, seed=5 * n + bs)
    t_am, j_am = tgc.block_absmax(t_x, bs), jgc.block_absmax(j_x, bs)
    assert t_am.dtype == torch.float32
    assert np.array_equal(t_am.numpy().view(np.uint32),
                          np.asarray(j_am).view(np.uint32))
    t_s = tgc.block_scales(t_am, codec)
    j_s = jgc.block_scales(j_am, codec)
    assert np.array_equal(t_s.numpy(), np.asarray(j_s))
    t_q = tcodec.block_encode(t_x, t_s, bs, codec, carrier=carrier)
    ref = jgc.block_encode(j_x, j_s, bs, codec)          # the carrier
    if carrier:
        assert t_q.dtype == tgc.CARRIER_DTYPE[codec]
        assert np.array_equal(t_q.numpy(), np.asarray(ref))
    else:
        assert np.array_equal(_bytes_torch(t_q), _bytes_jax(ref, codec))
    out = torch.empty_like(t_q)
    assert tcodec.block_encode(t_x, t_s, bs, codec, carrier=carrier,
                               out=out) is out
    assert torch.equal(out.view(torch.uint8), t_q.view(torch.uint8))
    t_r = tgc.block_residual(t_x, t_q, t_s, n)
    j_r = jgc.block_residual(j_x, ref, j_s, n)
    assert t_r.dtype == torch.float32
    assert np.array_equal(t_r.numpy().view(np.uint32),
                          np.asarray(j_r).view(np.uint32))


def check_bf16_decode_matches_reference(codec, n, bs, world):
    """Two ranks' summed carriers decoded to bf16 (rounded once, from the
    fp32 ``q * scale / world``): bit for bit the reference's
    ``block_decode(..., jnp.bfloat16, numel)``."""
    x = _inputs(n, bs, codec, seed=7 * n + bs)
    y = _inputs(n, bs, codec, seed=7 * n + bs + 1) * np.float32(0.25)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    t_s = tgc.block_scales(tgc.block_absmax(tx, bs)
                           + tgc.block_absmax(ty, bs), codec)
    q = (tgc.block_encode(tx, t_s, bs, codec, carrier=True)
         + tgc.block_encode(ty, t_s, bs, codec, carrier=True))
    t_d = tcodec.block_decode(q, t_s, world, n, dtype=torch.bfloat16)
    ref = jgc.block_decode(jnp.asarray(q.numpy()), jnp.asarray(t_s.numpy()),
                           world, jnp.bfloat16, n)
    assert t_d.dtype == torch.bfloat16 and t_d.shape == (n,)
    assert np.array_equal(t_d.view(torch.int16).numpy(),
                          np.asarray(ref).view(np.int16))


def check_block_absmax_ragged_matches_reference(n, bs):
    """The port's abs-max takes a ragged tail on its own (no padded copy):
    bit for bit the reference's, which pads with zeros. The tail planted
    with negatives and -0.0."""
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    tail = n % bs
    x[n - tail:] = -np.abs(x[n - tail:])
    x[-1] = -0.0
    t = tgc.block_absmax(torch.from_numpy(x), bs)
    j = np.asarray(jgc.block_absmax(jnp.asarray(x), bs))
    assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
    assert np.array_equal(t.numpy().view(np.uint32), j.view(np.uint32))


def check_int8_clips_at_127_with_shared_scales():
    """Scales smaller than the local abs-max: the clip must hold."""
    bs = 128
    x = _inputs(4 * bs, bs, "int8_block", seed=11)
    t_s = tgc.block_scales(tgc.block_absmax(torch.from_numpy(x), bs),
                           "int8_block") / 4
    t_q = tgc.block_encode(torch.from_numpy(x), t_s, bs, "int8_block")
    ref = jgc.block_encode(jnp.asarray(x), jnp.asarray(t_s.numpy()), bs,
                           "int8_block")
    assert int(t_q.abs().max()) == 127
    assert np.array_equal(t_q.numpy().astype(np.int32), np.asarray(ref))


def check_zero_block_scale_floor():
    x = np.zeros(256, np.float32)
    t_s = tgc.block_scales(tgc.block_absmax(torch.from_numpy(x), 128),
                           "int8_block")
    assert np.array_equal(t_s.numpy(), np.full(2, np.float32(1e-12) / 127,
                                               np.float32))
    assert not tgc.block_encode(torch.from_numpy(x), t_s, 128,
                                "int8_block").any()


def check_wrapper_rejects_unknown_codec():
    with pytest.raises(ValueError):
        tcodec.block_encode(torch.zeros(8), torch.ones(1), 8, "int4_block")


def check_codec_module_imports_without_nvcc():
    """The wrappers import (and the CPU path runs) with no nvcc on PATH;
    the build happens inside the first CUDA launch only."""
    env = dict(os.environ, PATH="/nonexistent")
    code = ("import torch\n"
            "from paddle_tpu_torch.ops import codec\n"
            "q = codec.block_encode(torch.ones(8), torch.ones(1), 8, "
            "'int8_block')\n"
            "assert codec.launch_counts() == "
            "{'codec_encode': 0, 'codec_decode': 0}\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def check_build_names_library_by_source_hash():
    from paddle_tpu_torch.ops import _build

    path = _build.library_path("codec")
    assert path.parent == _build.build_dir()
    assert path.name.startswith("codec_") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS


def test_codec_port_matches_reference():
    run_checks(
        [(check_encode_bits_match_jnp_pair_and_pallas_kernel, (c, n, bs))
         for c in CODECS for n, bs in CASES]
        + [(check_decode_matches_jnp_pair_and_pallas_kernel, (c, n, bs, w))
           for c in CODECS for n, bs in CASES for w in (1, 2, 3)]
        + [(check_bf16_encode_matches_reference, (c, n, bs, carrier))
           for c in CODECS for n, bs in ((5000, 1024), (777, 128))
           for carrier in (False, True)]
        + [(check_bf16_decode_matches_reference, (c, n, bs, w))
           for c in CODECS for n, bs in ((5000, 1024), (777, 128))
           for w in (2, 3)]
        + [(check_block_absmax_ragged_matches_reference, (n, bs))
           for n, bs in ((1, 1024), (3, 1024), (1023, 1024), (1025, 1024),
                         (4099, 1024), (100_003, 1024), (777, 128),
                         (1_000_003, 1024))]
        + [(check_int8_clips_at_127_with_shared_scales, ()),
           (check_zero_block_scale_floor, ()),
           (check_wrapper_rejects_unknown_codec, ()),
           (check_codec_module_imports_without_nvcc, ()),
           (check_build_names_library_by_source_hash, ())])
