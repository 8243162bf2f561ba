#!/usr/bin/env python3
"""Time the dequantizing optimizer update of one data-parallel step two
ways on one card: an earlier ``csrc/fused_update.cu`` that launches one
``fused_dequant_update`` kernel a bucket (its scalars prepared by
``scalar_prep``'s tensor ops before each launch), against the current
one launch of ``fused_dequant_update_buckets`` over every bucket.

    git show <commit>:paddle_tpu_torch/csrc/fused_update.cu \\
        > build/parent_fused_update.cu
    python3 tools/torch_dequant_ab.py --parent build/parent_fused_update.cu \\
        [--out FILE]

The step is GPT-125M's fp32 bucket plan (18 buckets, 124,475,904
elements; chip_smoke.py ``bucket_plan``), AdamW, each bucket's payload
two ranks' gradients encoded with their shared scales and summed
(int8_block, 1024-element blocks, world 2). Both forms start from the
same parameters and moments and are held bit for bit against each other
on one step before they are timed. Times are chip_smoke.py's
``median_ms`` (median of 30, L2 flushed, a spin kernel ahead: device
time) and ``span_ms`` (from an idle card, so the host's enqueue of the
18 launches and their scalar prep shows), in the order earlier, current,
current, earlier. The current kernel is timed also over the bf16 plan of
bench.py's configuration, which the earlier one refuses. Prints one line
a form and a JSON summary (also to ``--out``). Needs a CUDA card and
nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from chip_smoke import (DP_BLOCK, DP_WORLD, LR, bucket_plan,  # noqa: E402
                        bucket_updater, median_ms, span_ms, work_bound)
from paddle_tpu_torch.models import gpt_presets  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import fused_update as fu  # noqa: E402
from torch_checks import FUSED_HYPER, dequant_inputs, same_bits  # noqa: E402


def build_parent(src: Path) -> ctypes.CDLL:
    out_dir = _build.build_dir().parent / "dequant_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "parent.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(src)], capture_output=True, text=True, check=True)
    lib = ctypes.CDLL(str(so))
    p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    lib.fused_dequant_update.argtypes = [p, p, i, p, p, p, p, p,
                                         ctypes.c_int64, ctypes.c_int64, f,
                                         i, f, f, f, f, f, f, i, p]
    lib.fused_dequant_update.restype = ctypes.c_int
    return lib


def parent_step(lib, upd, pay, lr):
    """The earlier step_dequant: per bucket, scalar_prep's tensor ops for
    svec and the stepped powers, then one fused_dequant_update launch."""
    kind, hyper = "adamw", FUSED_HYPER["adamw"]
    stream = torch.cuda.current_stream().cuda_stream
    for b, (q, sc) in zip(upd.buckets, pay):
        slots = upd._slots[b.index]
        lm, wd = upd._hypers[b.index]
        svec, scal = fu.scalar_prep(kind, hyper, slots, lr, lm)
        p = upd._flat_p[b.index]
        rc = lib.fused_dequant_update(
            p.data_ptr(), q.data_ptr(), 0, sc.data_ptr(), None,
            slots["moment1"].data_ptr(), slots["moment2"].data_ptr(),
            svec.data_ptr(), p.numel(), DP_BLOCK, float(DP_WORLD), 3, wd,
            hyper["beta1"], hyper["beta2"], 1 - hyper["beta1"],
            1 - hyper["beta2"], hyper["eps"], 0, stream)
        if rc:
            raise RuntimeError(f"earlier fused_dequant_update: CUDA error "
                               f"{rc}")
        slots.update(scal)


def setup(buckets, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    upd = bucket_updater([b.size for b in buckets], gen,
                         [b.dtype for b in buckets])
    pay = [dequant_inputs("int8_block", b.size, DP_BLOCK, DP_WORLD, gen,
                          dtype=b.dtype) for b in buckets]
    return upd, pay


def bound(buckets):
    n = sum(b.size for b in buckets)
    nb = sum(-(-b.size // DP_BLOCK) for b in buckets)
    nbytes = sum(b.size * (4 + 2 * b.dtype.itemsize + 16)
                 for b in buckets) + 4 * nb
    return work_bound(nbytes, 22 * n)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    lib = build_parent(Path(args.parent))
    plan = bucket_plan(gpt_presets("gpt-125m"))
    lr = torch.full((), LR, device="cuda")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    # the two forms from the same state, one step each, bit for bit
    a, pay = setup(plan, 0)
    b, _ = setup(plan, 0)
    parent_step(lib, a, pay, lr)
    b.step_dequant(pay, DP_WORLD, DP_BLOCK)
    for bk in plan:
        i = bk.index
        pairs = [(a._flat_p[i], b._flat_p[i])] + [
            (a._slots[i][k], b._slots[i][k]) for k in a._slots[i]]
        if not all(same_bits(x, y) for x, y in pairs):
            raise AssertionError(f"bucket {i}: the two forms differ")
    print(f"the earlier 18-launch step and the one launch bit-identical "
          f"over {len(plan)} buckets", flush=True)
    table = b._dequant_table

    def current():
        fu.fused_dequant_update_buckets(table, lr, DP_WORLD)
        table.parity = 1 - table.parity

    forms = {"earlier": lambda: parent_step(lib, a, pay, lr),
             "current": current,
             "current_step": lambda: b.step_dequant(pay, DP_WORLD,
                                                    DP_BLOCK)}
    times = {k: [] for k in forms}
    for name in ("earlier", "current", "current_step", "current_step",
                 "current", "earlier"):
        ms = median_ms(forms[name], flush)
        sp = span_ms(forms[name], flush)
        times[name].append({"ms": ms, "span_ms": sp})
        print(f"fp32 plan {name}: {ms:.4f} ms device, {sp:.4f} ms from an "
              f"idle card", flush=True)
    bound_ms, bound_by = bound(plan)
    out = {"card": smi.stdout.strip(), "plan": "gpt-125m fp32",
           "buckets": len(plan), "bound_ms": bound_ms, "bound_by": bound_by,
           "times": times}
    plan16 = bucket_plan(gpt_presets("gpt-125m", max_position_embeddings=1024,
                                     dtype="bfloat16"))
    del a, b, pay, table
    torch.cuda.empty_cache()
    c, pay16 = setup(plan16, 1)
    c.step_dequant(pay16, DP_WORLD, DP_BLOCK)
    t16 = c._dequant_table

    def current16():
        fu.fused_dequant_update_buckets(t16, lr, DP_WORLD)
        t16.parity = 1 - t16.parity

    b16 = bound(plan16)
    out["bf16_plan"] = {"buckets": len(plan16), "ms": median_ms(current16,
                                                                flush),
                        "span_ms": span_ms(current16, flush),
                        "bound_ms": b16[0], "bound_by": b16[1]}
    print(f"bf16 plan current: {json.dumps(out['bf16_plan'])}", flush=True)
    print(json.dumps(out))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
