#!/usr/bin/env python3
"""Time variants of the bf16 flash kernels (paddle_tpu_torch/csrc/
flash_attention.cu) side by side on one card, at the shapes the port's
paths launch.

    python3 tools/torch_flash_ab.py [--parent PATH] [--variant NAME=PATH]
                                    [--only NAME,...] [--out FILE]

Builds, with ``ops/_build.py``'s nvcc flags, into build/flash_ab/ (all
of these, or ``--only`` the named ones; ptxas registers and spills
printed for the bf16 kernels each variant changes):
  new       csrc/flash_attention.cu as it stands;
  fwd_wg2   the same with two consumer warpgroups (128 query rows) a
            forward block (kFwdWarpgroups), no blocks-an-SM request;
  fwd_st2, fwd_st3
            two or three K/V stages in the forward's ring, not four
            (kFwdStages);
  fwd_mb2   ptxas asked for two forward blocks an SM at d <= 64, not
            three (kFwdMinBlocks);
  dkv_wg2   two consumer warpgroups (128 keys) a dkv block
            (kDkvWarpgroups);
  dkv_st2, dkv_st4
            two or four Q/dO stages in dkv's ring, not three
            (kDkvStages);
  dq_st2, dq_st4
            two or four K/V stages in dq's ring, not three (kDqStages);
  dq_mb1, dq_mb3
            ptxas asked for one or three dq blocks an SM at d <= 64, not
            two (kDqMinBlocks);
  parent    ``--parent``: an earlier flash_attention.cu with this one's
            C interface (write it first: ``git show <commit>:paddle_tpu_torch/
            csrc/flash_attention.cu > build/parent_flash.cu``);
  NAME      ``--variant NAME=PATH``: another flash_attention.cu.
Each variant runs through the port's own wrappers (ops/flash_attention.py,
its library swapped in), and its out, lse, dq, dk and dv are held
against the plain PyTorch versions within the bf16 limits of
tests/torch_checks.py at each shape before it is timed. Times are
chip_smoke.py's ``median_ms`` (median of 30, L2 flushed, a spin kernel
ahead) of flash_fwd_bf16, flash_dq_bf16 and flash_dkv_bf16, beside bf16
SDPA's forward and backward (the backward against the dq + dkv pair),
taken at each shape in the variants' order, then in the reverse order;
bounds are chip_smoke.py's ``flash_work`` at 989 TFLOP/s and 3.35 TB/s.
Shapes: b8 n12 s1024 d64 causal (every bf16 train launch) and b16 n12
s512 d64 full. Prints one line a shape, kernel and variant, then a JSON
summary (to ``--out`` instead where given). Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from chip_smoke import (FLASH_MAIN, flash_work, median_ms,  # noqa: E402
                        work_bound)
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from torch_checks import flash_err  # noqa: E402

SHAPES = ((FLASH_MAIN, True), ((16, 12, 512, 64), False))
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
PATCHES = {"new": (),
           "fwd_wg2": (("kFwdWarpgroups = 1;", "kFwdWarpgroups = 2;"),
                       ("kFwdMinBlocks = 3;", "kFwdMinBlocks = 1;")),
           "fwd_st2": (("kFwdStages = 4;", "kFwdStages = 2;"),),
           "fwd_st3": (("kFwdStages = 4;", "kFwdStages = 3;"),),
           "fwd_mb2": (("kFwdMinBlocks = 3;", "kFwdMinBlocks = 2;"),),
           "dkv_wg2": (("kDkvWarpgroups = 1;", "kDkvWarpgroups = 2;"),),
           "dkv_st2": (("kDkvStages = 3;", "kDkvStages = 2;"),),
           "dkv_st4": (("kDkvStages = 3;", "kDkvStages = 4;"),),
           "dq_st2": (("kDqStages = 3;", "kDqStages = 2;"),),
           "dq_st4": (("kDqStages = 3;", "kDqStages = 4;"),),
           "dq_mb1": (("kDqMinBlocks = 2;", "kDqMinBlocks = 1;"),),
           "dq_mb3": (("kDqMinBlocks = 2;", "kDqMinBlocks = 3;"),)}


def build(name: str, src: str) -> ctypes.CDLL:
    out_dir = _build.build_dir().parent / "flash_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-I", str(_build.CSRC), "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    # registers and spills of the bf16 kernels the variant changes (all
    # of them for new, parent and --variant sources)
    kern = name.split("_")[0] + "_wgmma"
    if kern not in ("fwd_wgmma", "dkv_wgmma", "dq_wgmma"):
        kern = "wgmma"
    entry = ""
    for line in proc.stderr.splitlines():
        if "Compiling entry" in line:
            entry = line
        if kern in entry and ("Used" in line or "spill" in line):
            print(name, entry.split("'")[1] if "'" in entry else entry,
                  line.strip(), flush=True)
    return ctypes.CDLL(str(so))


def variants(parent: str | None, others, only=None) -> dict:
    src = (_build.CSRC / "flash_attention.cu").read_text()
    srcs = {}
    for name, patches in PATCHES.items():
        if only and name not in only:
            continue
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in "
                                   f"flash_attention.cu")
            text = text.replace(old, new)
        srcs[name] = text
    for spec in others:
        name, path = spec.split("=", 1)
        srcs[name] = Path(path).read_text()
    if parent:
        srcs = {"parent": Path(parent).read_text(), **srcs}
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as ex:
        return dict(zip(srcs, ex.map(build, srcs, srcs.values())))


@contextlib.contextmanager
def using(lib):
    """The wrappers of ops/flash_attention.py launch ``lib``'s kernels
    inside (as tests/test_torch_cuda.py plants its faulty library)."""
    fa._lib.cache_clear()
    try:
        with mock.patch.object(fa, "load_library", lambda name: lib):
            yield
    finally:
        fa._lib.cache_clear()


def held(lib, q, k, v, do, lse, delta, causal, plain: dict) -> dict:
    """Each output's largest diff / limit against plain; raises over 1."""
    with using(lib):
        out, got_lse = fa.flash_fwd(q, k, v, causal)
        dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal)
        got = {"out": out, "lse": got_lse, "dk": dk, "dv": dv,
               "dq": fa.flash_dq(q, k, v, do, lse, delta, causal)}
    ratios = {n: flash_err(n, torch.bfloat16, got[n], plain[n])[1]
              for n in plain}
    if max(ratios.values()) > 1.0:
        raise AssertionError(f"differs from plain: {ratios}")
    return ratios


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an earlier flash_attention.cu")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH", help="another flash_attention.cu")
    ap.add_argument("--only", help="comma-separated variants of the "
                    "list above to build (default: all)")
    ap.add_argument("--out", help="write the JSON summary here, not to "
                    "the standard output")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    if only and only - set(PATCHES):
        ap.error(f"unknown variants {sorted(only - set(PATCHES))}")
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = variants(args.parent, args.variant, only)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows = []
    for shape, causal in SHAPES:
        q, k, v, do = (torch.randn(*shape, device=dev, generator=gen)
                       .bfloat16() for _ in range(4))
        out, lse = fa.flash_fwd_plain(q, k, v, causal)
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        plain = dict(zip(("dq", "dk", "dv"), fa.flash_bwd_plain(
            q, k, v, do, lse, delta, causal)), out=out, lse=lse)
        calls = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, causal),
                 "flash_dq": lambda: fa.flash_dq(q, k, v, do, lse, delta,
                                                 causal),
                 "flash_dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta,
                                                   causal)}
        label = f"{list(shape)} {'causal' if causal else 'full'} bf16"
        worst = {n: max(held(lib, q, k, v, do, lse, delta, causal,
                             plain).values())
                 for n, lib in libs.items()}
        print(f"{label}: every variant within the bf16 limits (largest "
              f"diff / limit " + ", ".join(f"{n} {r:.3f}"
                                           for n, r in worst.items())
              + ")", flush=True)
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        ref = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)
        yard = {
            "flash_fwd": lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal),
            "pair": lambda: torch.autograd.grad(ref, (qr, kr, vr), do,
                                                retain_graph=True)}
        ms = {}
        for name in [*libs, *reversed(libs)]:
            with using(libs[name]):
                for kern in KERNELS:
                    ms.setdefault((name, kern), []).append(
                        median_ms(calls[kern], flush))
        lib_ms = {y: [median_ms(fn, flush) for _ in range(2)]
                  for y, fn in yard.items()}
        for kern in KERNELS:
            bound_ms, bound_by = work_bound(*flash_work(shape, causal, kern,
                                                        2), bf16=True)
            for name in libs:
                t = ms[(name, kern)]
                print(f"{label} {kern + '_bf16':15s} {name:8s} "
                      + " / ".join(f"{x:.4f}" for x in t)
                      + f" ms, bound {bound_ms:.4f} {bound_by}", flush=True)
                rows.append({"shape": label, "kernel": kern + "_bf16",
                             "variant": name, "ms": t, "bound_ms": bound_ms,
                             "bound_by": bound_by})
        for name in libs:
            pair = [a + b for a, b in zip(ms[(name, "flash_dq")],
                                          ms[(name, "flash_dkv")])]
            print(f"{label} {'pair':15s} {name:8s} "
                  + " / ".join(f"{x:.4f}" for x in pair) + " ms", flush=True)
            rows.append({"shape": label, "kernel": "pair", "variant": name,
                         "ms": pair})
        for y, t in lib_ms.items():
            what = "SDPA forward" if y == "flash_fwd" else "SDPA backward"
            print(f"{label} {what:24s} " + " / ".join(f"{x:.4f}" for x in t)
                  + " ms", flush=True)
            rows.append({"shape": label, "kernel": what, "ms": t})
    out = json.dumps({"rows": rows})
    if args.out:
        Path(args.out).write_text(out + "\n")
        print(f"summary in {args.out}")
    else:
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
