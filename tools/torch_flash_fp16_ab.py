"""Time variants of the fp16 flash kernels (paddle_tpu_torch/csrc/
flash_attention.cu ``*_fp16``) side by side on one card, beside the bf16
forms of the same source.

    python3 tools/torch_flash_fp16_ab.py [--only new,noscale] \\
        [--variant NAME=PATH] [--out chiprun_out/fp16_ab.json]

Each variant is the current source with text patches (``PATCHES``; a
patch whose anchor is missing raises), built with ``_build.py``'s flags
and ``-Xptxas -v`` (the registers and spills of the 16-bit kernels are
printed), all in parallel. Every variant is held against the plain
versions within ``torch_checks.flash_fp16_limit`` first, at unit-scale dO
and at dO 2^-16 (``noscale``, a diagnostic that rounds dS as it is, is
held at unit scale only), then timed (median of 30 launches, L2 flushed,
``chip_smoke.median_ms``), forward then reverse order, at b8 n12 s1024
d64 causal and b16 n12 s512 d64 full, fp16 and bf16.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from chip_smoke import FLASH_BERT, FLASH_MAIN, median_ms  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402
from torch_checks import flash_vs_plain  # noqa: E402

SHAPES = ((FLASH_MAIN, True), (FLASH_BERT, False))
PATCHES = {
    "new": (),
    # dS rounded as it is: the cost of the remedy (fails at small dO)
    "noscale": (("int (&ks)[2]) {\n", "int (&ks)[2]) {\n  return;\n"),
                ("    return scale * exp2i(-k);",
                 "    return scale;")),
}


def build(name: str, src: str):
    out_dir = _build.build_dir().parent / "flash_fp16_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-I", str(_build.CSRC), "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    entry, regs = "", []
    for line in proc.stderr.splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        if "wgmma_kernel" in entry and ("Used" in line or "spill" in line):
            regs.append(f"{name} {entry[:60]} {line.strip()}")
    return so, regs


def variants(only, others) -> dict:
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out = {}
    for name, patches in PATCHES.items():
        if only and name not in only:
            continue
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {text.count(old)} "
                                   f"copies of {old!r}")
            text = text.replace(old, new)
        out[name] = text
    for spec in others:
        name, path = spec.split("=", 1)
        out[name] = Path(path).read_text()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    srcs = variants(only, args.variant)
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(lambda kv: build(*kv),
                                        srcs.items())))
    for _, regs in built.values():
        for line in regs:
            print(line, flush=True)
    libs = {n: ctypes.CDLL(str(so)) for n, (so, _) in built.items()}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    inputs = {}
    for shape, causal in SHAPES:
        for dt in (torch.float16, torch.bfloat16):
            q, k, v, do = (torch.randn(*shape, device=dev, generator=gen)
                           .to(dt) for _ in range(4))
            inputs[(shape, causal, dt)] = (q, k, v, do)

    def use(name):
        fa._lib.cache_clear()
        return mock.patch.object(fa, "load_library",
                                 lambda _n: libs[name])

    for name in libs:
        with use(name):
            for (shape, causal, dt), (q, k, v, do) in inputs.items():
                if dt != torch.float16:
                    continue
                scales = (1.0,) if name == "noscale" else (1.0, 2.0 ** -16)
                for sc in scales:
                    errs, _, _ = flash_vs_plain(
                        q, k, v, (do.float() * sc).to(dt), causal, sc)
                    print(f"{name} {list(shape)} causal={causal} dO x "
                          f"{sc:g}: largest diff / limit "
                          + ", ".join(f"{n} {r:.3f}"
                                      for n, (_, r) in errs.items()),
                          flush=True)
    rows = []
    order = list(libs) + list(reversed(libs))
    for i, name in enumerate(order):
        with use(name):
            for (shape, causal, dt), (q, k, v, do) in inputs.items():
                out, lse = fa.flash_fwd(q, k, v, causal)
                delta = (do.float() * out.float()).sum(-1, keepdim=True)
                calls = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, causal),
                         "flash_dq": lambda: fa.flash_dq(q, k, v, do, lse,
                                                         delta, causal),
                         "flash_dkv": lambda: fa.flash_dkv(q, k, v, do, lse,
                                                           delta, causal)}
                for kern, fn in calls.items():
                    ms = median_ms(fn, flush)
                    rows.append({"variant": name, "pass": int(i >= len(libs)),
                                 "shape": list(shape), "causal": causal,
                                 "dtype": str(dt).split(".")[-1],
                                 "kernel": kern, "ms": ms})
                    print(f"{name} pass {rows[-1]['pass']} {list(shape)} "
                          f"{rows[-1]['dtype']} {kern}: {ms:.4f} ms",
                          flush=True)
    fa._lib.cache_clear()
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
