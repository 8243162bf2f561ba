#!/usr/bin/env python3
"""Time variants of the CUDA codec kernels (paddle_tpu_torch/csrc/codec.cu)
side by side on one card, at the shapes the port's paths launch.

    python3 tools/torch_codec_ab.py [--parent PATH] [--variant NAME=PATH]
                                    [--out FILE]

Builds, with ``ops/_build.py``'s nvcc flags, into build/codec_ab/:
  new     csrc/codec.cu as it stands;
  stcs    the same with streaming stores (__stcs);
  ldg, ldcg, ldlu, ld
          the same with read-only cached (__ldg), L2-only (__ldcg),
          last-use (__ldlu) or plain loads in place of the streaming ones
          (__ldcs);
  div     the same with a zero input divided like any other (the
          kernel skips the divide for it);
  q1, q4  the same with 1 or 4 quads in flight a thread (kQuads);
  parent  ``--parent``: an earlier codec.cu whose codec_encode takes no
          element count (it is given a zero-padded copy of a ragged
          input, made inside the timed call, as its wrapper made it) and
          whose kernels take no element type (fp32 only);
  NAME    ``--variant NAME=PATH``: another codec.cu with this one's C
          interface (fp32 in and out here);
  copy    not a codec: a device-to-device copy (torch copy_) moving
          the row's bytes (half read, half written), the memory
          system's practical rate for that many bytes.
Every variant's payload and decode are held bit for bit against the
plain PyTorch versions (distributed/grad_comm.py) at every shape before
it is timed. Times are chip_smoke.py's ``median_ms`` (median of 30, L2
flushed, a spin kernel ahead), taken at each shape in the variants'
order, then in the reverse order; bounds are chip_smoke.py's
``bound``. Shapes: the serve path's int8 wire at 8, 128, 392 and 1024
tokens of GPT-125M (18,432 elements a token), encode and decode, and
the int32 carrier of every GPT-125M gradient bucket size; then inputs
holding zeros (a zero block in a serving row, a wte gradient bucket
with most rows zero). Prints one line a shape and variant, then a JSON
summary (also to ``--out``).
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (EPT, HBM_BYTES_PER_S, bound,  # noqa: E402
                        median_ms)
from paddle_tpu_torch.distributed import grad_comm as plain  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402

BS = 1024
TOKENS = (8, 128, 392, 1024)
BUCKETS = (2304, 4725504, 4726272, 5316096, 6495744, 5511168, 38633472)
ZERO_ROWS = 0.84
PATCHES = {"new": (), "stcs": (("*reinterpret_cast<Q*>(p) = v;",
                                 "__stcs(reinterpret_cast<Q*>(p), v);"),),
           "ldg": (("__ldcs(", "__ldg("),),
           "ldcg": (("__ldcs(", "__ldcg("),),
           "ldlu": (("__ldcs(", "__ldlu("),),
           "ld": (("__ldcs(reinterpret_cast<const Q*>(p))",
                   "*reinterpret_cast<const Q*>(p)"),),
           "div": (("x == 0.0f && s > 0.0f ? x : __fdiv_rn(x, s)",
                    "__fdiv_rn(x, s)"),),
           "q1": (("kQuads = 2;", "kQuads = 1;"),),
           "q4": (("kQuads = 2;", "kQuads = 4;"),)}


def build(name: str, src: str) -> ctypes.CDLL:
    out_dir = _build.build_dir().parent / "codec_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", str(so), str(cu)],
                          capture_output=True, text=True, check=True)
    if name == "new":   # registers and spills of each kernel
        print("\n".join(line.strip() for line in proc.stderr.splitlines()
                        if "Compiling entry" in line or "Used" in line
                        or "spill" in line), flush=True)
    lib = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.codec_encode.argtypes = ([p, p, p, i64, i64, i32, i32, p]
                                 if name == "parent" else
                                 [p, p, p, i64, i64, i64, i32, i32, i32, p])
    lib.codec_decode.argtypes = ([p, p, p, i64, i64, i64, i32,
                                  ctypes.c_float, p] if name == "parent" else
                                 [p, p, p, i64, i64, i64, i32,
                                  ctypes.c_float, i32, p])
    return lib


def variants(parent: str | None, others) -> dict:
    src = (ROOT / "paddle_tpu_torch/csrc/codec.cu").read_text()
    srcs = {}
    for name, patches in PATCHES.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in codec.cu")
            text = text.replace(old, new)
        srcs[name] = text
    for spec in others:
        name, path = spec.split("=", 1)
        srcs[name] = Path(path).read_text()
    if parent:
        srcs = {"parent": Path(parent).read_text(), **srcs}
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as ex:
        libs = dict(zip(srcs, ex.map(build, srcs, srcs.values())))
    return libs


def encoder(name, lib, x, s, carrier):
    n, nb = x.numel(), s.numel()
    dtype = torch.int32 if carrier else torch.int8
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        out = torch.empty((nb, BS), dtype=dtype, device=x.device)
        if name == "parent":
            xp = F.pad(x, (0, nb * BS - n)) if n != nb * BS else x
            rc = lib.codec_encode(xp.data_ptr(), s.data_ptr(), out.data_ptr(),
                                  nb, BS, 0, int(carrier), stream)
        else:
            rc = lib.codec_encode(x.data_ptr(), s.data_ptr(), out.data_ptr(),
                                  n, nb, BS, 0, int(carrier), 0, stream)
        if rc:
            raise RuntimeError(f"{name} codec_encode: CUDA error {rc}")
        return out
    return run


def decoder(name, lib, q, s, n):
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        out = torch.empty(n, dtype=torch.float32, device=q.device)
        args = () if name == "parent" else (0,)   # fp32 out
        rc = lib.codec_decode(q.data_ptr(), s.data_ptr(), out.data_ptr(),
                              s.numel(), BS, n, 0, 1.0, *args, stream)
        if rc:
            raise RuntimeError(f"{name} codec_decode: CUDA error {rc}")
        return out
    return run


def copier(bound_ms, device):
    """A device-to-device copy of the bytes a bound of ``bound_ms`` moves
    at HBM_BYTES_PER_S, half of them read and half written."""
    half = int(bound_ms * 1e-3 * HBM_BYTES_PER_S) // 2
    src = torch.empty(half, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    return lambda: dst.copy_(src)


def encode_row(label, x, libs, flush, rows, carrier=True):
    """Every variant's encode of ``x`` (the carrier, or the 1-byte wire)
    against the plain encode, bit for bit, then timed."""
    n = x.numel()
    nb = -(-n // BS)
    s = plain.block_scales(plain.block_absmax(x, BS), "int8_block")
    q_ref = plain.block_encode(x, s, BS, "int8_block", carrier=carrier)
    enc = {k: encoder(k, lib, x, s, carrier) for k, lib in libs.items()}
    for k in libs:
        if not torch.equal(enc[k](), q_ref):
            raise AssertionError(f"{k} {label} differs from plain")
    kind = "carrier" if carrier else "encode"
    bound_ms = bound(n, nb, kind, nb * BS)[0]
    enc["copy"] = copier(bound_ms, x.device)
    timed(f"{kind} {nb}x{BS} {label}", enc, flush, bound_ms, rows)


def timed(label, fns, flush, bound_ms, rows):
    ms = {}
    for name in [*fns, *reversed(fns)]:
        ms.setdefault(name, []).append(median_ms(fns[name], flush))
    for name, t in ms.items():
        print(f"{label:44s} {name:7s} "
              + " / ".join(f"{v:.4f}" for v in t)
              + f" ms, bound {bound_ms:.4f}, share "
              + " / ".join(f"{bound_ms / v:.0%}" for v in t), flush=True)
    rows.append({"shape": label, "bound_ms": bound_ms, "ms": ms})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an earlier codec.cu to time beside")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH", help="another codec.cu to time")
    ap.add_argument("--out", help="write the JSON summary here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_codec_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = variants(args.parent, args.variant)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows = []
    for tokens in TOKENS:
        n = tokens * EPT
        nb = n // BS
        x = torch.randn(n, device=dev, generator=gen) * 3.0
        s = plain.block_scales(plain.block_absmax(x, BS), "int8_block")
        q_ref = plain.block_encode(x, s, BS, "int8_block")
        d_ref = plain.block_decode(q_ref, s, 1, n)
        enc = {k: encoder(k, lib, x, s, False) for k, lib in libs.items()}
        dec = {k: decoder(k, lib, q_ref, s, n) for k, lib in libs.items()}
        for k in libs:
            if not (torch.equal(enc[k](), q_ref) and torch.equal(dec[k](),
                                                                 d_ref)):
                raise AssertionError(f"{k} at {tokens} tokens differs from "
                                     f"plain")
        for fns, kind in ((enc, "encode"), (dec, "decode")):
            bound_ms = bound(n, nb, kind)[0]
            fns["copy"] = copier(bound_ms, dev)
            timed(f"{kind} {tokens}x{EPT} int8", fns, flush, bound_ms, rows)
    for n in BUCKETS:
        encode_row(f"(bucket {n})",
                    torch.randn(n, device=dev, generator=gen) * 1e-3, libs,
                    flush, rows)
    # zeros in the input: the serving rows with one all-zero block, as
    # chip_smoke.py phase 2 plants, and the wte gradient bucket (50304 x
    # 768) with the rows a b8 s1024 step leaves zero (at least 1 - 8192 /
    # 50304 of them; ZERO_ROWS)
    for tokens in (8, 1024):
        x = torch.randn(tokens * EPT, device=dev, generator=gen) * 3.0
        x[:BS] = 0.0
        encode_row(f"{tokens}x{EPT}, one zero block", x, libs, flush, rows,
                    carrier=False)
    x = torch.randn(50304, 768, device=dev, generator=gen) * 1e-3
    x[torch.rand(50304, device=dev, generator=gen) < ZERO_ROWS] = 0.0
    encode_row(f"(wte bucket, {ZERO_ROWS:.0%} of rows zero)", x.reshape(-1),
                libs, flush, rows)
    out = json.dumps({"rows": rows})
    if args.out:
        Path(args.out).write_text(out + "\n")
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
