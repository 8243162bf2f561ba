#!/usr/bin/env python3
"""Time ``ce_chunk_bwd`` (paddle_tpu_torch/csrc/fused_ce.cu) beside an
earlier source of it on one card, at the chunk widths the fused loss
launches it at.

    python3 tools/torch_ce_ab.py --parent PATH [--out FILE]

Builds csrc/fused_ce.cu as it stands ("new") and ``--parent`` (an
earlier fused_ce.cu with the same C interface; write it first: ``git
show <commit>:paddle_tpu_torch/csrc/fused_ce.cu > build/parent_ce.cu``)
with ``ops/_build.py``'s nvcc flags into build/ce_ab/, and calls each
through its C entry point with ``ctypes``. At [8192, C] for BERT's
ragged last chunk (C = 5946 of 30,522 at chunk 8192) and GPT-125M's two
(8192 and 1152 of 50,304), with and without a bias, each is held against
the plain version (``ops/fused_ce.py`` ``ce_chunk_bwd_plain``) bit for
bit, then timed with chip_smoke.py's ``median_ms`` (median of 30, L2
flushed, a spin kernel ahead), parent, new, new, parent, beside
``torch.softmax`` over the chunk and the byte bound (the chunk read and
written once at 3.35 TB/s). Prints one line a width, form and bias, then
a JSON summary (to ``--out`` instead where given). Needs a CUDA card and
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
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from chip_smoke import HBM_BYTES_PER_S, median_ms  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import fused_ce as fce  # noqa: E402
from torch_checks import ce_inputs  # noqa: E402

ROWS = 8192
WIDTHS = ((5946, 24576, 30522), (8192, 40960, 50304),
          (1152, 49152, 50304))   # (columns, first column, vocabulary)


def build(name: str, src: Path) -> ctypes.CDLL:
    out = _build.build_dir().parent / "ce_ab" / f"{name}.so"
    lib = ctypes.CDLL(str(_build.compile_file(src, out)))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.ce_chunk_bwd.argtypes = [p, p, p, p, p, i64, i64, i64, p]
    lib.ce_chunk_bwd.restype = ctypes.c_int
    return lib


def call(lib, logit, bias, lse, labels, g, start) -> None:
    rc = lib.ce_chunk_bwd(logit.data_ptr(),
                          None if bias is None else bias.data_ptr(),
                          lse.data_ptr(), labels.data_ptr(), g.data_ptr(),
                          logit.shape[0], logit.shape[1], start,
                          torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"ce_chunk_bwd: CUDA error {rc}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="an earlier fused_ce.cu")
    ap.add_argument("--out", help="write the JSON summary here, not to "
                    "the standard output")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_ce_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = {"parent": build("parent", Path(args.parent)),
            "new": build("new", _build.CSRC / "fused_ce.cu")}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows = []
    for c, start, vocab in WIDTHS:
        logit, b, labels, _, lse, g = ce_inputs(ROWS, c, start, vocab, gen,
                                                dev, True, 100)
        label = f"[{ROWS}, {c}] fp32"
        bound = 8 * ROWS * c / HBM_BYTES_PER_S * 1e3
        for bias in (None, b):
            want = logit.clone()
            fce.ce_chunk_bwd_plain(want, bias, lse, labels, g, start)
            for name, lib in libs.items():
                got = logit.clone()
                call(lib, got, bias, lse, labels, g, start)
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} at {label}: differs from "
                                         f"plain")
            work = logit.clone()
            ms = {name: [] for name in libs}
            for name in ("parent", "new", "new", "parent"):
                ms[name].append(median_ms(lambda: call(
                    libs[name], work, bias, lse, labels, g, start), flush))
            form = "bias" if bias is not None else "no bias"
            for name, t in ms.items():
                print(f"{label} {form:7s} {name:6s} "
                      + " / ".join(f"{x:.4f}" for x in t)
                      + f" ms ({100 * bound / min(t):.1f}% of the bound "
                      f"{bound:.4f} bytes)", flush=True)
                rows.append({"shape": label, "bias": bias is not None,
                             "variant": name, "ms": t, "bound_ms": bound})
        lib_ms = [median_ms(lambda: torch.softmax(logit, -1), flush)
                  for _ in range(2)]
        print(f"{label} torch.softmax  " + " / ".join(f"{x:.4f}"
                                                     for x in lib_ms)
              + " ms", flush=True)
        rows.append({"shape": label, "variant": "torch.softmax",
                     "ms": lib_ms})
    out = json.dumps({"rows": rows})
    if args.out:
        Path(args.out).write_text(out + "\n")
        print(f"summary in {args.out}")
    else:
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
