#!/usr/bin/env python3
"""Time variants of the bf16 ``quant_matmul`` kernels (paddle_tpu_torch/
csrc/quant_matmul.cu) side by side on one card, at the shapes phase 27 of
chip_smoke.py launches them at (int8 BERT-base under O2, at 16 x 512 and
at 1 x 64).

    python3 tools/torch_qmm_ab.py [--parent PATH] [--variant NAME=PATH]
                                  [--only NAME,...] [--out FILE]

Builds, with ``ops/_build.py``'s nvcc flags, into build/qmm_ab/ (all of
these, or ``--only`` the named ones; ptxas registers and spills printed
for the bf16 kernels), and times each at its route's shapes: m > 64
(``WGMMA_SHAPES``: the 16 x 512 forward's) or m <= 64 (``SMALL_SHAPES``:
the pooler and the NSP head at 16 x 512, every bf16 launch at 1 x 64):
  new        csrc/quant_matmul.cu as it stands: its wgmma route
             (``quant_matmul_bf16_wgmma``), m > 64;
  VARIANTS   the same source at other knobs (``KNOBS``, the constants'
             text patched): consumer warpgroups (64 columns of n each,
             ``kQmmWarpgroups``), rows of m a tile (``kQmmRows``), stages
             in the ring (``kQmmStages``);
  ss         the source patched (``PATCHES``) so that the consumers widen
             each stage of q a k-step ahead into bf16 shared memory, read
             from there by SS products (A transposed), not in registers;
  cluster    the new source's cluster route
             (``quant_matmul_bf16_cluster``), m <= 64;
  cluster_bn16, cluster_bn32, cluster_bn64
             the cluster route with every tile 16, 32 or 64 columns wide
             (``cluster_bn`` patched), m <= 64;
  cluster_w8 the cluster route with 8 warps a block (``kCWarps``): the
             tile's 16-column groups split k twice as finely;
  cluster_u4 the cluster route's k16 loop unrolled 4 times, not 2;
  mma_sync   the new source's ``mma.sync`` route (``quant_matmul_bf16``,
             with its k slices and workspace: the route of m <= 64 before
             the cluster route), at both shape sets;
  diagnostics, timed only (their results are wrong by design):
  only_mma   the producer fills the ring once and the consumers run every
             k-step on the stages it holds: the products and the widening
             without the loads;
  only_load  the consumers wait for every stage and release it without
             reading it: the loads alone;
  pure_mma   only_mma with constant A fragments (no ldmatrix, no
             widening): the products alone;
  c_only_load     the cluster route without its products (loads, the
                  partial sums' stores, the barriers and the reduction);
  c_no_load       the cluster route without its loads (the products on
                  whatever shared memory holds, and the reduction);
  c_local_reduce  the cluster route pushing its sums into its own
                  shared memory instead of their owners' (no distributed
                  shared memory stores; the barrier stays);
  c_empty         the cluster route's launch with a kernel that returns
                  at once: the floor of its grid and clusters;
  c_no_barrier    the cluster route without the barrier that guards the
                  first push;
  parent     ``--parent``: an earlier quant_matmul.cu, its wgmma entry
             point at m > 64 where it has one and its cluster entry point
             at m <= 64 where it has one, else its ``quant_matmul_bf16``
             (write it first: ``git show <commit>:paddle_tpu_torch/csrc/
             quant_matmul.cu > build/parent_qmm.cu``);
  NAME       ``--variant NAME=PATH``: another quant_matmul.cu, chosen like
             ``parent``.
Each variant is called through its C entry point with ``ctypes`` and held
against the plain PyTorch version within tests/torch_checks.py's
``qmm_bf16_limit`` at each shape before it is timed (the cluster forms
also bit-identical on a second run). Times are chip_smoke.py's
``median_ms`` (median of 30, L2 flushed, a spin kernel ahead), taken at
each shape in the variants' order, then in the reverse order, beside the
launch floor (a one-element ``torch.add`` timed the same way) and bf16
``torch.matmul`` on the weight dequantized to bf16 at the port's GEMM
settings (no reduced-precision reduction); bounds from bytes at 3.35 TB/s
and operations at 989 TFLOP/s bf16. Prints one line a shape and variant,
then a JSON summary (to ``--out`` instead where given). Needs a CUDA card
and nvcc.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from chip_smoke import median_ms, work_bound  # noqa: E402
from paddle_tpu_torch.framework.precision import (  # noqa: E402
    matmul_precision)
from paddle_tpu_torch.ops import _build  # noqa: E402
from torch_checks import qmm_bf16_limit  # noqa: E402

qm = importlib.import_module("paddle_tpu_torch.ops.quant_matmul")

# (m, k, n): the wgmma route's, and m <= 64 (the cluster route's)
WGMMA_SHAPES = ((8192, 768, 768), (8192, 3072, 768))
SMALL_SHAPES = ((16, 768, 768), (16, 768, 2), (64, 768, 768),
                (64, 3072, 768), (1, 768, 768), (1, 768, 2))
# the source's knobs: consumer warpgroups, rows of m a tile, stages in
# the ring (the constants' text, and its form at a variant's value)
KNOBS = (("kQmmWarpgroups = 2;", "kQmmWarpgroups = {};"),
         ("kQmmRows = 192;", "kQmmRows = {};"),
         ("kQmmStages = 4;", "kQmmStages = {};"))
# name -> its knobs
VARIANTS = {"wg2_r192_s5": (2, 192, 5), "wg2_r192_s6": (2, 192, 6),
            "wg2_r128_s6": (2, 128, 6), "wg3_r128_s6": (3, 128, 6),
            "wg2_r256_s4": (2, 256, 4)}
# "ss": SS products with A transposed (MN-major), read from bf16 shared
# memory that the consumers widen a stage of q into a k-step ahead (64 k
# rows of 128 bytes, 128-byte swizzle; columns 2j and 2j + 1 of each 16
# at positions j and j + 8, the register route's pairing)
SS_HELPERS = r"""#define PTT_O16(d, b) "+f"(d[b + 0]), "+f"(d[b + 1]), \
  "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), "+f"(d[b + 5]), \
  "+f"(d[b + 6]), "+f"(d[b + 7]), "+f"(d[b + 8]), "+f"(d[b + 9]), \
  "+f"(d[b + 10]), "+f"(d[b + 11]), "+f"(d[b + 12]), "+f"(d[b + 13]), \
  "+f"(d[b + 14]), "+f"(d[b + 15])
__device__ __forceinline__ void wgmma_ss_ta_n128(float (&d0)[32],
    float (&d1)[32], uint64_t a, uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : PTT_O16(d0, 0), PTT_O16(d0, 16), PTT_O16(d1, 0), PTT_O16(d1, 16)
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_ss_ta_n64(float (&d)[32], uint64_t a,
                                                uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : PTT_O16(d, 0), PTT_O16(d, 16) : "l"(a), "l"(b), "r"(1));
}
#undef PTT_O16

"""
SS_LOOP = r"""    unsigned char* abase = ring + ST * T::kStage;
    auto widen_stage = [&](int kt) {
      const unsigned char* qb =
          ring + (g0 + kt) % ST * T::kStage + T::kX + wg * T::kQ;
      unsigned char* ab = abase + (wg * 2 + ((g0 + kt) & 1)) * kBoxBytes;
      const int tw = threadIdx.x & 127, kr = tw >> 1, hf = tw & 1;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int c = 2 * hf + cc;
        const uint4 v = *reinterpret_cast<const uint4*>(
            qb + kr * 64 + 16 * (c ^ ((kr >> 1) & 3)));
        uint4 ev, od;
        widen_int8x4(v.x, ev.x, od.x);
        widen_int8x4(v.y, ev.y, od.y);
        widen_int8x4(v.z, ev.z, od.z);
        widen_int8x4(v.w, ev.w, od.w);
        unsigned char* row = ab + kr * 128;
        *reinterpret_cast<uint4*>(row + 16 * ((2 * c) ^ (kr & 7))) = ev;
        *reinterpret_cast<uint4*>(row + 16 * ((2 * c + 1) ^ (kr & 7))) = od;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    };
    auto mma_ss = [&](int kt) {
      const uint32_t xs = smem_u32(ring + (g0 + kt) % ST * T::kStage);
      const uint32_t as =
          smem_u32(abase + (wg * 2 + ((g0 + kt) & 1)) * kBoxBytes);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kK16; ++ks) {
        const uint64_t a = desc_sw128(as + 2048 * ks);
#pragma unroll
        for (int p = 0; p + 1 < P; p += 2)
          wgmma_ss_ta_n128(acc[p], acc[p + 1], a,
                           desc_sw128(xs + p * kBoxBytes + 32 * ks));
        if constexpr (P % 2 == 1)
          wgmma_ss_ta_n64(acc[P - 1], a,
                          desc_sw128(xs + (P - 1) * kBoxBytes + 32 * ks));
      }
      wgmma_commit();
    };
    full_wait(0);
    widen_stage(0);
    for (int kt = 0; kt < nkt; ++kt) {
      mma_ss(kt);
      if (kt > 0) {
        wgmma_wait<1>();
        release(kt - 1);
      }
      if (kt + 1 < nkt) {
        full_wait(kt + 1);
        widen_stage(kt + 1);
      }
    }
"""
# the register route's mainloop (its first and last lines), which SS_LOOP
# replaces
RS_LOOP = ("    full_wait(0);\n    load_a(0, a0);\n",
           "        load_a(kt + 2, a0);\n      }\n    }\n")
# text patches of the wgmma kernel: "ss" keeps its results; the others
# are diagnostics, timed only (their results are wrong by design)
PATCHES = {
    "ss": (
        ("// Persistent: a block an SM walks",
         SS_HELPERS + "// Persistent: a block an SM walks"),
        ("      hopper::kSwizzleAlign + ST * kStage + 8 * 2 * ST;",
         "      hopper::kSwizzleAlign + ST * kStage + WG * 2 * "
         "hopper::kBoxBytes + 8 * 2 * ST;"),
        ("  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * "
         "T::kStage);",
         "  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * "
         "T::kStage + WG * 2 * kBoxBytes);")),
    "only_mma": (
        ("        for (int kt = 0; kt < nkt; ++kt, ++g) {",
         "        for (int kt = 0; kt < nkt; ++kt, ++g) {\n"
         "          if (g >= ST) continue;"),
        ("    mbar_wait(&full[(g0 + kt) % ST], (g0 + kt) / ST & 1);",
         "    if (g0 + kt < ST) mbar_wait(&full[g0 + kt], 0);")),
    "only_load": (
        ("      ldmatrix_x4_trans(v,",
         "      if (kt < 0) ldmatrix_x4_trans(v,"),
        ("        wgmma_rs_n192_k(acc[0]",
         "        if (kt < 0) wgmma_rs_n192_k(acc[0]"),
        ("          wgmma_rs_n128_k(acc[p]",
         "          if (kt < 0) wgmma_rs_n128_k(acc[p]")),
}
# the products alone: only_mma with constant A fragments (no ldmatrix,
# no widening)
PURE = (("      ldmatrix_x4_trans(v, qs + r * 64 + 16 * (warp ^ ((r >> 1) & "
         "3)));\n"
         "      widen_int8x4(v[0], a[2 * h][0], a[2 * h][1]);\n"
         "      widen_int8x4(v[1], a[2 * h][2], a[2 * h][3]);\n"
         "      widen_int8x4(v[2], a[2 * h + 1][0], a[2 * h + 1][1]);\n"
         "      widen_int8x4(v[3], a[2 * h + 1][2], a[2 * h + 1][3]);\n",
         "      for (int i = 0; i < 4; ++i) {\n"
         "        a[2 * h][i] = qs ^ (lane * 8 + i);\n"
         "        a[2 * h + 1][i] = qs ^ (lane * 8 + 4 + i);\n"
         "      }\n"),)
PATCHES["pure_mma"] = PATCHES["only_mma"] + PURE
# text patches of the cluster kernel: the tile widths keep their results;
# the "c_" diagnostics are timed only
BN_ANCHOR = "  return n <= 16 ? 16 : n <= 32 ? 32 : 64;\n"
PATCHES.update({
    "cluster_bn16": ((BN_ANCHOR, "  return 16;\n" + BN_ANCHOR),),
    "cluster_bn32": ((BN_ANCHOR, "  return 32;\n" + BN_ANCHOR),),
    "cluster_bn64": ((BN_ANCHOR, "  return 64;\n" + BN_ANCHOR),),
    "cluster_w8": (("constexpr int kCWarps = 4;", "constexpr int kCWarps = 8;"),),
    "cluster_u4": (("#pragma unroll 2\n    for (int s = kw;",
                    "#pragma unroll 4\n    for (int s = kw;"),),
    "c_only_load": (("    for (int s = kw; s < steps; s += kws) {",
                     "    for (int s = kw; s < steps && k < 0; s += kws) {"),),
    "c_no_load": (("    cluster_load<NT, XV, QV>(xs, qs,",
                   "    if (k < 0) cluster_load<NT, XV, QV>(xs, qs,"),),
    "c_empty": (("  __shared__ float tile_scales[64];\n",
                 "  __shared__ float tile_scales[64];\n  if (k > 0) return;\n"),),
    "c_no_barrier": (
        ('  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");\n', ""),
        ('  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n', "")),
    "c_local_reduce": (
        ("    float* dst = cluster.map_shared_rank(recv, lc / cols) +",
         "    float* dst = recv + 0 * (lc / cols) +"),),
})
CHECKED = ("ss", "cluster_bn16", "cluster_bn32", "cluster_bn64",
           "cluster_w8", "cluster_u4")
# variants of the cluster route (entry point quant_matmul_bf16_cluster)
CLUSTER = ("cluster_bn16", "cluster_bn32", "cluster_bn64", "cluster_w8",
           "cluster_u4", "c_only_load", "c_no_load", "c_local_reduce",
           "c_empty", "c_no_barrier")


def patched(src: str, name: str) -> str:
    """``src`` with the text patches of ``name`` (``PATCHES``)."""
    if name == "ss":
        a, b = (src.index(x) for x in RS_LOOP)
        src = src[:a] + SS_LOOP + src[b + len(RS_LOOP[1]):]
    for old, new in PATCHES[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in quant_matmul.cu "
                               f"exactly once")
        src = src.replace(old, new)
    return src


def build(name: str, src: str) -> ctypes.CDLL:
    out_dir = _build.build_dir().parent / "qmm_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-I", str(_build.CSRC), "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    entry = ""
    for line in proc.stderr.splitlines():
        if "Compiling entry" in line:
            entry = line
        if "wgmma" in line and "erformance" in line:
            print(name, "ptxas:", line.strip(), flush=True)
        if ("qmm_bf16" in entry or "qmm_wgmma" in entry
                or "qmm_cluster" in entry) and (
                "Used" in line or "spill" in line):
            print(name, entry.split("'")[1] if "'" in entry else entry,
                  line.strip(), flush=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.quant_matmul_bf16.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.quant_matmul_splits.argtypes = [i, i, i]
    for entry in ("quant_matmul_bf16_wgmma", "quant_matmul_bf16_cluster"):
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = [p, p, p, p, i, i, i, p]
    return lib


def _entries(lib) -> dict:
    """shape set ("big": m > 64, "small": m <= 64) -> the entry point an
    earlier or other source is timed through."""
    def first(*names):
        return next(n for n in names if hasattr(lib, n))
    return {"big": first("quant_matmul_bf16_wgmma", "quant_matmul_bf16"),
            "small": first("quant_matmul_bf16_cluster", "quant_matmul_bf16")}


def libraries(parent: str | None, others=(), only=None) -> dict:
    """name -> (library, {shape set: its entry point's name})."""
    src = (_build.CSRC / "quant_matmul.cu").read_text()
    jobs = {"new": src}
    for name, knobs in VARIANTS.items():
        text = src
        for (old, new), value in zip(KNOBS, knobs):
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in "
                                   f"quant_matmul.cu exactly once")
            text = text.replace(old, new.format(value))
        jobs[name] = text
    for name in PATCHES:
        jobs[name] = patched(src, name)
    for spec in others:
        name, path = spec.split("=", 1)
        jobs[name] = Path(path).read_text()
    if parent:
        jobs["parent"] = Path(parent).read_text()
    from_new = {"cluster", "mma_sync"}
    if only:
        need = set(only) | ({"new"} if from_new & set(only) else set())
        jobs = {n: j for n, j in jobs.items() if n in need}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        built = dict(zip(jobs, ex.map(build, jobs, jobs.values())))
    wgmma = {"big": "quant_matmul_bf16_wgmma"}
    out = {}
    for n, lib in built.items():
        if only and n not in only:
            continue
        if n in CLUSTER:
            out[n] = (lib, {"small": "quant_matmul_bf16_cluster"})
        elif n in ("parent", *(o.split("=", 1)[0] for o in others)):
            out[n] = (lib, _entries(lib))
        else:
            out[n] = (lib, wgmma)
    if "new" in built:
        for n, entries in (("cluster", {"small": "quant_matmul_bf16_cluster"}),
                           ("mma_sync", {"big": "quant_matmul_bf16",
                                         "small": "quant_matmul_bf16"})):
            if not only or n in only:
                out[n] = (built["new"], entries)
    return out


def call(lib, entry: str, x, q, s):
    """One launch of ``entry`` into a new bf16 [m, n]."""
    (m, k), n = x.shape, q.shape[1]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    if entry != "quant_matmul_bf16":
        rc = getattr(lib, entry)(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                 out.data_ptr(), m, n, k, stream)
    else:
        splits = lib.quant_matmul_splits(m, n, k)
        ws = (torch.empty((splits, m, n), dtype=torch.float32,
                          device=x.device) if splits > 1 else None)
        rc = lib.quant_matmul_bf16(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                   out.data_ptr(),
                                   ws.data_ptr() if ws is not None else None,
                                   m, n, k, stream)
    if rc:
        raise RuntimeError(f"{entry}: CUDA error {rc}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an earlier quant_matmul.cu")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH", help="another quant_matmul.cu")
    ap.add_argument("--only", help="comma-separated variants to build "
                    "(default: all)")
    ap.add_argument("--out", help="write the JSON summary here, not to "
                    "the standard output")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    if not torch.cuda.is_available():
        print("torch_qmm_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = libraries(args.parent, args.variant, only)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    one = torch.zeros(1, device=dev)
    floor = median_ms(lambda: torch.add(one, 1.0), flush)
    print(f"launch floor (a one-element torch.add, timed the same way): "
          f"{floor:.4f} ms", flush=True)
    rows = [{"variant": "launch floor", "ms": [floor]}]
    for m, k, n in (*WGMMA_SHAPES, *SMALL_SHAPES):
        shape_set = "small" if m <= 64 else "big"
        here = {name: (lib, entries[shape_set])
                for name, (lib, entries) in libs.items()
                if shape_set in entries}
        if not here:
            continue
        x = torch.randn(m, k, device=dev, generator=gen).bfloat16()
        q, s = qm.quantize_int8(torch.randn(k, n, device=dev, generator=gen)
                                * 0.02)
        ref = qm.quant_matmul_plain(x, q, s)
        limit = qmm_bf16_limit(x, q, s, ref)
        label = f"({m}, {k}, {n}) bf16"
        worst = {}
        for name, (lib, entry) in here.items():
            got = call(lib, entry, x, q, s)
            if name in PATCHES and name not in CHECKED:
                continue
            ratio = float(((got.double() - ref.double()).abs()
                           / limit).max())
            if not ratio <= 1.0:
                raise AssertionError(f"{name} at {label}: largest diff / "
                                     f"limit {ratio:.3f}")
            if entry.endswith("_cluster") and not torch.equal(
                    got, call(lib, entry, x, q, s)):
                raise AssertionError(f"{name} at {label}: two runs differ")
            worst[name] = ratio
        print(f"{label}: every variant within qmm_bf16_limit (largest diff "
              f"/ limit " + ", ".join(f"{n_} {r:.4f}"
                                      for n_, r in worst.items()) + ")",
              flush=True)
        w = (q.float() * s).to(torch.bfloat16)
        ms = {}
        for name in [*here, *reversed(here)]:
            lib, entry = here[name]
            ms.setdefault(name, []).append(median_ms(
                lambda: call(lib, entry, x, q, s), flush))
        with matmul_precision("float32"):
            lib_ms = [median_ms(lambda: torch.matmul(x, w), flush)
                      for _ in range(2)]
        bound_ms, bound_by = work_bound(2 * m * k + k * n + 4 * n + 2 * m * n,
                                        2 * m * n * k, bf16=True)
        for name, t in ms.items():
            print(f"{label} {name:14s} " + " / ".join(f"{v:.4f}" for v in t)
                  + f" ms ({100 * bound_ms / min(t):.1f}% of the bound "
                  f"{bound_ms:.4f} {bound_by}; {min(t) / min(lib_ms):.3f}x "
                  f"bf16 torch.matmul)", flush=True)
            rows.append({"shape": label, "variant": name,
                         "entry": here[name][1], "ms": t,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "err_over_limit": worst.get(name)})
        print(f"{label} {'torch.matmul':14s} "
              + " / ".join(f"{v:.4f}" for v in lib_ms) + " ms", flush=True)
        rows.append({"shape": label, "variant": "torch.matmul bf16",
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
