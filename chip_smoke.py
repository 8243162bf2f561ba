#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; the last stdout line is printed only
when every phase passed):

  1. device   card name and power limit (nvidia-smi), torch/CUDA
              versions, the kernel build from csrc/ and its seconds;
  2. kernels  each CUDA codec kernel against its plain PyTorch version on
              the card, at the rows x 18,432 shapes the serve phase
              launches (see ``serve_shapes``): the decode step's batched
              append (8 rows), the prefix gather (128), the longest
              uncached prompt, and (labelled as launched by no path here)
              the 512-token prompt cap and the 1024-token context cap,
              for int8_block and fp8_block — payload and
              decode bit-identical; median ms over 30 launches (L2
              flushed before each) for the kernel, the plain version and,
              for int8, the one-call yardsticks torch.quantize_per_channel
              and torch.mul; the bound from bytes and operations at
              3.35 TB/s / 67 TFLOP/s fp32;
  3. serve    GPT-125M (full width and depth, random weights from seed 0)
              behind ServingEngine(max_batch=8) on an int8_block paged KV
              pool of 512 x 16-token blocks: 16 requests, prompts 32..512
              tokens, 4 sharing a 128-token prefix, 64 new tokens each,
              14 greedy + 2 sampled; launch counts reset just before and
              read just after; every request completes, no block leaks,
              both kernels launched;
  4. parity   prefill + 4 greedy decode steps of 2 prompts on the card and
              on the CPU (plain codecs), teacher-forced with the card's
              tokens: logits within 1e-3, equal argmax wherever the
              top-2 gap exceeds 1e-3.
  5. profile  torch.profiler over 8 decode-only steps at batch 8: device
              busy/idle share and device time by kernel.

Output: a JSON line of per-kernel numbers, then the device summary as the
last line. Exits non-zero without output when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, fp32 outside the tensor cores
EPT = 12 * 2 * 768          # GPT-125M KV elements per token
QB = 1024                   # KV quant block
MAIN_SHAPE = "decode_step_8"  # the shape behind most serve-phase launches


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ timing
def median_ms(fn, flush: torch.Tensor, runs: int = 30) -> float:
    """Device time of ``fn`` (median of ``runs``), L2 cold. A spin kernel
    ahead of each run keeps the card busy while the host enqueues the
    run's launches, so no host launch gap falls between the events."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(runs):
        flush.zero_()                      # evict the 50 MB L2
        torch.cuda._sleep(2_000_000)       # ~1 ms of spinning
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(n: int, nb: int, direction: str):
    """Least time (ms) for n elements: each input read once, each output
    written once, against the operations at the fp32 peak."""
    if direction == "encode":   # read x fp32 + scales, write 1-byte q
        nbytes, ops = 4 * n + 4 * nb + n, 4 * n   # div, round, 2 clamps
    else:                       # read 1-byte q + scales, write fp32
        nbytes, ops = n + 4 * nb + 4 * n, 2 * n   # mul, div
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phases
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.compile_source("codec")
    _build.load_library("codec")
    log(f"built {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s")


def serve_shapes(reqs) -> dict:
    """Rows (tokens x EPT) of the codec launches the serve phase makes:
    name -> (tokens, kernels launched at that shape). A decode step
    appends one row per running sequence in one batched append (8 rows
    at a full batch; 1-7 while the batch fills and drains); a
    prefix-cache admission gathers its 128 shared tokens (read-back
    only); a prompt without a cache hit appends all its rows at once
    (the longest such prompt of the traffic)."""
    prompt = max(r.n_prompt for r in reqs[4:])   # no shared prefix
    both = ("codec_encode", "codec_decode")
    return {"decode_step_8": (8, both),
            "prefix_gather_128": (128, ("codec_decode",)),
            f"prefill_{prompt}": (prompt, both)}


# the largest a 512-token prompt's append and a full 1024-token context's
# gather can be at this configuration; this traffic launches neither
CAP_SHAPES = {"prompt_cap_512": (512, ()), "context_cap_1024": (1024, ())}


def phase_kernels(dev, gen, shapes):
    from paddle_tpu_torch.distributed import grad_comm as plain
    from paddle_tpu_torch.ops import codec

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows = {}
    for codec_name in ("int8_block", "fp8_block"):
        for shape, (tokens, on_path) in shapes.items():
            n = tokens * EPT
            nb = n // QB
            x = torch.randn(n, device=dev, generator=gen) * 3.0
            x[:QB] = 0.0                                   # scale floor
            s = plain.block_scales(plain.block_absmax(x, QB), codec_name)
            q = codec.block_encode(x, s, QB, codec_name)
            q_plain = plain.block_encode(x, s, QB, codec_name)
            d = codec.block_decode(q, s, 1, n)
            d_plain = plain.block_decode(q_plain, s, 1, n)
            torch.cuda.synchronize()
            if not torch.equal(q.view(torch.uint8), q_plain.view(torch.uint8)):
                raise AssertionError(f"codec_encode {codec_name} {shape}: "
                                     f"payload differs from plain")
            if not torch.equal(d, d_plain):
                raise AssertionError(f"codec_decode {codec_name} {shape}: "
                                     f"differs from plain")
            r = {
                "shape": f"{tokens}x{EPT} {codec_name}", "on_path": on_path,
                "enc_err": float((q.float() - q_plain.float()).abs().max()),
                "dec_err": float((d - d_plain).abs().max()),
                "enc_ms": median_ms(
                    lambda: codec.block_encode(x, s, QB, codec_name), flush),
                "enc_plain_ms": median_ms(
                    lambda: plain.block_encode(x, s, QB, codec_name), flush),
                "dec_ms": median_ms(
                    lambda: codec.block_decode(q, s, 1, n), flush),
                "dec_plain_ms": median_ms(
                    lambda: plain.block_decode(q, s, 1, n), flush),
                "enc_library_ms": None, "dec_library_ms": None,
            }
            lib = ""
            if codec_name == "int8_block":
                # one-call yardsticks, timed here and used nowhere in the
                # port: per-block quantize (divides in double) and the
                # int8 x fp32 product (world = 1)
                zp = torch.zeros(nb, dtype=torch.long, device=dev)
                xq = torch.quantize_per_channel(x.view(nb, QB), s, zp, 0,
                                                torch.qint8).int_repr()
                differ = int((xq != q).sum())
                r["enc_library_ms"] = median_ms(
                    lambda: torch.quantize_per_channel(
                        x.view(nb, QB), s, zp, 0, torch.qint8), flush)
                r["dec_library_ms"] = median_ms(
                    lambda: torch.mul(q, s[:, None]), flush)
                lib = (f" | quantize_per_channel {r['enc_library_ms']:.4f} "
                       f"ms ({differ} of {n} values differ from the "
                       f"kernel's), torch.mul {r['dec_library_ms']:.4f} ms")
            r["enc_bound_ms"], r["enc_bound_by"] = bound(n, nb, "encode")
            r["dec_bound_ms"], r["dec_bound_by"] = bound(n, nb, "decode")
            rows[(codec_name, shape)] = r
            path = "+".join(on_path) or "none in this traffic"
            log(f"{codec_name:10s} {shape:17s} [path: {path}] "
                f"encode {r['enc_ms']:.4f} ms (plain "
                f"{r['enc_plain_ms']:.4f}, bound {r['enc_bound_ms']:.4f} "
                f"{r['enc_bound_by']}) | decode {r['dec_ms']:.4f} ms (plain "
                f"{r['dec_plain_ms']:.4f}, bound {r['dec_bound_ms']:.4f} "
                f"{r['dec_bound_by']}){lib} | bit-identical")
    del flush
    return rows


def _traffic(seed: int, vocab: int):
    from paddle_tpu_torch.serving import SamplingParams, ServeRequest

    rs = np.random.RandomState(seed)
    shared = rs.randint(0, vocab, 128)
    lengths = rs.randint(32, 513, 16)
    lengths[:4] = np.maximum(lengths[:4], 160)   # prefix + a tail
    sampled = SamplingParams(temperature=0.8, top_p=0.95)
    reqs = []
    for i, n in enumerate(lengths):
        prompt = rs.randint(0, vocab, int(n))
        if i < 4:
            prompt[:128] = shared
        reqs.append(ServeRequest(
            prompt_ids=prompt, max_new_tokens=64, request_id=f"smoke-{i}",
            sampling=sampled if i in (5, 11) else SamplingParams()))
    return reqs


def phase_serve(dm, seed: int):
    from paddle_tpu_torch.observability.metrics import get_registry
    from paddle_tpu_torch.ops import codec
    from paddle_tpu_torch.serving import (KVBlockPool, RequestQueue,
                                          ServeRequest, ServingEngine)

    pool = KVBlockPool(512, 16, dm.elems_per_token, codec="int8_block",
                       device=dm.device)
    queue = RequestQueue()
    engine = ServingEngine(dm, pool, queue, max_batch=8)
    log(f"pool: {pool.n_blocks} x {pool.block_tokens} tokens, "
        f"{pool._payload.numel() / 1e6:.1f} MB int8 payload")
    # warm-up (cuBLAS handles, allocator): one short request, off the books
    queue.submit(ServeRequest(prompt_ids=np.arange(32), max_new_tokens=4))
    while engine.step():
        pass
    reqs = _traffic(seed, dm.vocab_size)
    get_registry().reset()
    codec.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        if not queue.submit(r):
            raise AssertionError("queue rejected a request")
    steps = 0
    while engine.step():
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = codec.launch_counts()
    snap = get_registry().snapshot()

    bad = [r.request_id for r in reqs
           if r.outcome != "completed" or len(r.generated) != 64]
    if bad:
        raise AssertionError(f"requests not completed: {bad}")
    if pool.blocks_in_use:
        raise AssertionError(f"{pool.blocks_in_use} KV blocks leaked")
    for r in reqs:
        if not all(0 <= t < dm.vocab_size for t in r.generated):
            raise AssertionError(f"{r.request_id}: token out of range")
    hit = snap["serve_prefix_cache_hit_tokens_total"]
    if hit <= 0:
        raise AssertionError("the shared prefix never hit the cache")
    # every KV append encodes once and reads back once: one per prompt
    # (its rows, or its tail after a prefix hit), then one batched
    # append per decode step; each prefix-cache admission also gathers
    # its prefix once
    dstep = snap["serve_decode_step_ms"]
    appends = len(reqs) + dstep["count"]
    if counts["codec_encode"] <= 0 or counts["codec_decode"] <= 0:
        raise AssertionError(f"a kernel was not launched: {counts}")
    gathers = counts["codec_decode"] - counts["codec_encode"]
    log(f"launches {counts}: {len(reqs)} prompt appends + "
        f"{dstep['count']} decode-step appends, {gathers} prefix gathers")
    if counts["codec_encode"] != appends or gathers < 1:
        raise AssertionError("launch counts disagree with the KV appends")
    ttft = np.array([r.ttft_ms for r in reqs])
    gen = sum(len(r.generated) for r in reqs)
    summary = {
        "requests": len(reqs), "generated_tokens": gen,
        "prompt_tokens": int(sum(r.n_prompt for r in reqs)),
        "wall_s": wall, "tokens_per_s": gen / wall, "steps": steps,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "decode_step_ms_mean": dstep["mean"],
        "decode_steps": dstep["count"],
        "prefix_hit_tokens": hit,
        "prefill_tokens": snap["serve_prefill_tokens_total"],
        "launches": counts,
    }
    log("serve " + json.dumps(summary))
    return counts


def phase_parity(cuda_dm, cpu_dm):
    from paddle_tpu_torch.serving import KVBlockPool, bucket_pow2

    prompts = [np.arange(40) % 997, (np.arange(77) * 31) % 50000]
    runs = {}
    forced = None
    for name, dm in (("cuda", cuda_dm), ("cpu", cpu_dm)):
        pool = KVBlockPool(64, 16, dm.elems_per_token, codec="int8_block",
                           device=dm.device)
        tables = [pool.alloc_table(len(p) + 4) for p in prompts]
        last, kvs = dm.prefill(prompts)
        mirrors = [pool.append(t, kv) for t, kv in zip(tables, kvs)]
        logits = [last.cpu()]
        toks = forced[0] if forced else last.argmax(-1).cpu().tolist()
        trail = [toks]
        for step in range(4):
            n_past = [m.shape[0] for m in mirrors]
            S = bucket_pow2(max(n_past), minimum=16)
            past = torch.zeros(2, S, dm.elems_per_token, device=dm.device)
            for i, m in enumerate(mirrors):
                past[i, :m.shape[0]] = m
            lg, kv = dm.decode(toks, n_past, past, n_past)
            mirrors = [torch.cat([m, pool.append(t, kv[i:i + 1])])
                       for i, (m, t) in enumerate(zip(mirrors, tables))]
            logits.append(lg.cpu())
            toks = (forced[step + 1] if forced
                    else lg.argmax(-1).cpu().tolist())
            trail.append(toks)
        runs[name] = torch.stack(logits)
        forced = forced or trail       # the CPU run replays the card's tokens
    err = float((runs["cuda"] - runs["cpu"]).abs().max())
    top2 = runs["cpu"].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3
    same = runs["cuda"].argmax(-1) == runs["cpu"].argmax(-1)
    log(f"card vs CPU: max |logit diff| {err:.3e} over prefill + 4 decode "
        f"steps; argmax equal at {int(same[clear].sum())}/{int(clear.sum())}"
        f" clear positions")
    if not (err <= 1e-3 and bool(same[clear].all())):
        raise AssertionError("card and CPU disagree beyond 1e-3")
    if not torch.isfinite(runs["cuda"]).all():
        raise AssertionError("non-finite logits on the card")


def phase_profile(dm, seed: int, steps: int = 8):
    """A torch.profiler window over ``steps`` decode-only
    engine steps at full batch (8 x 256-token prompts): device busy share
    of the window and device time by kernel."""
    from paddle_tpu_torch.serving import (KVBlockPool, RequestQueue,
                                          ServeRequest, ServingEngine)
    from torch.profiler import ProfilerActivity, profile

    rs = np.random.RandomState(seed + 1)
    pool = KVBlockPool(512, 16, dm.elems_per_token, codec="int8_block",
                       device=dm.device)
    queue = RequestQueue()
    engine = ServingEngine(dm, pool, queue, max_batch=8)
    for i in range(8):
        queue.submit(ServeRequest(prompt_ids=rs.randint(0, dm.vocab_size,
                                                        256),
                                  max_new_tokens=steps + 16))
    while queue.depth or len(engine.running) < 8:
        engine.step()
    for _ in range(4):                 # settle into decode-only steps
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    log(f"profile: {steps} decode steps at batch 8, wall "
        f"{wall_us / steps / 1e3:.3f} ms/step, device busy "
        f"{busy_us / steps / 1e3:.3f} ms/step "
        f"({100 * busy_us / wall_us:.1f}% busy, "
        f"{100 * (1 - busy_us / wall_us):.1f}% idle), "
        f"{launches / steps:.0f} kernels/step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / steps:9.1f} us/step "
            f"{e.count / steps:6.1f}x  {e.key[:90]}")
    while engine.step():
        pass


def kernels_line(rows, counts):
    """One entry per kernel at the shape behind most of its serve-phase
    launches (the int8 decode-step append, 8 x EPT); ``at_shapes`` holds
    the other int8 shapes the serve phase launches it at."""
    from paddle_tpu_torch.ops.codec import KERNEL_SOURCE

    def numbers(r, p):
        return {"shape": r["shape"], "max_abs_err": r[f"{p}_err"],
                "ms": r[f"{p}_ms"], "plain_ms": r[f"{p}_plain_ms"],
                "bound_ms": r[f"{p}_bound_ms"],
                "bound_by": r[f"{p}_bound_by"],
                "library_ms": r[f"{p}_library_ms"]}

    out = []
    for name, p, line in (("codec_encode", "enc", 93),
                          ("codec_decode", "dec", 138)):
        int8 = {shape: r for (c, shape), r in rows.items()
                if c == "int8_block" and name in r["on_path"]}
        out.append(dict(
            name=name, route="cuda", source=KERNEL_SOURCE,
            replaces=f"paddle_tpu/ops/pallas/codec.py:{line}",
            launches=counts[name], **numbers(int8.pop(MAIN_SHAPE), p),
            at_shapes=[numbers(r, p) for r in int8.values()]))
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_presets
    from paddle_tpu_torch.serving import GPTDecodeModel

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    phase_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    cfg = gpt_presets("gpt-125m")
    rows = phase_kernels(dev, gen, {
        **serve_shapes(_traffic(args.seed, cfg.vocab_size)), **CAP_SHAPES})

    t0 = time.perf_counter()
    cpu_model = GPTForCausalLM(cfg, seed=0, device="cpu")
    cuda_model = GPTForCausalLM(cfg, seed=0, device=dev)
    log(f"gpt-125m weights (seed 0) on cpu and {dev} in "
        f"{time.perf_counter() - t0:.1f} s")
    cuda_dm = GPTDecodeModel(cuda_model)
    counts = phase_serve(cuda_dm, args.seed)
    phase_parity(cuda_dm, GPTDecodeModel(cpu_model))
    phase_profile(cuda_dm, args.seed)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line(rows, counts)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
