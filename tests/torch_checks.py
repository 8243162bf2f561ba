"""Shared runner and comparisons for the PyTorch-port checks
(``tests/test_torch_*.py`` and ``chip_smoke.py``).

Each test file collects exactly ONE test item that runs all of the
file's cases through :func:`run_checks`. The reason is the scheduler of
the suite's parallel run (pytest-xdist, ``--dist loadfile``): it orders
files by their number of collected tests, largest first, and hands them
to workers in that order. A new file with many tests lands mid-queue and
shifts every smaller file onto other workers, after other files; some
existing tests depend on what ran before them on their worker (a mesh or
flag left behind). A file with one test sorts after every existing file,
so adding it leaves the existing files' schedule as it was.

The comparisons below hold a kernel against its plain version on the
same inputs; the on-card test and ``chip_smoke.py`` both call them, so
the two hold the kernels to one set of criteria:

- flash attention: out and lse within 2e-5 max abs; dq, dk and dv each
  within 1e-4 of the larger of 1 and the plain gradient's largest
  magnitude (unit-scale inputs; a gradient that is zero in exact
  arithmetic, as dq at s = 1, is rounding noise on both sides);
- ``fused_update``: bit-identical parameters and slots;
- one Adam(W) training step on two devices: :func:`adam_step_parity`.
"""
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_update as fu

FLASH_TOL = {"out": 2e-5, "lse": 2e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4}
FUSED_HYPER = {"sgd": {}, "momentum": {"momentum": 0.9, "nesterov": True},
               "adam": {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8},
               "adamw": {"beta1": 0.9, "beta2": 0.999, "eps": 1e-8}}


def run_checks(checks):
    """Run every ``(fn, args)`` case, then fail once naming each case
    that failed (a skip still ends the run at once)."""
    failures = []
    for fn, args in checks:
        try:
            fn(*args)
        except Exception as e:
            failures.append(f"{fn.__name__}{tuple(args)}: "
                            f"{type(e).__name__}: {e}")
    if failures:
        raise AssertionError(f"{len(failures)} of {len(checks)} cases "
                             f"failed:\n" + "\n".join(failures))


def _max_abs(a, b) -> float:
    return float((a - b).abs().max())


def flash_vs_plain(q, k, v, do, causal: bool):
    """The three flash kernels and their plain versions on the same
    inputs. Returns ``(errs, lse, delta)``: ``errs`` maps out, lse, dq, dk
    and dv to (max abs diff, limit); raises when one is over its limit."""
    out, lse = fa.flash_fwd(q, k, v, causal)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do * out).sum(-1, keepdim=True)
    dq = fa.flash_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal)
    p_dq, p_dk, p_dv = fa.flash_bwd_plain(q, k, v, do, lse, delta, causal)
    errs = {}
    for name, a, b in (("out", out, p_out), ("lse", lse, p_lse),
                       ("dq", dq, p_dq), ("dk", dk, p_dk), ("dv", dv, p_dv)):
        scale = 1.0 if name in ("out", "lse") else max(float(b.abs().max()),
                                                       1.0)
        errs[name] = (_max_abs(a, b), FLASH_TOL[name] * scale)
    over = [f"{n} {e:.3e} > {lim:.3e}" for n, (e, lim) in errs.items()
            if not e <= lim]
    if over:
        raise AssertionError(f"flash {list(q.shape)} causal={causal}: max "
                             f"abs diff " + ", ".join(over))
    return errs, lse, delta


def fused_inputs(kind, n, gen, lr):
    """Seeded ``(p, g, slots, lr)`` for one ``kind`` update of ``n``
    elements on ``gen``'s device: unit-scale weights and gradients,
    moments of 1e-2 and, for Adam, the beta powers of step 3."""
    dev = gen.device
    p = torch.randn(n, device=dev, generator=gen)
    g = torch.randn(n, device=dev, generator=gen)
    slots = {nm: torch.randn(n, device=dev, generator=gen).abs() * 1e-2
             for nm in fu.slot_names(kind)}
    if kind in ("adam", "adamw"):
        slots["beta1_pow"] = torch.full((), 0.9 ** 3, device=dev)
        slots["beta2_pow"] = torch.full((), 0.999 ** 3, device=dev)
    return p, g, slots, torch.full((), lr, device=dev)


def fused_vs_plain(p, g, slots, lr, *, kind, hyper, wd) -> float:
    """``fused_update_flat`` on copies of ``p`` and ``slots`` against
    ``reference_update_flat`` on the originals. Returns the max abs
    difference over the parameters and every slot; raises unless they
    are bit-identical."""
    ref_p, ref_s = fu.reference_update_flat(p, g, slots, lr, kind=kind,
                                            hyper=hyper, wd=wd)
    kp = p.clone()
    _, ks = fu.fused_update_flat(kp, g, {k: v.clone() for k, v in
                                         slots.items()},
                                 lr, kind=kind, hyper=hyper, wd=wd)
    pairs = [("p", kp, ref_p)] + [(k, ks[k], v) for k, v in ref_s.items()]
    err = max(_max_abs(a, b) for _, a, b in pairs)
    differ = [n for n, a, b in pairs
              if not torch.equal(a.view(torch.int32), b.view(torch.int32))]
    if differ:
        raise AssertionError(f"fused_update {kind} wd={wd} n={p.numel()}: "
                             f"{differ} differ from plain (max abs diff "
                             f"{err:.3e})")
    return err


def adam_step_parity(card, cpu, lr, grad_rtol=1e-4, update_rtol=1e-2,
                     eps=1e-8):
    """Hold one Adam(W) first step on the card against one on the CPU.

    ``card`` and ``cpu`` map each parameter's name to ``(before, after,
    grad)`` on the CPU. Adam's first step moves a weight by
    ``lr * g / (|g| + eps)``: about ``lr`` whatever the size of ``g``, so
    a gradient at fp32 noise level becomes a step of up to ``lr`` set by
    the noise. Hence two checks:

    - every gradient within ``grad_rtol`` of its tensor's largest one;
    - every *clear* element (``|g| >= 100 eps``, so its step is within 1%
      of ``lr``, and ``|g|`` at least 10 times the tensor's largest
      card-vs-CPU gradient difference, so its sign is the same on both
      devices) moved on the card by the CPU's step within
      ``update_rtol * lr``, and by at least ``0.9 lr``; every parameter
      with a nonzero gradient has clear elements, so a bucket the card
      skipped would be caught.

    Returns the worst gradient ratio, the worst clear-element step
    difference over ``lr``, the share of clear elements and the largest
    parameter difference over all elements."""
    worst_g, worst_u, worst_p, clear_n, total = 0.0, 0.0, 0.0, 0, 0
    bad = []
    for name, (b0, b1, bg) in cpu.items():
        c0, c1, cg = card[name]
        if not torch.equal(c0, b0):
            bad.append(f"{name}: the devices started from other weights")
        gmax = float(bg.abs().max())
        gerr = _max_abs(cg, bg)
        total += bg.numel()
        worst_p = max(worst_p, _max_abs(c1, b1))
        if gmax == 0.0:
            if gerr:
                bad.append(f"{name}: gradient {gerr:.3e} on the card, 0 on "
                           f"the CPU")
            continue
        worst_g = max(worst_g, gerr / gmax)
        if gerr > grad_rtol * gmax:
            bad.append(f"{name}: gradients differ by {gerr / gmax:.3e} of "
                       f"the largest")
        clear = (bg.abs() >= 100 * eps) & (bg.abs() >= 10 * gerr)
        if not bool(clear.any()):
            bad.append(f"{name}: no gradient above the noise")
            continue
        clear_n += int(clear.sum())
        du_card, du_cpu = (c1 - c0)[clear], (b1 - b0)[clear]
        derr = _max_abs(du_card, du_cpu) / lr
        worst_u = max(worst_u, derr)
        if derr > update_rtol:
            bad.append(f"{name}: steps differ by {derr:.3e} lr")
        moved = float(du_card.abs().min()) / lr
        if moved < 0.9:
            bad.append(f"{name}: a clear element moved {moved:.3e} lr on "
                       f"the card")
    if bad:
        raise AssertionError("Adam step, card vs CPU: " + "; ".join(bad))
    return {"grad_rtol": worst_g, "clear_step_diff_lr": worst_u,
            "clear_share": clear_n / total, "param_max_abs_diff": worst_p}
