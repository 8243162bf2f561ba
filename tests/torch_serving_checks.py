"""Serving checks shared by the CPU tests, the card tests and
``chip_smoke.py`` (JAX-free: the card's machine has no JAX).

- ``GapSampler``: a ``BatchSampler`` that records, for every row it
  samples, the margin of its decision (``decision_margin``), smallest
  overall and by (identity, position).
- ``drive``: submit requests to an engine and step it until every one is
  done.
- ``decision_margin``: how far a row's sampled token is from flipping,
  in logit units. A greedy row's margin is its top-2 logit gap. A
  sampled row's is the smaller of the logit change that moves the
  nearer edge of the chosen token's interval in the kept tokens'
  normalised cumulative mass onto the draw (the draw's distance to it
  times the temperature over twice the interval's upper edge) and the
  logit gaps from the chosen token to its sorted neighbours (a
  near-uniform distribution over a large vocabulary has both small).
- ``spec_rule``: the near-tie rule for speculative against plain
  tokens where the two runs' GEMMs differ in ``m`` (on the card):
  equal tokens, or, where a request differs, a decision margin below
  ``limit`` at its first differing position, read from a plain run of
  that request alone.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.serving import (BatchSampler, KVBlockPool,
                                      RequestQueue, ServeRequest,
                                      ServingEngine)

SPEC_TIE = 1e-3       # a token may flip only at a margin below this


def decision_margin(row: torch.Tensor, params, u: float) -> float:
    """The margin of one sampled decision (module docstring), in logit
    units, in float64 on the host."""
    x = row.detach().double().cpu()
    if params.temperature <= 0.0:
        top2 = x.topk(2).values
        return float(top2[0] - top2[1])
    V = x.numel()
    t = max(params.temperature, 1e-6)
    k = params.top_k if params.top_k > 0 else V
    z, _ = x.sort(descending=True, stable=True)
    s = z / t
    s = s.masked_fill(s < s[k - 1], float("-inf"))
    p = torch.softmax(s, 0)
    s = s.masked_fill(p.cumsum(0) - p >= params.top_p, float("-inf"))
    cdf = torch.softmax(s, 0).cumsum(0)
    cdf = cdf / cdf[-1]
    n_keep = int(torch.isfinite(s).sum())
    i = int(torch.searchsorted(cdf, torch.tensor([u], dtype=torch.float64),
                               right=True))
    i = min(i, n_keep - 1)
    lo = float(cdf[i - 1]) if i else 0.0
    hi = float(cdf[i])
    # logits moved by at most d move a boundary c by at most about
    # (2 d / t) c; and the chosen token swaps places with a sorted
    # neighbour once d reaches half their gap
    margins = [t * min(u - lo, hi - u) / (2.0 * hi)]
    if i:
        margins.append(float(z[i - 1] - z[i]))
    if i + 1 < n_keep:
        margins.append(float(z[i] - z[i + 1]))
    return min(margins)


class GapSampler(BatchSampler):
    """Records every sampled row's decision margin: ``min_gap`` over all
    rows, ``gaps[(identity, position)]`` the last one there."""

    def __init__(self, seed: int = 0):
        super().__init__(seed)
        self.min_gap = float("inf")
        self.gaps = {}

    def sample(self, logits, params, identities, positions):
        for row, p, ident, pos in zip(logits, params, identities, positions):
            u = self.stream.uniform(p.seed if p.seed is not None else ident,
                                    pos)
            g = decision_margin(row, p, u)
            self.gaps[(ident, pos)] = g
            self.min_gap = min(self.min_gap, g)
        return super().sample(logits, params, identities, positions)


def drive(engine, queue, reqs, max_steps: int = 4000):
    """Submit ``reqs`` and step ``engine`` until all are done and no
    block is held."""
    for r in reqs:
        assert queue.submit(r)
    for _ in range(max_steps):
        if not engine.step() and not engine.running and not queue.depth:
            break
    bad = [r.request_id for r in reqs if r.outcome != "completed"]
    assert not bad, f"requests not completed: {bad}"
    assert engine.pool.blocks_in_use == 0, engine.pool.stats()


def fresh(reqs):
    """Unsubmitted copies of ``reqs`` (same ids, prompts, sampling)."""
    return [ServeRequest(prompt_ids=r.prompt_ids,
                         max_new_tokens=r.max_new_tokens, eos_id=r.eos_id,
                         request_id=r.request_id, sampling=r.sampling)
            for r in reqs]


def plain_margin(dm, req, pos: int, pool_kw: dict) -> float:
    """The decision margin of ``req``'s token ``pos`` on the plain
    engine, the request run alone."""
    sampler = GapSampler()
    q = RequestQueue()
    eng = ServingEngine(dm, KVBlockPool(**pool_kw), q, max_batch=1,
                        sampler=sampler)
    drive(eng, q, fresh([req]))
    return sampler.gaps[(req.request_id, pos)]


def spec_rule(dm, plain, spec, pool_kw: dict, limit: float = SPEC_TIE):
    """Hold ``spec`` (finished requests) against ``plain`` (the same
    requests, finished on the plain engine) under the near-tie rule.
    Returns ``[(request_id, position, margin), ...]`` of the requests
    that differ; raises where one differs at a margin of ``limit`` or
    more."""
    differ = []
    for a, b in zip(plain, spec):
        assert a.request_id == b.request_id
        if a.generated == b.generated:
            continue
        pos = next((i for i, (x, y) in enumerate(zip(a.generated,
                                                     b.generated))
                    if x != y), min(len(a.generated), len(b.generated)))
        differ.append((a.request_id, pos, plain_margin(dm, a, pos,
                                                       pool_kw)))
    over = [d for d in differ if not d[2] < limit]
    assert not over, f"speculative tokens differ beyond a near-tie: {over}"
    return differ
