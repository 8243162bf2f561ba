"""Batched temperature/top-k/top-p sampling with per-request streams
(reference: ``paddle_tpu/serving/sampler.py``).

The one token-selection entry point of the engine. One batched pass on
the logits' device: temperature -> top-k -> top-p (nucleus in sorted
space: keep tokens whose cumulative probability before them is below
``top_p``; the head token always stays) -> a categorical draw by inverse
CDF. Temperature <= 0 is exactly ``argmax``; an all-greedy batch draws
nothing.

Randomness: row i's uniform comes from ``framework.random.CounterStream``
at (sampler seed, request identity or explicit seed, token position),
drawn on the host, so a request's tokens do not depend on the batch it
lands in or its row. The reference draws with JAX threefry keys from the
same triple; the bits differ, the determinism contract is the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..framework.device import to_device
from ..framework.random import CounterStream

__all__ = ["SamplingParams", "BatchSampler", "GREEDY", "default_sampler"]


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy. Defaults are exact greedy."""

    temperature: float = 0.0   # <= 0 -> argmax
    top_k: int = 0             # 0 -> disabled (full vocabulary)
    top_p: float = 1.0         # 1.0 -> disabled (no nucleus cut)
    seed: Optional[int] = None  # None -> derived from the request id

    def __post_init__(self):
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")


GREEDY = SamplingParams()


class BatchSampler:
    """Batched sampler over one deterministic stream space."""

    def __init__(self, seed: int = 0):
        self.stream = CounterStream(seed)

    def sample(self, logits: torch.Tensor,
               params: Sequence[SamplingParams],
               identities: Sequence,
               positions: Sequence[int]) -> torch.Tensor:
        """One token per row of ``logits`` [n, V] -> int64 [n] on the
        logits' device. ``identities[i]`` names row i's stream (unless its
        params pin a seed); ``positions[i]`` is the index of the token
        being sampled within that request's generation."""
        n, V = logits.shape
        if n != len(params) or n != len(identities) or n != len(positions):
            raise ValueError("sample wants one (params, identity, position) "
                             "per logits row")
        greedy = logits.argmax(dim=-1)
        if not any(p.temperature > 0.0 for p in params):
            return greedy
        dev = logits.device
        temps, top_p, u = to_device(
            [[p.temperature for p in params], [p.top_p for p in params],
             [self.stream.uniform(p.seed if p.seed is not None else ident,
                                  pos)
              for p, ident, pos in zip(params, identities, positions)]],
            dev, torch.float32)
        k = to_device([p.top_k if p.top_k > 0 else V for p in params], dev,
                      torch.long)
        scaled = logits.float() / temps.clamp_min(1e-6)[:, None]
        # sorted space: top-k is a rank cut, top-p a cumulative-mass cut
        slg, order = scaled.sort(dim=-1, descending=True, stable=True)
        kth = slg.gather(1, (k - 1).clamp(0, V - 1)[:, None])
        slg = slg.masked_fill(slg < kth, float("-inf"))
        probs = torch.softmax(slg, dim=-1)
        before = probs.cumsum(dim=-1) - probs
        slg = slg.masked_fill(before >= top_p[:, None], float("-inf"))
        cdf = torch.softmax(slg, dim=-1).cumsum(dim=-1)
        idx = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)
        # the kept tokens are a sorted prefix: never step past its end
        n_keep = torch.isfinite(slg).sum(dim=-1, keepdim=True)
        tok = order.gather(1, torch.minimum(idx, n_keep - 1)).squeeze(1)
        return torch.where(temps > 0.0, tok, greedy)


_default: Optional[BatchSampler] = None


def default_sampler() -> BatchSampler:
    """Process-wide sampler (stateless beyond its seed)."""
    global _default
    if _default is None:
        _default = BatchSampler(seed=0)
    return _default
