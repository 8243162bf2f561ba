"""Decode-model adapter: GPT parameters -> prefill/decode/extend steps
(reference: ``paddle_tpu/serving/model.py``).

  prefill(prompts)                  one pass over whole prompts -> logits
                                    at each last prompt position + the
                                    per-token KV payload to cache
  decode(ids, pos, past, past_len)  one token per sequence against the
                                    cached KV -> next-token logits + the
                                    new token's KV row
  extend(ids, pos, past, past_len, tail_len)
                                    a ragged multi-token tail against the
                                    cached KV (prefix-cache tail prefill,
                                    the speculative step's verification)

``truncated(n)`` is a draft model for speculative decoding: the first
``n`` blocks under the same embeddings and final norm, its parameters
views of this model's stacked ones (no copy). ``param_list()`` is the
flat parameter list, sorted by name, that the replica guard digests.

The block parameters are stacked ``[L, ...]`` on the model's device once;
a Python loop over layers takes the place of the reference's
``lax.scan``. The block math is the reference's: LayerNorm in fp32
(its affine too) cast back to the input's dtype, tanh-approximate gelu,
plain matmul attention with the same masking (``finfo.min`` of the
logits' dtype on masked logits) and the softmax in fp32 cast to v's
dtype; fp32 products with TF32 off, entered by each step
(``framework.precision.matmul_precision``), whatever the caller set
process-wide. Batch and context are rounded up to the reference's
power-of-two buckets, so padded shapes match.

A bf16 or fp16 GPT runs in its parameters' dtype, as the reference's
does: ``prefill`` and ``forced_logits`` return bf16 (fp16) logits and a
bf16 (fp16) KV payload (the final LayerNorm's fp32 parameters lift nothing past its
cast back). ``decode`` and ``extend`` raise ``TypeError`` there, as the
reference's do: its ``past`` enters as fp32, which promotes the
attention and with it the scan's carry to fp32 against a 16-bit input,
and ``lax.scan`` refuses the step.

A token's KV payload is laid out ``[L, 2 (k|v), heads, head_dim]``
flattened to ``elems_per_token`` — the reference's layout, so pool bytes
compare directly. Inputs may be numpy arrays or tensors; outputs are
tensors on the model's device.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..framework.device import to_device
from ..framework.precision import matmul_precision
from ..models.gpt import BLOCK_PARAMS, PORTED_DTYPES, GPTForCausalLM

__all__ = ["GPTDecodeModel", "bucket_pow2"]


def bucket_pow2(n: int, minimum: int = 1, maximum: int = 0) -> int:
    """Round ``n`` up to a power of two (>= minimum, capped at maximum
    when given) — the shape bucket."""
    b = max(int(minimum), 1)
    while b < n:
        b *= 2
    if maximum:
        b = min(b, int(maximum))
    return b


class GPTDecodeModel:
    """Serving adapter over the port's ``GPTForCausalLM``."""

    def __init__(self, model: GPTForCausalLM):
        cfg = model.config
        self.config = cfg
        self.dtype = PORTED_DTYPES[cfg.dtype]
        self.device = model.device
        self.n_layers = cfg.num_layers
        self.n_heads = cfg.num_heads
        self.head_dim = cfg.head_dim
        self.hidden = cfg.hidden_size
        self.vocab_size = cfg.vocab_size
        self.max_context = cfg.max_position_embeddings
        # per-token KV payload: layers x {k, v} x heads x head_dim
        self.elems_per_token = self.n_layers * 2 * self.hidden
        self._eps = cfg.layer_norm_epsilon
        self._scale = 1.0 / math.sqrt(self.head_dim)
        self.params = self._extract(model)

    def truncated(self, n_layers: int) -> "GPTDecodeModel":
        """A draft model from this model's own weights: the first
        ``n_layers`` blocks under the same embeddings and final norm.
        Its block parameters are views ``p[name][:n]`` of the stacked
        ones, so nothing is copied; its KV payload is proportionally
        smaller (``elems_per_token = n_layers * 2 * hidden``) and is not
        paged: the engine keeps a dense draft cache a sequence."""
        if not (0 < int(n_layers) <= self.n_layers):
            raise ValueError(
                f"truncated wants 1..{self.n_layers} layers, got {n_layers}")
        new = object.__new__(GPTDecodeModel)
        new.__dict__.update(self.__dict__)
        new.n_layers = int(n_layers)
        new.elems_per_token = new.n_layers * 2 * new.hidden
        new.params = dict(self.params)
        for name in BLOCK_PARAMS:
            new.params[name] = self.params[name][:new.n_layers]
        return new

    def param_list(self) -> list:
        """Flat deterministic parameter list (the replica guard's digest
        input): the reference's order, sorted by name."""
        return [self.params[k] for k in sorted(self.params)]

    def _extract(self, model: GPTForCausalLM) -> dict:
        gpt = model.gpt
        h = self.hidden
        p = {"word": gpt.embeddings.word_embeddings.detach(),
             "pos": gpt.embeddings.position_embeddings.detach(),
             "final_w": gpt.final_norm.weight.detach(),
             "final_b": gpt.final_norm.bias.detach()}
        for name in BLOCK_PARAMS:
            p[name] = torch.stack(
                [getattr(layer, name).detach() for layer in gpt.decoder])
        # [L, h, 3, h] -> [L, h, 3h]: one matmul yields q|k|v side by side
        p["qkv_w"] = p["qkv_w"].reshape(self.n_layers, h, 3 * h)
        p["qkv_b"] = p["qkv_b"].reshape(self.n_layers, 3 * h)
        return p

    # ------------------------------------------------------------ helpers
    def _t(self, x, dtype) -> torch.Tensor:
        return to_device(x, self.device, dtype)

    def _ln(self, v, w, b):
        """The reference's ``_ln``: normalise and apply ``w``, ``b`` in
        fp32, then cast to ``v.dtype``."""
        v32 = v.to(torch.float32)
        mean = v32.mean(-1, keepdim=True)
        var = v32.var(-1, keepdim=True, unbiased=False)
        out = (v32 - mean) * torch.rsqrt(var + self._eps)
        return (out * w + b).to(v.dtype)

    @staticmethod
    def _softmax(al, v):
        """Softmax over the last axis in fp32, cast to ``v.dtype``."""
        return torch.softmax(al.to(torch.float32), dim=-1).to(v.dtype)

    def _check_fp32_past(self, step: str) -> None:
        if self.dtype != torch.float32:
            raise TypeError(
                f"{step} on a {self.config.dtype} GPT: the reference's "
                f"past enters as float32, which promotes the attention and "
                f"the scan carry to float32 against a {self.config.dtype} "
                f"input, and its scan refuses the step (carry input and "
                f"output types differ); only prefill and forced_logits "
                f"run in {self.config.dtype}")

    def _qkv(self, x, l: int):
        """LayerNorm + packed projection -> q, k, v [..., heads, hd]."""
        p = self.params
        hn = self._ln(x, p["ln1_w"][l], p["ln1_b"][l])
        qkv = hn @ p["qkv_w"][l] + p["qkv_b"][l]
        qkv = qkv.reshape(*x.shape[:-1], 3, self.n_heads, self.head_dim)
        return qkv.unbind(-3)

    def _finish_block(self, x, attn, l: int):
        """Output projection, residual, MLP, residual."""
        p = self.params
        x = x + (attn.flatten(-2) @ p["out_w"][l] + p["out_b"][l])
        hn = self._ln(x, p["ln2_w"][l], p["ln2_b"][l])
        z = F.gelu(hn @ p["fc1_w"][l] + p["fc1_b"][l], approximate="tanh")
        return x + (z @ p["fc2_w"][l] + p["fc2_b"][l])

    def _logits(self, x):
        p = self.params
        return self._ln(x, p["final_w"], p["final_b"]) @ p["word"].T

    def _split_past(self, past):
        """[b, S, ept] -> [b, S, L, 2, heads, hd]."""
        b, S = past.shape[:2]
        return past.reshape(b, S, self.n_layers, 2, self.n_heads,
                            self.head_dim)

    # ------------------------------------------------------------ steps
    def _prefill_core(self, ids: torch.Tensor):
        """Full causal pass -> final hidden [b, s, h], KV [b, s, ept]."""
        p = self.params
        b, s = ids.shape
        x = p["word"][ids] + p["pos"][:s]
        causal = torch.ones(s, s, dtype=torch.bool,
                            device=self.device).tril()
        kvs = []
        for l in range(self.n_layers):
            q, k, v = self._qkv(x, l)                      # [b, s, n, d]
            al = torch.einsum("bqnd,bknd->bnqk", q, k) * self._scale
            neg = torch.finfo(al.dtype).min
            probs = self._softmax(al.masked_fill(~causal, neg), v)
            attn = torch.einsum("bnqk,bknd->bqnd", probs, v)
            x = self._finish_block(x, attn, l)
            kvs.append(torch.stack([k, v], dim=2))         # [b, s, 2, n, d]
        kv = torch.stack(kvs, dim=2).reshape(b, s, self.elems_per_token)
        return x, kv

    @torch.no_grad()
    @matmul_precision("float32")
    def prefill(self, prompts: Sequence) -> Tuple[torch.Tensor,
                                                   List[torch.Tensor]]:
        """Batch-prefill prompts (padded to shape buckets). Returns
        (last-position logits [n, V], per-sequence KV [s_i, ept])."""
        n_seq = len(prompts)
        lengths = np.array([len(p) for p in prompts], np.int64)
        if lengths.min() < 1:
            raise ValueError("empty prompt")
        if lengths.max() > self.max_context:
            raise ValueError(
                f"prompt of {lengths.max()} tokens exceeds max_context "
                f"{self.max_context}")
        b = bucket_pow2(n_seq)
        s = bucket_pow2(int(lengths.max()), minimum=8,
                        maximum=self.max_context)
        ids = np.zeros((b, s), np.int64)
        for i, p in enumerate(prompts):
            ids[i, :len(p)] = np.asarray(p, np.int64)
        x, kv = self._prefill_core(self._t(ids, torch.long))
        last_idx = self._t(lengths - 1, torch.long)
        last = self._logits(x[torch.arange(n_seq, device=self.device),
                              last_idx])
        return last, [kv[i, :lengths[i]] for i in range(n_seq)]

    @torch.no_grad()
    @matmul_precision("float32")
    def forced_logits(self, ids) -> torch.Tensor:
        """Full-sequence logits [b, s, V] (parity tests / scoring)."""
        x, _ = self._prefill_core(self._t(ids, torch.long))
        return self._logits(x)

    @torch.no_grad()
    @matmul_precision("float32")
    def decode(self, ids, pos, past, past_len
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decode step for a (bucketed) batch. ``past`` is [b, S, ept]
        fp32 (dequantized working copy), ``past_len`` the per-row valid
        prefix. Returns (logits [b, V], new KV [b, ept]). A bf16 model
        raises ``TypeError``, as the reference's does."""
        self._check_fp32_past("decode")
        p = self.params
        ids = self._t(ids, torch.long)
        pos = self._t(pos, torch.long)
        past = self._split_past(self._t(past, torch.float32))
        past_len = self._t(past_len, torch.long)
        b, S = past.shape[:2]
        x = p["word"][ids] + p["pos"][pos]                     # [b, h]
        valid = torch.arange(S, device=self.device)[None, :] \
            < past_len[:, None]
        mask = torch.cat([valid, valid.new_ones(b, 1)], dim=1)[:, None, :]
        neg = torch.finfo(torch.float32).min
        kvs = []
        for l in range(self.n_layers):
            q, k, v = self._qkv(x, l)                          # [b, n, d]
            k_past, v_past = past[:, :, l, 0], past[:, :, l, 1]
            lp = torch.einsum("bnd,bsnd->bns", q, k_past) * self._scale
            ls = (q * k).sum(-1, keepdim=True) * self._scale
            al = torch.cat([lp, ls], dim=-1).masked_fill(~mask, neg)
            probs = torch.softmax(al, dim=-1)                  # [b, n, S+1]
            attn = torch.einsum("bns,bsnd->bnd", probs[:, :, :S], v_past) \
                + probs[:, :, S:] * v
            x = self._finish_block(x, attn, l)
            kvs.append(torch.stack([k, v], dim=1))             # [b, 2, n, d]
        kv = torch.stack(kvs, dim=1).reshape(b, self.elems_per_token)
        return self._logits(x), kv

    @torch.no_grad()
    @matmul_precision("float32")
    def extend(self, ids, pos, past, past_len, tail_len
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Multi-token step for a (bucketed) batch: ``ids``/``pos`` are
        [b, s] tails, ``past`` [b, S, ept] fp32 with ``past_len`` valid
        rows, ``tail_len`` the per-row valid tail. Returns
        (logits [b, s, V], new KV [b, s, ept]); rows past ``tail_len``
        are padding the caller must ignore. A bf16 model raises
        ``TypeError``, as the reference's does."""
        self._check_fp32_past("extend")
        p = self.params
        ids = self._t(ids, torch.long)
        pos = self._t(pos, torch.long)
        past = self._split_past(self._t(past, torch.float32))
        past_len = self._t(past_len, torch.long)
        tail_len = self._t(tail_len, torch.long)
        b, s = ids.shape
        S = past.shape[1]
        x = p["word"][ids] + p["pos"][pos]                     # [b, s, h]
        ar_S = torch.arange(S, device=self.device)
        ar_s = torch.arange(s, device=self.device)
        valid_past = (ar_S[None, :] < past_len[:, None])[:, None, None, :]
        causal = torch.ones(s, s, dtype=torch.bool,
                            device=self.device).tril()
        tail_ok = ar_s[None, :] < tail_len[:, None]            # [b, s]
        mask_tail = causal[None, None] & tail_ok[:, None, None, :]
        neg = torch.finfo(torch.float32).min
        kvs = []
        for l in range(self.n_layers):
            q, k, v = self._qkv(x, l)                          # [b, s, n, d]
            k_past, v_past = past[:, :, l, 0], past[:, :, l, 1]
            lp = torch.einsum("bqnd,bknd->bnqk", q, k_past) * self._scale
            lt = torch.einsum("bqnd,bknd->bnqk", q, k) * self._scale
            al = torch.cat([lp.masked_fill(~valid_past, neg),
                            lt.masked_fill(~mask_tail, neg)], dim=-1)
            probs = torch.softmax(al, dim=-1)                  # [b,n,s,S+s]
            attn = torch.einsum("bnqk,bknd->bqnd", probs[..., :S], v_past) \
                + torch.einsum("bnqk,bknd->bqnd", probs[..., S:], v)
            x = self._finish_block(x, attn, l)
            kvs.append(torch.stack([k, v], dim=2))             # [b, s, 2, n, d]
        kv = torch.stack(kvs, dim=2).reshape(b, s, self.elems_per_token)
        return self._logits(x), kv
