"""Sequence decoding (reference: ``paddle_tpu/nn/decode.py``): the
``Decoder`` protocol, ``BeamSearchDecoder`` and ``dynamic_decode``.

The loop runs on the host, as the reference's does: decode lengths
depend on the data. Each step runs the cell, ``embedding_fn`` and
``output_fn`` on the device of the cell's states, and regathers the
states there by an index tensor; the beam bookkeeping is the reference's
numpy, kept as it is so that token ids match it bit for bit: the
logits copied to the host (one ``[b * beam, V]`` copy a step), their
log-softmax in float64, the finished beams extended only by
``end_token`` at no cost, the stable ``argsort`` top-k over ``beam x V``
candidates, and ``finalize``'s backtrack over the parent pointers,
beams ordered best first. ``tile_beam_merge_with_batch`` is
``repeat_interleave`` on the device.

Kept from the reference (ROADMAP Queue C "Reference caveats"):
``step`` drops its ``**kwargs`` (the cell is called as ``cell(emb,
states)``); ``dynamic_decode`` ignores ``output_time_major``,
``impute_finished`` and ``is_test`` and stops after 64 steps unless
``max_step_num`` says otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.autograd import unwrap, wrap
from ..framework.tensor import Tensor, to_tensor

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]


class Decoder:
    """The decode protocol: ``initialize``, then ``step`` until every
    sequence finishes, then ``finalize``."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError


def _like(v: torch.Tensor, ref):
    """``v`` as an eager ``Tensor`` when ``ref`` is one."""
    return wrap(v) if isinstance(ref, Tensor) else v


class BeamSearchDecoder(Decoder):
    """Beam search over a cell: ``cell(emb, states) -> (out, states)``;
    ``embedding_fn`` maps token ids to embeddings, ``output_fn`` the
    cell's output to logits over the vocabulary."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        self._device = None

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """``[b, ...]`` -> ``[b * beam_size, ...]``, each row repeated
        ``beam_size`` times in place."""
        return _like(torch.repeat_interleave(unwrap(x), beam_size, dim=0),
                     x)

    def _map_states(self, states, fn):
        if isinstance(states, (tuple, list)):
            return type(states)(self._map_states(s, fn) for s in states)
        return fn(states)

    def initialize(self, initial_cell_states):
        leaves = (initial_cell_states
                  if isinstance(initial_cell_states, (tuple, list))
                  else [initial_cell_states])
        b = leaves[0].shape[0]
        self._device = unwrap(leaves[0]).device
        K = self.beam_size
        states = self._map_states(
            initial_cell_states,
            lambda t: self.tile_beam_merge_with_batch(t, K))
        ids = np.full((b * K,), self.start_token, np.int64)
        # only beam 0 is live at the start
        log_probs = np.full((b, K), -1e9, np.float32)
        log_probs[:, 0] = 0.0
        finished = np.zeros((b, K), bool)
        return ids, (states, log_probs, finished)

    def _on_device(self, arr, dtype=None):
        return to_tensor(np.asarray(arr, dtype), place=self._device)

    def step(self, time, inputs, states, **kwargs):
        cell_states, log_probs, finished = states
        b, K = log_probs.shape
        emb = (self.embedding_fn(self._on_device(inputs))
               if self.embedding_fn is not None
               else self._on_device(inputs, np.float32))
        cell_out, new_cell_states = self.cell(emb, cell_states)
        logits = (self.output_fn(cell_out) if self.output_fn is not None
                  else cell_out)
        host = unwrap(logits).detach().to("cpu").numpy()
        logp = _log_softmax(np.asarray(host, np.float64))
        V = logp.shape[-1]
        logp = logp.reshape(b, K, V)
        # finished beams extend only with end_token, at no cost
        fin_mask = np.full((V,), -1e9)
        fin_mask[self.end_token] = 0.0
        logp = np.where(finished[:, :, None], fin_mask[None, None, :], logp)
        total = log_probs[:, :, None] + logp               # [b, K, V]
        flat = total.reshape(b, K * V)
        top = np.argsort(-flat, axis=1, kind="stable")[:, :K]
        new_log_probs = np.take_along_axis(flat, top, axis=1).astype(
            np.float32)
        beam_idx = top // V                                # [b, K]
        token_idx = (top % V).astype(np.int64)
        new_finished = np.take_along_axis(finished, beam_idx, axis=1) | (
            token_idx == self.end_token)
        gather = torch.from_numpy(
            (np.arange(b)[:, None] * K + beam_idx).reshape(-1)).to(
                self._device)

        def regather(t):
            return _like(unwrap(t)[gather], t)

        new_cell_states = self._map_states(new_cell_states, regather)
        next_ids = token_idx.reshape(-1)
        outputs = {"token": token_idx, "parent": beam_idx}
        return outputs, next_ids, (new_cell_states, new_log_probs,
                                   new_finished), new_finished

    def finalize(self, outputs, final_states, sequence_lengths):
        """The parent pointers traced back: a ``[b, beam, T]`` token
        matrix, beams best first."""
        tokens = np.stack([o["token"] for o in outputs], axis=-1)  # [b,K,T]
        parents = np.stack([o["parent"] for o in outputs], axis=-1)
        b, K, T = tokens.shape
        out = np.zeros((b, K, T), np.int64)
        for bi in range(b):
            for k in range(K):
                beam = k
                for t in range(T - 1, -1, -1):
                    out[bi, k, t] = tokens[bi, beam, t]
                    beam = parents[bi, beam, t]
        _, log_probs, _ = final_states
        order = np.argsort(-log_probs, axis=1, kind="stable")
        out = np.take_along_axis(out, order[:, :, None], axis=1)
        return self._on_device(out), final_states


def _log_softmax(x):
    m = x.max(-1, keepdims=True)
    e = np.exp(x - m)
    return (x - m) - np.log(e.sum(-1, keepdims=True))


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """``decoder.initialize`` then ``step`` until every beam finishes or
    ``max_step_num`` (64 by default) steps ran, then ``finalize``."""
    inputs, states = decoder.initialize(inits)
    outputs = []
    seq_len = None
    T = int(max_step_num or 64)
    for t in range(T):
        out, inputs, states, finished = decoder.step(t, inputs, states,
                                                     **kwargs)
        outputs.append(out)
        fin = np.asarray(finished)
        if seq_len is None:
            seq_len = np.full(fin.shape, T, np.int64)
        newly = fin & (seq_len == T)
        seq_len = np.where(newly, t + 1, seq_len)
        if fin.all():
            break
    final, final_states = decoder.finalize(outputs, states, seq_len)
    if return_length:
        return final, final_states, to_tensor(seq_len)
    return final, final_states
