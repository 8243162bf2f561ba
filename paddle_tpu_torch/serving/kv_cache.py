"""Paged KV cache with blockwise at-rest codecs and a prefix cache
(reference: ``paddle_tpu/serving/kv_cache.py``).

KV state lives in fixed-size blocks of ``block_tokens`` tokens drawn
from a shared pool with a free list; each sequence owns a
:class:`BlockTable` (ordered block ids + token count). The payload
``[n_blocks, block_tokens, elems_per_token]`` (int8, float8_e4m3fn or
fp32) and the fp32 scales live on the pool's device; the allocator's
bookkeeping (free list, refcounts, prefix index, LRU) is host state.

At-rest quantization: one fp32 abs-max scale per ``quant_block``
elements, encoded and decoded through ``ops.codec`` — the CUDA kernels
for a pool on the card, the plain versions for a pool on the CPU.
``quant_block`` divides the per-token element count, so scales align to
token boundaries and each token quantizes exactly once, whatever the
append's chunking: a token's at-rest bits never change after the write,
and an incrementally kept dequantized copy equals a fresh
:meth:`KVBlockPool.gather` bit for bit. One append therefore encodes all
its rows in one kernel launch and scatters them to their blocks, and
:meth:`KVBlockPool.append_batch` does the same for the rows of many
sequences (one decode step's KV).

``append`` returns the dequantized read-back of what was stored, never
the input: attention must see the at-rest bits.

Prefix cache: blocks carry a refcount and chain-hash index keys
(``h_i = sha1(h_{i-1} || chunk_i)``, so a key names the whole token path
from token 0). Admission maps matched blocks read-only into a new table;
the first append inside a shared block copies the matched rows' at-rest
bits (payload + scales) into the spare block reserved at admission
(copy-on-write). Freed blocks that carry index keys retire to an LRU of
refcount-0 cached blocks, evicted only when the free list runs dry.
``reserve``/``rollback`` grow and unwind a table's scratch without leaks.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..distributed import grad_comm as _gc
from ..framework.device import resolve_device, to_device
from ..framework.flags import flag
from ..ops import codec as _codec

__all__ = ["KVBlockPool", "BlockTable", "KVCacheOOM", "KV_CODECS"]

KV_CODECS = ("fp32", "int8_block", "fp8_block")


class KVCacheOOM(RuntimeError):
    """The pool has no free block for a requested allocation."""


@dataclass
class BlockTable:
    """Per-sequence view into the pool: ordered block ids + token count.

    ``n_shared`` leading blocks are mapped read-only from the prefix
    cache; ``cow_spare`` is the block reserved at admission for the
    copy-on-write of a partially matched last shared block;
    ``base_blocks`` is the admission reservation, below which
    ``rollback`` never shrinks the table.
    """

    block_ids: List[int] = field(default_factory=list)
    n_tokens: int = 0
    n_shared: int = 0
    cow_spare: Optional[int] = None
    base_blocks: int = 0

    def capacity(self, block_tokens: int) -> int:
        return len(self.block_ids) * block_tokens


def _chain_key(prev: bytes, tokens: np.ndarray) -> bytes:
    """h_i = H(h_{i-1} || tokens): a key names the whole token path."""
    return hashlib.sha1(
        prev + np.ascontiguousarray(tokens, np.int32).tobytes()).digest()


class KVBlockPool:
    """Fixed-size KV block pool on one device, with a free list,
    refcounted prefix sharing and blockwise codecs.

    ``elems_per_token`` is the flattened per-token KV payload (layers x
    {k,v} x heads x head_dim); callers append and gather
    ``[tokens, elems_per_token]`` fp32 tensors.
    """

    def __init__(self, n_blocks: int, block_tokens: Optional[int],
                 elems_per_token: int, codec: Optional[str] = None,
                 quant_block: Optional[int] = None, device="cuda"):
        codec = codec or flag("FLAGS_serving_kv_codec")
        if codec not in KV_CODECS:
            raise ValueError(f"codec must be one of {KV_CODECS}, got {codec!r}")
        self.device = resolve_device(device)
        self.n_blocks = int(n_blocks)
        self.block_tokens = int(block_tokens
                                or flag("FLAGS_serving_block_tokens"))
        self.elems_per_token = int(elems_per_token)
        self.codec = codec
        if codec != "fp32":
            qb = int(quant_block or min(self.elems_per_token, 1024))
            if self.elems_per_token % qb:
                raise ValueError(
                    f"quant_block ({qb}) must divide elems_per_token "
                    f"({self.elems_per_token}) so every append stays "
                    f"scale-aligned (tokens quantize exactly once)")
            self.quant_block = qb
            self._scales_per_token = self.elems_per_token // qb
        else:
            self.quant_block = 0
            self._scales_per_token = 0
        shape = (self.n_blocks, self.block_tokens, self.elems_per_token)
        wire = _gc.WIRE_DTYPE.get(codec, torch.float32)
        self._payload = torch.zeros(shape, dtype=wire, device=self.device)
        self._scales = (None if codec == "fp32" else torch.zeros(
            (self.n_blocks, self.block_tokens * self._scales_per_token),
            dtype=torch.float32, device=self.device))
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        # prefix cache state: per-block refcounts, chain-hash index
        # (key -> (block, matched rows)), per-block registered keys, and
        # the LRU of refcount-0 blocks still holding indexed content
        self._ref: List[int] = [0] * self.n_blocks
        self._index: Dict[bytes, Tuple[int, int]] = {}
        self._block_keys: List[List[bytes]] = [[] for _ in range(self.n_blocks)]
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.prefix_evictions = 0

    # ------------------------------------------------------------ allocator
    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: truly free plus cached (evictable LRU)."""
        return len(self._free) + len(self._lru)

    @property
    def blocks_in_use(self) -> int:
        """Blocks referenced by at least one live table."""
        return self.n_blocks - self.free_blocks

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks retained only for prefix reuse."""
        return len(self._lru)

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_tokens)

    def _take_block(self) -> int:
        """A writable block: free list first, then evict the LRU cached
        block (its index keys drop)."""
        if self._free:
            return self._free.pop()
        if self._lru:
            bi, _ = self._lru.popitem(last=False)
            for key in self._block_keys[bi]:
                if self._index.get(key, (None,))[0] == bi:
                    del self._index[key]
            self._block_keys[bi] = []
            self.prefix_evictions += 1
            return bi
        raise KVCacheOOM(
            f"no free or evictable block "
            f"(pool of {self.n_blocks} x {self.block_tokens} tokens)")

    def _release(self, bi: int):
        self._ref[bi] -= 1
        if self._ref[bi] < 0:
            raise AssertionError(f"block {bi} refcount underflow")
        if self._ref[bi] == 0:
            if self._block_keys[bi]:
                self._lru[bi] = None
                self._lru.move_to_end(bi)
            else:
                self._free.append(bi)

    def _match(self, prefix: np.ndarray
               ) -> Tuple[List[int], Optional[Tuple[int, int]], int]:
        """Walk ``prefix`` through the chain index. Returns (full-block
        ids, optional (block, rows) partial tail hit, matched tokens)."""
        bt = self.block_tokens
        full: List[int] = []
        h = b""
        t = 0
        while t + bt <= len(prefix):
            key = _chain_key(h, prefix[t:t + bt])
            ent = self._index.get(key)
            if ent is None:
                break
            full.append(ent[0])
            h = key
            t += bt
        partial = None
        rem = len(prefix) - t
        for length in range(min(rem, bt - 1), 0, -1):
            ent = self._index.get(_chain_key(h, prefix[t:t + length]))
            if ent is not None:
                partial = (ent[0], length)
                break
        matched = t + (partial[1] if partial else 0)
        return full, partial, matched

    def probe_prefix(self, prefix_tokens) -> int:
        """Longest cached-prefix match in tokens (no allocation)."""
        return self._match(np.asarray(prefix_tokens, np.int32))[2]

    def alloc_table(self, n_tokens: int, prefix_tokens=None) -> BlockTable:
        """Allocate blocks covering ``n_tokens`` up front. With
        ``prefix_tokens``, matched cached blocks become the table's
        leading shared entries and ``table.n_tokens`` starts at the
        matched length; one COW spare is reserved when the last match is
        partial."""
        need = self.blocks_needed(n_tokens)
        full: List[int] = []
        partial = None
        matched = 0
        if prefix_tokens is not None and len(prefix_tokens):
            full, partial, matched = self._match(
                np.asarray(prefix_tokens, np.int32))
        n_shared = len(full) + (1 if partial else 0)
        fresh = need - n_shared
        spare = 1 if partial else 0
        shared_ids = full + ([partial[0]] if partial else [])
        in_lru_shared = sum(1 for bi in shared_ids if bi in self._lru)
        if fresh + spare > self.free_blocks - in_lru_shared:
            raise KVCacheOOM(
                f"need {fresh + spare} blocks beyond {n_shared} shared, "
                f"{self.free_blocks - in_lru_shared} allocatable "
                f"(pool of {self.n_blocks} x {self.block_tokens} tokens)")
        for bi in shared_ids:
            self._ref[bi] += 1
            self._lru.pop(bi, None)
        ids = shared_ids + [self._take_block() for _ in range(fresh)]
        for bi in ids[n_shared:]:
            self._ref[bi] += 1
        spare_id = None
        if spare:
            spare_id = self._take_block()
            self._ref[spare_id] += 1
        return BlockTable(block_ids=ids, n_tokens=matched,
                          n_shared=n_shared, cow_spare=spare_id,
                          base_blocks=len(ids))

    def free_table(self, table: BlockTable):
        for bi in table.block_ids:
            self._release(bi)
        if table.cow_spare is not None:
            self._release(table.cow_spare)
        table.block_ids = []
        table.n_tokens = 0
        table.n_shared = 0
        table.cow_spare = None

    # --------------------------------------------------------- prefix index
    def register_prefix(self, table: BlockTable, prompt_tokens):
        """Index ``table``'s blocks under the chain keys of
        ``prompt_tokens``: every complete chunk gets its full-chain key
        and every proper prefix of a chunk its own key. First writer wins
        on collisions (identical content)."""
        tokens = np.asarray(prompt_tokens, np.int32)
        bt = self.block_tokens
        if table.n_tokens < len(tokens):
            raise ValueError("register_prefix before the prompt's KV "
                             "was appended")
        h = b""
        for start in range(0, len(tokens), bt):
            chunk = tokens[start:start + bt]
            bi = table.block_ids[start // bt]
            for length in range(1, len(chunk) + 1):
                key = _chain_key(h, chunk[:length])
                if key not in self._index:
                    self._index[key] = (bi, length)
                    self._block_keys[bi].append(key)
            if len(chunk) < bt:
                break
            h = _chain_key(h, chunk)

    # ------------------------------------------------------------- scratch
    def reserve(self, table: BlockTable, extra_tokens: int):
        """Grow the table so ``n_tokens + extra_tokens`` fit; raises
        :class:`KVCacheOOM` (table unchanged) when the pool cannot."""
        grow = (self.blocks_needed(table.n_tokens + int(extra_tokens))
                - len(table.block_ids))
        if grow <= 0:
            return
        if grow > self.free_blocks:
            raise KVCacheOOM(f"reserve wants {grow} blocks, "
                             f"{self.free_blocks} allocatable")
        for _ in range(grow):
            bi = self._take_block()
            self._ref[bi] += 1
            table.block_ids.append(bi)

    def rollback(self, table: BlockTable, n_tokens: int):
        """Unwind the last ``n_tokens`` tokens and return every block
        beyond ``max(base_blocks, blocks_needed(n_tokens))``."""
        n = int(n_tokens)
        if n < 0 or n > table.n_tokens:
            raise ValueError(f"rollback of {n} from {table.n_tokens} tokens")
        table.n_tokens -= n
        keep = max(table.base_blocks, self.blocks_needed(table.n_tokens))
        while len(table.block_ids) > keep:
            self._release(table.block_ids.pop())

    # ---------------------------------------------------------------- codec
    def _encode(self, kv: torch.Tensor):
        """fp32 [t, ept] -> (payload [t, ept] wire dtype, scales [t, spt]
        or None, dequantized read-back [t, ept] fp32)."""
        if self.codec == "fp32":
            return kv, None, kv
        t = kv.shape[0]
        flat = kv.reshape(-1)
        qb = self.quant_block
        scales = _gc.block_scales(_gc.block_absmax(flat, qb), self.codec)
        q = _codec.block_encode(flat, scales, qb, self.codec)
        deq = _codec.block_decode(q, scales, 1, flat.numel())
        return (q.reshape(t, self.elems_per_token),
                scales.reshape(t, self._scales_per_token),
                deq.reshape(t, self.elems_per_token))

    def _cow(self, table: BlockTable, idx: int, rows: int):
        """Copy-on-write of shared block ``table.block_ids[idx]``: move
        its first ``rows`` at-rest rows (payload + scales, the exact
        bits) into the reserved spare and swap it into the table."""
        if idx != table.n_shared - 1:
            raise AssertionError(
                "COW frontier must be the last shared block "
                f"(idx {idx}, n_shared {table.n_shared})")
        old = table.block_ids[idx]
        if table.cow_spare is not None:
            new = table.cow_spare
            table.cow_spare = None
        else:  # defensive: reservation should always have provided one
            new = self._take_block()
            self._ref[new] += 1
        if rows:
            self._payload[new, :rows] = self._payload[old, :rows]
            if self._scales is not None:
                spt = self._scales_per_token
                self._scales[new, :rows * spt] = \
                    self._scales[old, :rows * spt]
        table.block_ids[idx] = new
        table.n_shared = idx
        self._release(old)

    # ------------------------------------------------------------------- io
    def append(self, table: BlockTable, kv) -> torch.Tensor:
        """Append ``kv`` [t, elems_per_token] fp32 rows to the sequence.
        Returns the dequantized at-rest read-back of the same rows. The
        table must already hold enough blocks; a frontier inside a shared
        block triggers copy-on-write first."""
        kv = to_device(kv, self.device, torch.float32)
        return self.append_batch([table], kv, [kv.shape[0]])

    def append_batch(self, tables: List[BlockTable], kv: torch.Tensor,
                     counts: List[int]) -> torch.Tensor:
        """Append consecutive row groups of ``kv`` [sum(counts),
        elems_per_token]: ``counts[i]`` rows to ``tables[i]`` (a decode
        step passes one row per running sequence). Every row encodes in
        one codec launch and reads back in one; scales align to tokens,
        so the bits equal one append per table. Returns the read-back of
        all rows, in order."""
        kv = to_device(kv, self.device, torch.float32)
        if kv.dim() != 2 or kv.shape[1] != self.elems_per_token:
            raise ValueError(
                f"append wants [t, {self.elems_per_token}], got "
                f"{tuple(kv.shape)}")
        if len(tables) != len(counts) or sum(counts) != kv.shape[0]:
            raise ValueError(f"{len(tables)} tables and counts {counts} do "
                             f"not cover {kv.shape[0]} rows")
        if len({id(t) for t in tables}) != len(tables):
            raise ValueError("append_batch takes each table once")
        kv = kv.contiguous()
        if not kv.shape[0]:
            return kv
        bt = self.block_tokens
        for table, t in zip(tables, counts):
            if table.n_tokens + t > table.capacity(bt):
                raise KVCacheOOM(
                    f"table holds {table.capacity(bt)} tokens, append to "
                    f"{table.n_tokens + t} exceeds the reservation")
        where = []                                 # (block, offset) per row
        for table, t in zip(tables, counts):
            if not t:
                continue
            pos = np.arange(table.n_tokens, table.n_tokens + t)
            first = int(pos[0]) // bt
            if first < table.n_shared:
                self._cow(table, first, int(pos[0]) % bt)
            where.append(np.stack([np.asarray(table.block_ids)[pos // bt],
                                   pos % bt]))
        blk, off = to_device(np.concatenate(where, axis=1), self.device,
                             torch.long)
        payload, scales, deq = self._encode(kv)
        self._payload[blk, off] = payload
        if scales is not None:
            self._scales.view(self.n_blocks, bt, -1)[blk, off] = scales
        for table, t in zip(tables, counts):
            table.n_tokens += t
        return deq

    def gather(self, table: BlockTable) -> torch.Tensor:
        """Dequantize the sequence's full KV prefix -> fp32
        [n_tokens, elems_per_token]."""
        n = table.n_tokens
        ept = self.elems_per_token
        blocks = to_device(table.block_ids[:self.blocks_needed(n)],
                           self.device, torch.long)
        payload = self._payload[blocks].reshape(-1, ept)[:n]
        if self.codec == "fp32":
            return payload
        spt = self._scales_per_token
        scales = self._scales[blocks].reshape(-1)[:n * spt]
        return _codec.block_decode(payload.reshape(n * spt, self.quant_block), scales, 1,
                                   n * ept).reshape(n, ept)

    # ----------------------------------------------------------- accounting
    def block_bytes(self) -> int:
        """At-rest bytes of ONE block: payload + its scale slice."""
        b = (self.block_tokens * self.elems_per_token
             * self._payload.element_size())
        if self._scales is not None:
            b += self.block_tokens * self._scales_per_token * 4
        return b

    def bytes_in_use(self) -> int:
        return self.blocks_in_use * self.block_bytes()

    def fp32_equiv_bytes(self) -> int:
        return (self.blocks_in_use * self.block_tokens *
                self.elems_per_token * 4)

    def stats(self) -> dict:
        return {
            "codec": self.codec,
            "n_blocks": self.n_blocks,
            "block_tokens": self.block_tokens,
            "blocks_in_use": self.blocks_in_use,
            "free_blocks": self.free_blocks,
            "cached_blocks": self.cached_blocks,
            "prefix_evictions": self.prefix_evictions,
            "bytes_in_use": self.bytes_in_use(),
            "fp32_equiv_bytes": self.fp32_equiv_bytes(),
        }
