"""Per-request random streams (reference: ``paddle_tpu/framework/random.py``
``CounterKeyStream``).

Every draw is a pure function of (stream seed, identity, counter): the
identity is a request id (hashed with crc32) or an explicit integer seed,
the counter is the token position. So a request draws the same numbers
whichever batch it lands in and however often it is replayed. The
reference folds these into a JAX threefry key; the port seeds a
``torch.Generator`` from a 64-bit digest of the triple. The two give
different numbers from the same triple: only each stream's own
determinism carries over, not its bits.
"""
from __future__ import annotations

import hashlib
import struct
import zlib
from typing import Union

import torch

__all__ = ["CounterStream"]


class CounterStream:
    """``generator(identity, counter)`` — always the same generator state."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    @staticmethod
    def ident(identity: Union[str, int]) -> int:
        """Request identity -> 32-bit stream id (crc32 for strings)."""
        if isinstance(identity, str):
            return zlib.crc32(identity.encode("utf-8"))
        return int(identity) & 0xFFFFFFFF

    def seed_for(self, identity, counter: int) -> int:
        digest = hashlib.blake2b(
            struct.pack("<qIq", self.seed, self.ident(identity), int(counter)),
            digest_size=8).digest()
        return int.from_bytes(digest, "little") & 0x7FFFFFFFFFFFFFFF

    def generator(self, identity, counter: int) -> torch.Generator:
        """A host generator seeded for (identity, counter)."""
        g = torch.Generator()
        g.manual_seed(self.seed_for(identity, counter))
        return g

    def uniform(self, identity, counter: int) -> float:
        """One draw in [0, 1) from the (identity, counter) stream, on the
        host (one scalar needs no device launch)."""
        return float(torch.rand((), generator=self.generator(identity,
                                                             counter),
                                dtype=torch.float64))
