"""Random streams (reference: ``paddle_tpu/framework/random.py``: the
global ``Generator`` (lines 20-73), ``seed``, the host stream,
``get_rng_state``/``set_rng_state``, ``default_generator``,
``get_cuda_rng_state``/``set_cuda_rng_state`` (lines 75-112, 192-199),
and ``CounterKeyStream``).

**The global stream.** The reference splits one threefry key for every
draw. The port keeps one ``torch.Generator`` a device (the CPU's, each
card's Philox), made at its first draw and seeded with the stream's
seed. ``seed(s)`` reseeds all of them and the host's numpy stream (the
reference's ``_host``, which its samplers read), so after ``seed`` every
draw on a device repeats. A draw with an explicit ``seed=k``
(``uniform``, ``uniform_``, ``shuffle_batch``) uses a fresh generator
seeded with ``k``, as the reference's ``jax.random.key(seed)`` is
independent of the global stream. ``get_rng_state`` holds the seed,
each device generator made so far and the host stream;
``get_cuda_rng_state`` holds the cards' generators (shims in the
reference, real state here).

**What carries over, and what does not.** Threefry's bits cannot be
reproduced: a test holds a draw to the reference's dtypes (its
narrowed 64-bit names: ``randint`` asks for "int64" and gets int32),
shapes and ranges, to its moments at a stated sample size and sigma,
and to its determinism and state round trip, never to its values. The
CPU's generator (Mersenne Twister) and a card's (Philox) give other
numbers from one seed, so the same seeded draw differs between the CPU
and the card, on purpose (``ROADMAP.md`` Queue C): a draw on the card
stays on the card, with no host copy, and each device repeats itself.

**Per-request streams.** ``CounterStream`` is the reference's
``CounterKeyStream``: every draw is a pure function of (stream seed,
identity, counter), the identity a request id (hashed with crc32) or an
explicit integer seed, the counter the token position. So a request
draws the same numbers whichever batch it lands in and however often it
is replayed. The reference folds these into a JAX threefry key; the port
seeds a ``torch.Generator`` from a 64-bit digest of the triple. The two
give different numbers from the same triple: only each stream's own
determinism carries over, not its bits.
"""
from __future__ import annotations

import hashlib
import struct
import zlib
from typing import Union

import numpy as np
import torch

__all__ = ["CounterStream", "Generator", "seed", "default_generator",
           "generator_for", "get_rng_state", "set_rng_state",
           "get_cuda_rng_state", "set_cuda_rng_state", "host_rng"]


def _key(device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda:{torch.cuda.current_device() if device.index is None else device.index}"
    return device.type


class Generator:
    """The global stream: one ``torch.Generator`` a device, each seeded
    with ``initial_seed()`` when first drawn from."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._gens = {}

    def manual_seed(self, seed: int) -> "Generator":
        self._seed = int(seed)
        for g in self._gens.values():
            g.manual_seed(self._seed)
        return self

    def initial_seed(self) -> int:
        return self._seed

    def generator(self, device) -> torch.Generator:
        """This stream's generator on ``device``."""
        device = torch.device(device)
        key = _key(device)
        g = self._gens.get(key)
        if g is None:
            g = self._gens[key] = torch.Generator(device=key)
            g.manual_seed(self._seed)
        return g

    def get_state(self) -> dict:
        return {"seed": self._seed,
                "devices": {k: g.get_state() for k, g in self._gens.items()}}

    def set_state(self, state: dict) -> None:
        self._seed = int(state["seed"])
        for k, g in self._gens.items():
            if k not in state["devices"]:
                g.manual_seed(self._seed)
        for k, st in state["devices"].items():
            self.generator(k).set_state(st)


_global = Generator(0)
# the host numpy stream, seeded with the device streams (the reference's
# ``_host``: entropy-seeded until ``seed``)
_host = np.random.RandomState()


def seed(s: int) -> Generator:
    """``paddle.seed``: every device stream and the host stream."""
    _global.manual_seed(s)
    _host.seed(int(s))
    return _global


def default_generator() -> Generator:
    return _global


def host_rng() -> np.random.RandomState:
    """The host stream that ``seed`` governs."""
    return _host


def generator_for(device, seed: int = 0) -> torch.Generator:
    """The generator a draw on ``device`` takes: the global stream's, or,
    with a nonzero ``seed``, a fresh one seeded with it."""
    if not seed:
        return _global.generator(device)
    g = torch.Generator(device=_key(torch.device(device)))
    g.manual_seed(int(seed))
    return g


def get_rng_state() -> dict:
    """The seed, the device generators' states and the host stream."""
    return {**_global.get_state(), "host": _host.get_state()}


def set_rng_state(state: dict) -> None:
    _global.set_state(state)
    _host.set_state(state["host"])


def get_cuda_rng_state() -> list:
    """Each card's generator state, in card order."""
    return [_global.generator(f"cuda:{i}").get_state().clone()
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(states) -> None:
    for i, st in enumerate(states):
        _global.generator(f"cuda:{i}").set_state(st)


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
