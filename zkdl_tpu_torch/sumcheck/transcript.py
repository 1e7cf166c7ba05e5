"""Challenge generation: Fiat-Shamir transcript, seeded mt19937 stream, replay.

Counterpart of ``zkdl_tpu/sumcheck/transcript.py`` (:34-125), byte for byte:
the same BLAKE2s sponge over the same absorbed bytes, the same mt19937
stream. Challenges are host tensors: uint32 (n, 8) on the CPU, the
Montgomery representation of Fr elements (the prover moves them to the
device where it needs them and keeps the host copy for host-side math).
"""

from __future__ import annotations

import hashlib
from typing import Iterable

import numpy as np
import torch

from .. import config
from ..field import fr, mp

P_TOP = fr.P_TOP_LIMB


class MT19937:
    """Minimal mt19937-32 replica (C++ std::mt19937 compatible)."""

    N, M = 624, 397
    MATRIX_A = 0x9908B0DF
    UPPER, LOWER = 0x80000000, 0x7FFFFFFF

    def __init__(self, seed: int = 5489):
        self.mt = [0] * self.N
        self.mt[0] = seed & 0xFFFFFFFF
        for i in range(1, self.N):
            self.mt[i] = (1812433253 * (self.mt[i - 1] ^ (self.mt[i - 1] >> 30)) + i) & 0xFFFFFFFF
        self.idx = self.N

    def next_u32(self) -> int:
        if self.idx >= self.N:
            for i in range(self.N):
                y = (self.mt[i] & self.UPPER) | (self.mt[(i + 1) % self.N] & self.LOWER)
                self.mt[i] = self.mt[(i + self.M) % self.N] ^ (y >> 1)
                if y & 1:
                    self.mt[i] ^= self.MATRIX_A
            self.idx = 0
        y = self.mt[self.idx]
        self.idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y


def to_bytes(arr) -> bytes:
    """Row-major bytes of a uint32 array or tensor (any device), as the JAX
    package hashes them (np.asarray(arr).tobytes())."""
    return mp.host(arr).tobytes()


class ChallengeSource:
    def random_vec(self, n: int) -> torch.Tensor:  # (n, 8) uint32, CPU
        raise NotImplementedError

    def absorb(self, data: bytes) -> None:  # no-op outside Fiat-Shamir
        pass

    def absorb_array(self, arr) -> None:
        self.absorb(to_bytes(arr))


class SeededRng(ChallengeSource):
    """8 mt19937 draws per element, last limb reduced mod the top limb of p."""

    def __init__(self, seed: int = 5489):
        self.rng = MT19937(seed)

    def random_vec(self, n: int) -> torch.Tensor:
        out = np.empty((n, 8), dtype=np.uint32)
        for i in range(n):
            limbs = [self.rng.next_u32() for _ in range(8)]
            limbs[7] %= P_TOP
            out[i] = limbs
        return torch.from_numpy(out)


class FiatShamir(ChallengeSource):
    """BLAKE2s-based sponge: state <- H(state || absorbed); squeeze counter-mode.
    The label defaults to config's fiat_shamir_label (b"zkdl-tpu-v1" unless
    ZKDL_FIAT_SHAMIR_LABEL sets another)."""

    def __init__(self, label: bytes | None = None):
        if label is None:
            label = config.get().fiat_shamir_label
        self.state = hashlib.blake2s(label).digest()
        self.counter = 0

    def absorb(self, data: bytes) -> None:
        self.state = hashlib.blake2s(self.state + data).digest()

    def random_vec(self, n: int) -> torch.Tensor:
        out = np.empty((n, 8), dtype=np.uint32)
        for i in range(n):
            block = hashlib.blake2s(self.state + self.counter.to_bytes(8, "little")).digest()
            self.counter += 1
            limbs = np.frombuffer(block, dtype=np.uint32).copy()
            limbs[7] %= P_TOP
            out[i] = limbs
        return torch.from_numpy(out)


class Replay(ChallengeSource):
    """Replays a recorded challenge stream."""

    def __init__(self, arrays: Iterable):
        self.arrays = [np.asarray(a, dtype=np.uint32).reshape(-1, 8) for a in arrays]
        self.pos = 0
        self.flat = np.concatenate(self.arrays) if self.arrays else np.zeros((0, 8), np.uint32)

    def random_vec(self, n: int) -> torch.Tensor:
        out = self.flat[self.pos : self.pos + n]
        if out.shape[0] != n:
            raise ValueError("replay stream exhausted")
        self.pos += n
        return torch.from_numpy(out.copy())
