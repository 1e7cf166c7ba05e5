"""Planar protocol helpers: bit-reversed storage and eq tables.

Counterpart of ``zkdl_tpu/tensor/planar_ops.py`` (:41-107). Sumcheck folds
bind the lowest index bit each round; storing tensors with their index bits
reversed turns that into combining the two contiguous halves, so one gather
per tensor per prove replaces a shuffle per round. Sums are order-free, so
the proof stream is the same either way.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import mp, planar


@functools.lru_cache(maxsize=None)
def bitrev_indices(r: int) -> np.ndarray:
    """perm[i] = bit-reverse of i over r bits; an involution."""
    n = 1 << r
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for b in range(r):
        out |= ((idx >> b) & 1) << (r - 1 - b)
    return out


@functools.lru_cache(maxsize=None)
def _bitrev_on(r: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(bitrev_indices(r)).to(device)


def bitrev_axis(t: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply the bit-reversal permutation along `axis` (length 2^r)."""
    n = t.shape[axis]
    r = int(n - 1).bit_length() if n > 1 else 0
    if (1 << r) != n:
        raise ValueError(f"axis length {n} must be a power of two")
    if r <= 1:
        return t
    return mp.take(t, _bitrev_on(r, t.device), axis)


def eq_table_rev(u, device) -> torch.Tensor:
    """Bit-reversed-storage eq table of host challenges u ((r, 8) mont) ->
    planar (8, 2^r): u[0] controls the TOP stored bit."""
    u = np.asarray(u, dtype=np.uint32)
    t = planar.ones_mont(1, device).contiguous()
    for k in range(u.shape[0] - 1, -1, -1):
        hi = planar.mul_scalar(t, u[k])
        lo = planar.sub(t, hi)  # (1-u)*t == t - u*t
        t = torch.cat([lo, hi], dim=1)
    return t


def eq_table(u, device) -> torch.Tensor:
    """Standard-order eq table: T[:, j] = eq(u, j), u[0] controls the LOWEST
    stored bit. Planar (8, 2^r)."""
    u = np.asarray(u, dtype=np.uint32)
    t = planar.ones_mont(1, device).contiguous()
    for k in range(u.shape[0]):
        hi = planar.mul_scalar(t, u[k])
        lo = planar.sub(t, hi)
        t = torch.cat([lo, hi], dim=1)
    return t
