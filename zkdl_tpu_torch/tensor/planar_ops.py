"""Planar protocol helpers: bit-reversed storage and eq tables.

Counterpart of ``zkdl_tpu/tensor/planar_ops.py`` (:41-168). Sumcheck folds
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
from ..field.fr import SPEC


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


def inverse_scalar(x) -> torch.Tensor:
    """x^-1 in Fr by Fermat (x^(p-2)), Montgomery in and out; x (8,) ->
    (8,) on x's device (planar_ops.py:inverse_scalar), square and multiply
    (K1)."""
    x = torch.as_tensor(x)
    x2 = x.reshape(8, 1).contiguous()
    e = SPEC.p - 2
    result = planar.ones_mont(1, x.device).contiguous()
    acc = x2
    while e > 0:
        if e & 1:
            result = planar.mul(result, acc)
        e >>= 1
        if e:
            acc = planar.mul(acc, acc)
    return result[:, 0].contiguous()


def fold_half(t: torch.Tensor, x) -> torch.Tensor:
    """One MLE fold on bit-reversed storage: t (8, n) (n even), host scalar
    x (8,) -> (8, n/2) = t_lo + x (t_hi - t_lo) (planar_ops.py:fold_half)."""
    h = t.shape[1] // 2
    lo, hi = t[:, :h], t[:, h:]
    return planar.add(lo, planar.mul_scalar(planar.sub(hi, lo), mp.host(x)))


def fold_axis(t: torch.Tensor, x, axis: int) -> torch.Tensor:
    """Fold the halves of `axis` (>= 1) of a planar (8, ...) tensor by the
    host scalar x (8,) (planar_ops.py:fold_axis)."""
    h = t.shape[axis] // 2
    lo, hi = t.narrow(axis, 0, h), t.narrow(axis, h, h)
    return planar.add(lo, planar.mul_scalar(planar.sub(hi, lo).contiguous(), mp.host(x)))


def me_eval_rev(t: torch.Tensor, u) -> torch.Tensor:
    """MLE of a bit-reversed planar (8, 2^r) tensor at host u ((r, 8)) ->
    (8,); the value of fr_ops.me_eval on the unreversed (n, 8) tensor."""
    u = mp.host(u)
    if t.shape[1] != 1 << u.shape[0]:
        raise ValueError(f"me_eval_rev: {t.shape[1]} columns for {u.shape[0]} challenges")
    for i in range(u.shape[0]):
        t = fold_half(t, u[i])
    return t[:, 0].contiguous()


def me_eval_rev_dot(t: torch.Tensor, u) -> torch.Tensor:
    """me_eval_rev's value as one dot (K3) against the eq table."""
    return planar.dot(t, eq_table_rev(mp.host(u), t.device))


def to_planar_rev(t: torch.Tensor, r: int) -> torch.Tensor:
    """(n, 8) (n <= 2^r, zero-padded) -> bit-reversed planar (8, 2^r)."""
    from . import fr_ops

    return bitrev_axis(planar.to_planar(fr_ops.pad_to(t, 1 << r)), axis=1).contiguous()


def from_planar_rev(t: torch.Tensor) -> torch.Tensor:
    """Bit-reversed planar (8, n) -> (n, 8) natural order."""
    return planar.from_planar(bitrev_axis(t, axis=1)).contiguous()
