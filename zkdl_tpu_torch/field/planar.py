"""Planar Fr arithmetic: uint32 (8, ...) tensors, limbs leading.

Counterpart of ``zkdl_tpu/field/planar.py``. The layout is the JAX one: limb
i of every element is one contiguous row, so each limb step is one
elementwise op over all elements, and the CUDA kernels' limb loads coalesce.

- ``mul``, ``mul_scalar``, ``dot`` (and ``to_mont``/``from_mont``, which are
  products by a constant) go through the kernels of ``field/kernels.py``.
- ``add``/``sub``/``neg``/``double``/``select`` and the lazy sums are plain
  PyTorch on int64 (see ``field/mp.py`` for why int64).

Every result is canonical (< p), so values are bit-identical to the JAX
package's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels, mp
from .fr import SPEC

N_LIMBS = 8
N_DIGITS = 16
_P = SPEC.P_limbs
_ONE_RAW = mp.limbs_from_int(1, N_LIMBS)

mul = kernels.mul
mul_scalar = kernels.mul_scalar
dot = kernels.dot
dot_many = kernels.dot_many


def to_planar(x: torch.Tensor) -> torch.Tensor:
    """(n, 8) -> (8, n) (a view)."""
    return x.transpose(-1, -2)


def from_planar(x: torch.Tensor) -> torch.Tensor:
    """(8, n) -> (n, 8) (a view)."""
    return x.transpose(-1, -2)


def const(limbs, n: int, device) -> torch.Tensor:
    """Broadcast (8, n) view of one host element."""
    t = torch.from_numpy(np.asarray(limbs, dtype=np.uint32).reshape(N_LIMBS, 1)).to(device)
    return t.expand(N_LIMBS, n)


def ones_mont(n: int, device) -> torch.Tensor:
    return const(SPEC.ONE_mont, n, device)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p; inputs canonical, shapes broadcast."""
    return mp.u32(mp.mod_add(_P, mp.i64(a), mp.i64(b)))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mp.u32(mp.mod_sub(_P, mp.i64(a), mp.i64(b)))


def neg(a: torch.Tensor) -> torch.Tensor:
    a64 = mp.i64(a)
    return mp.u32(mp.mod_sub(_P, torch.zeros_like(a64), a64))


def double(a: torch.Tensor) -> torch.Tensor:
    a64 = mp.i64(a)
    return mp.u32(mp.mod_add(_P, a64, a64))


def select(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """pred: bool (...) -> where(pred, a, b) over (8, ...)."""
    return mp.where(pred.unsqueeze(0), a, b)


def _lift(hi: torch.Tensor) -> torch.Tensor:
    """hi * 2^256 mod p = mont(hi * R^2), via the K2 kernel."""
    return mp.i64(mul_scalar(mp.u32(hi), SPEC.R2_limbs))


def masked_sum(mask: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Sum of w's entries where mask, along the LAST axis.

    mask: bool (*batch, n); w: (8, n) (or (8, 1, ..., 1, n)), shared by every
    batch row. Returns (8, *batch). Mul-free: the 16 digit columns of w are
    summed under each mask row as one float64 matrix product (digits < 2^16,
    n < 2^24: every partial sum is an integer below 2^53, so exact), then one
    modular reduction. Equals the sum of select(mask, w, 0)."""
    n = mask.shape[-1]
    batch = mask.shape[:-1]
    if w.shape[0] != N_LIMBS or w.shape[-1] != n or any(d != 1 for d in w.shape[1:-1]):
        raise ValueError(f"masked_sum: w must be (8, n) shared, got {tuple(w.shape)}")
    if n == 0:
        return torch.zeros((N_LIMBS, *batch), dtype=torch.uint32, device=w.device)
    digits = mp.to_digits(mp.i64(w.reshape(N_LIMBS, n))).to(torch.float64)  # (16, n)
    m = mask.reshape(-1, n).to(torch.float64)  # (B, n)
    cols = (digits @ m.T).to(torch.int64)  # (16, B)
    out = mp.reduce_digit_sums(SPEC, cols, _lift)
    return mp.u32(out).reshape((N_LIMBS, *batch))


def lazy_sum(w: torch.Tensor) -> torch.Tensor:
    """Modular sum along the last axis of (8, *batch, n) -> (8, *batch)."""
    return mp.u32(mp.reduce_digit_sums(SPEC, mp.digit_sums(mp.i64(w)), _lift))


def tree_sum(a: torch.Tensor) -> torch.Tensor:
    """Modular sum over the LAST axis (the JAX name; same value as lazy_sum)."""
    return lazy_sum(a)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """a -> a*R mod p, planar: one Montgomery product by R^2 (K2)."""
    return mul_scalar(a, SPEC.R2_limbs)


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """a -> a*R^-1 mod p, planar: one Montgomery product by 1 (K2)."""
    return mul_scalar(a, _ONE_RAW)
