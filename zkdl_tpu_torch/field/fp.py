"""BLS12-381 base field Fp (381-bit): constants and plain tensor ops.

Counterpart of ``zkdl_tpu/field/fp.py``: uint32[..., 12] little-endian limbs,
Montgomery form with R = 2^384. ``mul`` takes and returns that layout; the
``*_w`` ops work on the limb-leading int64 working form of
``field/mp.py`` and are what the plain G1 code chains together (one layout
change per G1 call instead of one per field op). On the card the G1 comb is
a CUDA kernel (``curve/g1.py``); these ops are its plain version.
"""

from __future__ import annotations

import torch

from . import mp

P_INT = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

SPEC = mp.FieldSpec(name="Fp", p=P_INT, n_limbs=12)

N_LIMBS = 12

assert list(SPEC.P_limbs) == [4294945451, 3120496639, 2975072255, 514588670, 4138792484, 1731252896, 4085584575, 1685539716, 1129032919, 1260103606, 964683418, 436277738]
assert list(SPEC.ONE_mont) == [196605, 1980301312, 3289120770, 3958636555, 1405573306, 1598593111, 1884444485, 2010011731, 2723605613, 1543969431, 4202751123, 368467651]
assert list(SPEC.R2_limbs) == [473175878, 4108263220, 164693233, 175564454, 1284880085, 2380613484, 2476573632, 1743489193, 3038352685, 2591637125, 2462770090, 295210981]

ZERO = SPEC.ZERO
ONE_MONT = SPEC.ONE_mont
_P = SPEC.P_limbs


def to_work(a: torch.Tensor) -> torch.Tensor:
    """uint32 (..., 12) -> int64 (12, ...)."""
    return mp.i64(a).movedim(-1, 0)


def from_work(w: torch.Tensor) -> torch.Tensor:
    """int64 (12, ...) -> uint32 (..., 12), contiguous."""
    return mp.u32(w.movedim(0, -1).contiguous())


def add_w(a, b):
    return mp.mod_add(_P, a, b)


def sub_w(a, b):
    return mp.mod_sub(_P, a, b)


def double_w(a):
    return mp.mod_add(_P, a, a)


def mul_w(a, b):
    return mp.mont_mul(SPEC, a, b)


def sqr_w(a):
    return mp.mont_mul(SPEC, a, a)


def is_zero_w(a):
    return (a == 0).all(0)


def eq_w(a, b):
    return (a == b).all(0)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p on (..., 12) uint32."""
    return from_work(mul_w(to_work(a), to_work(b)))
