"""BLS12-381 base field Fp (381-bit): constants and plain tensor ops.

Counterpart of ``zkdl_tpu/field/fp.py``: uint32[..., 12] little-endian limbs,
Montgomery form with R = 2^384. ``mul`` and the element ops of fp.py
(:32-60: ``add``, ``sub``, ``neg``, ``double``, ``sqr``, ``mont``,
``unmont``, ``pow_static``, ``is_zero``, ``eq``, ``select``, ``zeros``,
``ones_mont``, ``from_int``, ``to_int``) take and return that layout; the
``*_w`` ops work on the limb-leading int64 working form of
``field/mp.py`` and are what the plain G1 code chains together (one layout
change per G1 call instead of one per field op). On the card the G1 comb is
a CUDA kernel (``curve/g1.py``); these ops are its plain version.
"""

from __future__ import annotations

import numpy as np
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


def neg_w(a):
    return mp.mod_sub(_P, torch.zeros_like(a), a)


def _wrap(f):
    def op(*xs):
        return from_work(f(*(to_work(x) for x in xs)))

    op.__name__ = f.__name__.removesuffix("_w")
    op.__doc__ = f"{op.__name__} of uint32 (..., 12) Fp tensors."
    return op


add = _wrap(add_w)
sub = _wrap(sub_w)
neg = _wrap(neg_w)
double = _wrap(double_w)
sqr = _wrap(sqr_w)


def mont(a: torch.Tensor) -> torch.Tensor:
    """a -> a R mod p: the product by R^2 mod p."""
    return mul(a, torch.from_numpy(SPEC.R2_limbs).to(a.device).expand_as(a))


def unmont(a: torch.Tensor) -> torch.Tensor:
    """a -> a R^-1 mod p: the product by 1."""
    return mul(a, torch.from_numpy(mp.limbs_from_int(1, N_LIMBS)).to(a.device).expand_as(a))


def pow_static(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e (Montgomery in and out) for a host exponent e >= 0, square and
    multiply from e's top bit; one value whatever the order (fp.py:pow_static)."""
    w = to_work(a)
    out = mp.const(ONE_MONT, w).expand_as(w)
    for b in range(int(e).bit_length() - 1, -1, -1):
        out = sqr_w(out)
        if (e >> b) & 1:
            out = mul_w(out, w)
    return from_work(out)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """(..., 12) -> bool (...)."""
    return (a.view(torch.int32) == 0).all(-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.view(torch.int32) == b.view(torch.int32)).all(-1)


def select(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mp.where(pred.unsqueeze(-1), a, b)


def zeros(shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros((*shape, N_LIMBS), dtype=torch.uint32, device=device)


def ones_mont(shape=(), device="cpu") -> torch.Tensor:
    return torch.from_numpy(ONE_MONT).to(device).expand(*shape, N_LIMBS)


def from_int(x: int) -> np.ndarray:
    """Host: python int -> canonical (non-Montgomery) limbs."""
    return SPEC.from_int(x)


def to_int(a) -> int:
    return SPEC.to_int(mp.host(a))
