"""BLS12-381 quadratic extension Fp2 = Fp[u]/(u^2 + 1).

Counterpart of ``zkdl_tpu/field/fp2.py``: the ``Fp2`` pair of uint32
(..., 12) Montgomery Fp tensors and its ops (:27-125: ``zeros``,
``ones_mont``, ``is_zero``, ``eq``, ``select``, ``add``, ``sub``, ``neg``,
``double``, ``mul`` (Karatsuba, 3 Fp products), ``sqr`` (complex squaring,
2), ``conj``, ``mul_by_fp``, ``inv`` (a Fermat power of the norm),
``from_ints``, ``to_ints``), and the host oracle ``HostFp2`` with ``sqrt``
(:127-187), copied. The ``*_w`` ops take pairs of limb-leading int64
(12, ...) Fp tensors (``field/fp.py``'s working form), which the plain G2
code (``curve/g2.py``) chains together; ``prods_w`` runs several
independent Fp2 products in one batched Fp product.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import fp, mp

P_INT = fp.P_INT


class Fp2(NamedTuple):
    """c0 + u c1 with u^2 = -1 (p = 3 mod 4 makes -1 a non-residue)."""

    c0: torch.Tensor  # uint32 (..., 12) Montgomery
    c1: torch.Tensor

    @property
    def shape(self):
        return self.c0.shape[:-1]


# --- the working form: pairs of int64 (12, ...) ------------------------------


def to_work(a: Fp2):
    return fp.to_work(a.c0), fp.to_work(a.c1)


def from_work(w) -> Fp2:
    return Fp2(fp.from_work(w[0]), fp.from_work(w[1]))


def add_w(a, b):
    return fp.add_w(a[0], b[0]), fp.add_w(a[1], b[1])


def sub_w(a, b):
    return fp.sub_w(a[0], b[0]), fp.sub_w(a[1], b[1])


def neg_w(a):
    return fp.neg_w(a[0]), fp.neg_w(a[1])


def double_w(a):
    return fp.double_w(a[0]), fp.double_w(a[1])


def is_zero_w(a):
    return fp.is_zero_w(a[0]) & fp.is_zero_w(a[1])


def eq_w(a, b):
    return fp.eq_w(a[0], b[0]) & fp.eq_w(a[1], b[1])


def select_w(pred, a, b):
    p = pred.unsqueeze(0)
    return torch.where(p, a[0], b[0]), torch.where(p, a[1], b[1])


def prods_w(*ops):
    """Independent Fp2 products, ("m", a, b) for a b (Karatsuba) or ("s",
    a) for a^2 (complex squaring), in one batched Fp product."""
    xs, ys = [], []
    for op in ops:
        a = op[1]
        if op[0] == "m":
            b = op[2]
            xs += [a[0], a[1], fp.add_w(a[0], a[1])]
            ys += [b[0], b[1], fp.add_w(b[0], b[1])]
        else:
            xs += [a[0], fp.add_w(a[0], a[1])]
            ys += [a[1], fp.sub_w(a[0], a[1])]
    shape = torch.broadcast_shapes(*(t.shape for t in xs + ys))
    z = fp.mul_w(torch.stack([t.expand(shape) for t in xs], 1), torch.stack([t.expand(shape) for t in ys], 1)).unbind(1)
    out, k = [], 0
    for op in ops:
        if op[0] == "m":
            v0, v1, c = z[k : k + 3]
            out.append((fp.sub_w(v0, v1), fp.sub_w(fp.sub_w(c, v0), v1)))
            k += 3
        else:
            ab, t = z[k : k + 2]
            out.append((t, fp.double_w(ab)))
            k += 2
    return out


def mul_w(a, b):
    return prods_w(("m", a, b))[0]


def sqr_w(a):
    return prods_w(("s", a))[0]


# --- ops on the stored form ----------------------------------------------------


def zeros(shape=(), device="cpu") -> Fp2:
    return Fp2(fp.zeros(shape, device), fp.zeros(shape, device))


def ones_mont(shape=(), device="cpu") -> Fp2:
    return Fp2(fp.ones_mont(shape, device), fp.zeros(shape, device))


def is_zero(a: Fp2) -> torch.Tensor:
    return fp.is_zero(a.c0) & fp.is_zero(a.c1)


def eq(a: Fp2, b: Fp2) -> torch.Tensor:
    return fp.eq(a.c0, b.c0) & fp.eq(a.c1, b.c1)


def select(pred: torch.Tensor, a: Fp2, b: Fp2) -> Fp2:
    return Fp2(fp.select(pred, a.c0, b.c0), fp.select(pred, a.c1, b.c1))


def _on_work(f):
    def op(*xs):
        return from_work(f(*(to_work(x) for x in xs)))

    op.__name__ = f.__name__.removesuffix("_w")
    return op


add = _on_work(add_w)
sub = _on_work(sub_w)
neg = _on_work(neg_w)
double = _on_work(double_w)
mul = _on_work(mul_w)
sqr = _on_work(sqr_w)


def conj(a: Fp2) -> Fp2:
    return Fp2(a.c0, fp.neg(a.c1))


def mul_by_fp(a: Fp2, s: torch.Tensor) -> Fp2:
    return Fp2(fp.mul(a.c0, s), fp.mul(a.c1, s))


def inv(a: Fp2) -> Fp2:
    """1/a = conj(a) / norm(a); the Fp inverse is a Fermat power (fp2.py:inv)."""
    norm = fp.add(fp.sqr(a.c0), fp.sqr(a.c1))
    return mul_by_fp(conj(a), fp.pow_static(norm, P_INT - 2))


def from_ints(x0: int, x1: int, shape=(), device="cpu") -> Fp2:
    """Host: value pair -> broadcast Montgomery Fp2 tensor."""
    def c(x):
        return torch.from_numpy(mp.limbs_from_int(x * fp.SPEC.r % P_INT, 12)).to(device).expand(*shape, 12)

    return Fp2(c(x0), c(x1))


def to_ints(a: Fp2) -> tuple[int, int]:
    """Host: one Fp2 element (shape ()) -> canonical value pair."""
    return (fp.to_int(a.c0) * fp.SPEC.r_inv % P_INT, fp.to_int(a.c1) * fp.SPEC.r_inv % P_INT)


# ---------------------------------------------------------------------------
# host oracle (python ints; the tests' reference and point finding)
# ---------------------------------------------------------------------------


class HostFp2:
    """Fp2 on (int, int) value pairs mod p: the test oracle."""

    p = P_INT

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % P_INT, (a[1] + b[1]) % P_INT)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % P_INT, (a[1] - b[1]) % P_INT)

    @staticmethod
    def neg(a):
        return ((-a[0]) % P_INT, (-a[1]) % P_INT)

    @staticmethod
    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % P_INT, (a[0] * b[1] + a[1] * b[0]) % P_INT)

    @classmethod
    def sqr(cls, a):
        return cls.mul(a, a)

    @classmethod
    def pow(cls, a, e: int):
        result = (1, 0)
        base = a
        while e:
            if e & 1:
                result = cls.mul(result, base)
            base = cls.sqr(base)
            e >>= 1
        return result

    @staticmethod
    def inv(a):
        norm = (a[0] * a[0] + a[1] * a[1]) % P_INT
        ninv = pow(norm, P_INT - 2, P_INT)
        return ((a[0] * ninv) % P_INT, (-a[1] * ninv) % P_INT)

    @classmethod
    def sqrt(cls, a):
        """Square root for p = 3 mod 4 (Adj-Rodriguez); None if a is a
        non-residue."""
        if a == (0, 0):
            return (0, 0)
        a1 = cls.pow(a, (P_INT - 3) // 4)
        x0 = cls.mul(a1, a)
        alpha = cls.mul(a1, x0)  # a^((p-1)/2)
        if alpha == ((P_INT - 1) % P_INT, 0):
            x = cls.mul((0, 1), x0)
        else:
            b = cls.pow(cls.add((1, 0), alpha), (P_INT - 1) // 2)
            x = cls.mul(b, x0)
        return x if cls.sqr(x) == a else None


host = HostFp2()
