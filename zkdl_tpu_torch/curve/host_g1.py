"""Host (python-int) G1 arithmetic: the comb table, the verifier, the oracle.

Copy of ``zkdl_tpu/curve/host_g1.py`` (plain-int Jacobian arithmetic mod p,
non-Montgomery). ``scalar_mul`` stays pure Python (the tests' oracle); the
verifier's batches go through ``scalar_mul_batch``, the native library of
``native/`` (same double-and-add, same formulas), which raises rather than
fall back when it cannot be built.
"""

from __future__ import annotations

import dataclasses

from ..field.fp import P_INT as P

B_COEFF = 4  # y^2 = x^3 + 4


@dataclasses.dataclass(frozen=True)
class JacPoint:
    x: int
    y: int
    z: int  # z == 0 => identity

    def is_identity(self) -> bool:
        return self.z == 0


IDENTITY = JacPoint(0, 0, 0)

GEN_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
GEN_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
GENERATOR = JacPoint(GEN_X, GEN_Y, 1)


def on_curve(p: JacPoint) -> bool:
    if p.is_identity():
        return True
    return (p.y * p.y - p.x**3 - B_COEFF * pow(p.z, 6, P)) % P == 0


def double(p: JacPoint) -> JacPoint:
    if p.is_identity():
        return p
    a = p.x * p.x % P
    b = p.y * p.y % P
    c = b * b % P
    d = 2 * ((p.x + b) ** 2 - a - c) % P
    e = 3 * a % P
    f = e * e % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * p.y * p.z % P
    return JacPoint(x3, y3, z3)


def add(p: JacPoint, q: JacPoint) -> JacPoint:
    if p.is_identity():
        return q
    if q.is_identity():
        return p
    z1z1 = p.z * p.z % P
    z2z2 = q.z * q.z % P
    u1 = p.x * z2z2 % P
    u2 = q.x * z1z1 % P
    s1 = p.y * q.z * z2z2 % P
    s2 = q.y * p.z * z1z1 % P
    if u1 == u2 and s1 == s2:
        return double(p)
    h = (u2 - u1) % P
    i = (2 * h) ** 2 % P
    j = h * i % P
    r = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * s1 * j) % P
    z3 = ((p.z + q.z) ** 2 - z1z1 - z2z2) * h % P
    return JacPoint(x3, y3, z3)


def neg(p: JacPoint) -> JacPoint:
    return JacPoint(p.x, (-p.y) % P, p.z)


def scalar_mul(p: JacPoint, k: int) -> JacPoint:
    """LSB-first double-and-add over 256 bits."""
    out = IDENTITY
    acc = p
    k = int(k)
    for _ in range(256):
        if k & 1:
            out = add(out, acc)
        acc = double(acc)
        k >>= 1
    return out


def scalar_mul_batch(points: list[JacPoint], scalars: list[int]) -> list[JacPoint]:
    """[scalar_mul(p, k) for p, k in zip(points, scalars)] in one native call."""
    from .. import native

    return [JacPoint(*c) for c in native.g1_scalar_mul_batch([(p.x, p.y, p.z) for p in points], scalars)]


def to_affine(p: JacPoint) -> tuple[int, int] | None:
    """None for identity; else (x, y) affine ints."""
    if p.is_identity():
        return None
    zinv = pow(p.z, -1, P)
    zinv2 = zinv * zinv % P
    return (p.x * zinv2 % P, p.y * zinv2 * zinv % P)


def eq_points(p: JacPoint, q: JacPoint) -> bool:
    return to_affine(p) == to_affine(q)
