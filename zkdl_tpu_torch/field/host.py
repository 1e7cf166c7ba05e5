"""Host-side (pure python-int) field arithmetic: test oracle and verifier math.

Copy of ``zkdl_tpu/field/host.py``; values are Montgomery-form ints tracked
by the caller.
"""

from __future__ import annotations

from .fp import SPEC as FP_SPEC
from .fr import SPEC as FR_SPEC


class HostField:
    """Montgomery arithmetic on python ints for one field."""

    def __init__(self, spec):
        self.spec = spec
        self.p = spec.p
        self.r = spec.r
        self.r_inv = spec.r_inv
        self.one_mont = spec.r % spec.p

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b * self.r_inv) % self.p

    def sqr(self, a: int) -> int:
        return self.mul(a, a)

    def inv(self, a: int) -> int:
        x = (a * self.r_inv) % self.p
        return (pow(x, -1, self.p) * self.r) % self.p

    def mont(self, a: int) -> int:
        return (a * self.r) % self.p

    def unmont(self, a: int) -> int:
        return (a * self.r_inv) % self.p


fr = HostField(FR_SPEC)
fp = HostField(FP_SPEC)
