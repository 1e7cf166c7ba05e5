"""Host (python-int) sumcheck verifiers and int converters.

Copy of ``zkdl_tpu/sumcheck/protocols.py:301-371``. The provers are in
``planar_protocols.py``; these check their streams on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..field import fr, host, mp

HF = host.fr


@dataclasses.dataclass
class SumcheckResult:
    ok: bool
    final_claim: int
    reason: str = ""


def _q_at(c: Sequence[int], x: int) -> int:
    """Evaluate c0 + c1*x + c2*x^2 (mont ints)."""
    return HF.add(c[0], HF.add(HF.mul(c[1], x), HF.mul(c[2], HF.mul(x, x))))


def inner_product_verify(polys: Sequence[Sequence[int]], u: Sequence[int], claim: int) -> SumcheckResult:
    """Check q_i(0)+q_i(1) == claim_i; next claim = q_i(u_i)."""
    for i, c in enumerate(polys):
        total = HF.add(c[0], _q_at(c, HF.one_mont))
        if total != claim:
            return SumcheckResult(False, claim, f"round {i}: q(0)+q(1) != claim")
        claim = _q_at(c, u[i])
    return SumcheckResult(True, claim)


def point_anchored_verify(polys: Sequence[Sequence[int]], u: Sequence[int], v: Sequence[int], claim: int) -> SumcheckResult:
    """Hadamard/binary: claim_i == (1-u_i)*q_i(0) + u_i*q_i(1); next = q_i(v_i)."""
    one = HF.one_mont
    for i, c in enumerate(polys):
        q0 = c[0]
        q1 = _q_at(c, one)
        lhs = HF.add(HF.mul(HF.sub(one, u[i]), q0), HF.mul(u[i], q1))
        if lhs != claim:
            return SumcheckResult(False, claim, f"round {i}: eq-weighted sum != claim")
        claim = _q_at(c, v[i])
    return SumcheckResult(True, claim)


def hadamard_verify(polys, u, v, claim, final_a: int, final_b: int) -> SumcheckResult:
    res = point_anchored_verify(polys, u, v, claim)
    if not res.ok:
        return res
    if HF.mul(final_a, final_b) != res.final_claim:
        return SumcheckResult(False, res.final_claim, "final product mismatch")
    return res


def binary_verify(polys, u, v, final_a: int) -> SumcheckResult:
    res = point_anchored_verify(polys, u, v, 0)
    if not res.ok:
        return res
    if HF.sub(HF.mul(final_a, final_a), final_a) != res.final_claim:
        return SumcheckResult(False, res.final_claim, "final bit-check mismatch")
    return res


def inner_product_check_final(res: SumcheckResult, final_a: int, final_b: int) -> bool:
    return res.ok and HF.mul(final_a, final_b) == res.final_claim


def polys_to_ints(polys) -> list[list[int]]:
    arr = mp.host(polys)  # (r, 3, 8)
    return [[fr.to_ints(arr[i, j][None])[0] for j in range(3)] for i in range(arr.shape[0])]


def scalars_to_ints(scalars) -> list[int]:
    return fr.to_ints(mp.host(scalars).reshape(-1, 8))
