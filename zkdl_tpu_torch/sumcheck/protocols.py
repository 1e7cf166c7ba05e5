"""Sumcheck provers on natural-order (n, 8) tensors, host (python-int)
verifiers and int converters.

Counterpart of ``zkdl_tpu/sumcheck/protocols.py``: ``inner_product_prove``,
``hadamard_prove`` and ``binary_prove`` (:108-156), whose scan forms
(:208-300) emit the same streams, and the verifiers (:301-371). The JAX
provers pair neighbours a[0::2], a[1::2] of the natural order, padded with
zeros to 2^r; here the operands go into bit-reversed planar storage once
and the rounds run on the planar round code (``planar_protocols.py``),
whose contiguous halves are those same pairs.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..field import fr, host, mp, planar
from ..tensor import fr_ops
from ..tensor import planar_ops as pops
from . import planar_protocols as pp

HF = host.fr


def _rev(t: torch.Tensor, r: int) -> torch.Tensor:
    """(m, 8) natural order, 2^(r-1) < m <= 2^r (or m = 1 for r = 0) ->
    (8, 2^r) bit-reversed planar, zero-padded."""
    m = t.shape[0]
    if not ((1 << r) // 2 < m <= (1 << r)):
        raise ValueError(f"sumcheck: {m} rows for {r} rounds")
    return pops.bitrev_axis(planar.to_planar(fr_ops.pad_to(t, 1 << r)), axis=1).contiguous()


def inner_product_prove(a: torch.Tensor, b: torch.Tensor, u):
    """Prove sum_i a_i * b_i for (n, 8) Montgomery a, b; u host (r, 8).
    Returns (polys (r, 3, 8), finals (2, 8)) (protocols.py:inner_product_prove)."""
    r = u.shape[0]
    return pp.inner_product_prove(_rev(a, r), _rev(b, r), mp.host(u))


def hadamard_prove(a: torch.Tensor, b: torch.Tensor, u, v):
    """Prove the elementwise-product relation at u, folding along v; (n, 8)
    Montgomery a, b; u, v host (r, 8). Returns (polys, finals (2, 8))."""
    r = u.shape[0]
    return pp.hadamard_prove(_rev(a, r), _rev(b, r), u, v)


def binary_prove(a: torch.Tensor, u, v):
    """Prove every element is a bit at u, folding along v; (n, 8) Montgomery
    a; u, v host (r, 8). Returns (polys (r, 3, 8), final (8,))."""
    return pp.binary_prove(_rev(a, u.shape[0]), u, v)


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
