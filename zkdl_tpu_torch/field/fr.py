"""BLS12-381 scalar field Fr: constants and host conversions.

Counterpart of ``zkdl_tpu/field/fr.py``: uint32 little-endian limbs,
Montgomery form with R = 2^256. The tensor arithmetic lives in
``field/planar.py`` (planar (8, n) layout, the prover's only Fr layout).
"""

from __future__ import annotations

import numpy as np

from . import mp

P_INT = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

SPEC = mp.FieldSpec(name="Fr", p=P_INT, n_limbs=8)

N_LIMBS = 8
# Top u32 limb of p; "uniform" Fr draws reduce their top limb mod this.
P_TOP_LIMB = 1944954707

assert list(SPEC.P_limbs) == [1, 4294967295, 4294859774, 1404937218, 161601541, 859428872, 698187080, 1944954707]
assert list(SPEC.ONE_mont) == [4294967294, 1, 215042, 1485092858, 3971764213, 2576109551, 2898593135, 405057881]
assert list(SPEC.R2_limbs) == [4092763245, 3382307216, 2274516003, 728559051, 1918122383, 97719446, 2673475345, 122214873]

ZERO = SPEC.ZERO
ONE_MONT = SPEC.ONE_mont


def from_int(x: int) -> np.ndarray:
    """Host: python int -> canonical (non-Montgomery) limbs."""
    return SPEC.from_int(x)


def from_ints(xs, mont_form: bool = False) -> np.ndarray:
    """Host: iterable of python ints -> uint32[N, 8] (optionally Montgomery)."""
    return np.stack([
        mp.limbs_from_int((x % P_INT) * (SPEC.r if mont_form else 1) % P_INT, N_LIMBS)
        for x in xs
    ])


def to_ints(a, mont_form: bool = False) -> list[int]:
    """Host: uint32[N, 8] -> python ints (demontgomerized if mont_form)."""
    arr = np.asarray(a, dtype=np.uint32).reshape(-1, N_LIMBS)
    out = []
    for row in arr:
        v = mp.int_from_limbs(row)
        if mont_form:
            v = (v * SPEC.r_inv) % P_INT
        out.append(v)
    return out
