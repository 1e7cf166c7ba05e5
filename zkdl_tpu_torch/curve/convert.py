"""Host <-> device conversions for G1 point tensors.

Counterpart of ``zkdl_tpu/curve/convert.py``: a ``G1Jac`` holds Montgomery
Fp limbs, a ``host_g1.JacPoint`` plain ints.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import fp, mp
from . import g1, host_g1


def jac_to_device(points: list[host_g1.JacPoint], device="cpu") -> g1.G1Jac:
    """Python-int Jacobian points -> Montgomery-form (n, 12) tensors."""
    r, p = fp.SPEC.r, fp.P_INT

    def coords(name: str) -> torch.Tensor:
        rows = [mp.limbs_from_int(getattr(pt, name) * r % p, 12) for pt in points]
        arr = np.stack(rows) if rows else np.zeros((0, 12), dtype=np.uint32)
        return torch.from_numpy(arr).to(device)

    return g1.G1Jac(coords("x"), coords("y"), coords("z"))


def jac_from_device(t: g1.G1Jac) -> list[host_g1.JacPoint]:
    """Montgomery-form point tensor (any shape, any device) -> python-int
    Jacobian points, in row-major order."""
    r_inv, p = fp.SPEC.r_inv, fp.P_INT

    def ints(c: torch.Tensor) -> list[int]:
        raw = mp.host(c).astype("<u4").tobytes()  # 48 bytes a coordinate
        return [int.from_bytes(raw[o : o + 48], "little") * r_inv % p for o in range(0, len(raw), 48)]

    return [host_g1.JacPoint(x, y, z) for x, y, z in zip(*(ints(c) for c in t))]


def affine_from_device(t: g1.G1Jac) -> list[tuple[int, int] | None]:
    return [host_g1.to_affine(pt) for pt in jac_from_device(t)]
