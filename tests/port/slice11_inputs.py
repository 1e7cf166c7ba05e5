"""Seeded inputs of the port's GLV and blinded-tier tests, shared by the
tests and by ``record_slice11.py``, which runs the JAX package on them once.
Made with the host (python-int) G1 code, so no JAX and no device compile
is needed to rebuild them."""

from __future__ import annotations

import numpy as np
import torch

from zkdl_tpu_torch.commit import pedersen
from zkdl_tpu_torch.curve import convert, g1, host_g1
from zkdl_tpu_torch.field import fr
from zkdl_tpu_torch.tensor import fr_ops
from zkdl_tpu_torch.utils import prng

LAMBDA = g1._LAMBDA_INT
# the decomposition's edges: s1 = lambda - 1 with s2 = 0, s1 = 0 with s2 = 1
# and 1 with 1, and r - 1 (the largest scalar of the paths)
EDGE_SCALARS = (0, 1, LAMBDA - 1, LAMBDA, LAMBDA + 1, fr.P_INT - 1)
BLIND_KEYS = (10, 11)  # the blinded tests' commitment keys; 4 rows each
BLIND_ROWS = 4
# tests/test_conv.py's cases: the forwards' (seed, pad, stride), the prove
# case's and the tampered-output case's (seed, pad, stride, key)
CONV_FORWARD = [(3, 0, 1), (3, 1, 1), (3, 1, 2)]
CONV_PROVE = (4, 1, 1, 1)
CONV_TAMPER = (5, 0, 1, 2)


def conv_case(seed: int, pad: int, stride: int, small: bool):
    """tests/test_conv.py's geometry (ConvShape's fields), batch, float input
    (batch, H, W, C_in) and kernel (kh, kw, C_in, C_out) for one case."""
    rng = np.random.default_rng(seed)
    h, c_in, c_out, batch = (4, 1, 2, 1) if small else (6, 2, 3, 2)
    shape = dict(h=h, w=h, c_in=c_in, c_out=c_out, kh=3, kw=3, stride=stride, pad=pad)
    x = (rng.standard_normal((batch, h, h, c_in)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((3, 3, c_in, c_out)) * 0.5).astype(np.float32)
    return shape, batch, x, k


def rand_scalars(seed: int, n: int) -> list[int]:
    a = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8), dtype=np.uint32)
    a[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    return fr.to_ints(a)


def glv_inputs() -> tuple[g1.G1Jac, torch.Tensor]:
    """(38,) CPU points and (38, 8) raw scalars: every edge scalar on the
    generator, a random point (Jacobian, z != 1), the identity (0, 0, 0) and
    an identity with other limbs (P + (-P) by the generic formula: (r^2,
    -r^3, 0)); six random scalars below r on six random points; and the
    blinded tests' H^b rows, H by the random_fr blinders of BLIND_KEYS."""
    G = host_g1.GENERATOR
    R = [host_g1.scalar_mul(G, k) for k in rand_scalars(1101, 7)]
    junk = host_g1.add(R[0], host_g1.neg(R[0]))
    assert junk.is_identity() and junk.x != 0
    pts, scal = [], []
    for p in (G, R[0], host_g1.IDENTITY, junk):
        pts += [p] * len(EDGE_SCALARS)
        scal += list(EDGE_SCALARS)
    pts += R[1:]
    scal += rand_scalars(1102, 6)
    H = convert.jac_from_device(pedersen.blinding_point("cpu"))[0]
    for key in BLIND_KEYS:
        pts += [H] * BLIND_ROWS
        scal += fr.to_ints(fr_ops.random_fr(prng.PRNGKey(key), BLIND_ROWS, "cpu").numpy())
    limbs = np.stack([fr.from_int(s) if s < fr.P_INT else np.zeros(8, np.uint32) for s in scal])
    return convert.jac_to_device(pts), torch.from_numpy(limbs)
