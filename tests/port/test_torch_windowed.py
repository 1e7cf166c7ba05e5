"""The port's fixed-window G1 scalar multiplication (``curve/g1.py:
scalar_mul_windowed``, K13's plain version) against the JAX package's
``g1.scalar_mul_windowed``, recorded by ``record_slice14.py`` on K5's edge
points (G, a NUMS candidate, O, (r^2, -r^3, 0)) and edge scalars (0, 1,
r - 1, the cofactor, 2^256 - 1, r, 2^256 - r) and on random ones; and in
affine form against double-and-add."""

import numpy as np
import pytest
import torch

from slice14_fixture import rec, t
from zkdl_tpu_torch.curve import convert, g1, host_g1
from zkdl_tpu_torch.field import fr

EDGE_POINTS = ("G", "a NUMS candidate", "O", "(r^2, -r^3, 0)")
N_EDGE_SCALARS = 7


def _points(sel):
    return g1.G1Jac(*(t(f"win/points.{c}")[sel] for c in "xyz"))


def test_windowed_equals_jax_and_double_and_add():
    """Every edge point under every edge scalar and the random cases, limb
    for limb; the random cases also in affine form against host
    double-and-add (the plain walk's cost is a window's, whatever the
    points: one call for all)."""
    got = g1.scalar_mul_windowed(_points(slice(None)), t("win/scalars"))
    for c, v in zip("xyz", got):
        for part, name in enumerate(EDGE_POINTS + ("random",)):
            rows = slice(part * N_EDGE_SCALARS, (part + 1) * N_EDGE_SCALARS if part < len(EDGE_POINTS) else None)
            assert np.array_equal(v[rows].numpy(), rec(f"win/out.{c}")[rows]), (name, c)
    lo = len(EDGE_POINTS) * N_EDGE_SCALARS
    pts = convert.jac_from_device(_points(slice(lo, None)))
    ks = fr.to_ints(rec("win/scalars")[lo:])
    outs = convert.jac_from_device(g1.G1Jac(*(c[lo:] for c in got)))
    for p, k, q in zip(pts, ks, outs):
        assert host_g1.to_affine(q) == host_g1.to_affine(host_g1.scalar_mul(p, k))


def test_windowed_rejects_bad_scalars():
    p = _points(slice(0, 2))
    with pytest.raises(ValueError):
        g1.scalar_mul_windowed(p, torch.zeros((3, 8), dtype=torch.uint32))
    with pytest.raises(ValueError):
        g1.scalar_mul_windowed(p, torch.zeros((2, 8), dtype=torch.int64))
