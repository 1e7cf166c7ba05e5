"""Port G1 (plain versions of kernel K4) against the JAX package's host oracle
and comb table. Jacobian limb equality is covered by the golden proof."""

import numpy as np
import pytest
import torch

from zkdl_tpu.curve import g1 as jg1
from zkdl_tpu.curve import host_g1 as jhost
from zkdl_tpu_torch.curve import g1
from zkdl_tpu_torch.field import fp, fr, mp

TOP = np.full(8, 0xFFFFFFFF, dtype=np.uint32)
TOP[7] %= np.uint32(fr.P_TOP_LIMB)  # 2^256 - 1 as setup draws it


def _affine(pt, i):
    x, y, z = (fp.SPEC.from_mont_int(mp.int_from_limbs(c[i].numpy())) for c in pt)
    return jhost.to_affine(jhost.JacPoint(x, y, z))


def _jac(p: jhost.JacPoint) -> g1.G1Jac:
    return g1.G1Jac(*(torch.from_numpy(mp.limbs_from_int(fp.SPEC.to_mont_int(c), 12)[None])
                      for c in (p.x, p.y, p.z)))


def test_comb_table_matches_jax():
    for got, want in zip(g1._comb_table(), jg1._comb_table()):
        np.testing.assert_array_equal(got, want)


def test_generator_pow_plain_matches_host_oracle():
    rng = np.random.default_rng(40)
    sc = rng.integers(0, 1 << 32, size=(6, 8), dtype=np.uint32)
    sc[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    sc[:4] = np.stack([fr.ZERO, fr.from_int(1), fr.from_int(fr.P_INT - 1), TOP])
    pts = g1.generator_pow(torch.from_numpy(sc))
    assert g1.is_identity(pts)[0] and not g1.is_identity(pts)[1:].any()
    for i in range(sc.shape[0]):
        k = mp.int_from_limbs(sc[i])
        assert _affine(pts, i) == jhost.to_affine(jhost.scalar_mul(jhost.GENERATOR, k)), i


@pytest.mark.parametrize("k", [1, 5, 12345])
def test_double_and_equal_point_add_match_host(k):
    p = jhost.scalar_mul(jhost.GENERATOR, k)
    want = jhost.to_affine(jhost.double(p))
    assert _affine(g1.double(_jac(p)), 0) == want
    aff = jhost.to_affine(p)
    q = [torch.from_numpy(mp.limbs_from_int(fp.SPEC.to_mont_int(c), 12)[None]) for c in aff]
    assert _affine(g1.add_mixed(_jac(p), *q), 0) == want  # equal points -> double(p)
    # identity + q lifts q
    ident = g1.identity((1,))
    assert _affine(g1.add_mixed(ident, *q), 0) == aff
