"""The port's Fp2 (``field/fp2.py``), the Fp ops it needs (``field/fp.py``)
and G2 (``curve/g2.py``: double, add, add_mixed, neg, scalar_mul, g2_sum,
msm, the plain versions of K11 and K12) against the JAX package's
``field/fp2.py`` and ``curve/g2.py``, recorded by ``record_slice14.py``;
and a word-level model of K12's Fp2 product and squaring
(``csrc/jac.cuh:F2``) on ``csrc/fp_chain.cuh``'s lazy bound."""

import numpy as np
import pytest
import torch

from slice14_fixture import meta, rec, same, t
from test_torch_glv_fp import RINV, V, _int, _words, add_lazy, mont_mul, sub_lazy
from zkdl_tpu.curve import g2 as jg2
from zkdl_tpu.field import fp2 as jfp2
from zkdl_tpu_torch.curve import g2
from zkdl_tpu_torch.field import fp, fp2
from zkdl_tpu_torch.field.fp2 import Fp2
from zkdl_tpu_torch.utils import build

P = fp.P_INT


def F(key: str) -> Fp2:
    return Fp2(t(f"{key}.c0"), t(f"{key}.c1"))


def same_f(a: Fp2, key: str) -> bool:
    return same(a.c0, f"{key}.c0") and same(a.c1, f"{key}.c1")


def G(key: str) -> g2.G2Jac:
    return g2.G2Jac(*(Fp2(t(f"{key}.{c}0"), t(f"{key}.{c}1")) for c in "xyz"))


def same_g(p: g2.G2Jac, key: str) -> bool:
    return all(same(getattr(p, c).c0, f"{key}.{c}0") and same(getattr(p, c).c1, f"{key}.{c}1") for c in "xyz")


FP2_OPS = {
    "add": lambda a, b: fp2.add(a, b), "sub": lambda a, b: fp2.sub(a, b), "neg": lambda a, b: fp2.neg(a),
    "double": lambda a, b: fp2.double(a), "mul": lambda a, b: fp2.mul(a, b), "sqr": lambda a, b: fp2.sqr(a),
    "conj": lambda a, b: fp2.conj(a), "mul_by_fp": lambda a, b: fp2.mul_by_fp(a, b.c1),
    "inv": lambda a, b: fp2.inv(a),
}


@pytest.mark.parametrize("op", sorted(FP2_OPS))
def test_fp2_op_equals_jax(op):
    assert same_f(FP2_OPS[op](F("fp2/a"), F("fp2/b")), f"fp2/{op}")


def test_fp2_predicates_and_fp_ops_equal_jax():
    a, b = F("fp2/a"), F("fp2/b")
    assert same(fp2.is_zero(a), "fp2/is_zero") and same(fp2.eq(a, b), "fp2/eq")
    assert same(fp.neg(a.c0), "fp2/fp_neg") and same(fp.pow_static(a.c0, 5), "fp2/fp_pow5")
    assert same(fp.unmont(a.c0), "fp2/fp_unmont") and same(fp.mont(a.c0), "fp2/fp_mont")
    sel = torch.tensor([True, False] * 7)
    got = fp2.select(sel, a, b)
    assert torch.equal(got.c0[0], a.c0[0]) and torch.equal(got.c1[1], b.c1[1])


def test_fp2_host_conversions_and_oracle_equal_jax():
    pairs = [(int(x, 16), int(y, 16)) for x, y in meta("fp2_pairs")["a"]]
    for i, (x, y) in enumerate(pairs):
        e = fp2.from_ints(x, y)
        assert torch.equal(e.c0, t("fp2/a.c0")[i]) and torch.equal(e.c1, t("fp2/a.c1")[i])
        assert fp2.to_ints(e) == (x, y)
    hp, hj = fp2.host, jfp2.host
    rng = np.random.default_rng(1406)
    for _ in range(4):
        a = (int.from_bytes(rng.bytes(48), "little") % P, int.from_bytes(rng.bytes(48), "little") % P)
        b = (int.from_bytes(rng.bytes(48), "little") % P, 7)
        for op in ("add", "sub", "mul"):
            assert getattr(hp, op)(a, b) == getattr(hj, op)(a, b)
        assert hp.inv(a) == hj.inv(a) and hp.pow(a, 1234567) == hj.pow(a, 1234567)
        assert hp.sqrt(a) == hj.sqrt(a) and hp.sqrt(hp.sqr(a)) == hj.sqrt(hj.sqr(a))
    assert fp2.zeros((2,)).c0.shape == (2, 12) and fp2.to_ints(fp2.ones_mont()) == (1, 0)


def test_g2_host_points_equal_jax():
    want = [tuple(tuple(int(c, 16) for c in xy) for xy in h) for h in meta("g2_host_points")]
    assert [g2.find_point_host(s) for s in (3, 11, 29)] == want
    for s, h in zip((3, 11, 29), want):
        P_ = g2.jac_from_host(h)
        assert g2.to_affine_host(P_) == h == jg2.to_affine_host(jg2.jac_from_host(h))
    assert g2.to_affine_host(g2.identity()) is None


G2_CASES = {
    "double": lambda E, R: g2.double(E),
    "neg": lambda E, R: g2.neg(E),
    "add_self": lambda E, R: g2.add(E, E),  # p + p: the equal-point double
    "add_neg": lambda E, R: g2.add(E, g2.neg(E)),  # p + (-p): z = 0 by the generic formula
    "add_roll": lambda E, R: g2.add(E, R),  # distinct points, and p + O, O + q
    "add_roll_rev": lambda E, R: g2.add(R, E),
}


def _roll(E):
    return g2.G2Jac(*(Fp2(torch.roll(f.c0, 1, 0), torch.roll(f.c1, 1, 0)) for f in E))


@pytest.mark.parametrize("case", sorted(G2_CASES))
def test_g2_formula_equals_jax(case):
    """On [P, Q, R, O, P + (-P), 2P, P + Q, 2Q] (find_point_host(3, 11,
    29): off the r-torsion subgroup)."""
    E = G("g2/edge")
    assert same_g(G2_CASES[case](E, _roll(E)), f"g2/{case}")


@pytest.mark.parametrize("i", [0, 1, 2])
def test_g2_add_mixed_equals_jax(i):
    h = [tuple(tuple(int(c, 16) for c in xy) for xy in p) for p in meta("g2_host_points")][i]
    assert same_g(g2.add_mixed(G("g2/edge"), g2.affine_from_host(h, (8,))), f"g2/add_mixed{i}")


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8])
def test_g2_sum_equals_jax(m):
    E = G("g2/edge")
    assert same_g(g2.g2_sum(g2.G2Jac(*(Fp2(f.c0[:m], f.c1[:m]) for f in E))), f"g2/sum{m}")


def test_g2_scalar_mul_and_msm_equal_jax():
    """scalar_mul of every edge scalar (0, 1, 2, 5, r - 1, r, 2^256 - 1, two
    random) on P, Q, O, P + (-P), 2P and P + Q, and of test_tower's 5P, 2P
    and 3Q; and msm, whose JAX call is scalar_mul then g2_sum, of the 8 edge
    points by 0, 1, 2^256 - 1, r - 1 and four random scalars. The plain
    loop's cost is a bit's, whatever the points: one call for both."""
    E = G("g2/edge")
    idx = torch.from_numpy(rec("g2/smul_idx").astype(np.int64))
    n = idx.shape[0]
    pts = g2.G2Jac(*(Fp2(torch.cat([f.c0[idx], f.c0]), torch.cat([f.c1[idx], f.c1])) for f in E))
    got = g2.scalar_mul(pts, torch.cat([t("g2/smul_scalars"), t("g2/msm_scalars")]))
    assert same_g(g2.G2Jac(*(Fp2(f.c0[:n], f.c1[:n]) for f in got)), "g2/smul")
    assert same_g(g2.g2_sum(g2.G2Jac(*(Fp2(f.c0[n - 2 : n], f.c1[n - 2 : n]) for f in got))), "g2/tower_msm")
    assert same_g(g2.g2_sum(g2.G2Jac(*(Fp2(f.c0[n:], f.c1[n:]) for f in got))), "g2/msm")


def test_g2_msm_is_scalar_mul_then_sum():
    E = G("g2/edge")
    k = torch.from_numpy(np.array([[v, 0, 0, 0, 0, 0, 0, 0] for v in (3, 0, 1, 7, 2, 5, 9, 11)], np.uint32))
    a, b = g2.msm(E, k), g2.g2_sum(g2.scalar_mul(E, k))
    assert all(torch.equal(getattr(a, c).c0, getattr(b, c).c0) and torch.equal(getattr(a, c).c1, getattr(b, c).c1)
               for c in "xyz")


def test_g2_one_scalar_for_all_equals_a_scalar_each():
    E = G("g2/edge")
    k = torch.from_numpy(np.array([5, 0, 0, 0, 0, 0, 0, 0], np.uint32))
    a = g2.scalar_mul(E, k)
    b = g2.scalar_mul(E, k.expand(8, 8).contiguous())
    assert all(torch.equal(getattr(a, c).c0, getattr(b, c).c0) for c in "xyz")


def test_g2_pack_roundtrip_and_device_rules():
    E = G("g2/edge")
    back = g2.unpack(g2.pack(E))
    assert all(torch.equal(getattr(back, c).c0, getattr(E, c).c0) and torch.equal(getattr(back, c).c1, getattr(E, c).c1)
               for c in "xyz")
    with pytest.raises(ValueError):
        g2.add(E, g2.G2Jac(*(Fp2(f.c0[:2], f.c1[:2]) for f in E)))
    with pytest.raises(ValueError):
        g2.scalar_mul(E, torch.zeros((3, 8), dtype=torch.uint32))
    meta_e = g2.G2Jac(*(Fp2(f.c0.to("meta"), f.c1.to("meta")) for f in E))
    with pytest.raises(ValueError):
        g2.add(meta_e, meta_e)


# ---------------------------------------------------------------------------
# K12's Fp2 product on fp_chain.cuh's lazy values
# ---------------------------------------------------------------------------

JAC = " ".join((build.CSRC / "jac.cuh").read_text().split())


def f2_mul(a, b):
    """jac.cuh:F2::mul (Karatsuba) on fp_chain.cuh's word-level model."""
    v0 = mont_mul(a[0], b[0])
    v1 = mont_mul(a[1], b[1])
    c = mont_mul(add_lazy(V(a[0]), V(a[1])).w, add_lazy(V(b[0]), V(b[1])).w)
    return sub_lazy(V(v0), V(v1)).w, sub_lazy(sub_lazy(V(c), V(v0)), V(v1)).w


def f2_sqr(a):
    """jac.cuh:F2::sqr (complex squaring)."""
    ab = mont_mul(a[0], a[1])
    return mont_mul(add_lazy(V(a[0]), V(a[1])).w, sub_lazy(V(a[0]), V(a[1])).w), add_lazy(V(ab), V(ab)).w


def test_f2_model_mirrors_the_source():
    for line in ("const Fq v0 = mont_mul(a.c0, b.c0); const Fq v1 = mont_mul(a.c1, b.c1); "
                 "const Fq c = mont_mul(add_lazy(a.c0, a.c1), add_lazy(b.c0, b.c1)); "
                 "return {sub_lazy(v0, v1), sub_lazy(sub_lazy(c, v0), v1)};",
                 "const Fq ab = mont_mul(a.c0, a.c1); "
                 "return {mont_mul(add_lazy(a.c0, a.c1), sub_lazy(a.c0, a.c1)), add_lazy(ab, ab)};"):
        assert line in JAC, line


def _lazy_pairs():
    """Fp2 operands with components anywhere below 2p: the lazy bound's
    edges (0, 1, p - 1, p, p + 1, 2p - 1) and seeded values."""
    edges = [0, 1, P - 1, P, P + 1, 2 * P - 1]
    rng = np.random.default_rng(1407)
    rnd = [int.from_bytes(rng.bytes(48), "little") % (2 * P) for _ in range(12)]
    vals = edges + rnd
    return [((vals[i], vals[(i + 3) % len(vals)]), (vals[(i + 5) % len(vals)], vals[(i + 7) % len(vals)]))
            for i in range(len(vals))]


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_f2_model_is_the_fp2_product_below_2p(op):
    """Each component of F2::mul and F2::sqr is below 2p and, mod p, the
    Montgomery Fp2 product (a b R^-1 with u^2 = -1), for components of a
    and b anywhere below 2p."""
    for a, b in _lazy_pairs():
        if op == "mul":
            r = f2_mul([_words(a[0]), _words(a[1])], [_words(b[0]), _words(b[1])])
            want = ((a[0] * b[0] - a[1] * b[1]) * RINV % P, (a[0] * b[1] + a[1] * b[0]) * RINV % P)
        else:
            r = f2_sqr([_words(a[0]), _words(a[1])])
            want = ((a[0] * a[0] - a[1] * a[1]) * RINV % P, 2 * a[0] * a[1] * RINV % P)
        got = (_int(r[0]), _int(r[1]))
        assert got[0] < 2 * P and got[1] < 2 * P, (a, b)
        assert (got[0] % P, got[1] % P) == want, (a, b)
