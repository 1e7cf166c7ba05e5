"""The plain arithmetic that the chip checks hold the CUDA kernels against,
and the verifier's two routes through the openings' group math, on the CPU.

- field/mp.py:mont_mul (Toeplitz products for the constant factors, one
  shifted multiply-add a digit for the variable one) against the
  straight-line formula it replaced (every column of a product by one 0/1
  scatter-matrix product) and against Python integers, for Fp and Fr.
- curve/g1.py:_scalar_mul_w (bit b adds and doubles only the points whose
  scalar needs it) against the loop it replaced (every point through every
  bit up to the batch's highest), on the edge scalars in one batch.
- commit/pedersen.py: the openings' group math as the card runs it
  (_reveal_group_math: one scalar_mul for the MSMs, g1.me_evals for the
  row-commitment MLEs; here their plain versions) against the native host
  library's route (_reveal_group_math_host), which verify_reveals takes
  for openings on the CPU.
"""

import random

import numpy as np
import pytest
import torch

from zkdl_tpu_torch.commit import pedersen
from zkdl_tpu_torch.curve import g1, host_g1
from zkdl_tpu_torch.field import fp, fr, mp
from zkdl_tpu_torch.tensor import fr_ops


# --- mont_mul ---------------------------------------------------------------


def _scatter(D: int) -> torch.Tensor:
    S = torch.zeros((2 * D - 1, D * D), dtype=torch.float64)
    for i in range(D):
        for j in range(D):
            S[i + j, i * D + j] = 1.0
    return S


def _columns(ad: torch.Tensor, bd: torch.Tensor, n_cols: int) -> torch.Tensor:
    D = ad.shape[0]
    prod = (ad.to(torch.float64).unsqueeze(1) * bd.to(torch.float64).unsqueeze(0)).reshape(D * D, -1)
    cols = (_scatter(D) @ prod).to(torch.int64).reshape(2 * D - 1, *ad.shape[1:])
    if n_cols <= 2 * D - 1:
        return cols[:n_cols]
    return torch.cat([cols, torch.zeros_like(cols[: n_cols - 2 * D + 1])])


def mont_mul_scatter(spec, a, b):
    """mont_mul as one scatter-matrix product a column sum."""
    D = spec.n_digits
    a, b = torch.broadcast_tensors(a, b)
    T = mp.normalize_digits(_columns(mp.to_digits(a), mp.to_digits(b), 2 * D))
    low = T[:D]
    m = mp.normalize_digits(_columns(low, mp.const(mp.digits_from_int(spec.np_full, D), low).expand_as(low), D))
    total = _columns(m, mp.const(mp.digits_from_int(spec.p, D), m).expand_as(m), 2 * D + 1)
    total[: 2 * D] += T
    r = mp.from_digits(mp.normalize_digits(total)[D : 2 * D])
    return mp.sub_p_if_gte(spec.P_limbs, r)


def _limbs(values, n_limbs):
    return torch.from_numpy(np.stack([mp.limbs_from_int(v, n_limbs) for v in values], 1).astype(np.int64))


def _ints(t):
    return [sum(int(t[i, j]) << (32 * i) for i in range(t.shape[0])) for j in range(t.shape[1])]


@pytest.mark.parametrize("spec", [fp.SPEC, fr.SPEC], ids=["Fp", "Fr"])
def test_mont_mul_equals_scatter_formula(spec):
    p, L = spec.p, spec.n_limbs
    R = 1 << (32 * L)
    rng = random.Random(91 + L)
    edge = [0, 1, 2, 3, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2, R % p, R * R % p, (R - 1) % p,
            (1 << 32) - 1, 1 << 32, (1 << (32 * L - 32)) % p, (1 << 255) % p, p >> 1]
    edge += [rng.randrange(p) for _ in range(16)]
    a_int = [x for x in edge for _ in edge]
    b_int = [y for _ in edge for y in edge]
    a, b = _limbs(a_int, L), _limbs(b_int, L)
    got = mp.mont_mul(spec, a, b)
    assert torch.equal(got, mont_mul_scatter(spec, a, b))
    r_inv = pow(R, -1, p)
    assert _ints(got) == [x * y * r_inv % p for x, y in zip(a_int, b_int)]


# --- the plain scalar multiplication's loop -----------------------------------


def scalar_mul_w_full(p, bits):
    """Every point through add and double at every bit up to the batch's
    highest set bit."""
    zero = torch.zeros_like(p[0])
    out, acc = (zero, zero, zero), p
    live = bits.any(0).nonzero()
    top = int(live.max()) if live.numel() else -1
    for b in range(top + 1):
        m = bits[:, b]
        if bool(m.any()):
            out = g1._select_w(m, g1._add_w(out, acc), out)
        if b < top:
            acc = g1._double_w(acc)
    return out


@pytest.mark.parametrize("with_top", [True, False], ids=["full_width", "low_bits"])
def test_scalar_mul_loop_equals_full_loop(with_top):
    """Points of NUMS(8) and the identity, each with its own scalar: 0, 1,
    2, 3, r - 1, r (z = 0 through the generic formula), 2^256 - r (the
    equal-point double), 2^256 - 1, and below: scalars whose top bits
    differ point by point."""
    r = fr.P_INT
    scalars = [0, 1, 2, 3, 5, 1 << 40, (1 << 41) - 1, 0x1234567, 77]
    if with_top:
        scalars += [r - 1, r, (1 << 256) - r, (1 << 256) - 1, 1 << 255, random.Random(5).getrandbits(256)]
    n = len(scalars)
    gens = pedersen.nums_generators(8, torch.device("cpu")).points
    pts = g1.G1Jac(*(torch.cat([c[torch.arange(n - 1) % 8], torch.zeros_like(c[:1])]) for c in gens))
    sc = torch.from_numpy(np.stack([mp.limbs_from_int(s, 8) for s in scalars]))
    work = tuple(fp.to_work(c) for c in pts)
    bits = g1._scalar_bits(sc)
    got, want = g1._scalar_mul_w(work, bits), scalar_mul_w_full(work, bits)
    for u, v in zip(got, want):
        assert torch.equal(u, v)


# --- the openings' group math: the card's route against the host library's ---


def test_reveal_group_math_routes_agree():
    """Openings over NUMS(8) and NUMS(4) of a bit tensor and a wide one, and
    one against the wrong commitment: each MSM and each row-commitment MLE
    of the card's route is the host route's point, and both routes split
    the point alike."""
    rng = np.random.default_rng(93)
    g8, g4 = pedersen.nums_generators(8, torch.device("cpu")), pedersen.nums_generators(4, torch.device("cpu"))
    bits = rng.integers(0, 2, 40).astype(np.uint32)
    t_bits = fr_ops.mont_bits(torch.from_numpy(bits))
    t_wide = torch.from_numpy(fr.from_ints([int(v) for v in rng.integers(0, 1 << 62, 12)] + [fr.P_INT - 3] * 4,
                                           mont_form=True))
    com_bits, com_wide = pedersen.commit_many([(g8, t_bits), (g4, t_wide)])
    u6 = fr.from_ints([11 + 5 * i for i in range(6)], mont_form=True)
    u4 = fr.from_ints([7 + 3 * i for i in range(4)], mont_form=True)
    checks = []
    for gens, t, com, u in ((g8, t_bits, com_bits, u6), (g4, t_wide, com_wide, u4)):
        op = pedersen.open_reveal(gens, t, com, torch.from_numpy(u))
        checks.append((op, gens, com, fr.to_ints(u), None))
    moved = pedersen.RowCommitments(points=g1.G1Jac(*(c[[1, 0, 2, 3, 4]] for c in com_bits.points)))
    checks.append((checks[0][0], g8, moved, checks[0][3], None))
    live = list(range(len(checks)))
    card = pedersen._reveal_group_math(checks, live)
    host = pedersen._reveal_group_math_host(checks, live)
    assert card[2] == host[2]
    for k in live:
        assert host_g1.eq_points(card[0][k], host[0][k]), ("msm", k)
        assert host_g1.eq_points(card[1][k], host[1][k]), ("mle", k)
    assert host_g1.eq_points(card[0][0], card[1][0]) and host_g1.eq_points(card[0][1], card[1][1])
    assert not host_g1.eq_points(card[0][2], card[1][2])
