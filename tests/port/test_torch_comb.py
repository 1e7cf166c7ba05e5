"""K4 (the G1 comb): an integer model of the JAX comb held limb for limb
against the port's plain version and against the host oracle, and a
word-level model of the kernel's team arithmetic (csrc/g1_comb.cu: the
Montgomery product spread over a team's lanes, and the two-stage carry
resolve of its add, sub and product) held against exact integers."""

import random
import re

import numpy as np
import pytest
import torch

from zkdl_tpu_torch.curve import g1, host_g1
from zkdl_tpu_torch.field import fp, fr, mp
from zkdl_tpu_torch.utils import build

P = fp.P_INT
R = fr.P_INT  # the group order: scalars are below it on the prover's path
M32 = (1 << 32) - 1
SRC = (build.CSRC / "g1_comb.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


# ---------------------------------------------------------------------------
# integer model of zkdl_tpu/curve/g1.py:double, add_mixed, generator_pow
# (Fp values as plain ints: a Montgomery product of Montgomery forms is the
# Montgomery form of the plain product, and mont(1) is 1)
# ---------------------------------------------------------------------------


def _double(p):
    """g1.py:double (:90-103), line for line."""
    x, y, z = p
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = (x + b) ** 2 % P
    d = 2 * (d - a - c) % P
    e = (2 * a + a) % P
    f = e * e % P
    z3 = 2 * (y * z % P) % P
    x3 = (f - d - d) % P
    c8 = 8 * c % P
    y3 = ((d - x3) * e % P - c8) % P
    return p if z == 0 else (x3, y3, z3)


def _add_mixed(p, q, events):
    """g1.py:add_mixed (:135-158), line for line; events records which
    select decided the result."""
    x, y, z = p
    qx, qy = q
    z1z1 = z * z % P
    u2 = qx * z1z1 % P
    s2 = qy * z % P * z1z1 % P
    h = (u2 - x) % P
    hh = h * h % P
    i = 4 * hh % P
    j = h * i % P
    r = 2 * (s2 - y) % P
    v = x * i % P
    x3 = (r * r % P - j - 2 * v) % P
    y3 = ((v - x3) * r % P - 2 * (y * j % P)) % P
    z3 = ((z + h) ** 2 % P - z1z1 - hh) % P
    if z == 0:
        events.append("lift")
        return (qx, qy, 1)
    if x == u2 and y == s2:
        events.append("double")
        return _double(p)
    events.append("generic" if z3 else "generic to z = 0")
    return (x3, y3, z3)


def _table():
    xs, ys, _ = g1._comb_table()
    to = lambda a: fp.SPEC.from_mont_int(mp.int_from_limbs(a))  # noqa: E731
    return [[(to(xs[w, d]), to(ys[w, d])) for d in range(16)] for w in range(64)]


def _generator_pow(k: int, table, events):
    """g1.py:generator_pow (:378-397): 4-bit windows LSB first, a zero digit
    keeps the point."""
    pt = (0, 0, 0)
    for w in range(64):
        d = (k >> (4 * w)) & 15
        if d:
            pt = _add_mixed(pt, table[w][d], events)
        else:
            events.append("keep")
    return pt


def _limbs8(k: int) -> np.ndarray:
    return np.array([(k >> (32 * i)) & M32 for i in range(8)], dtype=np.uint32)


SCALARS = {"0": 0, "1": 1, "r-1": R - 1, "2^256-1 reduced": mp.int_from_limbs(
    np.array([M32] * 7 + [M32 % fr.P_TOP_LIMB], dtype=np.uint32)), "r": R, "2^256-r": (1 << 256) - R}


def test_integer_comb_matches_generator_pow_plain_and_host_oracle():
    """Limb for limb against the port's plain comb, and in affine form against
    double-and-add, on the edge scalars and seeded ones. r ends in z = 0
    through the generic formula at window 63 (p = -q there, x and y stay
    nonzero); 2^256 - r adds equal points at window 63 (double)."""
    rng = np.random.default_rng(41)
    seeded = rng.integers(0, 1 << 32, size=(3, 8), dtype=np.uint32)
    seeded[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    ks = list(SCALARS.values()) + [mp.int_from_limbs(s) for s in seeded]
    got = g1.generator_pow_plain(torch.from_numpy(np.stack([_limbs8(k) for k in ks])))
    table = _table()
    for n, k in enumerate(ks):
        events = []
        pt = _generator_pow(k, table, events)
        for c, want in zip(got, pt):
            assert mp.int_from_limbs(c[n].numpy()) == fp.SPEC.to_mont_int(want), (n, k)
        oracle = host_g1.scalar_mul(host_g1.GENERATOR, k % R)
        assert host_g1.to_affine(host_g1.JacPoint(*pt)) == host_g1.to_affine(oracle), n
        if k == R:
            assert events[63] == "generic to z = 0" and pt[2] == 0 and pt[0] and pt[1]
        elif k == (1 << 256) - R:
            assert events[63] == "double"
        else:
            assert "double" not in events and "generic to z = 0" not in events, n


# ---------------------------------------------------------------------------
# word-level model of the team arithmetic of csrc/g1_comb.cu: the same lane
# layout (lane k < 12 of a team holds limb k of every Fp value; the team's
# other four lanes idle) and the same step order as Team::mul, Team::add,
# Team::sub
# ---------------------------------------------------------------------------

NL = 12  # lanes of a team that hold a limb
NP0 = (-pow(P, -1, 1 << 32)) % (1 << 32)
BITS = (1 << NL) - 1


def _split(x: int):
    return [(x >> (32 * k)) & M32 for k in range(NL)]


def _join(lanes) -> int:
    return sum(w << (32 * k) for k, w in enumerate(lanes))


PL = _split(P)


def _resolve(flags, drop=None):
    """Team::resolve: flags[k] = (o10, o11, o200, o201, o210, o211) of lane k;
    a ballot per flag gives the team's lanes where it holds."""
    o10, o11, o200, o201, o210, o211 = (sum(int(f[q]) << k for k, f in enumerate(flags)) for q in range(6))
    G1 = o10
    P1 = o11 & ~G1
    S1 = (G1 << 1) + P1
    C1 = (S1 ^ P1) & BITS
    G2 = (o200 & ~C1) | (o210 & C1)
    P2 = ((o201 & ~C1) | (o211 & C1)) & ~G2
    S2 = (G2 << 1) + P2
    C2 = S2 ^ P2
    in1 = [0 if drop == "stage 1" else (C1 >> k) & 1 for k in range(NL)]
    in2 = [0 if drop == "stage 2" else (C2 >> k) & 1 for k in range(NL)]
    return in1, in2, S1 >> NL, S2 >> NL


def _add(x, y, drop=None):
    """Team::add: (x + y) mod p for x + y < 2p."""
    flags, s0s, s1s = [], [], []
    for k in range(NL):
        s0 = (x[k] + y[k]) & M32
        s1 = (s0 + 1) & M32
        o10 = s0 < x[k]
        flags.append((o10, o10 or s0 == M32, s0 < PL[k], s0 <= PL[k], s1 < PL[k], s1 <= PL[k]))
        s0s.append(s0)
        s1s.append(s1)
    in1, in2, _, top2 = _resolve(flags, drop)
    s = [s1s[k] if in1[k] else s0s[k] for k in range(NL)]
    return s if top2 else [(s[k] - PL[k] - in2[k]) & M32 for k in range(NL)]


def _sub(x, y, drop=None):
    """Team::sub: (x - y) mod p."""
    flags, d0s, d1s = [], [], []
    for k in range(NL):
        d0 = (x[k] - y[k]) & M32
        d1 = (d0 - 1) & M32
        s0, s1 = (d0 + PL[k]) & M32, (d1 + PL[k]) & M32
        o200, o210 = s0 < PL[k], s1 < PL[k]
        flags.append((x[k] < y[k], x[k] <= y[k], o200, o200 or s0 == M32, o210, o210 or s1 == M32))
        d0s.append(d0)
        d1s.append(d1)
    in1, in2, top1, _ = _resolve(flags, drop)
    d = [d1s[k] if in1[k] else d0s[k] for k in range(NL)]
    return [(d[k] + PL[k] + in2[k]) & M32 for k in range(NL)] if top1 else d


def _row(t, x, y):
    """Team::row: t + x y as (new word, high word for the pending carry)."""
    v = x * y + t
    assert v <= (1 << 64) - (1 << 32)
    return v & M32, v >> 32


def _shift(up, e, drop=None):
    """Team::shift: the word that lands, plus the carry pending into it."""
    v = up + (0 if drop == "pending" else e)
    return v & M32, v >> 32


def _mul(a, b, drop=None):
    """Team::mul: a * b * 2^-384 mod p, operand scanning over b's limbs."""
    a0, p0 = a[0], PL[0]
    t, e = [0] * NL, [0] * NL
    s, es = 0, 0
    for i in range(NL):
        for k in range(NL):
            t[k], hi = _row(t[k], a[k], b[i])
            e[k] += hi
        s, hi = _row(s, a0, b[i])
        es += hi
        m = s * NP0 & M32
        for k in range(NL):
            t[k], hi = _row(t[k], PL[k], m)
            e[k] += hi
        s, hi = _row(s, p0, m)
        es += hi
        assert t[0] == 0 and s == t[0] and es == e[0]  # every lane's copy of lane 0 is exact
        assert max(e) < 4 + 2 * (1 << 32)
        up = [t[k + 1] if k + 1 < NL else 0 for k in range(NL)]
        up_s = t[1]
        t, e = map(list, zip(*(_shift(up[k], e[k], drop) for k in range(NL))))
        s, es = _shift(up_s, es, drop)
        assert max(e) < 4
    assert e[NL - 1] == 0
    return _add(t, [0] + e[:-1], drop)


RINV = pow(1 << 384, -1, P)


def _operands(kind: str, n: int = 96):
    """Pairs (x, y) of canonical Fp values. "targeted": results or sums whose
    lane words sit at a carry's edge (0, all ones, or p's words), where a
    lane generates or propagates a carry between lanes."""
    rng = random.Random(f"comb-{kind}")
    if kind == "zero":
        return [(0, 0), (0, P - 1), (P - 1, 0)]
    if kind == "p_minus_1":
        return [(P - 1, P - 1), (P - 1, 1), (1, P - 1)]
    if kind == "random":
        return [(rng.randrange(P), rng.randrange(P)) for _ in range(n)]
    out = []
    while len(out) < n:
        lanes = [rng.choice([0, M32, PL[k], rng.getrandbits(32)]) for k in range(NL)]
        z = _join(lanes) % P
        y = rng.randrange(1, P)
        out.append((z * (1 << 384) * pow(y, -1, P) % P, y))  # mul result z
        out.append((z, (-z - rng.randrange(3)) % P))  # z + y at 2^... edges
        out.append((z, (z + rng.randrange(-1, 2)) % P))  # z - y near 0 or -1
    return out


@pytest.mark.parametrize("kind", ["zero", "p_minus_1", "random", "targeted"])
def test_team_arithmetic_matches_integers(kind):
    for x, y in _operands(kind):
        X, Y = _split(x), _split(y)
        assert _join(_mul(X, Y)) == x * y * RINV % P, (x, y)
        assert _join(_add(X, Y)) == (x + y) % P, (x, y)
        assert _join(_sub(X, Y)) == (x - y) % P, (x, y)


@pytest.mark.parametrize("drop", ["pending", "stage 1", "stage 2"])
def test_team_model_fails_when_a_carry_is_dropped(drop):
    """Each carry the kernel moves between words or lanes matters: dropping
    it gives wrong products (pending: the carry out of a lane's top word at
    a shift; stage 1 / stage 2: a lane's resolved carry-in) and, for the
    stage carries, wrong sums and differences, on the targeted operands."""
    bad = {"mul": 0, "add": 0, "sub": 0}
    for x, y in _operands("targeted", 96):
        X, Y = _split(x), _split(y)
        bad["mul"] += _join(_mul(X, Y, drop)) != x * y * RINV % P
        bad["add"] += _join(_add(X, Y, drop)) != (x + y) % P
        bad["sub"] += _join(_sub(X, Y, drop)) != (x - y) % P
    assert bad["mul"] > 0, bad
    if drop != "pending":
        assert bad["add"] > 0 and bad["sub"] > 0, bad


def test_kernel_source_matches_the_model():
    """The model's team shape and p' are the kernel's: a team of 16 lanes whose
    first 12 hold a limb each (Team, csrc/fp_team.cuh), two teams a warp (one
    scalar a warp, so its decisions are warp-uniform and its ballots
    whole-warp)."""
    team = (build.CSRC / "fp_team.cuh").read_text()
    assert int(re.search(r"constexpr int TEAM_WIDTH = (\d+);", team).group(1)) == 16
    assert '#include "fp_team.cuh"' in SRC and _const("THREADS") % 32 == 0
    field = (build.CSRC / "field.cuh").read_text()
    assert re.search(rf"NP0 = 0x{NP0:08x}u", field) and re.search(rf"N = {NL};", field)
