"""K5 and K6 (csrc/g1_var.cu) on the CPU, where the kernels cannot run:
models of what they do, over Python integers.

- K5: the kernel's formula code (Var::dbl and Var::add_dbl, read from the
  source and run over integers, each mul2 round computing its two products
  as the two teams do, on the operands selected per team) and its per-bit
  step (a warp of points, every decision a select under a warp-wide any),
  against a line-for-line model of zkdl_tpu/curve/g1.py:scalar_mul, with
  the decisions recorded as events; on the edge scalars and points, with
  one, four and sixteen points a warp (the Team, Quad and Solo layouts).
  The line model, which the one-thread form follows line for line, is held
  against the port's plain version and the host oracle.
- K6: a model of the per-block list (classification, the direct writes,
  the generic pairs appended warp by warp in any order, then added)
  against add_plain and add_bits_plain.
- The word-level arithmetic of the four-lane team (Quad in
  csrc/fp_team.cuh) against exact integers.
- The constants and round tables the models assume, read from the source.
Each model fails on a deliberately broken schedule.
"""

import functools
import random
import re

import numpy as np
import pytest
import torch

from zkdl_tpu_torch.commit import pedersen
from zkdl_tpu_torch.curve import g1, host_g1
from zkdl_tpu_torch.field import fp, fr, mp
from zkdl_tpu_torch.utils import build

P = fp.P_INT
R = fr.P_INT
M32 = (1 << 32) - 1
SRC = (build.CSRC / "g1_var.cu").read_text()
VAR_SRC = (build.CSRC / "g1_var.cuh").read_text()  # Var, K5's formulas
TEAM_SRC = (build.CSRC / "fp_team.cuh").read_text()
COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr (?:int|int64_t) {name} = (\d+);", src).group(1))


# ---------------------------------------------------------------------------
# line-for-line integer models of zkdl_tpu/curve/g1.py (Fp values as plain
# ints: a Montgomery product of Montgomery forms is the Montgomery form of
# the plain product, and 0 stays 0)
# ---------------------------------------------------------------------------


def _double(p):
    """g1.py:double (:90-103)."""
    x, y, z = p
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) ** 2 - a - c) % P
    e = 3 * a % P
    f = e * e % P
    z3 = 2 * (y * z % P) % P
    x3 = (f - 2 * d) % P
    y3 = ((d - x3) * e - 8 * c) % P
    return p if z == 0 else (x3, y3, z3)


def _add(p, q, events):
    """g1.py:add (:106-132), its selects in its order (same -> double(p),
    q == O -> p, p == O -> q: the last that holds wins); events records
    which decided."""
    (x1, y1, z1), (x2, y2, z2) = p, q
    z1z1, z2z2 = z1 * z1 % P, z2 * z2 % P
    u1, u2 = x1 * z2z2 % P, x2 * z1z1 % P
    s1, s2 = y1 * z2 % P * z2z2 % P, y2 * z1 % P * z1z1 % P
    h = (u2 - u1) % P
    i = (2 * h) ** 2 % P
    j = h * i % P
    r = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * (s1 * j % P)) % P
    z3 = ((z1 + z2) ** 2 - z1z1 - z2z2) % P * h % P
    out, ev = (x3, y3, z3), "generic" if z3 else "generic to z = 0"
    if u1 == u2 and s1 == s2:
        out, ev = _double(p), "double"
    if z2 == 0:
        out, ev = p, "q is O"
    if z1 == 0:
        out, ev = q, "p is O"
    events.append(ev)
    return out


def _scalar_mul(p, k, events):
    """g1.py:scalar_mul (:168-184): 256 bits LSB first, out = bit ? add(out,
    acc) : out, acc = double(acc); events gets (bit, decision) per set bit."""
    out, acc = (0, 0, 0), p
    for b in range(256):
        if (k >> b) & 1:
            ev = []
            out = _add(out, acc, ev)
            events.append((b, ev[0]))
        acc = _double(acc)
    return out


def _neg(p):
    return (p[0], -p[1] % P, p[2])


def _from_host(p: host_g1.JacPoint):
    return (p.x, p.y, p.z)


G = _from_host(host_g1.GENERATOR)
NUMS = [(x, y, 1) for _, x, y in pedersen._nums_affine(1)][0]
O = (0, 0, 0)
C = _add(G, _neg(G), [])  # p + (-p): (r^2, -r^3, 0)
EDGE_POINTS = {"G": G, "a NUMS candidate": NUMS, "O": O, "(r^2, -r^3, 0)": C}
EDGE_SCALARS = {"0": 0, "1": 1, "r-1": R - 1, "the cofactor": COFACTOR, "2^256-1": (1 << 256) - 1, "r": R,
                "2^256-r": (1 << 256) - R}


def test_line_model_matches_plain_and_oracle():
    """The line model against the port's plain version, limb for limb, on
    small scalars (the plain loop runs to the highest bit, so they are
    cheap) on the edge points; and in affine form against double-and-add
    for every edge scalar on G and the NUMS candidate. r runs the generic
    formula to z = 0 on G (at bit 254, out = -acc) and 2^256 - r adds equal
    points (bit 255: double)."""
    assert C[2] == 0 and C[0] and C[1]
    pts = list(EDGE_POINTS.values())
    ks = [0, 1, 2, 3, 5, 37]
    pairs = [(p, k) for p in pts for k in ks]
    limbs = lambda v: torch.from_numpy(mp.limbs_from_int(fp.SPEC.to_mont_int(v), 12))  # noqa: E731
    got = g1.scalar_mul_plain(g1.G1Jac(*(torch.stack([limbs(p[c]) for p, _ in pairs]) for c in range(3))),
                              torch.stack([torch.from_numpy(fr.from_int(k)) for _, k in pairs]))
    for n, (p, k) in enumerate(pairs):
        want = _scalar_mul(p, k, [])
        assert tuple(fp.SPEC.from_mont_int(mp.int_from_limbs(c[n].numpy())) for c in got) == want, (n, k)
    for name, p in (("G", G), ("a NUMS candidate", NUMS)):
        for label, k in EDGE_SCALARS.items():
            events = []
            pt = _scalar_mul(p, k, events)
            oracle = host_g1.scalar_mul(host_g1.JacPoint(*p), k % R if name == "G" else k)
            assert host_g1.to_affine(host_g1.JacPoint(*pt)) == host_g1.to_affine(oracle), (name, label)
            if name == "G" and label == "r":
                assert events[-1] == (254, "generic to z = 0") and pt[2] == 0 and pt[0] and pt[1]
            if name == "G" and label == "2^256-r":
                assert (255, "double") in events


# ---------------------------------------------------------------------------
# K5: the kernel's formula code over integers, a warp of points at a time
# ---------------------------------------------------------------------------


def _body(name: str) -> str:
    """The body of Var::<name> in g1_var.cuh."""
    m = re.search(rf"__device__ static \w+ {name}\(const T& tm,[^)]*\) \{{\n(.*?)\n  \}}\n", VAR_SRC, re.S)
    return m.group(1)


def _statements(name: str) -> list[str]:
    body = re.sub(r"//[^\n]*", "", _body(name))
    return [" ".join(s.split()) for s in body.split(";") if s.strip()]


def _rounds(name: str) -> list[tuple]:
    """Var::<name>'s product rounds in order: ("mul2", x0, y0, x1, y1, o0,
    o1) computes o0 = x0 y0 on team 0 and o1 = x1 y1 on team 1; ("mul", a,
    b) computes a b on both."""
    out = []
    for s in _statements(name):
        for m in re.finditer(r"tm\.(mul2?)\(", s):
            depth, i = 1, m.end()
            while depth:
                depth += {"(": 1, ")": -1}.get(s[i], 0)
                i += 1
            out.append((m.group(1), *_args(s[m.end():i - 1])))
    return out


def _args(s: str) -> list[str]:
    """Split a call's arguments at its top-level commas."""
    out, depth, cur = [], 0, ""
    for ch in s:
        depth += {"(": 1, ")": -1}.get(ch, 0)
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return out + [cur.strip()]


# The schedules the models assume (the kernel's, checked below): dbl-2009-l
# in 4 rounds; add-2007-bl of out (P1) and acc (P2) with dbl-2009-l of acc,
# 23 products in 12 rounds.
DBL_ROUNDS = [
    ("mul2", "P.x", "P.x", "P.y", "P.y", "A", "B"),
    ("mul2", "B", "B", "E", "E", "C", "F"),
    ("mul2", "XB", "XB", "P.y", "P.z", "XB2", "YZ"),
    ("mul", "tm.sub(D, X3)", "E"),
]
ADD_DBL_ROUNDS = [
    ("mul2", "P1.z", "P1.z", "P2.z", "P2.z", "Z1Z1", "Z2Z2"),
    ("mul2", "P1.y", "P2.z", "P2.y", "P1.z", "S1a", "S2a"),
    ("mul2", "P1.x", "Z2Z2", "P2.x", "Z1Z1", "U1", "U2"),
    ("mul2", "S1a", "Z2Z2", "S2a", "Z1Z1", "S1", "S2"),
    ("mul2", "H2", "H2", "R", "R", "I", "RR"),
    ("mul2", "H", "I", "U1", "I", "J", "V"),
    ("mul2", "VX", "R", "S1", "J", "VR", "SJ"),
    ("mul2", "ZS", "ZS", "P2.x", "P2.x", "ZZ", "A"),
    ("mul2", "T2", "H", "P2.y", "P2.y", "Z3", "B"),
    ("mul2", "P2.y", "P2.z", "E", "E", "YZ", "F"),
    ("mul2", "B", "B", "XB", "XB", "C", "XB2"),
    ("mul", "tm.sub(D, X3d)", "E"),
]


class Pt(tuple):
    """A point of per-point value vectors (numpy object arrays of ints)."""

    def __new__(cls, x, y, z):
        return super().__new__(cls, (x, y, z))

    x = property(lambda s: s[0])
    y = property(lambda s: s[1])
    z = property(lambda s: s[2])


def _formulas(swap: int | None = None):
    """Var::dbl and Var::add_dbl compiled from the kernel's source into
    Python over per-point vectors. Each mul2 round runs as the two teams run
    it: team t multiplies the operands selected for it (x1, y1 if t else x0,
    y0), and each team's product reaches both (o0 from team 0, o1 from team
    1). swap = k exchanges the two teams' operand selects in the k-th mul2
    round the formulas run (a broken schedule)."""
    count = [0]

    def mul2(x0, y0, x1, y1):
        k, count[0] = count[0], count[0] + 1
        prods = []
        for team in (0, 1):
            t = 1 - team if k == swap else team
            x, y = (x1, y1) if t else (x0, y0)
            prods.append(x * y % P)
        return prods[0], prods[1]

    # the team's Fp operations (tm.f) as f_f, apart from the point formulas
    ns = {"f_mul2": mul2, "f_mul": lambda a, b: a * b % P, "f_add": lambda a, b: (a + b) % P,
          "f_sub": lambda a, b: (a - b) % P, "f_dbl": lambda a: 2 * a % P, "f_eq": lambda a, b: a == b, "Pt": Pt}
    for name, params, tail in (("dbl", "P", ""), ("add_dbl", "P1, P2", "    return sum, same, dbl2\n")):
        lines = []
        for s in _statements(name):
            if s.startswith("Fp ") and "=" not in s:
                continue  # declarations
            s = s.replace("tm.", "f_").replace("&&", "&")
            m = re.fullmatch(r"f_mul2\((.*)\)", s)
            if m:
                a = _args(m.group(1))
                s = f"{a[4]}, {a[5]} = f_mul2({', '.join(a[:4])})"
            s = re.sub(r"^const Fp ", "", s)
            s = re.sub(r"\{(.*)\}", r"Pt(\1)", s)
            lines.append("    " + s + "\n")
        exec(f"def {name}({params}):\n" + "".join(lines) + tail, ns)
    return ns["dbl"], ns["add_dbl"]


def _sel(c, a: Pt, b: Pt) -> Pt:
    return Pt(*(np.where(c, u, v) for u, v in zip(a, b)))


def _step(dbl, add_dbl, out: Pt, acc: Pt, bit, b: int, events, always_add: bool):
    """Var::step over a warp's points (checked against the source below);
    always_add: the layout's ALWAYS_ADD (every bit runs add_dbl)."""
    out_O, acc_O = out.z == 0, acc.z == 0
    gen = bit & ~out_O & ~acc_O
    if always_add or gen.any():
        s, same, nxt = add_dbl(out, acc)
        if (gen & same).any():
            s = _sel(same, dbl(out), s)
        out = _sel(gen, s, out)
    else:
        same, nxt = np.zeros_like(bit), dbl(acc)
    for j in np.nonzero(bit)[0]:
        ev = ("p is O" if out_O[j] else "q is O" if acc_O[j] else "double" if same[j] else
              "generic" if out.z[j] else "generic to z = 0")
        events[j].append((b, ev))
    out = _sel(bit & out_O, acc, out)
    acc = _sel(acc_O, acc, nxt)
    return out, acc


LAYOUTS = {1: "Team", 4: "Quad", 16: "Solo"}  # points a warp -> the layout of fp_team.cuh


def _always_add(team: str) -> bool:
    return re.search(rf"struct {team} {{.*?ALWAYS_ADD = (true|false);", TEAM_SRC, re.S).group(1) == "true"


def _kernel_scalar_mul(points, scalars, per_warp: int, swap=None):
    """g1_scalar_mul_kernel<T> with per_warp points a warp (LAYOUTS): a
    warp's lanes past the last point mirror it; the warp runs to its points'
    highest set bit; out starts at (0, 0, 0). Returns the outputs and each
    point's events."""
    dbl, add_dbl = _formulas(swap)
    always_add = _always_add(LAYOUTS[per_warp])
    outs, events = [], []
    for w in range(0, len(points), per_warp):
        pts = points[w:w + per_warp]
        ks = scalars[w:w + per_warp]
        live = len(pts)
        pts, ks = pts + [pts[-1]] * (per_warp - live), ks + [ks[-1]] * (per_warp - live)
        acc = Pt(*(np.array([p[c] for p in pts], dtype=object) for c in range(3)))
        out = Pt(*(np.zeros(per_warp, dtype=object) for _ in range(3)))
        ev = [[] for _ in range(per_warp)]
        for b in range(max(k.bit_length() for k in ks)):
            out, acc = _step(dbl, add_dbl, out, acc, np.array([bool((k >> b) & 1) for k in ks]), b, ev, always_add)
        outs += [tuple(int(c[j]) for c in out) for j in range(live)]
        events += ev[:live]
    return outs, events


def _edge_cases(seed: int):
    """Every edge scalar on every edge point (a warp of four holds one point
    with four scalars), then the same pairs in a seeded order (warps mixing
    points), and two random scalars below r on G."""
    pairs = [(p, k) for p in EDGE_POINTS.values() for k in EDGE_SCALARS.values()]
    rng = random.Random(seed)
    mixed = pairs[:]
    rng.shuffle(mixed)
    return pairs + mixed + [(G, rng.randrange(R)), (G, rng.randrange(R))]


@pytest.mark.parametrize("per_warp", [1, 4, 16], ids=["one point a warp", "four points a warp", "sixteen points a warp"])
def test_k5_schedule_matches_scalar_mul(per_warp):
    """The kernel's rounds and step, a warp of points at a time, give
    g1.py:scalar_mul's limbs and its decisions (the first add's copy, the
    identity cases, equal points, z = 0 through the generic formula) at
    every set bit, on every edge scalar and point."""
    assert len(_rounds("add_dbl")) == 12 and len(_rounds("dbl")) == 4
    cases = _edge_cases(per_warp)
    got, got_events = _kernel_scalar_mul([p for p, _ in cases], [k for _, k in cases], per_warp)
    seen = set()
    for n, (p, k) in enumerate(cases):
        events = []
        assert got[n] == _scalar_mul(p, k, events), n
        assert got_events[n] == events, n
        seen.update(e for _, e in events)
    assert seen == {"p is O", "double", "generic", "generic to z = 0"}  # acc is O only if out is


@pytest.mark.parametrize("round_", range(14))
def test_k5_model_fails_when_a_round_swaps_its_teams(round_):
    """Each mul2 round of the schedule matters: exchanging the two teams'
    operand selects in any one round (round_ counts the mul2 rounds a bit
    runs: add_dbl's 11, then a double's 3) breaks the product on G by a
    scalar that runs add_dbl at its second set bit and a double at its
    first and at a clear bit."""
    k = 0b1101  # bit 0: first add (copy) with a double; bit 1: double only; bits 2, 3: add_dbl
    want = _scalar_mul(G, k, [])
    # the mul2 rounds of this walk: bit 0 dbl (3), bit 1 dbl (3), bit 2 add_dbl (11), bit 3 add_dbl (11)
    swap = 6 + round_ if round_ < 11 else round_ - 11
    got, _ = _kernel_scalar_mul([G], [k], 1, swap=swap)
    assert got[0] != want


# ---------------------------------------------------------------------------
# K6: the per-block list
# ---------------------------------------------------------------------------


def _k6_tile(n: int) -> int:
    """zk_g1_add's tile: ADD_TILE pairs a block where the launch then fills
    ADD_BLOCKS blocks, else the smallest multiple of ADD_THREADS that does."""
    threads, blocks = _const(SRC, "ADD_THREADS"), 4 * 132
    return min(_const(SRC, "ADD_TILE"), -(-(-(-n // blocks)) // threads) * threads)


def _k6_model(p_at, q_at, n: int, tile: int, threads: int, rng, broken=None):
    """g1_add_kernel: a block of `threads` lanes takes `tile` pairs; pass 1
    writes every pair whose one side is the identity (p == O: q, else q ==
    O: p) and appends the generic pairs warp by warp (one atomic a warp, so
    the warps' groups land in any order); pass 2 adds the listed pairs.
    broken: "copy p" (O + q written as p), "tail" (the last partial tile
    dropped), "overwrite" (each warp's group written at the list's start)."""
    out = [None] * n
    last = n if broken != "tail" else n - n % tile
    for base in range(0, last, tile):
        m = min(tile, n - base)
        groups = []
        for j0 in range(0, m, threads):
            for w in range(0, threads, 32):
                group = []
                for j in range(j0 + w, min(j0 + w + 32, m)):
                    p, q = p_at(base + j), q_at(base + j)
                    if p[2] == 0:
                        out[base + j] = p if broken == "copy p" else q
                    elif q[2] == 0:
                        out[base + j] = p
                    else:
                        group.append(j)
                groups.append(group)
        rng.shuffle(groups)
        listed = []
        for group in groups:
            if broken == "overwrite":
                listed[:len(group)] = group
            else:
                listed += group
        for j in listed:
            out[base + j] = _add(p_at(base + j), q_at(base + j), [])
    return out


@functools.lru_cache(maxsize=None)
def _limbs(v: int) -> np.ndarray:
    return mp.limbs_from_int(fp.SPEC.to_mont_int(v), 12)


@functools.lru_cache(maxsize=None)
def _value(row: bytes) -> int:
    return fp.SPEC.from_mont_int(mp.int_from_limbs(np.frombuffer(row, dtype=np.uint32)))


def _mont_points(pts) -> g1.G1Jac:
    return g1.G1Jac(*(torch.from_numpy(np.stack([_limbs(p[c]) for p in pts])) for c in range(3)))


def _ints(pt: g1.G1Jac) -> list:
    cs = [[_value(r.tobytes()) for r in c.numpy()] for c in pt]
    return list(zip(*cs))


def _k6_inputs(n: int, seed: int):
    """2n points: random (distinct z), the identity (0, 0, 0) and (r^2, -r^3,
    0), equal points and negations, so that the pairs (2i, 2i + 1) take every
    kind: O + O, O + q, p + O, p + p (double), p + (-p) (z = 0), generic."""
    rng = random.Random(seed)
    base = [_from_host(host_g1.scalar_mul(host_g1.GENERATOR, rng.randrange(1, 1 << 40))) for _ in range(24)]
    flat = []
    for _ in range(n):
        kind = rng.randrange(10)
        p, q = rng.choice(base), rng.choice(base)
        if kind == 0:
            p, q = rng.choice([O, C]), rng.choice([O, C])
        elif kind in (1, 2):
            p = rng.choice([O, C])
        elif kind in (3, 4):
            q = rng.choice([O, C])
        elif kind == 5:
            q = p
        elif kind == 6:
            q = _neg(p)
        flat += [p, q]
    return flat


@pytest.mark.parametrize("mode", ["pairs", "strided halves", "q negated"])
def test_k6_list_matches_add_plain(mode):
    """Two tiles and an odd tail of pairs of every kind, as add (p[i] +
    q[i]), on strided halves of one vector (me_step's a0, a1; the tree's
    levels), and with q negated (me_step's a1 + (-a0))."""
    tile, threads = _const(SRC, "ADD_TILE"), _const(SRC, "ADD_THREADS")
    n = tile + 37
    flat = _k6_inputs(n, 61)
    neg = mode == "q negated"
    if mode == "strided halves":
        ps, qs = flat[0::2], flat[1::2]
        dev = _mont_points(flat)
        p_t, q_t = g1.G1Jac(*(c[0::2] for c in dev)), g1.G1Jac(*(c[1::2] for c in dev))
    else:
        ps, qs = flat[:n], flat[n:]
        p_t, q_t = _mont_points(ps), _mont_points(qs)
    q_at = (lambda i: _neg(qs[i])) if neg else (lambda i: qs[i])
    want = _ints(g1.add_plain(p_t, q_t, neg_q=neg))
    for t in (_k6_tile(n), tile):  # this launch's tile (many blocks), and the largest (one block and a tail)
        assert _k6_model(lambda i: ps[i], q_at, n, t, threads, random.Random(5)) == want, t


@pytest.mark.parametrize("gen", [1, 7, 64])
def test_k6_list_matches_add_bits_plain(gen):
    """Bit mode: leaf(e) = bits[e] ? G[e mod gen] : O, over two tiles and a
    tail; gen = 1 pairs a generator with itself (double)."""
    tile, threads = _const(SRC, "ADD_TILE"), _const(SRC, "ADD_THREADS")
    n = tile + 5
    rng = np.random.default_rng(62 + gen)
    bits = (rng.random(2 * n) < 0.5).astype(np.uint32)
    gens = [_from_host(host_g1.scalar_mul(host_g1.GENERATOR, int(k))) for k in rng.integers(1, 1 << 40, gen)]
    leaf = lambda e: gens[e % gen] if bits[e] else O  # noqa: E731
    want = _ints(g1.add_bits_plain(torch.from_numpy(bits), _mont_points(gens)))
    for t in (_k6_tile(n), tile):
        assert _k6_model(lambda i: leaf(2 * i), lambda i: leaf(2 * i + 1), n, t, threads, random.Random(6)) == want


@pytest.mark.parametrize("broken", ["copy p", "tail", "overwrite"])
def test_k6_model_fails_when_broken(broken):
    tile, threads = _const(SRC, "ADD_TILE"), _const(SRC, "ADD_THREADS")
    n = tile + 37
    flat = _k6_inputs(n, 63)
    ps, qs = flat[:n], flat[n:]
    want = _k6_model(lambda i: ps[i], lambda i: qs[i], n, tile, threads, random.Random(7))
    got = _k6_model(lambda i: ps[i], lambda i: qs[i], n, tile, threads, random.Random(7), broken=broken)
    assert got != want


# ---------------------------------------------------------------------------
# word-level model of the four-lane team (Quad in csrc/fp_team.cuh): lane k
# holds words 3k .. 3k + 2; the same steps as Quad::mul, add, sub
# ---------------------------------------------------------------------------

L, W = 3, 4
NP0 = (-pow(P, -1, 1 << 32)) % (1 << 32)
RINV = pow(1 << 384, -1, P)


def _split(x: int):
    return [[(x >> (32 * (L * k + j))) & M32 for j in range(L)] for k in range(W)]


def _join(lanes) -> int:
    return sum(w << (32 * (L * k + j)) for k, lane in enumerate(lanes) for j, w in enumerate(lane))


PL = _split(P)


def _resolve(flags, drop=None):
    """lookahead<W>: flags[k] = (o10, o11, o200, o201, o210, o211) of lane k."""
    f10, f11, f200, f201, f210, f211 = (sum(int(f[q]) << k for k, f in enumerate(flags)) for q in range(6))
    bits = (1 << W) - 1
    P1 = f11 & ~f10
    S1 = (f10 << 1) + P1
    C1 = (S1 ^ P1) & bits
    G2 = (f200 & ~C1) | (f210 & C1)
    P2 = ((f201 & ~C1) | (f211 & C1)) & ~G2
    S2 = (G2 << 1) + P2
    in1 = [0 if drop == "stage 1" else (C1 >> k) & 1 for k in range(W)]
    in2 = [0 if drop == "stage 2" else ((S2 ^ P2) >> k) & 1 for k in range(W)]
    return in1, in2, S1 >> W, S2 >> W


def _chunk(lane) -> int:
    return sum(w << (32 * j) for j, w in enumerate(lane))


def _words(v: int):
    return [(v >> (32 * j)) & M32 for j in range(L)]


B96 = 1 << (32 * L)


def _qadd(x, y, drop=None):
    flags, s0s, s1s = [], [], []
    for k in range(W):
        s0 = _chunk(x[k]) + _chunk(y[k])
        o10 = s0 >= B96
        s0 %= B96
        s1 = (s0 + 1) % B96
        p = _chunk(PL[k])
        flags.append((o10, o10 or s0 == B96 - 1, s0 < p, s0 <= p, s1 < p, s1 <= p))
        s0s.append(s0)
        s1s.append(s1)
    in1, in2, _, top2 = _resolve(flags, drop)
    s = [s1s[k] if in1[k] else s0s[k] for k in range(W)]
    return [_words(s[k] if top2 else (s[k] - _chunk(PL[k]) - in2[k]) % B96) for k in range(W)]


def _qsub(x, y, drop=None):
    flags, d0s, d1s = [], [], []
    for k in range(W):
        a, b, p = _chunk(x[k]), _chunk(y[k]), _chunk(PL[k])
        d0 = (a - b) % B96
        d1 = (d0 - 1) % B96
        flags.append((a < b, a <= b, d0 + p >= B96, d0 + p + 1 >= B96, d1 + p >= B96, d1 + p + 1 >= B96))
        d0s.append(d0)
        d1s.append(d1)
    in1, in2, top1, _ = _resolve(flags, drop)
    d = [d1s[k] if in1[k] else d0s[k] for k in range(W)]
    return [_words((d[k] + _chunk(PL[k]) + in2[k]) % B96 if top1 else d[k]) for k in range(W)]


def _qmul(a, b, drop=None):
    """Quad::mul: operand scanning over b's 12 limbs; per step each lane adds
    a_lane b_i, then m p_lane (m from lane 0's word 0), each with one carry
    chain over its three words, and the team shifts one word down; the
    carry out of a lane's top word is pending into the next lane."""
    bl = [b[i // L][i % L] for i in range(12)]
    t = [[0] * L for _ in range(W)]
    e = [0] * W
    for i in range(12):
        for k in range(W):
            c = 0
            for j in range(L):
                v = a[k][j] * bl[i] + t[k][j] + c
                assert v <= (1 << 64) - 1
                t[k][j], c = v & M32, v >> 32
            e[k] += c
        m = t[0][0] * NP0 & M32
        for k in range(W):
            c = 0
            for j in range(L):
                v = PL[k][j] * m + t[k][j] + c
                t[k][j], c = v & M32, v >> 32
            e[k] += c
        assert t[0][0] == 0 and max(e) < (1 << 33) + 4
        up = [t[k + 1][0] if k + 1 < W else 0 for k in range(W)]
        for k in range(W):
            v = up[k] + (0 if drop == "pending" else e[k])
            t[k] = t[k][1:] + [v & M32]
            e[k] = v >> 32
        assert max(e) < 4
    assert e[W - 1] == 0
    y = [[0 if k == 0 else e[k - 1], 0, 0] for k in range(W)]
    return _qadd(t, y, drop)


def _operands(kind: str, n: int = 64):
    """Pairs of canonical Fp values; "targeted": lane chunks at a carry's
    edge (all zero, all ones, p's words, or such words mixed), where carries
    run between lanes."""
    rng = random.Random(f"quad-{kind}")
    if kind == "edges":
        return [(0, 0), (0, P - 1), (P - 1, 0), (P - 1, P - 1), (P - 1, 1), (1, P - 1)]
    if kind == "random":
        return [(rng.randrange(P), rng.randrange(P)) for _ in range(n)]
    out = []
    while len(out) < n:
        lanes = [rng.choice([[0] * L, [M32] * L, PL[k], [rng.getrandbits(32) for _ in range(L)],
                             [rng.choice([0, M32, PL[k][j], rng.getrandbits(32)]) for j in range(L)]])
                 for k in range(W)]
        z = _join(lanes) % P
        y = rng.randrange(1, P)
        out.append((z * (1 << 384) * pow(y, -1, P) % P, y))  # mul result z
        out.append((z, (-z - rng.randrange(3)) % P))
        out.append((z, (z + rng.randrange(-1, 2)) % P))
    return out


@pytest.mark.parametrize("kind", ["edges", "random", "targeted"])
def test_quad_arithmetic_matches_integers(kind):
    for x, y in _operands(kind):
        X, Y = _split(x), _split(y)
        assert _join(_qmul(X, Y)) == x * y * RINV % P, (x, y)
        assert _join(_qadd(X, Y)) == (x + y) % P, (x, y)
        assert _join(_qsub(X, Y)) == (x - y) % P, (x, y)


@pytest.mark.parametrize("drop", ["pending", "stage 1", "stage 2"])
def test_quad_model_fails_when_a_carry_is_dropped(drop):
    bad = {"mul": 0, "add": 0, "sub": 0}
    for x, y in _operands("targeted", 64):
        X, Y = _split(x), _split(y)
        bad["mul"] += _join(_qmul(X, Y, drop)) != x * y * RINV % P
        bad["add"] += _join(_qadd(X, Y, drop)) != (x + y) % P
        bad["sub"] += _join(_qsub(X, Y, drop)) != (x - y) % P
    assert bad["mul"] > 0, bad
    if drop != "pending":
        assert bad["add"] > 0 and bad["sub"] > 0, bad


# ---------------------------------------------------------------------------
# the source the models assume
# ---------------------------------------------------------------------------


def test_kernel_source_matches_the_models():
    """The round tables, the step, the team shapes and the block constants
    the models above assume are the kernel's."""
    assert _rounds("dbl") == DBL_ROUNDS and _rounds("add_dbl") == ADD_DBL_ROUNDS
    step = " ".join(_body("step").split())
    for line in ("const bool gen = bit && !out_O && !acc_O;", "if (T::ALWAYS_ADD || __any_sync(FULL, gen)) {",
                 "add_dbl(tm, out, acc, sum, same, next);",
                 "if (__any_sync(FULL, gen && same)) sum = sel(same, dbl(tm, out), sum);",
                 "out = sel(gen, sum, out);", "next = dbl(tm, acc);", "out = sel(bit && out_O, acc, out);",
                 "acc = sel(acc_O, acc, next);"):
        assert line in step, line
    assert step.index("out = sel(gen, sum, out);") < step.index("out = sel(bit && out_O, acc, out);")
    assert _const(TEAM_SRC, "TEAM_WIDTH") == 16 and "static constexpr int L = 3;" in TEAM_SRC
    assert "static constexpr int W = NL / L;" in TEAM_SRC and re.search(rf"NP0 = 0x{NP0:08x}u",
                                                                        (build.CSRC / "field.cuh").read_text())
    assert _const(SRC, "ADD_THREADS") % 32 == 0 and _const(SRC, "ADD_TILE") % _const(SRC, "ADD_THREADS") == 0
    assert _const(SRC, "ADD_TILE") <= 1 << 16  # list entries are uint16_t
    assert re.search(r"__shared__ uint16_t list\[ADD_TILE\]", SRC)
    assert re.search(r"constexpr int ADD_BLOCKS = 4 \* 132;", SRC)  # _k6_tile's
    assert "tile = (n + ADD_BLOCKS - 1) / ADD_BLOCKS;" in " ".join(SRC.split())
    # the layouts the wrapper names are the C entry's forms, with the points a
    # warp the K5 model runs
    assert g1.SCALAR_MUL_FORMS == {"auto": 0, "warp": 1, "quad": 2, "pair": 3}
    for line in ("if (form == 1) launch_scalar_mul<Team>", "else if (form == 2) launch_scalar_mul<Quad>",
                 "else launch_scalar_mul<Solo>"):
        assert line in SRC, line
    lanes = {t: re.search(rf"struct {t} {{.*?POINT_LANES = ([^;]+);", TEAM_SRC, re.S).group(1)
             for t in LAYOUTS.values()}
    assert lanes == {"Team": "2 * TEAM_WIDTH", "Quad": "2 * W", "Solo": "2"}
    assert [_always_add(t) for t in LAYOUTS.values()] == [False, False, True]
