"""K11's G2 walk on a team of lanes (csrc/g2.cu, g2_team_kernel) on the
CPU, where it cannot run: the program tables of csrc/g2_prog.cuh, read
from the header, run stage by stage on integers as the team's lanes run
them (lane k takes operations k, k + L, ...; every lane of a stage reads
what the stages before wrote), with fp_chain.cuh's exact lazy values (the
Montgomery product's CIOS result below 2p with no final subtraction, the
lazy sum and difference, canon); the kernel's walk around them (the
warp's choice of program, jac_add's selects, the rare double of acc);
held against the recorded JAX ``g2.scalar_mul`` and ``g2.add``
(``record_slice14.py``) and against ``g2.scalar_mul_plain``, in each
form. Also: the committed header is what ``curve/g2_program.py`` writes,
and every stage is free of hazards between its lanes."""

import functools
import re

import numpy as np
import pytest
import torch

from slice14_fixture import rec, t
from zkdl_tpu_torch.curve import g2, g2_program
from zkdl_tpu_torch.field import fp, fr, mp
from zkdl_tpu_torch.field.fp2 import Fp2
from zkdl_tpu_torch.utils import build

P = fp.P_INT
R = 1 << 384
NPRIME = (-pow(P, -1, R)) % R
HDR = (build.CSRC / "g2_prog.cuh").read_text()
SRC = " ".join((build.CSRC / "g2.cu").read_text().split())
FORMS = {"four": 4, "eight": 8, "sixteen": 16}


# --- fp_chain.cuh's values, exactly --------------------------------------------


def mont_mul(a: int, b: int) -> int:
    """CIOS over 32-bit words with no final subtraction: its result is
    (a b + M p) / 2^384 for the one M < 2^384 that makes it exact."""
    assert a < 2 * P and b < 2 * P
    t = a * b
    r = (t + ((t * NPRIME) % R) * P) >> 384
    assert r < 2 * P
    return r


def add_lazy(x: int, y: int) -> int:
    assert x < 2 * P and y < 2 * P
    s = x + y
    return s - 2 * P if s >= 2 * P else s


def sub_lazy(x: int, y: int) -> int:
    assert x < 2 * P and y < 2 * P
    d = x - y
    return d + 2 * P if d < 0 else d


def canon(x: int) -> int:
    assert x < 2 * P
    return x - P if x >= P else x


# --- the header's tables ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def tables(lanes: int) -> dict:
    """G2_MUL_L, G2_LIN_L, G2_STAGE_L, G2_PROG_L and G2_SLOTS_L, read from
    the header."""

    def body(name):
        m = re.search(rf"__constant__ \w+ {name}\[\] = \{{(.*?)\}};\n", HDR, re.S)
        assert m, name
        return re.sub(r"//[^\n]*", "", m.group(1))

    muls = [tuple(map(int, g)) for g in re.findall(r"\{(\d+), (\d+), (\d+), 0\}", body(f"G2_MUL_{lanes}"))]
    lins = []
    for d, n, c, neg, ts, es in re.findall(r"\{(\d+), (\d+), (\d+), (\d+), \{([\d, ]+)\}, \{([\d, ]+)\}\}",
                                           body(f"G2_LIN_{lanes}")):
        lins.append((int(d), int(n), int(c), int(neg), [int(v) for v in ts.split(",")],
                     [int(v) for v in es.split(",")]))
    stages = [tuple(map(int, g)) for g in re.findall(r"\{(\d+), (\d+), (\d+), 0\}", body(f"G2_STAGE_{lanes}"))]
    progs = [tuple(map(int, g)) for g in re.findall(r"\{(\d+), (\d+)\}", body(f"G2_PROG_{lanes}"))]
    slots = int(re.search(rf"constexpr int G2_SLOTS_{lanes} = (\d+);", HDR).group(1))
    return dict(mul=muls, lin=lins, stage=stages, prog=progs, slots=slots)


@functools.lru_cache(maxsize=None)
def consts() -> dict:
    out = {k: int(v) for k, v in re.findall(r"\b(G2_(?:ACC|BASE|ENT|OUT|DA|CMP)) = (\d+)", HDR)}
    out.update({k: int(v) for k, v in re.findall(r"\b(G2_(?:ADD|DBL|DACC)) = (\d+)", HDR)})
    out["RING"] = int(re.search(r"constexpr int RING = (\d+);", SRC).group(1))
    return out


def lin_value(W, o) -> int:
    """g2.cu:lin_value."""
    d, n, c, neg, ts, es = o
    acc = W[ts[0]]
    for _ in range(es[0]):
        acc = add_lazy(acc, acc)
    for j in range(1, n):
        v = W[ts[j]]
        for _ in range(es[j]):
            v = add_lazy(v, v)
        acc = sub_lazy(acc, v) if (neg >> j) & 1 else add_lazy(acc, v)
    return canon(acc) if c else acc


def run(W: list, lanes: int, prog: int) -> None:
    """g2.cu:run on one point's workspace: each stage's lanes read the
    workspace as the stages before left it, then write."""
    tb = tables(lanes)
    first, n = tb["prog"][prog]
    for kind, cnt, op0 in tb["stage"][first: first + n]:
        ops = [tb["mul" if kind == 0 else "lin"][op0 + t] for t in range(cnt)]
        snap = list(W)
        writes = {}
        for lane in range(lanes):
            for t_ in range(lane, cnt, lanes):
                o = ops[t_]
                writes[o[0]] = mont_mul(snap[o[1]], snap[o[2]]) if kind == 0 else lin_value(snap, o)
        for d, v in writes.items():
            W[d] = v


# --- the kernel's walk --------------------------------------------------------------


def point_ints(p: g2.G2Jac) -> list[list[int]]:
    """(n,) points -> per point its six Montgomery words as integers (x.c0,
    x.c1, y.c0, y.c1, z.c0, z.c1: the kernel's layout)."""
    cols = [mp.host(c) for f in p for c in (f.c0, f.c1)]
    return [[mp.int_from_limbs(col[i]) for col in cols] for i in range(cols[0].shape[0])]


def walk(points: list, scalars: list, lanes: int, steps: list | None = None) -> list:
    """g2_team_kernel: warps of 32 / lanes points; each step the warp adds
    (ADD on the oldest entry of each point's ring, then jac_add's selects)
    where a ring is full or no point has a double left, and doubles (DBL,
    pushing the new base where its bit is set) otherwise. steps collects
    each warp's (adds, doubles)."""
    c = consts()
    acc_s, base_s, ent_s, cmp_s, out_s = c["G2_ACC"], c["G2_BASE"], c["G2_ENT"], c["G2_CMP"], c["G2_OUT"]
    per = 32 // lanes
    out = []
    for lo in range(0, len(points), per):
        pts, ks = points[lo: lo + per], scalars[lo: lo + per]
        Ws = []
        for p in pts:
            W = [0] * tables(lanes)["slots"]
            W[base_s: base_s + 6] = p
            Ws.append(W)
        tops = [k.bit_length() - 1 for k in ks]
        rings = [[W[base_s: base_s + 6]] if k & 1 else [] for W, k in zip(Ws, ks)]
        b, adds, dbls = 0, 0, 0
        while True:
            need = [b < top for top in tops]
            if any(len(r) == c["RING"] for r in rings) or (not any(need) and any(rings)):
                adds += 1
                flags = []
                for W, r in zip(Ws, rings):
                    if r:
                        W[ent_s: ent_s + 6] = r[0]
                    pO, qO = W[acc_s + 4: acc_s + 6] == [0, 0], W[ent_s + 4: ent_s + 6] == [0, 0]
                    if r and pO:
                        W[acc_s: acc_s + 6] = W[ent_s: ent_s + 6]
                    run(W, lanes, c["G2_ADD"])
                    same = W[cmp_s: cmp_s + 2] == W[cmp_s + 2: cmp_s + 4] and \
                        W[cmp_s + 4: cmp_s + 6] == W[cmp_s + 6: cmp_s + 8]
                    flags.append((bool(r), pO, qO, same))
                if any(pend and not pO and not qO and same for pend, pO, qO, same in flags):
                    for W in Ws:
                        run(W, lanes, c["G2_DACC"])
                for W, r, (pend, pO, qO, same) in zip(Ws, rings, flags):
                    frm = -1 if not pend or pO or qO else c["G2_DA"] if same else out_s
                    if frm >= 0:
                        W[acc_s: acc_s + 6] = W[frm: frm + 6]
                    if pend:
                        r.pop(0)
            elif any(need):
                dbls += 1
                for W in Ws:
                    run(W, lanes, c["G2_DBL"])
                b += 1
                for W, k, r, nd in zip(Ws, ks, rings, need):
                    if nd and W[base_s + 4: base_s + 6] != [0, 0]:
                        W[base_s: base_s + 6] = W[out_s: out_s + 6]
                    if nd and (k >> b) & 1:
                        r.append(W[base_s: base_s + 6])
            else:
                break
        if steps is not None:
            steps.append((adds, dbls))
        out += [W[acc_s: acc_s + 6] for W in Ws]
    return out


def team_add(p: list, q: list, lanes: int) -> list:
    """One bit's add of q into p as the walk runs it (program ADD, then
    jac_add's selects and DACC where the points are equal)."""
    c = consts()
    W = [0] * tables(lanes)["slots"]
    W[c["G2_ACC"]: c["G2_ACC"] + 6], W[c["G2_ENT"]: c["G2_ENT"] + 6] = p, q
    if p[4:6] == [0, 0]:  # acc == O takes the entry, before ADD writes over it
        return q
    run(W, lanes, c["G2_ADD"])
    cm = c["G2_CMP"]
    pO, qO = p[4:6] == [0, 0], q[4:6] == [0, 0]
    same = W[cm: cm + 2] == W[cm + 2: cm + 4] and W[cm + 4: cm + 6] == W[cm + 6: cm + 8]
    if not pO and not qO and same:
        run(W, lanes, c["G2_DACC"])
    return p if qO else W[c["G2_DA"]: c["G2_DA"] + 6] if same else W[c["G2_OUT"]: c["G2_OUT"] + 6]


def recorded(key: str) -> list:
    return point_ints(g2.G2Jac(*(Fp2(t(f"{key}.{c}0"), t(f"{key}.{c}1")) for c in "xyz")))


def _edge() -> g2.G2Jac:
    return g2.G2Jac(*(Fp2(t(f"g2/edge.{c}0"), t(f"g2/edge.{c}1")) for c in "xyz"))


# --- tests --------------------------------------------------------------------------


def test_header_is_the_generator_output():
    assert g2_program.render() == HDR, "rerun python -m zkdl_tpu_torch.curve.g2_program"


@pytest.mark.parametrize("lanes", g2_program.TEAMS)
def test_program_tables_are_hazard_free_and_count_the_formulas(lanes):
    """Within a stage no operation writes a slot that another reads or
    writes; each program runs the formulas' Fp products (an add 43, a double
    16) in the rounds the generator claims; every slot is in the workspace."""
    tb = tables(lanes)
    want = {"ADD": 43, "DBL": 16, "DACC": 16}
    for name, (first, n) in zip(g2_program.PROGRAMS, tb["prog"]):
        products = 0
        for kind, cnt, op0 in tb["stage"][first: first + n]:
            ops = [tb["mul" if kind == 0 else "lin"][op0 + i] for i in range(cnt)]
            dsts = [o[0] for o in ops]
            srcs = {s for o in ops for s in ([o[1], o[2]] if kind == 0 else o[4][: o[1]])}
            assert len(set(dsts)) == len(dsts) and not set(dsts) & srcs
            assert max(dsts + list(srcs)) < tb["slots"]
            products += cnt if kind == 0 else 0
        assert products == want[name]
    rounds = {p: g2_program.rounds(st, lanes)[0] for p, (st, _) in g2_program.build(lanes).items()}
    assert rounds["ADD"] == {4: 12, 8: 7, 16: 5}[lanes] and rounds["DBL"] == {4: 4, 8: 3, 16: 3}[lanes]


@pytest.mark.parametrize("case", ["add_self", "add_neg", "add_roll", "add_roll_rev"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_team_add_equals_jax(form, case):
    """The walk's add on the recorded edge batch [P, Q, R, O, P + (-P), 2P,
    P + Q, 2Q] (off the r-torsion subgroup): p + p (equal points: DACC),
    p + (-p) (z = 0 by the generic formula), p + O, O + q and distinct
    points, every coordinate equal to the JAX add's."""
    E = point_ints(_edge())
    rolled = E[-1:] + E[:-1]
    neg = point_ints(g2.neg(_edge()))
    pairs = {"add_self": zip(E, E), "add_neg": zip(E, neg), "add_roll": zip(E, rolled),
             "add_roll_rev": zip(rolled, E)}[case]
    assert [team_add(p, q, FORMS[form]) for p, q in pairs] == recorded(f"g2/{case}")


@pytest.mark.parametrize("form", sorted(FORMS))
def test_team_walk_equals_jax(form):
    """Every edge scalar (0, 1, 2, 5, r - 1, r, 2^256 - 1, two random) on P,
    Q, O, P + (-P), 2P and P + Q, and the recorder's 5P, 2P and 3Q: the
    walk gives JAX scalar_mul's coordinates."""
    E = point_ints(_edge())
    idx = rec("g2/smul_idx").tolist()
    ks = fr.to_ints(rec("g2/smul_scalars"))
    assert walk([E[i] for i in idx], ks, FORMS[form]) == recorded("g2/smul")


@pytest.mark.parametrize("form", sorted(FORMS))
def test_team_walk_equals_plain_on_mixed_warps(form):
    """Warps that mix tops (a scalar 0 beside 2^255 + 1, small and random
    scalars), the identity, a point whose double is taken past another's top,
    and the recorded msm scalars on the edge points: the walk gives
    scalar_mul_plain's limbs."""
    rng = np.random.default_rng(1502)
    E = _edge()
    idx = torch.tensor([0, 1, 2, 3, 5, 6, 7, 4, 0, 1, 3, 2])
    ks = [0, (1 << 255) + 1, 3, 7, 1 << 64, 2, fr.P_INT - 1, 9]
    ks += [int.from_bytes(rng.bytes(32), "little") % fr.P_INT for _ in range(len(idx) - len(ks))]
    pts = g2.G2Jac(*(Fp2(f.c0[idx], f.c1[idx]) for f in E))
    want = point_ints(g2.scalar_mul_plain(pts, torch.from_numpy(np.stack([mp.limbs_from_int(k, 8) for k in ks]))))
    assert walk(point_ints(pts), ks, FORMS[form]) == want


def test_kernel_source_matches_the_model():
    """The statements of g2.cu that run, lin_value and walk mirror."""
    for line in ("for (int t = k; t < st.n; t += L) {",
                 "ws_store(W, o.d, mont_mul(ws_load(W, o.a), ws_load(W, o.b)));",
                 "ws_store(W, o->d, lin_value(W, o));", "for (int e = 0; e < o->e[0]; ++e) acc = dbl_lazy(acc);",
                 "for (int j = 1; j < n; ++j) {", "for (int e = 0; e < o->e[j]; ++e) v = dbl_lazy(v);",
                 "acc = pick((neg >> j) & 1 ? FULL : 0u, sub_lazy(acc, v), add_lazy(acc, v));",
                 "return pick(below | (o->canon ? 0u : FULL), acc, t);",
                 "ks[pt][w] = live ? __ldg(scalars + src * scalar_stride + w) : 0u;",
                 "if (ks[pt][0] & 1u) push();", "const bool need = b < top;",
                 "if (any_full || (!any_need && __any_sync(FULL, count > 0))) {",
                 "const bool any_full = __any_sync(FULL, count == RING), any_need = __any_sync(FULL, need);",
                 "const bool pO = ws_zero2(W, G2_ACC + 4), qO = ws_zero2(W, G2_ENT + 4);",
                 "if (pend && pO) ws_copy<L>(W4, G2_ENT, G2_ACC, k); __syncwarp(); run<L>(W, k, G2_ADD);",
                 "const bool same = ws_eq2(W, G2_CMP, G2_CMP + 2) && ws_eq2(W, G2_CMP + 4, G2_CMP + 6);",
                 "if (__any_sync(FULL, pend && !pO && !qO && same)) run<L>(W, k, G2_DACC);",
                 "const int from = !pend || pO || qO ? -1 : same ? G2_DA : G2_OUT;",
                 "if (from >= 0) ws_copy<L>(W4, from, G2_ACC, k);", "head += pend;",
                 "} else if (any_need) {", "run<L>(W, k, G2_DBL);",
                 "const bool keep = !need || ws_zero2(W, G2_BASE + 4);",
                 "if (!keep) ws_copy<L>(W4, G2_OUT, G2_BASE, k);", "++b;",
                 "if (need && ((ks[pt][b >> 5] >> (b & 31)) & 1u)) push();",
                 "W4[G2_ACC * 3 + q] = make_uint4(0u, 0u, 0u, 0u);"):
        assert line in SRC, line


def test_ring_steps_follow_the_set_bits():
    """The walk's steps on random scalars in the sixteen form (two points a
    warp): the doubles are the warp's highest bit, the adds at least the
    most set bits of a point of the warp and at most the ring's size
    more."""
    rng = np.random.default_rng(1503)
    E = point_ints(_edge())
    ks = [int.from_bytes(rng.bytes(32), "little") % fr.P_INT for _ in range(4)]
    steps = []
    walk([E[i % 3] for i in range(4)], ks, 16, steps)
    for (adds, dbls), pair in zip(steps, (ks[:2], ks[2:])):
        assert dbls == max(k.bit_length() for k in pair) - 1
        assert max(bin(k).count("1") for k in pair) <= adds <= max(bin(k).count("1") for k in pair) + consts()["RING"]
