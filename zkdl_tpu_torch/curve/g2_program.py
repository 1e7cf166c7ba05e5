"""K11's G2 formulas as programs of Fp operations for a team of lanes.

K11 (``csrc/g2.cu``) runs a point's dbl-2009-l and add-2007-bl over Fp2
(``zkdl_tpu/curve/g2.py:73-112``, value for value ``csrc/jac.cuh``) on a
team of L lanes, the point's values in shared memory, one Fp value a slot.
A program is a list of stages; a stage is a set of independent operations
of one kind, which the team's lanes share out (lane k runs operations k,
k + L, ...), and the team meets after each stage:

- a product ``d = a * b`` (the Montgomery product of two slots, lazy: below
  2p);
- a sum ``d = +-2^e0 t0 +- 2^e1 t1 ...`` of up to four slots, each doubled
  e times, lazy, optionally reduced to canonical (``canon``).

This module writes the formulas once as such operations (Karatsuba Fp2
products, complex squarings, every sum of the JAX formulas folded into the
operands: how a value is computed inside a formula is free, and every
value that is stored or compared is canonical), places each product at a
level of its dependency chain (for a team of L lanes: the levels are
filled to whole rounds of L products, a product taking a later level where
its chain allows and the earlier level has a free lane), places each sum
in the last gap before its first reader (an output sum in the first gap
after its inputs), and assigns slots by liveness. ``python
-m zkdl_tpu_torch.curve.g2_program`` writes the tables into
``csrc/g2_prog.cuh`` (tests/port/test_torch_g2_team.py checks that the
committed header is this module's output, and runs its tables on
integers).

The programs of g2.py:scalar_mul's LSB-first walk (csrc/g2.cu runs the
doubles of base and the adds into acc as steps of their own, the adds
reading the bases of the set bits from a ring): ADD (acc + ent, the ring's
oldest entry, into OUT, over ent's slots), DBL (double(base) into OUT)
and DACC (double(acc) into DA, for the rare add of equal points). ADD also leaves U1, U2, S1 and
S2 canonical in CMP, the values add-2007-bl compares.
"""

from __future__ import annotations

import pathlib

COORDS = ("x0", "x1", "y0", "y1", "z0", "z1")
# fixed slots of a point's workspace: the walk's two points, the ring's
# entry being added, which shares its slots with the programs' output (ADD
# reads the entry in its first two levels and writes its output from the
# third: schedule checks it), and add-2007-bl's compared values; DA
# (DACC's output, which runs after ADD) lies in the temporaries of ADD and
# DBL, which are dead by then
FIXED = {"acc": 0, "base": 6, "ent": 12, "out": 12}
CMP = ("u1_0", "u1_1", "u2_0", "u2_1", "s1_0", "s1_1", "s2_0", "s2_1")
CMP_SLOT = 18
TEMP_SLOT = CMP_SLOT + len(CMP)
FIXED["da"] = TEMP_SLOT
MAX_SLOTS = 128
TEAMS = (4, 8, 16)  # lanes a point of K11's forms
PROGRAMS = ("ADD", "DBL", "DACC")
HEADER = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "g2_prog.cuh"


def fixed_slot(name: str) -> int | None:
    if name.startswith("cmp."):
        return CMP_SLOT + CMP.index(name[4:])
    pt, _, c = name.partition(".")
    return FIXED[pt] + COORDS.index(c) if pt in FIXED and c in COORDS else None


class _Ops:
    def __init__(self, tag: str):
        self.tag, self.ops = tag, []

    def v(self, n: str) -> str:
        return n if "." in n else self.tag + n

    def mul(self, d, a, b):
        self.ops.append(("mul", self.v(d), self.v(a), self.v(b)))

    def lin(self, d, *terms, canon=False):
        """terms: "name", "-name", "2name" (2^1), "-8name" (2^3), ..."""
        out = []
        for t in terms:
            neg = t.startswith("-")
            t = t.lstrip("-")
            k = 0
            while t[k].isdigit():
                k += 1
            coef = int(t[:k]) if k else 1
            e = coef.bit_length() - 1
            assert coef == 1 << e, t
            out.append((self.v(t[k:]), neg, e))
        assert 1 <= len(out) <= 4 and not out[0][1], (d, terms)
        self.ops.append(("lin", self.v(d), tuple(out), canon))


def dbl_ops(src: str, dst: str, tag: str) -> list:
    """dbl-2009-l (jac.cuh:jac_double) of point src into dst, canonical
    out; an Fp2 value a is (a0, a1). A = X^2 = (A0, 2ax), B = Y^2 = (B0,
    2ay), YZ = Y Z (Karatsuba), C = B^2 = (C0, 4cb), XB2 = (X + B)^2 =
    (XB0, 2xx), E = 3A, F = E^2 = (F0, 2ee), D = 2(XB2 - A - C), X3 = F -
    2D, Y3 = (D - X3) E - 8C, Z3 = 2 YZ."""
    o = _Ops(tag)
    X0, X1, Y0, Y1, Z0, Z1 = (f"{src}.{c}" for c in COORDS)
    x0, x1, y0, y1, z0, z1 = (f"{dst}.{c}" for c in COORDS)
    o.lin("sx", X0, X1), o.lin("dx", X0, "-" + X1), o.lin("sy", Y0, Y1), o.lin("dy", Y0, "-" + Y1)
    o.lin("sz", Z0, Z1)
    o.mul("ax", X0, X1), o.mul("A0", "sx", "dx"), o.mul("ay", Y0, Y1), o.mul("B0", "sy", "dy")
    o.mul("v0", Y0, Z0), o.mul("v1", Y1, Z1), o.mul("cyz", "sy", "sz")
    o.lin(z0, "2v0", "-2v1", canon=True), o.lin(z1, "2cyz", "-2v0", "-2v1", canon=True)
    o.lin("sB", "B0", "2ay"), o.lin("dB", "B0", "-2ay")
    o.lin("xb0", X0, "B0"), o.lin("xb1", X1, "2ay"), o.lin("sxb", X0, "B0", X1, "2ay")
    o.lin("dxb", X0, "B0", "-" + X1, "-2ay")
    o.lin("E0", "A0", "2A0"), o.lin("E1", "2ax", "4ax"), o.lin("sE", "A0", "2A0", "2ax", "4ax")
    o.lin("dE", "A0", "2A0", "-2ax", "-4ax")
    o.mul("C0", "sB", "dB"), o.mul("cb", "B0", "ay")
    o.mul("XB0", "sxb", "dxb"), o.mul("xx", "xb0", "xb1")
    o.mul("F0", "sE", "dE"), o.mul("ee", "E0", "E1")
    o.lin("D0", "2XB0", "-2A0", "-2C0"), o.lin("D1", "4xx", "-4ax", "-8cb")
    o.lin(x0, "F0", "-2D0", canon=True), o.lin(x1, "2ee", "-2D1", canon=True)
    o.lin("DX0", "D0", "-" + x0), o.lin("DX1", "D1", "-" + x1), o.lin("sDX", "D0", "D1", "-" + x0, "-" + x1)
    o.mul("p0", "DX0", "E0"), o.mul("p1", "DX1", "E1"), o.mul("p2", "sDX", "sE")
    o.lin(y0, "p0", "-p1", "-8C0", canon=True), o.lin(y1, "p2", "-p0", "-p1", "-32cb", canon=True)
    return o.ops


def add_ops(p1: str, p2: str, dst: str, tag: str) -> list:
    """add-2007-bl (jac.cuh:jac_add, its generic formula) of p1 and p2 into
    dst, canonical out, and U1, U2, S1, S2 canonical into cmp.*. Z1Z1 =
    (Z1, 2m1), Z2Z2 = (Z2, 2m2), S1a = y1 z2, S2a = y2 z1, ZZ = (z1 + z2)^2
    = (ZZ0, 2zm), T = ZZ - Z1Z1 - Z2Z2, U1 = x1 Z2Z2, U2 = x2 Z1Z1, S1 = S1a
    Z2Z2, S2 = S2a Z1Z1, H = U2 - U1, I = (2H)^2 = (I0, 2im), R = 2(S2 - S1),
    RR = R^2 = (RR0, 2rm), J = H I, V = U1 I, X3 = RR - J - 2V, Y3 = (V -
    X3) R - 2 S1 J, Z3 = T H."""
    o = _Ops(tag)
    a0, a1, b0, b1, c0, c1 = (f"{p1}.{c}" for c in COORDS)  # x1, y1, z1 (Fp2 each)
    d0, d1, e0, e1, f0, f1 = (f"{p2}.{c}" for c in COORDS)  # x2, y2, z2
    x0, x1, y0, y1, z0, z1 = (f"{dst}.{c}" for c in COORDS)
    U10, U11, U20, U21, S10, S11, S20, S21 = (f"cmp.{c}" for c in CMP)
    o.lin("sz1", c0, c1), o.lin("dz1", c0, "-" + c1), o.lin("sz2", f0, f1), o.lin("dz2", f0, "-" + f1)
    o.lin("sy1", b0, b1), o.lin("sy2", e0, e1), o.lin("sx1", a0, a1), o.lin("sx2", d0, d1)
    o.lin("zs0", c0, f0), o.lin("zs1", c1, f1), o.lin("szs", c0, f0, c1, f1), o.lin("dzs", c0, f0, "-" + c1, "-" + f1)
    o.mul("m1", c0, c1), o.mul("Z1", "sz1", "dz1"), o.mul("m2", f0, f1), o.mul("Z2", "sz2", "dz2")
    o.mul("a0", b0, f0), o.mul("a1", b1, f1), o.mul("ac", "sy1", "sz2")
    o.mul("b0", e0, c0), o.mul("b1", e1, c1), o.mul("bc", "sy2", "sz1")
    o.mul("zm", "zs0", "zs1"), o.mul("ZZ0", "szs", "dzs")
    o.lin("sZ1", "Z1", "2m1"), o.lin("sZ2", "Z2", "2m2")
    o.lin("S1a0", "a0", "-a1"), o.lin("S1a1", "ac", "-a0", "-a1"), o.lin("sS1a", "ac", "-2a1")
    o.lin("S2a0", "b0", "-b1"), o.lin("S2a1", "bc", "-b0", "-b1"), o.lin("sS2a", "bc", "-2b1")
    o.lin("T0", "ZZ0", "-Z1", "-Z2"), o.lin("T1", "2zm", "-2m1", "-2m2"), o.lin("sT", "T0", "T1")
    # (the products by Z1Z1's and Z2Z2's second halves, 2m1 and 2m2, are
    # taken by m1 and m2 and doubled in the sums)
    o.mul("u0", a0, "Z2"), o.mul("u1", a1, "m2"), o.mul("uc", "sx1", "sZ2")
    o.mul("w0", d0, "Z1"), o.mul("w1", d1, "m1"), o.mul("wc", "sx2", "sZ1")
    o.mul("s0", "S1a0", "Z2"), o.mul("s1", "S1a1", "m2"), o.mul("sc", "sS1a", "sZ2")
    o.mul("r0", "S2a0", "Z1"), o.mul("r1", "S2a1", "m1"), o.mul("rc", "sS2a", "sZ1")
    o.lin(U10, "u0", "-2u1", canon=True), o.lin(U11, "uc", "-u0", "-2u1", canon=True)
    o.lin(U20, "w0", "-2w1", canon=True), o.lin(U21, "wc", "-w0", "-2w1", canon=True)
    o.lin(S10, "s0", "-2s1", canon=True), o.lin(S11, "sc", "-s0", "-2s1", canon=True)
    o.lin(S20, "r0", "-2r1", canon=True), o.lin(S21, "rc", "-r0", "-2r1", canon=True)
    o.lin("H0", U20, "-" + U10), o.lin("H1", U21, "-" + U11), o.lin("sH", U20, "-" + U10, U21, "-" + U11)
    o.lin("h0", "2" + U20, "-2" + U10), o.lin("h1", "2" + U21, "-2" + U11)
    o.lin("sh", "2" + U20, "-2" + U10, "2" + U21, "-2" + U11), o.lin("dh", "2" + U20, "-2" + U10, "-2" + U21, "2" + U11)
    o.lin("R0", "2" + S20, "-2" + S10), o.lin("R1", "2" + S21, "-2" + S11)
    o.lin("sR", "2" + S20, "-2" + S10, "2" + S21, "-2" + S11), o.lin("dR", "2" + S20, "-2" + S10, "-2" + S21, "2" + S11)
    o.lin("sU1", U10, U11), o.lin("sS1", S10, S11)
    o.mul("im", "h0", "h1"), o.mul("I0", "sh", "dh"), o.mul("rm", "R0", "R1"), o.mul("RR0", "sR", "dR")
    o.mul("q0", "T0", "H0"), o.mul("q1", "T1", "H1"), o.mul("qc", "sT", "sH")
    o.lin("sI", "I0", "2im")  # (I's second half, 2im: the products by it are taken by im)
    o.lin(z0, "q0", "-q1", canon=True), o.lin(z1, "qc", "-q0", "-q1", canon=True)
    o.mul("j0", "H0", "I0"), o.mul("j1", "H1", "im"), o.mul("jc", "sH", "sI")
    o.mul("v0", U10, "I0"), o.mul("v1", U11, "im"), o.mul("vc", "sU1", "sI")
    o.lin("J0", "j0", "-2j1"), o.lin("J1", "jc", "-j0", "-2j1"), o.lin("sJ", "jc", "-4j1")
    o.lin("V0", "v0", "-2v1"), o.lin("V1", "vc", "-v0", "-2v1")
    o.lin(x0, "RR0", "-J0", "-2V0", canon=True), o.lin(x1, "2rm", "-J1", "-2V1", canon=True)
    o.lin("VX0", "V0", "-" + x0), o.lin("VX1", "V1", "-" + x1), o.lin("sVX", "V0", "V1", "-" + x0, "-" + x1)
    o.mul("e0", "VX0", "R0"), o.mul("e1", "VX1", "R1"), o.mul("ec", "sVX", "sR")
    o.mul("f0", S10, "J0"), o.mul("f1", S11, "J1"), o.mul("fc", "sS1", "sJ")
    o.lin("SJ1", "fc", "-f0", "-f1")
    o.lin(y0, "e0", "-e1", "-2f0", "2f1", canon=True), o.lin(y1, "ec", "-e0", "-e1", "-2SJ1", canon=True)
    return o.ops


def program_ops(name: str) -> list:
    if name == "ADD":
        return add_ops("acc", "ent", "out", "a_")
    if name == "DBL":
        return dbl_ops("base", "out", "d_")
    if name == "DACC":
        return dbl_ops("acc", "da", "d_")
    raise ValueError(name)


def _srcs(op) -> list[str]:
    return [op[2], op[3]] if op[0] == "mul" else [t[0] for t in op[2]]


def schedule(ops: list, lanes: int) -> list[tuple[str, list]]:
    """[(kind, [op, ...]), ...]: the stages of a program for a team of
    `lanes` lanes."""
    prod = {op[1]: i for i, op in enumerate(ops)}
    assert len(prod) == len(ops), "every operation writes a value of its own"
    muls = [i for i, op in enumerate(ops) if op[0] == "mul"]

    def prod_preds(i, seen=None):  # the products an operation reads, through sums
        out = set()
        for s in _srcs(ops[i]):
            j = prod.get(s)
            if j is None:
                assert fixed_slot(s) is not None, s
            elif ops[j][0] == "mul":
                out.add(j)
            else:
                out |= prod_preds(j)
        return out

    preds = {i: prod_preds(i) for i in muls}
    succs = {i: [j for j in muls if i in preds[j]] for i in muls}
    asap = {}
    for i in muls:  # (ops are in dependency order)
        asap[i] = 1 + max((asap[j] for j in preds[i]), default=0)
    depth = max(asap.values())
    alap = {}
    for i in reversed(muls):
        alap[i] = min((alap[j] - 1 for j in succs[i]), default=depth)
    level, placed = {}, set()
    for lv in range(1, depth + 1):
        ready = [i for i in muls if i not in placed and asap[i] <= lv and all(j in placed and level[j] < lv
                                                                            for j in preds[i])]
        must = [i for i in ready if alap[i] == lv]
        cap = -(-len(must) // lanes) * lanes
        fill = sorted((i for i in ready if alap[i] > lv), key=lambda i: (alap[i], i))[: cap - len(must)]
        for i in must + fill:
            level[i] = lv
            placed.add(i)
    assert len(placed) == len(muls)
    # a sum sits in the last gap before its first reader (so its slot is
    # held briefly), one with no reader (an output) in the first gap after
    # its inputs; sub: its depth among the sums of its gap
    readers = {i: [j for j, o in enumerate(ops) if op[1] in _srcs(o)] for i, op in enumerate(ops)}
    gap, sub = {}, {}
    lins = [i for i, op in enumerate(ops) if op[0] == "lin"]
    for i in lins:  # first after the inputs
        ins = [prod[s] for s in _srcs(ops[i]) if s in prod]
        gap[i] = max((level[j] if ops[j][0] == "mul" else gap[j] for j in ins), default=0)
    for i in reversed(lins):  # then, where read, as late as the readers allow
        if readers[i]:
            gap[i] = min(level[j] - 1 if ops[j][0] == "mul" else gap[j] for j in readers[i])
    for i in lins:
        ins = [prod[s] for s in _srcs(ops[i]) if s in prod]
        sub[i] = 1 + max((sub[j] for j in ins if ops[j][0] == "lin" and gap[j] == gap[i]), default=-1)
    stages = []
    for lv in range(0, depth + 1):
        if lv:
            stages.append(("mul", [ops[i] for i in muls if level[i] == lv]))
        for s in range(1 + max((sub[i] for i in gap if gap[i] == lv), default=-1)):
            stages.append(("lin", [ops[i] for i in gap if gap[i] == lv and sub[i] == s]))
    stages = [st for st in stages if st[1]]
    # where two fixed names share slots (ent and out), every read of the one
    # comes in a stage before the first write of the other
    written = {}
    for s, (_, st_ops) in enumerate(stages):
        for op in st_ops:
            if fixed_slot(op[1]) is not None:
                written.setdefault(fixed_slot(op[1]), (s, op[1]))
    for s, (_, st_ops) in enumerate(stages):
        for op in st_ops:
            for v in _srcs(op):
                w = written.get(fixed_slot(v))
                assert w is None or w[1] == v or s < w[0], f"{v} read in stage {s}, its slot written by {w[1]} in {w[0]}"
    return stages


def allocate(stages: list, reserved: int = 0) -> dict[str, int]:
    """Slots for every value of a program: fixed ones, and the others by
    liveness (a slot is reused from the stage after its value's last read),
    from TEMP_SLOT + reserved up."""
    last = {}
    for s, (_, ops) in enumerate(stages):
        for op in ops:
            for v in _srcs(op):
                last[v] = s
    slots, free, busy, top = {}, [], [], TEMP_SLOT + reserved
    for s, (_, ops) in enumerate(stages):
        for v, slot in [b for b in busy if last.get(b[0], -1) < s]:
            free.append(slot)
        busy = [b for b in busy if last.get(b[0], -1) >= s]
        free.sort()
        for op in ops:
            d = op[1]
            f = fixed_slot(d)
            if f is None:
                if free:
                    f = free.pop(0)
                else:
                    f, top = top, top + 1
                busy.append((d, f))
            slots[d] = f
    for v in last:
        if v not in slots:
            slots[v] = fixed_slot(v)
    assert top <= MAX_SLOTS
    return slots


def build(lanes: int) -> dict:
    """{program: (stages, slots)} and the slots a point needs, for a team
    of `lanes` lanes."""
    out = {}
    for name in PROGRAMS:
        stages = schedule(program_ops(name), lanes)
        out[name] = (stages, allocate(stages, len(COORDS) if name == "DACC" else 0))
    return out


def slot_count(progs: dict) -> int:
    return 1 + max(max(slots.values()) for _, slots in progs.values())


def rounds(stages: list, lanes: int) -> tuple[int, int]:
    """(product rounds, sum rounds) of a program on a team of `lanes`."""
    m = sum(-(-len(ops) // lanes) for k, ops in stages if k == "mul")
    return m, sum(-(-len(ops) // lanes) for k, ops in stages if k == "lin")


def _describe(op) -> str:
    if op[0] == "mul":
        return f"{op[1]} = {op[2]} * {op[3]}"
    terms = " ".join(f"{'-' if neg else '+'} {1 << e if e else ''}{v}" for v, neg, e in op[2])
    return f"{op[1]} = {'canon(' if op[3] else ''}{terms.lstrip('+ ')}{')' if op[3] else ''}"


def render() -> str:
    lines = [
        "// K11's programs (csrc/g2.cu): dbl-2009-l and add-2007-bl over Fp2 as stages",
        "// of Fp products and sums for a team of L lanes, one table set a form.",
        "// Written by `python -m zkdl_tpu_torch.curve.g2_program` from the formulas",
        "// in zkdl_tpu_torch/curve/g2_program.py: do not edit by hand.",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        "namespace {",
        "",
        "// d = a * b (slots of the point's workspace)",
        "struct G2Mul {",
        "  uint8_t d, a, b, pad;",
        "};",
        "// d = sum over j < n of (-1)^(neg bit j) 2^e[j] t[j], lazy; canonical if canon",
        "struct G2Lin {",
        "  uint8_t d, n, canon, neg;",
        "  uint8_t t[4], e[4];",
        "};",
        "// kind 0: products, 1: sums; ops first .. first + n - 1 of its table",
        "struct G2Stage {",
        "  uint16_t kind, n, first, pad;",
        "};",
        "// stages first .. first + n - 1",
        "struct G2Prog {",
        "  uint16_t first, n;",
        "};",
        "",
        f"constexpr int G2_ACC = {FIXED['acc']}, G2_BASE = {FIXED['base']}, G2_ENT = {FIXED['ent']}, "
        f"G2_OUT = {FIXED['out']}, G2_DA = {FIXED['da']}, G2_CMP = {CMP_SLOT};",
        f"enum G2Program {{ {', '.join(f'G2_{p} = {i}' for i, p in enumerate(PROGRAMS))} }};",
        "",
    ]
    for lanes in TEAMS:
        progs = build(lanes)
        muls, lins, stages, heads = [], [], [], []
        for name in PROGRAMS:
            st, slots = progs[name]
            heads.append(f"{{{len(stages)}, {len(st)}}}")
            for kind, ops in st:
                table = muls if kind == "mul" else lins
                stages.append(f"{{{0 if kind == 'mul' else 1}, {len(ops)}, {len(table)}, 0}}")
                for op in ops:
                    if kind == "mul":
                        table.append(f"{{{slots[op[1]]}, {slots[op[2]]}, {slots[op[3]]}, 0}},  // {_describe(op)}")
                    else:
                        ts = list(op[2]) + [(op[2][0][0], False, 0)] * (4 - len(op[2]))
                        neg = sum(1 << j for j, t in enumerate(op[2]) if t[1])
                        table.append(f"{{{slots[op[1]]}, {len(op[2])}, {int(op[3])}, {neg}, "
                                     f"{{{', '.join(str(slots[t[0]]) for t in ts)}}}, "
                                     f"{{{', '.join(str(t[2]) for t in ts)}}}}},  // {_describe(op)}")
        summary = ", ".join(f"{p} {'+'.join(map(str, rounds(progs[p][0], lanes)))}" for p in PROGRAMS)
        lines += [f"// L = {lanes}: product + sum rounds a program: {summary}",
                  f"constexpr int G2_SLOTS_{lanes} = {slot_count(progs)};",
                  f"__constant__ G2Mul G2_MUL_{lanes}[] = {{"] + ["    " + m for m in muls] + ["};"]
        lines += [f"__constant__ G2Lin G2_LIN_{lanes}[] = {{"] + ["    " + m for m in lins] + ["};"]
        lines += [f"__constant__ G2Stage G2_STAGE_{lanes}[] = {{{', '.join(stages)}}};",
                  f"__constant__ G2Prog G2_PROG_{lanes}[] = {{{', '.join(heads)}}};", ""]
    lines += ["template <int L>", "struct G2Tables;"]
    for lanes in TEAMS:
        lines += ["template <>", f"struct G2Tables<{lanes}> {{",
                  f"  static constexpr int SLOTS = G2_SLOTS_{lanes};",
                  f"  __device__ __forceinline__ static const G2Mul* mul() {{ return G2_MUL_{lanes}; }}",
                  f"  __device__ __forceinline__ static const G2Lin* lin() {{ return G2_LIN_{lanes}; }}",
                  f"  __device__ __forceinline__ static const G2Stage* stage() {{ return G2_STAGE_{lanes}; }}",
                  f"  __device__ __forceinline__ static const G2Prog* prog() {{ return G2_PROG_{lanes}; }}", "};"]
    lines += ["", "}  // namespace", ""]
    return "\n".join(lines)


if __name__ == "__main__":
    HEADER.write_text(render())
    print(f"wrote {HEADER}")
