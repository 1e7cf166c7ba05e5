"""K8's Fp arithmetic (csrc/fp_chain.cuh) on the CPU, where it cannot be
compiled: every asm statement of the header run instruction by instruction
with PTX's carry semantics (the statements are read from the source, so the
model runs what the kernel runs), the C code around them mirrored line for
line, and the result held against Python integers: the Montgomery product
of lazy operands (below 2p) and the lazy sum, difference and reduction, on
edge values (0, 1, p - 1, p, 2p - 1, mont(1)) and seeded ones. No carry the
header drops may be nonzero, and dropping any carry it keeps gives wrong
results."""

import functools
import re

import numpy as np
import pytest

from zkdl_tpu_torch.field import fp
from zkdl_tpu_torch.utils import build

SRC = (build.CSRC / "fp_chain.cuh").read_text()
P = fp.P_INT
R = 1 << 384
M32 = (1 << 32) - 1
RINV = pow(R, -1, P)


# ---------------------------------------------------------------------------
# the header's asm statements, read from the source
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _consts() -> dict:
    """The header's constexpr words (PW0.., QW0.., NP0)."""
    return {k: int(v, 16) for k, v in re.findall(r"\b(PW\d+|QW\d+|NP0) = 0x([0-9a-f]+)u", SRC)}


def _body(name: str) -> str:
    """The body of the header's function `name`."""
    m = re.search(rf"__device__ __forceinline__ \w+ {name}\([^{{]*\) \{{\n(.*?)\n\}}\n", SRC, re.S)
    assert m, f"{name} not found in fp_chain.cuh"
    return m.group(1)


@functools.lru_cache(maxsize=None)
def _asm(name: str):
    """(instructions, operands) of the one asm statement of `name`: each
    instruction (opcode, [operand tokens]), each operand (constraint,
    compiled expression, its write-back: a name or compiled code)."""
    m = re.search(r"asm\((.*?)\);", _body(name), re.S)
    text = m.group(1)
    template = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', text.split(":")[0]))
    instrs = []
    for ins in template.replace("\\n", "").replace("\\t", "").split(";"):
        ins = ins.strip()
        if ins:
            op, _, args = ins.partition(" ")
            instrs.append((op, [a.strip() for a in args.split(",")]))
    operands = []
    for part in text.split(":")[1:3]:
        for c, e in re.findall(r'"([+=]?[rn])"\(([^()]*(?:\([^()]*\))?[^()]*)\)', part):
            put = compile(f"{e} = __v", name, "exec") if "[" in e else e
            operands.append((c, compile(e, name, "eval"), put))
    return instrs, operands


def run_asm(name: str, ns: dict, drop: int | None = None, lost: list | None = None) -> None:
    """Run `name`'s asm statement over the variables in ns (lists, ints and
    objects with a .w list, as the C code names them), writing its outputs
    back. drop: the index of an instruction whose carry-in is taken as 0.
    lost: collects (name, index) of each instruction without .cc whose sum
    overflowed its word (a carry the statement drops)."""
    instrs, operands = _asm(name)
    env = dict(_consts())
    vals = [None if c == "=r" else eval(code, env, ns) for c, code, _ in operands]

    def val(tok):
        if tok.startswith("%"):
            v = vals[int(tok[1:])]
            assert v is not None, f"{name}: %{tok} read before it is written"
            return v
        return int(tok, 0)

    cf = None
    for k, (op, args) in enumerate(instrs):
        d = int(args[0][1:])
        parts = op.split(".")
        base, cc = parts[0], "cc" in parts
        cin = 0
        if base in ("addc", "subc", "madc"):
            assert cf is not None, f"{name}: carry read before it is set"
            cin = 0 if k == drop else cf
        if base in ("add", "addc"):
            full = val(args[1]) + val(args[2]) + cin
        elif base in ("sub", "subc"):
            full = val(args[1]) - val(args[2]) - cin
        elif base in ("mad", "madc"):
            prod = val(args[1]) * val(args[2])
            full = (prod & M32 if "lo" in parts else prod >> 32) + val(args[3]) + cin
        else:
            raise AssertionError(f"{name}: unmodelled {op}")
        vals[d] = full % (1 << 32)
        if cc:
            cf = int(full < 0) if base.startswith("sub") else full >> 32
        elif lost is not None and base != "subc" and full >> 32:
            lost.append((name, k))
    for (c, _, put), v in zip(operands, vals):
        if c in ("+r", "=r"):
            if isinstance(put, str):
                ns[put] = v
            else:
                exec(put, env, {**ns, "__v": v})


class V:
    """An Fq: its words as .w, as the C code reads them."""

    def __init__(self, w):
        self.w = list(w)


# ---------------------------------------------------------------------------
# the C code around the statements, line for line
# ---------------------------------------------------------------------------


def _call(name, kw, **ns):
    run_asm(name, ns, drop=kw.get("drop", {}).get(name), lost=kw.get("lost"))
    return ns


def odd_shift(x, y, a, b, **kw):
    y[0] = _call("odd_shift", kw, x=x, y0=y[0], a=a, b=b)["y0"]


def even_mad(y, x, a, b, **kw):
    x[11] = _call("even_mad", kw, y=y, x11=x[11], a=a, b=b)["x11"]


def odd_red(x, m, **kw):
    _call("odd_red", kw, x=x, m=m)


def even_red(y, x, m, **kw):
    x[11] = _call("even_red", kw, y=y, x11=x[11], m=m)["x11"]


def mont_mul(a, b, **kw):
    """fp_chain.cuh:mont_mul on word lists."""
    np0 = _consts()["NP0"]
    x, y = [0] * 12, [0] * 12
    for k in range(0, 12, 2):  # mul_first
        x[k], x[k + 1] = (a[k] * b[0]) & M32, (a[k] * b[0]) >> 32
        y[k], y[k + 1] = (a[k + 1] * b[0]) & M32, (a[k + 1] * b[0]) >> 32
    m = x[0] * np0 & M32
    odd_red(y, m, **kw)
    even_red(x, y, m, **kw)
    for i in range(1, 12, 2):
        odd_shift(x, y, a, b[i], **kw)
        even_mad(y, x, a, b[i], **kw)
        m = y[0] * np0 & M32
        odd_red(x, m, **kw)
        even_red(y, x, m, **kw)
        if i + 1 < 12:
            odd_shift(y, x, a, b[i + 1], **kw)
            even_mad(x, y, a, b[i + 1], **kw)
            m = x[0] * np0 & M32
            odd_red(y, m, **kw)
            even_red(x, y, m, **kw)
    _call("merge", kw, x=x, y=y)
    return x


def _masked(name, v, kw, y=None):
    ns = _call(name, kw, v=v, mask=None, **({} if y is None else {"y": y}))
    return ns["mask"]


# lop3's table for (a, b, c) = (0xf0, 0xcc, 0xaa): (a & c) | (b & ~c), pick's 0xe4
LOP3_PICK = (0xF0 & 0xAA) | (0xCC & ~0xAA & 0xFF)


def _pick(mask, a, b):
    return V([(p & mask) | (q & ~mask & M32) for p, q in zip(a.w, b.w)])


def add_lazy(x, y, **kw):
    s = V(x.w)
    _call("plus", kw, v=s, y=y)
    t = V(s.w)
    below = _masked("minus_q", t, kw)
    return _pick(below, s, t)


def sub_lazy(x, y, **kw):
    d = V(x.w)
    borrow = _masked("minus", d, kw, y)
    q = V([w & borrow for w in _words(2 * P)])
    _call("plus", kw, v=d, y=q)
    return d


def canon(x, **kw):
    t = V(x.w)
    below = _masked("minus_p", t, kw)
    return _pick(below, x, t)


# the C bodies the functions above mirror
C_BODIES = {
    "mont_mul": """uint32_t x[NW], y[NW]; mul_first(x, y, a.w, b.w[0]); uint32_t m = x[0] * NP0; odd_red(y, m);
        even_red(x, y[11], m); #pragma unroll for (int i = 1; i < NW; i += 2) { odd_shift(x, y[0], a.w, b.w[i]);
        even_mad(y, x[11], a.w, b.w[i]); m = y[0] * NP0; odd_red(x, m); even_red(y, x[11], m); if (i + 1 < NW) {
        odd_shift(y, x[0], a.w, b.w[i + 1]); even_mad(x, y[11], a.w, b.w[i + 1]); m = x[0] * NP0; odd_red(y, m);
        even_red(x, y[11], m); } } merge(x, y); Fq r; #pragma unroll for (int k = 0; k < NW; ++k) r.w[k] = x[k];
        return r;""",
    "mul_first": """#pragma unroll for (int k = 0; k < NW; k += 2) { x[k] = a[k] * b; x[k + 1] = __umulhi(a[k], b);
        y[k] = a[k + 1] * b; y[k + 1] = __umulhi(a[k + 1], b); }""",
    "add_lazy": "Fq s = x; plus(s, y); Fq t = s; const uint32_t below = minus_q(t); return pick(below, s, t);",
    "sub_lazy": """Fq d = x; const uint32_t borrow = minus(d, y); const Fq q{{QW0 & borrow, QW1 & borrow, QW2 & borrow,
        QW3 & borrow, QW4 & borrow, QW5 & borrow, QW6 & borrow, QW7 & borrow, QW8 & borrow, QW9 & borrow,
        QW10 & borrow, QW11 & borrow}}; plus(d, q); return d;""",
    "canon": "Fq t = x; const uint32_t below = minus_p(t); return pick(below, x, t);",
    "pick": """Fq r; #pragma unroll for (int k = 0; k < NW; ++k) asm("lop3.b32 %0, %1, %2, %3, 0xe4;" : "=r"(r.w[k]) :
        "r"(a.w[k]), "r"(b.w[k]), "r"(mask)); return r;""",
}


def _norm(s: str) -> str:
    return " ".join(re.sub(r"//[^\n]*", "", s).split())


@pytest.mark.parametrize("name", sorted(C_BODIES))
def test_model_mirrors_the_c_code(name):
    assert _norm(_body(name)) == _norm(C_BODIES[name])


# ---------------------------------------------------------------------------
# against integers
# ---------------------------------------------------------------------------


def _words(v: int) -> list[int]:
    return [(v >> (32 * i)) & M32 for i in range(12)]


def _int(w) -> int:
    return sum(x << (32 * i) for i, x in enumerate(w))


EDGES = [0, 1, P - 1, P, P + 1, 2 * P - 1, R % P, (R * R) % P]


def _seeded(seed: int, n: int, below: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % below for _ in range(n)]


def _carry_edge(rng) -> int:
    """A value below 2p of words at a carry's edge (0, 1, all ones, all ones
    less one), where chains generate and propagate carries."""
    w = rng.choice([0, 1, M32 - 1, M32], size=12).tolist()
    w[11] = int(rng.choice([0, 1, rng.integers(0, 2 * P >> 352)]))
    return _int(w)


def _pairs(kind: str) -> list[tuple[int, int]]:
    if kind == "edges":
        return [(a, b) for a in EDGES for b in EDGES]
    if kind == "carry_edges":
        rng = np.random.default_rng(1205)
        return [(_carry_edge(rng), _carry_edge(rng)) for _ in range(64)]
    if kind == "lazy":  # operands anywhere below 2p
        return list(zip(_seeded(1201, 48, 2 * P), _seeded(1202, 48, 2 * P)))
    return list(zip(_seeded(1203, 48, P), _seeded(1204, 48, P)))  # canonical


def test_header_constants():
    assert LOP3_PICK == 0xE4
    c = _consts()
    assert _int([c[f"PW{i}"] for i in range(12)]) == P
    assert _int([c[f"QW{i}"] for i in range(12)]) == 2 * P
    assert (c["NP0"] * P + 1) % (1 << 32) == 0
    assert P < 1 << 381  # three spare bits: the product's bounds rest on them


@pytest.mark.parametrize("kind", ["edges", "carry_edges", "lazy", "canonical"])
def test_product_is_montgomery_below_2p(kind):
    """mont_mul(a, b) = a b 2^-384 mod p, below 2p (no final subtraction),
    for a, b < 2p; no carry the statements drop is ever nonzero."""
    for a, b in _pairs(kind):
        lost = []
        r = _int(mont_mul(_words(a), _words(b), lost=lost))
        assert r < 2 * P and r % P == a * b * RINV % P, (hex(a), hex(b))
        assert lost == [], (hex(a), hex(b), lost)


@pytest.mark.parametrize("kind", ["edges", "carry_edges", "lazy", "canonical"])
def test_sums_are_lazy_and_canon_is_canonical(kind):
    """add and dbl in [0, 2p), sub in [0, 2p), canon in [0, p), each
    congruent to the integer result; add and canon drop no carry, sub only
    the one that cancels its borrow."""
    for a, b in _pairs(kind):
        A, B = V(_words(a)), V(_words(b))
        lost = []
        for got, want in ((add_lazy(A, B, lost=lost), a + b), (add_lazy(A, A, lost=lost), 2 * a)):
            assert _int(got.w) < 2 * P and _int(got.w) % P == want % P
        c = _int(canon(A, lost=lost).w)
        assert c == a % P and c < P and lost == []
        d = _int(sub_lazy(A, B, lost=lost).w)
        assert d < 2 * P and d % P == (a - b) % P
        assert lost == ([("plus", 11)] if a < b else []), (hex(a), hex(b), lost)


CHAINS = ["odd_shift", "even_mad", "odd_red", "even_red", "merge", "plus", "minus", "minus_q", "minus_p"]


@pytest.mark.parametrize("name", CHAINS)
def test_model_fails_when_a_carry_is_dropped(name):
    """Every carry the statements pass on matters: with the carry-in of any
    one instruction of `name` dropped, the product (or the sum, difference
    or reduction) is wrong on some of the seeded operands."""
    instrs, _ = _asm(name)
    takes = [k for k, (op, _) in enumerate(instrs) if op.split(".")[0] in ("addc", "subc", "madc")]
    assert takes
    cases = _pairs("carry_edges") + _pairs("edges") + _pairs("lazy")

    def wrong(a, b, kw) -> bool:
        A, B = V(_words(a)), V(_words(b))
        if name in ("odd_shift", "even_mad", "odd_red", "even_red", "merge"):
            r = _int(mont_mul(A.w, B.w, **kw))
            return r % P != a * b * RINV % P or r >= 2 * P
        if name == "minus_p":
            return _int(canon(A, **kw).w) != a % P
        s, d = _int(add_lazy(A, B, **kw).w), _int(sub_lazy(A, B, **kw).w)
        return s % P != (a + b) % P or s >= 2 * P or d % P != (a - b) % P or d >= 2 * P

    for k in takes:
        kw = {"drop": {name: k}}
        assert any(wrong(a, b, kw) for a, b in cases), f"no result changed without {name}'s carry into instruction {k}"
