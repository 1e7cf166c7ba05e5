"""The port's GLV scalar multiplication on the CPU, where K8 cannot run: its
plain version held against the JAX package's ``g1.glv_decompose``,
``endomorphism``, ``_window_digits`` and ``scalar_mul_glv`` on the inputs of
``slice11_inputs.glv_inputs``, recorded by ``record_slice11.py`` (JAX's
window walk compiles for minutes on XLA:CPU, so no JAX runs here); a
word-level model of K8's decomposition against Python integers; K8's add
formula, table build and window walk, compiled from the kernel's source
into Python over field integers, against the recorded JAX limbs; and the
constants the source carries. (K8's Fp arithmetic, csrc/fp_chain.cuh, is
modelled word for word in test_torch_glv_fp.py.)"""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import slice11_inputs
from slice11_fixture import rec
from test_torch_g1_var import Pt as VarPt
from test_torch_g1_var import _args
from zkdl_tpu_torch.curve import convert, g1, host_g1
from zkdl_tpu_torch.field import fp, fr, mp

LAMBDA = g1._LAMBDA_INT
U32 = (1 << 32) - 1
CSRC = pathlib.Path(g1.__file__).resolve().parents[1] / "csrc"
# K8's kernel and the layouts' formulas and table build it shares with K13
GLV_SRC = (CSRC / "g1_glv.cu").read_text() + (CSRC / "g1_team.cuh").read_text()
P = fp.P_INT


@functools.lru_cache(maxsize=None)
def inputs():
    return slice11_inputs.glv_inputs()


@functools.lru_cache(maxsize=None)
def plain_out():
    return g1.scalar_mul_glv_plain(*inputs())


def test_inputs_are_the_recorded_ones():
    pts, scal = inputs()
    for c in "xyz":
        np.testing.assert_array_equal(getattr(pts, c).numpy(), rec(f"glv/points.{c}"))
    np.testing.assert_array_equal(scal.numpy(), rec("glv/scalars"))


@pytest.mark.parametrize("part", ["s1", "s2"])
def test_glv_decompose_matches_jax(part):
    s1, s2 = g1.glv_decompose(inputs()[1])
    np.testing.assert_array_equal({"s1": s1, "s2": s2}[part].numpy(), rec(f"glv/{part}"))


@pytest.mark.parametrize("part", ["s1", "s2"])
def test_window_digits_match_jax(part):
    s = g1.glv_decompose(inputs()[1])[part == "s2"]
    np.testing.assert_array_equal(g1._window_digits(s).numpy(), rec(f"glv/d{part[1]}").astype(np.int64))


def test_endomorphism_matches_jax():
    out = g1.endomorphism(inputs()[0])
    for c in "xyz":
        np.testing.assert_array_equal(getattr(out, c).numpy(), rec(f"glv/endo.{c}"))


@pytest.mark.parametrize("c", ["x", "y", "z"])
def test_scalar_mul_glv_plain_matches_jax_limbs(c):
    np.testing.assert_array_equal(getattr(plain_out(), c).numpy(), rec(f"glv/out.{c}"))


def test_scalar_mul_glv_is_the_group_product():
    pts, scal = inputs()
    got = convert.jac_from_device(plain_out())
    for p, k, q in zip(convert.jac_from_device(pts), fr.to_ints(scal.numpy()), got):
        assert host_g1.eq_points(q, host_g1.scalar_mul(p, k))


def test_scalar_mul_glv_wrapper_on_cpu():
    """The CPU wrapper runs the plain version (no launch counted) and
    refuses bad operands: a scalar a point, uint32."""
    pts, scal = inputs()
    sub = g1.G1Jac(*(c[:6] for c in pts))
    before = g1.GLV.launches
    got = g1.scalar_mul_glv(sub, scal[:6])
    assert g1.GLV.launches == before
    for c in "xyz":
        np.testing.assert_array_equal(getattr(got, c).numpy(), rec(f"glv/out.{c}")[:6])
    with pytest.raises(ValueError):
        g1.scalar_mul_glv(sub, scal[:5])
    with pytest.raises(ValueError):
        g1.scalar_mul_glv(sub, scal[0])
    with pytest.raises(ValueError):
        g1.scalar_mul_glv(sub, scal[:6].to(torch.int32))


# --- K8's decomposition, word for word (csrc/g1_glv.cu:glv_split) ----------


def _words(x: int, n: int) -> list[int]:
    return [(x >> (32 * i)) & U32 for i in range(n)]


def _int(w) -> int:
    return sum(v << (32 * i) for i, v in enumerate(w))


def glv_split_model(s: int) -> tuple[int, int]:
    """glv_split over 32-bit words as the kernel runs it; asserts every
    product and carry fits its word."""
    sw, L, M = _words(s, 8), _words(LAMBDA, 4), _words(g1._M_BARRETT, 5)
    t = [0] * 13
    for i in range(5):
        c = 0
        for j in range(8):
            v = sw[j] * M[i] + t[i + j] + c
            assert v < 1 << 64
            t[i + j], c = v & U32, v >> 32
        t[i + 8] = c
    ql = [0] * 5
    for i in range(5):
        c = 0
        for j in range(4):
            if i + j < 5:
                v = t[8 + i] * L[j] + ql[i + j] + c
                assert v < 1 << 64
                ql[i + j], c = v & U32, v >> 32
        if i == 0:
            ql[4] = c
    rem, b = [0] * 5, 0
    for i in range(5):
        v = sw[i] - ql[i] - b
        rem[i], b = v & U32, int(v < 0)
    q = t[8:13]
    for _ in range(2):
        d, b = [0] * 5, 0
        for i in range(5):
            v = rem[i] - (L[i] if i < 4 else 0) - b
            d[i], b = v & U32, int(v < 0)
        ge = b == 0
        c = int(ge)
        for i in range(5):
            rem[i] = d[i] if ge else rem[i]
            v = q[i] + c
            q[i], c = v & U32, v >> 32
    assert rem[4] == 0, "the remainder must fit s1's 4 words"
    return _int(rem[:4]), _int(q)


def _model_cases() -> list[int]:
    rng = np.random.default_rng(1103)
    edges = [*slice11_inputs.EDGE_SCALARS, fr.P_INT, (1 << 256) - 1, (1 << 128) * LAMBDA - 1, (1 << 128) * LAMBDA,
             2 * LAMBDA - 1, 2 * LAMBDA, 3 * LAMBDA + 5, (1 << 255)]
    # the Barrett quotient's undershoot is largest just below a multiple of lambda
    near = [k * LAMBDA - 1 for k in rng.integers(1, 1 << 62, size=64, dtype=np.uint64).tolist()]
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(512)]
    return edges + near + rand


def test_glv_split_model_divides_exactly():
    """For every 256-bit s the kernel's words give floor(s / lambda) and its
    remainder (2^256 - 1 included: s2 < 2^129, so its 33 windows hold it);
    below 2^128 lambda (every s < r) that is the JAX Barrett division's
    pair, whose quotient keeps 128 bits."""
    undershoot = set()
    for s in _model_cases():
        s1, s2 = glv_split_model(s)
        assert (s2, s1) == divmod(s, LAMBDA), hex(s)
        assert s2 < 1 << 129
        undershoot.add(s2 - ((s * g1._M_BARRETT) >> 256))
    assert undershoot <= {0, 1}


def test_glv_split_model_matches_the_port_decompose():
    cases = [s for s in _model_cases() if s < (1 << 256)]
    limbs = torch.from_numpy(np.stack([mp.limbs_from_int(s, 8) for s in cases]))
    s1, s2 = g1.glv_decompose(limbs)
    assert [glv_split_model(s) for s in cases] == list(zip(fr.to_ints(s1.numpy()), fr.to_ints(s2.numpy())))


def _cu_words(name: str) -> list[int]:
    m = re.search(rf"{name}\[\w*\] = \{{([^}}]*)\}}", GLV_SRC)
    assert m, f"{name} not found in g1_glv.cu"
    return [int(v.strip().rstrip("u"), 16) for v in m.group(1).split(",")]


@pytest.mark.parametrize("name,value,n", [("L", LAMBDA, 4), ("M", g1._M_BARRETT, 5),
                                          ("GLV_BETA_MONT", fp.SPEC.to_mont_int(g1._BETA_INT), 12)])
def test_cu_carries_the_constants(name, value, n):
    assert _cu_words(name) == _words(value, n)


# --- K8's formula code and walk over integers (csrc/g1_glv.cu: add_gen and
# dbl_gen in their two schedules, Glv::add, Glv::dbl and the kernel's table
# build and window loop) ----------------------------------------------------------

# the layout type each schedule's functions take: two products a round
# (Pair, Single) or up to four (Four)
SCHEDULES = {"two": "T", "four": "Four"}


def _glv_statements(name: str, schedule: str = "two") -> list[str]:
    """The statements of `name` (g1_glv.cu or g1_team.cuh) in a schedule."""
    m = re.search(rf"__device__ __forceinline__ \w+ {name}\(const {SCHEDULES[schedule]}& tm,[^)]*\) \{{\n(.*?)\n\}}\n",
                  GLV_SRC, re.S)
    assert m, f"{name} ({schedule}) not found in g1_glv.cu or g1_team.cuh"
    body = re.sub(r"//[^\n]*", "", m.group(1))
    return [" ".join(s.split()) for s in body.split(";") if s.strip()]


def _rounds(name: str, schedule: str) -> list[tuple[str, list[str]]]:
    """(mulN, its arguments) of each product round of `name`."""
    out = []
    for s in _glv_statements(name, schedule):
        m = re.fullmatch(r"tm\.(mul\d)\((.*)\)", s)
        if m:
            out.append((m.group(1), _args(m.group(2))))
    return out


@functools.lru_cache(maxsize=None)
def _var_formulas(schedule: str = "two"):
    """add_gen (add-2007-bl, K8's) and dbl_gen (dbl-2009-l) of a schedule
    compiled from the kernel's source into Python over field integers (a
    Montgomery product is the product of the values its operands stand for,
    and a lazy value stands for its residue: canon is the identity here)."""
    ns = {"f_mul": lambda a, b: a * b % P, "f_add": lambda a, b: (a + b) % P, "f_sub": lambda a, b: (a - b) % P,
          "f_dbl": lambda a: 2 * a % P, "f_eq": lambda a, b: a == b, "f_canon": lambda a: a % P, "Pt": VarPt}
    for n in (2, 3, 4):
        ns[f"f_mul{n}"] = lambda *a: tuple(x * y % P for x, y in zip(a[0::2], a[1::2]))
    for name, params, tail in (("add_gen", "P1, P2", "    return sum, same\n"), ("dbl_gen", "P", "")):
        lines = []
        for s in _glv_statements(name, schedule):
            if s.startswith("Fq ") and "=" not in s:
                continue  # declarations
            s = re.sub(r"\.([xyz])\(\)", r".\1", s).replace("tm.", "f_").replace("&&", "&")
            m = re.fullmatch(r"f_mul(\d)\((.*)\)", s)
            if m:
                k, a = int(m.group(1)), _args(m.group(2))
                s = f"{', '.join(a[2 * k:])} = f_mul{k}({', '.join(a[:2 * k])})"
            s = re.sub(r"^const Fq ", "", s)
            s = re.sub(r"\{(.*)\}", r"Pt(\1)", s)
            lines.append("    " + s + "\n")
        exec(f"def {name}({params}):\n" + "".join(lines) + tail, ns)
    return ns["add_gen"], ns["dbl_gen"]


def _jac(p: host_g1.JacPoint) -> "VarPt":
    return VarPt(p.x, p.y, p.z)


def _glv_add(P1, P2, schedule="two", generic=None):
    """Glv::add: P1 == O -> P2, P2 == O -> P1, equal points double(P1);
    generic (a list) gets whether add-2007-bl gave the result."""
    add, dbl = _var_formulas(schedule)
    if generic is not None:
        generic.append(P1.z != 0 and P2.z != 0 and not add(P1, P2)[1])
    if P1.z == 0:
        return P2
    if P2.z == 0:
        return P1
    s, same = add(P1, P2)
    return dbl(P1) if same else s


def _table(B, generic=None):
    """build_table: t[0] = O, t[1] = B, t[k] = Glv::add(t[k-1], t[1]);
    generic gets each add's flag from t[3] on."""
    t, e = [VarPt(0, 0, 0), B], B
    for k in range(2, 16):
        e = _glv_add(e, B, generic=generic if k >= 3 else None)
        t.append(e)
    return t


def _k8_tables(p):
    """The kernel's two tables of p: t1 built, t2 derived from it entry by
    entry (t2[2] = (beta X, Y, Z) of t1[2], t2[k] = (X, Y, beta Z) of
    t1[k]) where p is not the identity and every add of t1 from t1[3] on
    ran add-2007-bl, else built the long way; and whether it was derived."""
    generic = []
    t1 = _table(p, generic)
    derive = all(generic) and p.z != 0
    b = g1._BETA_INT
    phi = VarPt(b * p.x % P, p.y, p.z)
    if not derive:
        return t1, _table(phi), False
    t2 = [VarPt(0, 0, 0), phi, VarPt(b * t1[2].x % P, t1[2].y, t1[2].z)]
    t2 += [VarPt(e.x, e.y, b * e.z % P) for e in t1[3:]]
    return t1, t2, True


def _glv_dbl(P1, schedule="two"):
    return P1 if P1.z == 0 else _var_formulas(schedule)[1](P1)


def _k8_model(points, scalars, walk="two"):
    """g1_glv_kernel over a warp of points: each point's tables
    (_k8_tables), then the walk from the warp's highest nonzero window, its
    doubles skipped there, in the schedule `walk` (two: Pair; four: Four;
    the tables' adds take the same values in either)."""
    splits = [glv_split_model(s) for s in scalars]
    tops = [max((w for w in range(33) if (s1 >> 4 * w) & 15 or (s2 >> 4 * w) & 15), default=-1) for s1, s2 in splits]
    start = max(tops)
    out = []
    for p, (s1, s2) in zip(points, splits):
        tables = _k8_tables(p)[:2]
        acc = VarPt(0, 0, 0)
        for w in range(start, -1, -1):
            if w < start:
                for _ in range(4):
                    acc = _glv_dbl(acc, walk)
            acc = _glv_add(acc, tables[0][(s1 >> 4 * w) & 15], walk)
            acc = _glv_add(acc, tables[1][(s2 >> 4 * w) & 15], walk)
        out.append(acc)
    return out


def test_var_add_is_add_2007_bl_in_8_rounds():
    """add_gen with two products a round (Pair's, Single's): 16 products in
    8 rounds of two (each round's pair independent of the other's output)
    giving host_g1.add's Jacobian values on random points, and `same`
    exactly on equal points."""
    rounds = _rounds("add_gen", "two")
    assert [m for m, _ in rounds] == ["mul2"] * 8
    assert all("tm.mul" not in s or s.startswith("tm.mul2(") for s in _glv_statements("add_gen"))
    for _, a in rounds:
        assert not {a[4], a[5]} & set(re.findall(r"\w+", " ".join(a[:4]))), a
    add, _ = _var_formulas()
    pts = [host_g1.scalar_mul(host_g1.GENERATOR, k) for k in slice11_inputs.rand_scalars(1104, 9)]
    for p, q in zip(pts, pts[1:]):
        s, same = add(_jac(p), _jac(q))
        assert (s, same) == (_jac(host_g1.add(p, q)), False)
    s, same = add(_jac(pts[0]), _jac(pts[0]))
    assert same


@pytest.mark.parametrize("name,shape", [("add_gen", ["mul4", "mul4", "mul3", "mul3", "mul2"]),
                                        ("dbl_gen", ["mul3", "mul3"])])
def test_four_lane_schedule_is_the_same_formula(name, shape):
    """The schedule of up to four products a round (Four): add-2007-bl's
    16 products in 5 rounds and dbl-2009-l in 3 (its last product inline),
    each round's products independent of its outputs, giving the two-lane
    schedule's values (and host_g1's points) on random and equal points."""
    rounds = _rounds(name, "four")
    assert [m for m, _ in rounds] == shape
    for m, a in rounds:
        k = int(m[3])
        assert len(a) == 3 * k and not set(a[2 * k:]) & set(re.findall(r"\w+", " ".join(a[: 2 * k]))), a
    pts = [_jac(host_g1.scalar_mul(host_g1.GENERATOR, k)) for k in slice11_inputs.rand_scalars(1105, 9)]
    (add4, dbl4), (add2, dbl2) = _var_formulas("four"), _var_formulas("two")
    for p, q in zip(pts, pts[1:]):
        if name == "add_gen":
            assert add4(p, q) == add2(p, q) and add4(p, q)[1] is False
        else:
            assert dbl4(p) == dbl2(p)
    if name == "add_gen":
        assert add4(pts[0], pts[0])[1] is True


def test_k8_four_lane_walk_gives_the_jax_limbs():
    """The walk in the schedule of up to four products a round gives the
    recorded JAX scalar_mul_glv's Jacobian coordinates (the tables are built
    two products a round in every layout)."""
    pts, scal = inputs()
    got = _k8_model([_jac(p) for p in convert.jac_from_device(pts)], fr.to_ints(scal.numpy()), walk="four")
    want = convert.jac_from_device(g1.G1Jac(*(torch.from_numpy(rec(f"glv/out.{c}")) for c in "xyz")))
    assert got == [_jac(p) for p in want]


def _order3_points() -> list:
    """(0, +-2, 1): y^2 = x^3 + 4 at x = 0, points of order 3 (off the
    order-r subgroup: their tables reach O at t[3])."""
    return [VarPt(0, 2, 1), VarPt(0, P - 2, 1)]


def test_t2_follows_from_t1():
    """The kernel's t2 (derived from t1 where every add of t1 from t1[3] on
    is generic) equals phi(P)'s table built by g1.py's adds: on random
    points of the subgroup, where it is derived, and on the identity in
    two encodings, (r^2, -r^3, 0) and points of order 3, where the kernel
    builds it the long way (deriving would give other limbs there)."""
    b = g1._BETA_INT
    pts = [_jac(host_g1.scalar_mul(host_g1.GENERATOR, k)) for k in slice11_inputs.rand_scalars(1106, 6)]
    r0 = pts[0]
    special = [VarPt(0, 0, 0), VarPt(5, 7, 0), _glv_add(r0, VarPt(r0.x, P - r0.y, r0.z))] + _order3_points()
    assert special[2].z == 0 and special[2].x != 0
    for p in pts + special:
        t1, t2, derived = _k8_tables(p)
        assert derived == (p in pts)
        assert t1 == _table(p) and t2 == _table(VarPt(b * p.x % P, p.y, p.z))
    for p in special:
        generic = []
        t1 = _table(p, generic)
        rule = [VarPt(0, 0, 0), VarPt(b * p.x % P, p.y, p.z), VarPt(b * t1[2].x % P, t1[2].y, t1[2].z)]
        rule += [VarPt(e.x, e.y, b * e.z % P) for e in t1[3:]]
        assert rule != _table(VarPt(b * p.x % P, p.y, p.z)) or p == VarPt(0, 0, 0)


def test_k8_walk_model_gives_the_jax_limbs():
    """K8's table build and window walk over integers, with the kernel's
    formulas and skips, give the recorded JAX scalar_mul_glv's Jacobian
    coordinates for every input (one warp of them)."""
    pts, scal = inputs()
    got = _k8_model([_jac(p) for p in convert.jac_from_device(pts)], fr.to_ints(scal.numpy()))
    want = convert.jac_from_device(g1.G1Jac(*(torch.from_numpy(rec(f"glv/out.{c}")) for c in "xyz")))
    assert got == [_jac(p) for p in want]


def test_kernel_source_matches_the_walk_model():
    """The statements of g1_glv.cu and g1_team.cuh that _k8_model mirrors."""
    src = " ".join(GLV_SRC.split())
    for line in ("if (w < start) {", "for (int j = 0; j < 4; ++j) out = G::dbl(tm, out);",
                 "for (int t = 0; t < 2; ++t) out = G::add(tm, out, Shared{t ? e1 : e0});",
                 "e0 = tab + window(split, 0, w) * ENTRY_WORDS; "
                 "e1 = tab + (GLV_ENTRIES + window(split, 1, w)) * ENTRY_WORDS;",
                 "return (int)((split[t * 5 + (w >> 3)] >> (4 * (w & 7))) & 15u);",
                 "splits[pt][k] = k < 4 ? s1[k] : 0u; splits[pt][5 + k] = s2[k];",
                 "put_entry(dst, Pt{}); put_entry(dst + ENTRY_WORDS, B);",
                 "for (int k = 2; k < GLV_ENTRIES; ++k) {",
                 "e = Glv<T>::add(tm, e, Shared{stash}, generic); all_generic &= generic || k == 2;",
                 "if (writer) put_entry(dst + k * ENTRY_WORDS, e);",
                 "derive = build_table(tm, P, tab, stash1, role == 0, writer);", "const Pt P = Shared{stash1}.pt();",
                 "derive = derive && !T::zero(P.z);",
                 "put_entry(tab2, Pt{}); put_entry(tab2 + ENTRY_WORDS, Pt{bx, P.y, P.z});",
                 "const uint32_t two = k == 2 ? FULL : 0u;", "const Fq b = canon(mont_mul(pick(two, x, z), beta));",
                 "put_entry(tab2 + k * ENTRY_WORDS, Pt{pick(two, b, x), get_fq(e + NW), pick(two, z, b)});",
                 "if (__any_sync(FULL, !derive)) "
                 "build_table(tm, Pt{bx, P.y, P.z}, tab2, stash2, role == 0, writer && !derive);",
                 "sum = sel(qO, P, sum); if (__any_sync(FULL, pO)) sum = sel(pO, Q.pt(), sum);",
                 "sum = sel(same, dbl_gen(tm, P), sum);",
                 "__device__ __forceinline__ static Pt dbl(const T& tm, const Pt& P) { "
                 "return sel(T::zero(P.z), P, dbl_gen(tm, P)); }",
                 "const Fq bx = canon(mont_mul(P.x, beta));",
                 "const uint32_t* g = tab + (role * GLV_ENTRIES + window(split, role, w)) * ENTRY_WORDS;"):
        assert line in src, line
