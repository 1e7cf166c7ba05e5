"""The port's GLV scalar multiplication on the CPU, where K8 cannot run: its
plain version held against the JAX package's ``g1.glv_decompose``,
``endomorphism``, ``_window_digits`` and ``scalar_mul_glv`` on the inputs of
``slice11_inputs.glv_inputs``, recorded by ``record_slice11.py`` (JAX's
window walk compiles for minutes on XLA:CPU, so no JAX runs here); a
word-level model of K8's decomposition against Python integers; K8's add
formula, table build and window walk, compiled from the kernel's source
into Python over field integers, against the recorded JAX limbs; and the
constants the source carries."""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import slice11_inputs
from slice11_fixture import rec
from test_torch_g1_var import Pt as VarPt
from test_torch_g1_var import _args, _statements
from zkdl_tpu_torch.curve import convert, g1, host_g1
from zkdl_tpu_torch.field import fp, fr, mp

LAMBDA = g1._LAMBDA_INT
U32 = (1 << 32) - 1
GLV_SRC = (pathlib.Path(g1.__file__).resolve().parents[1] / "csrc" / "g1_glv.cu").read_text()
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


# --- K8's formula code and walk over integers (csrc/g1_var.cuh:Var::add,
# csrc/g1_glv.cu:Glv and the kernel's table build and window loop) ----------

@functools.lru_cache(maxsize=None)
def _var_formulas():
    """Var::add (add-2007-bl alone, K8's) and Var::dbl compiled from the
    kernel's source into Python over field integers (a Montgomery product
    of canonical values is the product of the values they stand for)."""
    ns = {"f_mul": lambda a, b: a * b % P, "f_add": lambda a, b: (a + b) % P, "f_sub": lambda a, b: (a - b) % P,
          "f_dbl": lambda a: 2 * a % P, "f_eq": lambda a, b: a == b, "Pt": VarPt,
          "f_mul2": lambda x0, y0, x1, y1: (x0 * y0 % P, x1 * y1 % P)}
    for name, params, tail in (("add", "P1, P2", "    return sum, same\n"), ("dbl", "P", "")):
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
    return ns["add"], ns["dbl"]


def _jac(p: host_g1.JacPoint) -> "VarPt":
    return VarPt(p.x, p.y, p.z)


def _glv_add(P1, P2):
    """Glv::add: P1 == O -> P2, P2 == O -> P1, equal points double(P1)."""
    add, dbl = _var_formulas()
    if P1.z == 0:
        return P2
    if P2.z == 0:
        return P1
    s, same = add(P1, P2)
    return dbl(P1) if same else s


def _glv_dbl(P1):
    return P1 if P1.z == 0 else _var_formulas()[1](P1)


def _k8_model(points, scalars):
    """g1_glv_kernel over a warp of points: each point's tables (t[0] = O,
    t[1] its limbs, t[k] = Glv::add(t[k-1], t[1]); the second on phi(P)),
    then the walk from the warp's highest nonzero window, its doubles
    skipped there."""
    splits = [glv_split_model(s) for s in scalars]
    tops = [max((w for w in range(33) if (s1 >> 4 * w) & 15 or (s2 >> 4 * w) & 15), default=-1) for s1, s2 in splits]
    start = max(tops)
    out = []
    for p, (s1, s2) in zip(points, splits):
        tables = []
        for B in (p, VarPt(g1._BETA_INT * p.x % P, p.y, p.z)):
            t, e = [VarPt(0, 0, 0), B], B
            for _ in range(2, 16):
                e = _glv_add(e, B)
                t.append(e)
            tables.append(t)
        acc = VarPt(0, 0, 0)
        for w in range(start, -1, -1):
            if w < start:
                for _ in range(4):
                    acc = _glv_dbl(acc)
            acc = _glv_add(acc, tables[0][(s1 >> 4 * w) & 15])
            acc = _glv_add(acc, tables[1][(s2 >> 4 * w) & 15])
        out.append(acc)
    return out


def test_var_add_is_add_2007_bl_in_8_rounds():
    """Var::add: 16 products in 8 rounds of two (each round's pair
    independent of the other's output) giving host_g1.add's Jacobian
    values on random points, and `same` exactly on equal points."""
    rounds = [s for s in _statements("add") if "tm.mul" in s]
    assert len(rounds) == 8 and all(s.startswith("tm.mul2(") for s in rounds)
    for s in rounds:
        a = _args(re.fullmatch(r"tm\.mul2\((.*)\)", s).group(1))
        assert not {a[4], a[5]} & set(re.findall(r"\w+", " ".join(a[:4]))), s
    add, _ = _var_formulas()
    pts = [host_g1.scalar_mul(host_g1.GENERATOR, k) for k in slice11_inputs.rand_scalars(1104, 9)]
    for p, q in zip(pts, pts[1:]):
        s, same = add(_jac(p), _jac(q))
        assert (s, same) == (_jac(host_g1.add(p, q)), False)
    s, same = add(_jac(pts[0]), _jac(pts[0]))
    assert same


def test_k8_walk_model_gives_the_jax_limbs():
    """K8's table build and window walk over integers, with the kernel's
    formulas and skips, give the recorded JAX scalar_mul_glv's Jacobian
    coordinates for every input (one warp of them)."""
    pts, scal = inputs()
    got = _k8_model([_jac(p) for p in convert.jac_from_device(pts)], fr.to_ints(scal.numpy()))
    want = convert.jac_from_device(g1.G1Jac(*(torch.from_numpy(rec(f"glv/out.{c}")) for c in "xyz")))
    assert got == [_jac(p) for p in want]


def test_kernel_source_matches_the_walk_model():
    """The statements of g1_glv.cu that _k8_model mirrors."""
    src = " ".join(GLV_SRC.split())
    for line in ("if (w < start) {", "for (int j = 0; j < 4; ++j) out = G::dbl(tm, out);",
                 "out = G::add(tm, out, G::get(tm, table, tb + (int64_t)window(s1, w) * 3 * NL));",
                 "out = G::add(tm, out, G::get(tm, table, tb + (int64_t)(GLV_ENTRIES + window(s2, w)) * 3 * NL));",
                 "for (int k = 2; k < GLV_ENTRIES; ++k) { e = G::add(tm, e, B);",
                 "return V::sel(pO, Q, V::sel(qO, P, sum));",
                 "sum = V::sel(same, V::dbl(tm, P), sum);",
                 "if (t) B.x = tm.mul(P.x, tm.load(GLV_BETA_MONT, 0));"):
        assert line in src, line
