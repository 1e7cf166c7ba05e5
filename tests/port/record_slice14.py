"""Record the JAX package's side of the port's tower, NTT, windowed and cheap
softmax tests (``tests/port/test_torch_{ntt,tower,softmax_cheap,windowed}.py``
and the slice-14 cases of the field, planar-ops and native tests), which run
no JAX compile.

    JAX_PLATFORMS=cpu python tests/port/record_slice14.py

Runs on the CPU and writes ``tests/port/fixtures/slice14_jax.npz`` and
``slice14_jax.json``. Every input is recorded beside its outputs, so the
tests feed the port exactly what the JAX functions got:

- ``fr/*``: the (n, 8) ops of ``field/fr.py`` (double, sqr, unmont,
  pow_static by 5 and by p - 2, is_zero, eq, select, zeros, ones_mont) on
  edge and random Montgomery values;
- ``planar/*``: ``tensor/planar_ops.py``'s inverse_scalar, fold_half,
  fold_axis (axes 1 and 2), me_eval_rev, me_eval_rev_dot, to_planar_rev
  (full and zero-padded) and from_planar_rev;
- ``fp2/*``: ``field/fp2.py``'s add, sub, neg, double, mul, sqr, conj,
  mul_by_fp, inv, is_zero and eq on edge and random pairs, and
  ``tests/test_tower.py``'s pairs;
- ``g2/*``: ``curve/g2.py``'s double, add (p + p, p + (-p), p + O, O + p,
  O + O and distinct points), add_mixed and neg on find_point_host(3, 11,
  29) and points built from them; scalar_mul of every edge scalar on every
  edge point and of the test_tower cases, in one call; g2_sum at 1, 2, 3, 5
  and 8 points; msm of 8 points (its own call);
- ``ntt/*``: ntt and intt at n = 1, 2, 8, 16 and 256 (random, zeros and
  p - 1), poly_mul at three sizes, and ``tests/test_tower.py``'s cases;
- ``win/*``: ``g1.scalar_mul_windowed`` on K5's edge points (G, a NUMS
  candidate, O, (r^2, -r^3, 0)) and edge scalars, and random ones;
- ``soft<seq>/*``: the cheap softmax of ``models/zkattention.py`` at seq 4,
  d 8 and seq 16, d 16: S, softmax_aux's P and q, p_range_bits, softmax_prove's proof under SeededRng and
  FiatShamir, and the proof of P with one entry off by one; softmax_aux
  with padding rows raises in the JAX package (it writes into a read-only
  view), and the error is recorded;
- in the JSON, the native host library's outputs (``g1_msm``, ``g1_sum``,
  ``g1_add_batch``, ``g1_eq``, ``fr_mont_mul_batch``) on host points and
  ints, and the JAX verifier's verdicts (each proof, a tampered bit
  polynomial, a tampered ip_finals, the off-by-one P).

Also the command, the JAX version and the SHA-256 of the JAX sources it read.
Each phase runs in a process of its own (G2's and the windowed walk's loops
compile for minutes on XLA:CPU), side by side; ``--parts DIR`` reruns the
phases DIR lacks. Not a test: pytest does not collect it.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
COMMAND = "JAX_PLATFORMS=cpu python tests/port/record_slice14.py"
SOURCES = ["zkdl_tpu/field/fr.py", "zkdl_tpu/field/fp.py", "zkdl_tpu/field/fp2.py", "zkdl_tpu/field/mp.py",
           "zkdl_tpu/tensor/planar_ops.py", "zkdl_tpu/tensor/fft.py", "zkdl_tpu/curve/g2.py",
           "zkdl_tpu/curve/g1.py", "zkdl_tpu/models/zkattention.py", "zkdl_tpu/native/__init__.py",
           "zkdl_tpu/native/zkdl_host.cpp"]

FR_P = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
FP_P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# G2's edge scalars: 0, 1, 2 (a double), 5 (test_tower), r - 1, r (no
# subgroup: not the identity), 2^256 - 1 (every bit) and two random ones
G2_SCALARS = (0, 1, 2, 5, FR_P - 1, FR_P, (1 << 256) - 1)
G1_COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB
WIN_SCALARS = (0, 1, FR_P - 1, G1_COFACTOR, (1 << 256) - 1, FR_P, (1 << 256) - FR_P)  # K5's edge scalars
NTT_SIZES = (1, 2, 8, 16, 256)
POLY_SIZES = ((5, 4), (9, 8), (100, 29))  # a transform of 8, 16 and 128
SOFTMAX_CASES = ((4, 8), (16, 16))  # (seq, d_model)
SEEDED = 5489


def rand_ints(rng, n: int, mod: int) -> list[int]:
    return [int.from_bytes(rng.bytes(56), "little") % mod for _ in range(n)]


def limbs(vals, n_limbs: int) -> np.ndarray:
    return np.stack([np.array([(int(v) >> (32 * i)) & 0xFFFFFFFF for i in range(n_limbs)], np.uint32)
                     for v in vals])


def put_g2(out: dict, prefix: str, p) -> None:
    for c in ("x", "y", "z"):
        f = getattr(p, c)
        out[f"{prefix}.{c}0"], out[f"{prefix}.{c}1"] = np.asarray(f.c0), np.asarray(f.c1)


def phase_fields(out: dict, meta: dict) -> None:
    from zkdl_tpu.field import fp, fp2, fr
    from zkdl_tpu.tensor import planar_ops
    from zkdl_tpu.field import planar

    rng = np.random.default_rng(1401)
    # (n, 8) Fr ops
    av = [0, 1, 2, FR_P - 1, FR_P - 2] + rand_ints(rng, 11, FR_P)
    bv = [0, 5, 2, FR_P - 1, 1] + rand_ints(rng, 11, FR_P)
    bv[6] = av[6]
    a = jnp.asarray(limbs(av, 8))  # any value < p is a Montgomery value
    b = jnp.asarray(limbs(bv, 8))
    out["fr/a"], out["fr/b"] = np.asarray(a), np.asarray(b)
    out["fr/double"] = np.asarray(fr.double(a))
    out["fr/sqr"] = np.asarray(fr.sqr(a))
    out["fr/unmont"] = np.asarray(fr.unmont(a))
    out["fr/mont"] = np.asarray(fr.mont(a))
    out["fr/pow5"] = np.asarray(fr.pow_static(a, 5))
    out["fr/pow_inv"] = np.asarray(fr.pow_static(a, FR_P - 2))
    out["fr/is_zero"] = np.asarray(fr.is_zero(a))
    out["fr/eq"] = np.asarray(fr.eq(a, b))
    mask = jnp.asarray(rng.integers(0, 2, 16).astype(bool))
    out["fr/mask"] = np.asarray(mask)
    out["fr/select"] = np.asarray(fr.select(mask, a, b))
    out["fr/zeros"] = np.asarray(fr.zeros((3,)))
    out["fr/ones_mont"] = np.asarray(fr.ones_mont((3,)))

    # planar_ops
    t = jnp.asarray(limbs(rand_ints(rng, 16, FR_P), 8))
    x = jnp.asarray(limbs(rand_ints(rng, 1, FR_P), 8)[0])
    u = jnp.asarray(limbs(rand_ints(rng, 4, FR_P), 8))
    out["planar/t"], out["planar/x"], out["planar/u"] = np.asarray(t), np.asarray(x), np.asarray(u)
    tp = planar_ops.to_planar_rev(t, 4)
    out["planar/to_rev"] = np.asarray(tp)
    out["planar/to_rev_pad"] = np.asarray(planar_ops.to_planar_rev(t[:11], 4))
    out["planar/from_rev"] = np.asarray(planar_ops.from_planar_rev(tp))
    out["planar/fold_half"] = np.asarray(planar_ops.fold_half(tp, x))
    t3 = planar.to_planar(t).reshape(8, 4, 4)
    out["planar/fold_axis1"] = np.asarray(planar_ops.fold_axis(t3, x, 1))
    out["planar/fold_axis2"] = np.asarray(planar_ops.fold_axis(t3, x, 2))
    out["planar/me_eval_rev"] = np.asarray(planar_ops.me_eval_rev(tp, u))
    out["planar/me_eval_rev_dot"] = np.asarray(planar_ops.me_eval_rev_dot(tp, u))
    out["planar/inverse_scalar"] = np.asarray(planar_ops.inverse_scalar(x))

    # Fp2: edge pairs, random pairs, and tests/test_tower.py's pairs
    a_pairs = [(0, 0), (1, 0), (0, 1), (FP_P - 1, FP_P - 1)] + list(zip(rand_ints(rng, 8, FP_P), rand_ints(rng, 8, FP_P)))
    b_pairs = [(0, 0), (FP_P - 1, 0), (0, 1), (1, 1)] + list(zip(rand_ints(rng, 8, FP_P), rand_ints(rng, 8, FP_P)))
    b_pairs[5] = a_pairs[5]
    r0 = np.random.default_rng(0)  # test_tower._rand_pairs(default_rng(0), 4)
    tower = [(int(r0.integers(0, 1 << 62)) * 0x1234567 % FP_P, int(r0.integers(0, 1 << 62)) * 0x89ABCDE % FP_P)
             for _ in range(4)]
    a_pairs += tower[0::2]
    b_pairs += tower[1::2]

    def mont_pairs(pairs):
        return fp2.Fp2(jnp.asarray(limbs([x * fp.SPEC.r % FP_P for x, _ in pairs], 12)),
                       jnp.asarray(limbs([y * fp.SPEC.r % FP_P for _, y in pairs], 12)))

    A, B = mont_pairs(a_pairs), mont_pairs(b_pairs)
    for name, v in (("a", A), ("b", B), ("add", fp2.add(A, B)), ("sub", fp2.sub(A, B)), ("neg", fp2.neg(A)),
                    ("double", fp2.double(A)), ("mul", fp2.mul(A, B)), ("sqr", fp2.sqr(A)), ("conj", fp2.conj(A)),
                    ("mul_by_fp", fp2.mul_by_fp(A, B.c1)), ("inv", fp2.inv(A))):
        out[f"fp2/{name}.c0"], out[f"fp2/{name}.c1"] = np.asarray(v.c0), np.asarray(v.c1)
    out["fp2/is_zero"] = np.asarray(fp2.is_zero(A))
    out["fp2/eq"] = np.asarray(fp2.eq(A, B))
    out["fp2/fp_neg"] = np.asarray(fp.neg(A.c0))
    out["fp2/fp_pow5"] = np.asarray(fp.pow_static(A.c0, 5))
    out["fp2/fp_unmont"] = np.asarray(fp.unmont(A.c0))
    out["fp2/fp_mont"] = np.asarray(fp.mont(A.c0))
    meta["fp2_pairs"] = {"a": [[hex(x), hex(y)] for x, y in a_pairs], "b": [[hex(x), hex(y)] for x, y in b_pairs]}

    # the native host library
    from zkdl_tpu import native
    from zkdl_tpu.curve import host_g1

    G = host_g1.GENERATOR
    R = [host_g1.scalar_mul(G, k) for k in rand_ints(rng, 6, FR_P)]
    junk = host_g1.add(R[0], host_g1.neg(R[0]))
    pts = [G, host_g1.double(G), R[0], R[1], R[2], host_g1.IDENTITY, junk, R[3]]
    qs = [G, G, host_g1.neg(R[0]), R[2], host_g1.IDENTITY, R[4], R[5], junk]
    trip = [(p.x, p.y, p.z) for p in pts]
    qtrip = [(q.x, q.y, q.z) for q in qs]
    ks = [0, 1, FR_P - 1, (1 << 256) - 1] + rand_ints(rng, 4, 1 << 256)
    fa = [0, 1, FR_P - 1] + rand_ints(rng, 5, FR_P)
    fb = [FR_P - 1, 1, FR_P - 1] + rand_ints(rng, 5, FR_P)
    same = host_g1.JacPoint(G.x * 4 % FP_P, G.y * 8 % FP_P, 2)  # G with z = 2
    eq_pairs = [(trip[0], (same.x, same.y, same.z)), (trip[0], trip[1]), (trip[5], trip[6]), (trip[5], trip[0])]

    def hx(v):
        return [[hex(c) for c in t] for t in v] if isinstance(v, list) else [hex(c) for c in v]

    meta["native"] = {
        "points": hx(trip), "qs": hx(qtrip), "scalars": [hex(k) for k in ks], "fa": [hex(v) for v in fa],
        "fb": [hex(v) for v in fb], "eq_pairs": [[hx(p), hx(q)] for p, q in eq_pairs],
        "g1_msm": hx(native.g1_msm(trip, ks)), "g1_sum": hx(native.g1_sum(trip)),
        "g1_add_batch": hx(native.g1_add_batch(trip, qtrip)),
        "g1_eq": [native.g1_eq(p, q) for p, q in eq_pairs],
        "fr_mont_mul_batch": [hex(v) for v in native.fr_mont_mul_batch(fa, fb)],
    }


def g2_points():
    """P, Q, R = find_point_host(3, 11, 29) and the Jacobian edge batch
    [P, Q, R, O, P + (-P), 2P, P + Q, 2Q]."""
    from zkdl_tpu.curve import g2
    from zkdl_tpu.field import fp2

    hp = [g2.find_point_host(s) for s in (3, 11, 29)]
    P, Q, R = (g2.jac_from_host(h) for h in hp)
    O = g2.identity()
    pts = [P, Q, R, O, g2.add(P, g2.neg(P)), g2.double(P), g2.add(P, Q), g2.double(Q)]

    def stack(ps):
        def f(c):
            return fp2.Fp2(jnp.stack([getattr(p, c).c0 for p in ps]), jnp.stack([getattr(p, c).c1 for p in ps]))
        return g2.G2Jac(f("x"), f("y"), f("z"))

    return hp, stack(pts), stack


def phase_g2(out: dict, meta: dict) -> None:
    from zkdl_tpu.curve import g2

    hp, E, stack = g2_points()
    meta["g2_host_points"] = [[[hex(c) for c in xy] for xy in h] for h in hp]
    put_g2(out, "g2/edge", E)
    n = E.shape[0]
    roll = g2.G2Jac(*(type(f)(jnp.roll(f.c0, 1, 0), jnp.roll(f.c1, 1, 0)) for f in E))
    put_g2(out, "g2/double", g2.double(E))
    put_g2(out, "g2/neg", g2.neg(E))
    put_g2(out, "g2/add_self", g2.add(E, E))
    put_g2(out, "g2/add_neg", g2.add(E, g2.neg(E)))
    put_g2(out, "g2/add_roll", g2.add(E, roll))
    put_g2(out, "g2/add_roll_rev", g2.add(roll, E))
    for i, h in enumerate(hp):
        put_g2(out, f"g2/add_mixed{i}", g2.add_mixed(E, g2.affine_from_host(h, (n,))))
    rng = np.random.default_rng(1402)
    scal = list(G2_SCALARS) + rand_ints(rng, 2, FR_P)
    pts_i = [0, 1, 3, 4, 5, 6]  # P, Q, O, P + (-P), 2P, P + Q
    pairs = [(i, k) for i in pts_i for k in scal]
    pairs += [(0, 5), (0, 2), (1, 3)]  # test_tower: 5 P, and the msm [P, Q] by [2, 3]
    idx = jnp.asarray([i for i, _ in pairs])
    Pb = g2.G2Jac(*(type(f)(f.c0[idx], f.c1[idx]) for f in E))
    S = jnp.asarray(limbs([k % (1 << 256) for _, k in pairs], 8))
    out["g2/smul_idx"], out["g2/smul_scalars"] = np.asarray(idx), np.asarray(S)
    t0 = time.perf_counter()
    res = g2.scalar_mul_jit(Pb, S)
    print(f"g2 scalar_mul at {len(pairs)} points: {time.perf_counter() - t0:.0f}s", file=sys.stderr, flush=True)
    put_g2(out, "g2/smul", res)
    for m in (1, 2, 3, 5, 8):
        put_g2(out, f"g2/sum{m}", g2.g2_sum(g2.G2Jac(*(type(f)(f.c0[:m], f.c1[:m]) for f in E))))
    put_g2(out, "g2/tower_msm", g2.g2_sum(g2.G2Jac(*(type(f)(f.c0[-2:], f.c1[-2:]) for f in res))))


def phase_g2msm(out: dict, meta: dict) -> None:
    from zkdl_tpu.curve import g2

    _, E, _ = g2_points()
    rng = np.random.default_rng(1403)
    ks = [0, 1, (1 << 256) - 1, FR_P - 1] + rand_ints(rng, 4, FR_P)
    S = jnp.asarray(limbs(ks, 8))
    out["g2/msm_scalars"] = np.asarray(S)
    t0 = time.perf_counter()
    put_g2(out, "g2/msm", g2.msm(E, S))
    print(f"g2 msm at 8 points: {time.perf_counter() - t0:.0f}s", file=sys.stderr, flush=True)


def phase_ntt(out: dict, meta: dict) -> None:
    from zkdl_tpu.field import fr
    from zkdl_tpu.tensor import fft

    rng = np.random.default_rng(1404)
    for n in NTT_SIZES:
        x = jnp.asarray(limbs(rand_ints(rng, n, FR_P), 8))
        out[f"ntt/x{n}"] = np.asarray(x)
        out[f"ntt/fwd{n}"] = np.asarray(fft.ntt(x))
        out[f"ntt/inv{n}"] = np.asarray(fft.intt(x))
    for name, v in (("zeros", 0), ("pm1", FR_P - 1)):
        x = jnp.asarray(limbs([v] * 8, 8))
        out[f"ntt/{name}_fwd"] = np.asarray(fft.ntt(x))
        out[f"ntt/{name}_inv"] = np.asarray(fft.intt(x))
    for na, nb in POLY_SIZES:
        a = jnp.asarray(limbs(rand_ints(rng, na, FR_P), 8))
        b = jnp.asarray(limbs(rand_ints(rng, nb, FR_P), 8))
        out[f"ntt/poly_a{na}"], out[f"ntt/poly_b{nb}"] = np.asarray(a), np.asarray(b)
        out[f"ntt/poly{na}x{nb}"] = np.asarray(fft.poly_mul(a, b))
    # tests/test_tower.py: the roundtrip (rng 2, 16), the naive DFT (rng 3, 8), poly_mul (rng 4)

    def rand_fr(r, n):
        return fr.mont(jnp.asarray(fr.from_ints([int(r.integers(0, 1 << 61)) * 0xDEADBEEF % FR_P for _ in range(n)])))

    x = rand_fr(np.random.default_rng(2), 16)
    out["ntt/tower_rt_x"], out["ntt/tower_rt"] = np.asarray(x), np.asarray(fft.intt(fft.ntt(x)))
    x = rand_fr(np.random.default_rng(3), 8)
    out["ntt/tower_dft_x"], out["ntt/tower_dft"] = np.asarray(x), np.asarray(fft.ntt(x))
    r4 = np.random.default_rng(4)
    ai = [int(r4.integers(1, 1000)) for _ in range(5)]
    bi = [int(r4.integers(1, 1000)) for _ in range(4)]
    a, b = fr.mont(jnp.asarray(fr.from_ints(ai))), fr.mont(jnp.asarray(fr.from_ints(bi)))
    out["ntt/tower_pa"], out["ntt/tower_pb"] = np.asarray(a), np.asarray(b)
    out["ntt/tower_poly"] = np.asarray(fft.poly_mul(a, b))
    meta["ntt_omega"] = {str(k): [hex(fft._omega(k, False)), hex(fft._omega(k, True))] for k in range(0, 21)}


def win_inputs():
    """K5's edge points (G, a NUMS candidate, O, (r^2, -r^3, 0)) under K5's
    edge scalars, then four random multiples of G (z != 1) under random
    scalars below r: plain-int Jacobian triples and 256-bit ints."""
    from zkdl_tpu.commit import pedersen
    from zkdl_tpu.curve import host_g1

    G = host_g1.GENERATOR
    _, nx, ny = pedersen._nums_affine(1)[0]
    C = host_g1.add(G, host_g1.neg(G))
    assert C.z == 0 and C.x != 0  # the generic formula's identity
    rng = np.random.default_rng(1405)
    pts, ks = [], []
    for p in (G, host_g1.JacPoint(nx, ny, 1), host_g1.IDENTITY, C):
        pts += [p] * len(WIN_SCALARS)
        ks += list(WIN_SCALARS)
    pts += [host_g1.scalar_mul(G, k) for k in rand_ints(rng, 4, FR_P)]
    ks += rand_ints(rng, 4, FR_P)
    return pts, ks


def phase_windowed(out: dict, meta: dict) -> None:
    from zkdl_tpu.curve import convert, g1

    pts, ks = win_inputs()
    P = convert.jac_to_device(pts)
    S = jnp.asarray(limbs(ks, 8))
    for c in ("x", "y", "z"):
        out[f"win/points.{c}"] = np.asarray(getattr(P, c))
    out["win/scalars"] = np.asarray(S)
    t0 = time.perf_counter()
    res = jax.jit(g1.scalar_mul_windowed)(P, S)
    print(f"scalar_mul_windowed at {len(pts)} points: {time.perf_counter() - t0:.0f}s", file=sys.stderr, flush=True)
    for c in ("x", "y", "z"):
        out[f"win/out.{c}"] = np.asarray(getattr(res, c))


def softmax_scores(seq: int) -> np.ndarray:
    """(seq * seq,) signed scores at scale 2^16: standard normals x 2.5."""
    rng = np.random.default_rng(1400 + seq)
    return np.round(rng.standard_normal(seq * seq) * 2.5 * 65536).astype(np.int64)


def phase_softmax(out: dict, meta: dict) -> None:
    import dataclasses

    from zkdl_tpu.field import fr
    from zkdl_tpu.models import zkattention as za
    from zkdl_tpu.sumcheck.transcript import FiatShamir, SeededRng

    for seq, d in SOFTMAX_CASES:
        pre = f"soft{seq}"
        S = fr.mont(jnp.asarray(limbs([int(v) % FR_P for v in softmax_scores(seq)], 8)))
        out[f"{pre}/S"] = np.asarray(S)
        P, q = za.softmax_aux(S, seq, seq, d)
        out[f"{pre}/P"], out[f"{pre}/q"] = np.asarray(P), np.asarray(q)
        try:  # writes into np.asarray of a JAX array, which is read-only
            za.softmax_aux(S, seq, seq, d, real_rows=seq - 1)
            meta[f"{pre}_pad_error"] = None
        except ValueError as e:
            meta[f"{pre}_pad_error"] = str(e)
        out[f"{pre}/bits"] = np.asarray(za.p_range_bits(P))
        proofs = {}
        for name, ch in (("seeded", SeededRng(SEEDED)), ("fs", FiatShamir())):
            t0 = time.perf_counter()
            proofs[name] = za.softmax_prove(P, seq, seq, ch)
            print(f"softmax_prove seq {seq} {name}: {time.perf_counter() - t0:.0f}s", file=sys.stderr, flush=True)
            for f in dataclasses.fields(proofs[name]):
                out[f"{pre}/{name}/{f.name}"] = np.asarray(getattr(proofs[name], f.name))
            meta[f"{pre}_{name}_ok"] = za.softmax_verify(proofs[name])
        pf = proofs["fs"]
        bp = np.asarray(pf.bin_polys).copy()
        bp[0, 0, 0] ^= 1
        meta[f"{pre}_tamper_bin_poly"] = za.softmax_verify(dataclasses.replace(pf, bin_polys=jnp.asarray(bp)))
        ipf = np.asarray(pf.ip_finals).copy()
        ipf[0, 0] ^= 1
        meta[f"{pre}_tamper_ip_finals"] = za.softmax_verify(dataclasses.replace(pf, ip_finals=jnp.asarray(ipf)))
        q1 = np.asarray(q).reshape(-1).copy()
        q1[0] += 1  # row 0 sums to 2^16 + 1
        P1 = fr.mont(jnp.asarray(limbs(q1, 8)))
        out[f"{pre}/P_off"] = np.asarray(P1)
        p1 = za.softmax_prove(P1, seq, seq, FiatShamir())
        for f in dataclasses.fields(p1):
            out[f"{pre}/off/{f.name}"] = np.asarray(getattr(p1, f.name))
        meta[f"{pre}_tamper_row_sum"] = za.softmax_verify(p1)


PHASES = {"fields": phase_fields, "g2": phase_g2, "g2msm": phase_g2msm, "ntt": phase_ntt,
          "windowed": phase_windowed, "softmax": phase_softmax}


def save(path: pathlib.Path, out: dict) -> None:
    keys = sorted(out)
    np.savez_compressed(
        path,
        __keys__=np.frombuffer(json.dumps({k: f"a{i}" for i, k in enumerate(keys)}).encode(), np.uint8),
        **{f"a{i}": out[k] for i, k in enumerate(keys)},
    )


def load(path: pathlib.Path) -> dict:
    with np.load(path) as z:
        keys = json.loads(bytes(z["__keys__"]).decode())
        return {k: z[v] for k, v in keys.items()}


def run_phase(name: str, parts: pathlib.Path) -> None:
    t0 = time.perf_counter()
    out: dict = {}
    meta: dict = {}
    PHASES[name](out, meta)
    save(parts / f"{name}.npz", out)
    (parts / f"{name}.json").write_text(json.dumps(meta))
    print(f"phase {name}: {time.perf_counter() - t0:.0f}s", file=sys.stderr, flush=True)


def main() -> None:
    """With no argument, every phase in a new temporary directory; with
    --parts DIR, the phases whose parts DIR lacks; with PHASE DIR, that
    phase alone."""
    import subprocess
    import tempfile

    if len(sys.argv) == 3 and sys.argv[1] in PHASES:
        run_phase(sys.argv[1], pathlib.Path(sys.argv[2]))
        return
    t0 = time.perf_counter()
    parts = pathlib.Path(sys.argv[2] if sys.argv[1:2] == ["--parts"] else tempfile.mkdtemp(prefix="record_slice14_"))
    me = [sys.executable, str(pathlib.Path(__file__).resolve())]
    procs = {nm: subprocess.Popen([*me, nm, str(parts)]) for nm in PHASES if not (parts / f"{nm}.json").exists()}
    failed = [nm for nm, p in procs.items() if p.wait()]
    if failed:
        raise SystemExit(f"phases {failed} failed; rerun with --parts {parts}")
    out: dict = {}
    meta: dict = {}
    for nm in PHASES:
        out.update(load(parts / f"{nm}.npz"))
        meta.update(json.loads((parts / f"{nm}.json").read_text()))
    FIXTURES.mkdir(exist_ok=True)
    save(FIXTURES / "slice14_jax.npz", out)
    meta = {
        "command": COMMAND,
        "jax_version": jax.__version__,
        "recorded": meta,
        "sources_sha256": {s: hashlib.sha256((ROOT / s).read_bytes()).hexdigest() for s in SOURCES},
    }
    (FIXTURES / "slice14_jax.json").write_text(json.dumps(meta, indent=1) + "\n")
    print(f"wrote slice14_jax.npz/json ({time.perf_counter() - t0:.0f}s)", file=sys.stderr)


if __name__ == "__main__":
    main()
