"""The port's batch inversion (K7's plain version and an integer model of
K7's schedule), logUp lookup, natural-order sumcheck provers and general
field matmul, held on the CPU against the JAX package's outputs recorded by
``record_attention.py`` (no JAX at run time)."""

import functools

import numpy as np
import pytest
import torch

from attention_helpers import assert_same_arrays, attention_fixture, flat_arrays
from zkdl_tpu_torch.field import fr, kernels, mp
from zkdl_tpu_torch.field.host import fr as HF
from zkdl_tpu_torch.models import zkfc
from zkdl_tpu_torch.sumcheck import lookup
from zkdl_tpu_torch.sumcheck import protocols as sc
from zkdl_tpu_torch.sumcheck.transcript import FiatShamir


def rec(key):
    return attention_fixture()[0][key]


@pytest.mark.parametrize("case", ["1", "2", "5", "64", "_zero"])
def test_batch_inverse_plain_matches_jax(case):
    x = torch.from_numpy(rec(f"binv/in{case}"))
    np.testing.assert_array_equal(kernels.batch_inverse(x).numpy(), rec(f"binv/out{case}"))


def test_batch_inverse_zero_makes_all_zero():
    x = torch.from_numpy(np.random.default_rng(4).integers(1, 1 << 31, size=(9, 8), dtype=np.uint32))
    x[3] = 0
    assert int(kernels.batch_inverse(x).view(torch.int32).abs().sum()) == 0


# csrc/fr_inverse.cu's constants
K7_THREADS = 256
K7_TARGET_CHUNKS = 32768
K7_MAX_SEGMENTS = 8
K7_LAST_LEAVES = 2 * K7_TARGET_CHUNKS // K7_THREADS + K7_MAX_SEGMENTS
K7_MAX_BATCHES = 25
M30 = (1 << 30) - 1
U32 = (1 << 32) - 1
R3 = pow(2, 3 * 256, fr.P_INT)  # C: (xR)^-1 times R^3, R^-1 of it the Montgomery product's, is x^-1 R
P30 = [(fr.P_INT >> (30 * k)) & M30 for k in range(8)] + [fr.P_INT >> 240]  # p in 30-bit limbs
P_INV30 = pow(fr.P_INT, -1, 1 << 30)
# The input of the most divstep batches (and, among those, inner iterations)
# of the seeded search in test_gcd_model_inverts; chip_smoke.py holds K7 on it
GCD_SLOWEST = 0x73227B5DE2E79A360ED5B065AE09D832F5A9EBD42DED0059A2833BC4183570D


def _i32(x: int) -> int:
    x &= U32
    return x - (1 << 32) if x >> 31 else x


def _i64(x: int) -> int:
    assert -(1 << 63) <= x < 1 << 63, "a 64-bit sum overflows"
    return x


def _divsteps30(eta: int, f: int, g: int):
    """divsteps30: 30 divsteps on uint32 words; returns eta, the matrix, and
    the inner iterations (the kernel's loop trips after the halvings)."""
    u, v, q, r = 1, 0, 0, 1
    i, trips = 30, 0
    while True:
        z = ((g | ((U32 << i) & U32)) & -(g | ((U32 << i) & U32))).bit_length() - 1  # __ffs - 1
        g >>= z
        u, v = (u << z) & U32, (v << z) & U32
        eta, i = eta - z, i - z
        if i == 0:
            break
        trips += 1
        if eta < 0:
            eta = -eta
            f, g = g, -f & U32
            u, q = q, -u & U32
            v, r = r, -v & U32
        limit = min(eta + 1, i)
        m = (U32 >> (32 - limit)) & 255
        finv = f
        finv = finv * (2 - f * finv) & U32
        finv = finv * (2 - f * finv) & U32
        w = g * (-finv & U32) & m
        g, q, r = (g + f * w) & U32, (q + u * w) & U32, (r + v * w) & U32
        assert g & m == 0
    t = tuple(_i32(c) for c in (u, v, q, r))
    assert abs(t[0]) + abs(t[1]) <= 1 << 30 and abs(t[2]) + abs(t[3]) <= 1 << 30
    return eta, t, trips


def _update_de(d, e, t):
    u, v, q, r = t
    sd, se = -1 if d[8] < 0 else 0, -1 if e[8] < 0 else 0
    md, me = (u & sd) + (v & se), (q & sd) + (r & se)
    cd, ce = u * d[0] + v * e[0], q * d[0] + r * e[0]
    md = _i32(md - ((P_INV30 * (cd & U32) + (md & U32)) & M30))
    me = _i32(me - ((P_INV30 * (ce & U32) + (me & U32)) & M30))
    cd, ce = cd + P30[0] * md, ce + P30[0] * me
    assert cd & M30 == 0 and ce & M30 == 0
    cd, ce = cd >> 30, ce >> 30
    for k in range(1, 9):
        cd = _i64(cd + u * d[k] + v * e[k] + P30[k] * md)
        ce = _i64(ce + q * d[k] + r * e[k] + P30[k] * me)
        d[k - 1], e[k - 1] = cd & M30, ce & M30
        cd, ce = cd >> 30, ce >> 30
    assert _i32(cd) == cd and _i32(ce) == ce
    d[8], e[8] = cd, ce


def _update_fg(f, g, t):
    u, v, q, r = t
    cf, cg = u * f[0] + v * g[0], q * f[0] + r * g[0]
    assert cf & M30 == 0 and cg & M30 == 0
    cf, cg = cf >> 30, cg >> 30
    for k in range(1, 9):
        cf, cg = _i64(cf + u * f[k] + v * g[k]), _i64(cg + q * f[k] + r * g[k])
        f[k - 1], g[k - 1] = cf & M30, cg & M30
        cf, cg = cf >> 30, cg >> 30
    f[8], g[8] = cf, cg


def _carry(r):
    for k in range(8):
        r[k + 1] += r[k] >> 30
        r[k] &= M30


def _add_p_if_negative(r):
    if r[8] < 0:
        for k in range(9):
            r[k] += P30[k]
    _carry(r)


def _limbs30(r) -> int:
    return sum(x << (30 * k) for k, x in enumerate(r))


def _gcd30(a: int):
    """gcd_inverse of csrc/fr_inverse.cu on Python integers, word for word:
    a^-1 mod p (0 for 0), with its batches of 30 divsteps and inner trips."""
    if a == 0:
        return 0, 0, 0
    words = [(a >> (32 * k)) & U32 for k in range(8)]
    g = []
    for k in range(9):  # limb k from the words around bit 30k
        w, off = 30 * k // 32, 30 * k % 32
        pair = words[w] | (words[w + 1] << 32 if w + 1 < 8 else 0)
        g.append((pair >> off) & M30)
    f, d, e = list(P30), [0] * 9, [1] + [0] * 8
    eta, batches, trips = -1, 0, 0
    while batches < K7_MAX_BATCHES:
        eta, t, n = _divsteps30(eta, f[0] & U32, g[0] & U32)
        batches, trips = batches + 1, trips + n
        _update_de(d, e, t)
        _update_fg(f, g, t)
        assert all(0 <= x <= M30 for x in d[:8] + e[:8] + f[:8] + g[:8])
        assert -2 * fr.P_INT < _limbs30(d) < fr.P_INT and -2 * fr.P_INT < _limbs30(e) < fr.P_INT
        if not any(g):
            break
    assert not any(g) and _limbs30(f) in (1, -1), "the GCD did not end within MAX_BATCHES"
    _add_p_if_negative(d)
    if f[8] < 0:
        d = [-x for x in d]
    _carry(d)
    _add_p_if_negative(d)
    out = 0
    for k in range(8):  # word k from the limbs around bit 32k
        l, off = 32 * k // 30, 32 * k % 30
        out |= (((d[l] | d[l + 1] << 30) >> off) & U32) << (32 * k)
    return out, batches, trips


def _inverse_mont(a: int) -> int:
    """inverse_mont: the GCD, then a Montgomery product by R^3."""
    return HF.mul(_gcd30(a)[0], R3)


def _k7_plan(ns, target=K7_TARGET_CHUNKS):
    """plan(): the chunk and, per segment, its chunks, blocks, first block
    and the depth of the last block's tree over its blocks."""
    chunk = -(-sum(ns) // target)
    segs, blocks, nodes = [], 0, 0
    for n in ns:
        T = -(-n // chunk)
        B = -(-T // K7_THREADS)
        lg = (B - 1).bit_length()
        segs.append((T, B, blocks, lg))
        blocks, nodes = blocks + B, nodes + (2 << lg)
    assert nodes <= 2 * K7_LAST_LEAVES
    return chunk, segs


def _down(h, lg):
    """A heap walked down from its inverted root, one level at a time:
    inv(child) = inv(parent) * sibling, every sibling read before the level
    is written."""
    for d in range(1, lg + 1):
        level = {k: HF.mul(h[k >> 1], h[k ^ 1]) for k in range(1 << d, 2 << d)}
        h.update(level)


def _k7_model(segments, target=K7_TARGET_CHUNKS):
    """csrc/fr_inverse.cu's schedule on Montgomery ints: the chunk walks and
    block trees of launch 1, the last block's tree per segment with its root
    inverted by the GCD model, and launch 2's trees down and walks back."""
    one = HF.one_mont
    chunk, plan = _k7_plan([len(xs) for xs in segments], target)
    outs = [[0] * len(xs) for xs in segments]

    def chunks(n, T, lb):
        m = min(K7_THREADS, T - lb * K7_THREADS)
        for j in range(m):
            s0 = (lb * K7_THREADS + j) * chunk
            yield j, s0, min(s0 + chunk, n)

    trees = []
    for xs, pre, (T, B, _, _) in zip(segments, outs, plan):  # launch 1
        for lb in range(B):
            m = min(K7_THREADS, T - lb * K7_THREADS)
            lg = (m - 1).bit_length()
            h = {(1 << lg) + j: one for j in range(1 << lg)}
            for j, s0, e0 in chunks(len(xs), T, lb):
                acc = pre[s0] = xs[s0]
                for i in range(s0 + 1, e0):
                    acc = pre[i] = HF.mul(acc, xs[i])
                h[(1 << lg) + j] = acc
            for k in range((1 << lg) - 1, 0, -1):
                h[k] = HF.mul(h[2 * k], h[2 * k + 1])
            trees.append((h, lg))
    binv = []
    for T, B, b0, lg in plan:  # the last block
        h = {(1 << lg) + i: trees[b0 + i][0][1] if i < B else one for i in range(1 << lg)}
        for k in range((1 << lg) - 1, 0, -1):
            h[k] = HF.mul(h[2 * k], h[2 * k + 1])
        h[1] = _inverse_mont(h[1])
        _down(h, lg)
        binv += [h[(1 << lg) + i] for i in range(B)]
    for xs, out, (T, B, b0, _) in zip(segments, outs, plan):  # launch 2
        for lb in range(B):
            h, lg = trees[b0 + lb]
            h = dict(h)
            h[1] = binv[b0 + lb]
            _down(h, lg)
            for j, s0, e0 in chunks(len(xs), T, lb):
                il = h[(1 << lg) + j]
                for i in range(e0 - 1, s0, -1):
                    out[i] = HF.mul(out[i - 1], il)
                    il = HF.mul(il, xs[i])
                out[s0] = il
    return outs


def _nonzero(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % (fr.P_INT - 1) + 1 for _ in range(n)]


@pytest.mark.parametrize("n", [1, 2, 3, 257, 2049, 4096, 5000])
def test_k7_schedule_inverts(n):
    rng = np.random.default_rng(n)
    xs = _nonzero(rng, n)
    assert _k7_model([xs]) == [[HF.inv(x) for x in xs]]
    xs[n // 2] = 0
    assert _k7_model([xs]) == [[0] * n]


@pytest.mark.parametrize("ns, target", [
    ((16384, 4096), K7_TARGET_CHUNKS),  # the lookup's two sides at seq 128
    ((5, 1, 3000, 257), K7_TARGET_CHUNKS),
    ((33000,), K7_TARGET_CHUNKS),  # two elements a chunk
    ((700, 1, 70), 64),  # chunks of 12 elements, a segment shorter than one chunk
], ids=["lookup", "four", "chunk2", "chunk12"])
def test_k7_schedule_inverts_segments(ns, target):
    """Every segment inverted in one call; a zero in one segment zeroes that
    segment alone."""
    rng = np.random.default_rng(len(ns) + sum(ns))
    segs = [_nonzero(rng, n) for n in ns]
    want = [[HF.inv(x) for x in xs] for xs in segs]
    assert _k7_model(segs, target) == want
    for z in range(len(ns)):
        bad = [list(xs) for xs in segs]
        bad[z][len(bad[z]) // 3] = 0
        assert _k7_model(bad, target) == [[0] * n if s == z else w for s, (n, w) in enumerate(zip(ns, want))]


def test_k7_schedule_matches_recorded_segments():
    """The model and the segmented plain call on the recorded inputs of 5,
    64 and 64-with-a-zero give the JAX package's outputs, each."""
    cases = ["5", "64", "_zero"]
    xs = [torch.from_numpy(rec(f"binv/in{c}")) for c in cases]
    for x, got, c in zip(xs, kernels.batch_inverse_many(xs), cases):
        np.testing.assert_array_equal(got.numpy(), rec(f"binv/out{c}"))
    ints = [[int(v) for v in fr.to_ints(x.numpy())] for x in xs]
    model = _k7_model(ints)
    for c, out in zip(cases, model):
        assert out == [int(v) for v in fr.to_ints(rec(f"binv/out{c}"))]


def _slowest(values):
    return max(values, key=lambda a: _gcd30(a)[1:])


def test_gcd_model_inverts():
    """The word-level GCD against Python's inverse, through the product by
    C, on the edge values, powers of two, the seeded search's slowest input
    and 200 seeded values."""
    p, R = fr.P_INT, 1 << 256
    rng = np.random.default_rng(10)
    seeded = _nonzero(rng, 200)
    edges = [1, 2, p - 1, p - 2, R % p, pow(R, -1, p), (p + 1) // 2, GCD_SLOWEST] + [1 << k for k in range(0, 255, 9)]
    for a in edges + seeded:
        inv, batches, _ = _gcd30(a)
        assert inv == pow(a, -1, p) and 1 <= batches <= K7_MAX_BATCHES
        assert _inverse_mont(a) == HF.inv(a)
    assert _gcd30(0) == (0, 0, 0) and _inverse_mont(0) == 0
    assert _slowest(_nonzero(np.random.default_rng(11), 600)) == GCD_SLOWEST
    assert _gcd30(GCD_SLOWEST)[1] == max(_gcd30(a)[1] for a in edges + seeded)


def test_k7_bound_counts_the_gcd():
    """chip_smoke.py's K7 bound charges each GCD the batches and inner trips
    that the word-level model takes on that input, and a segment 3 (n - 1)
    products and the product by C."""
    import chip_smoke

    p, R = fr.P_INT, 1 << 256
    assert chip_smoke.K7_GCD_SLOWEST == GCD_SLOWEST and chip_smoke.K7_MAX_BATCHES == K7_MAX_BATCHES
    for a in [0, 1, 2, p - 1, R % p, GCD_SLOWEST] + _nonzero(np.random.default_rng(12), 50):
        _, batches, trips = _gcd30(a)
        assert chip_smoke.k7_gcd_imads(a) == batches * chip_smoke.K7_BATCH_IMAD + trips * chip_smoke.K7_TRIP_IMAD
    xs = _nonzero(np.random.default_rng(13), 5)
    root = functools.reduce(HF.mul, xs)  # the Montgomery product the GCD inverts
    ops = chip_smoke.FR_MUL_IMAD * (3 * 4 + 1) + chip_smoke.k7_gcd_imads(root)
    ops += chip_smoke.FR_MUL_IMAD + chip_smoke.k7_gcd_imads(R % p)  # a segment of one: the GCD and C alone
    segs = [torch.from_numpy(fr.from_ints(xs)), torch.from_numpy(fr.from_ints([R % p]))]
    want = max(64 * 6 / chip_smoke.HBM_BYTES_PER_S, ops / chip_smoke.IMAD_PER_S) * 1e3
    assert chip_smoke.k7_bound(segs) == (pytest.approx(want, rel=1e-12), "operations")


def test_lookup_proof_matches_jax():
    a_vals = rec("lookup/a_vals")
    m = lookup.multiplicities(a_vals, 16, "cpu")
    np.testing.assert_array_equal(m.numpy(), rec("lookup/m"))
    proof = lookup.prove(_witness(a_vals), lookup.range_table(4, "cpu"), m, FiatShamir())
    assert_same_arrays(flat_arrays(proof), _recorded("lookup"), "lookup proof")
    assert lookup.verify(proof, table_vals=list(range(16))) == tuple(attention_fixture()[1]["verdicts"]["lookup_ok"])


def _witness(a_vals):
    """The lookup's witness: the range table's entries at a_vals."""
    return mp.take(lookup.range_table(4, "cpu"), torch.from_numpy(a_vals.astype(np.int64)), 0)


def _recorded(prefix):
    arrays = {k[len(prefix) + 1 :]: v for k, v in attention_fixture()[0].items() if k.startswith(prefix + ":")}
    arrays.pop("__skeleton__", None)
    return arrays


def test_lookup_rejects_unequal_sums():
    a_vals = rec("lookup/a_vals")
    m = lookup.multiplicities(a_vals, 16, "cpu")
    proof = lookup.prove(_witness(a_vals), lookup.range_table(4, "cpu"), m, FiatShamir())
    w = proof.sum_w.numpy().copy()
    w[0] += np.uint32(1)
    proof.sum_w = torch.from_numpy(w)
    assert lookup.verify(proof) == (False, "grand sums differ")


def _t(key):
    return torch.from_numpy(rec(key))


@pytest.mark.parametrize("n", [5, 8, 1])
def test_inner_product_prove_matches_jax(n):
    polys, finals = sc.inner_product_prove(_t(f"scan/ip{n}/a"), _t(f"scan/ip{n}/b"), _t(f"scan/ip{n}/u"))
    np.testing.assert_array_equal(polys.numpy(), rec(f"scan/ip{n}/polys"))
    np.testing.assert_array_equal(finals.numpy(), rec(f"scan/ip{n}/finals"))


@pytest.mark.parametrize("tag", ["hp6", "hp8", "hp8b", "hp1"])
def test_hadamard_prove_matches_jax(tag):
    k = f"scan/{tag}/"
    polys, finals = sc.hadamard_prove(_t(k + "a"), _t(k + "b"), _t(k + "u"), _t(k + "v"))
    np.testing.assert_array_equal(polys.numpy(), rec(k + "polys"))
    np.testing.assert_array_equal(finals.numpy(), rec(k + "finals"))


@pytest.mark.parametrize("tag", ["bin16", "bin7", "bin1"])
def test_binary_prove_matches_jax(tag):
    k = f"scan/{tag}/"
    polys, final = sc.binary_prove(_t(k + "a"), _t(k + "u"), _t(k + "v"))
    np.testing.assert_array_equal(polys.numpy(), rec(k + "polys"))
    np.testing.assert_array_equal(final.numpy(), rec(k + "final"))


def test_field_matmul_matches_jax():
    np.testing.assert_array_equal(zkfc.field_matmul(_t("fm/X"), _t("fm/W"), 8, 4).numpy(), rec("fm/Z"))


def test_k7_source_carries_its_constants():
    """csrc/fr_inverse.cu hard-codes mont(1), C = R^3 mod p, p in 30-bit
    limbs and p^-1 mod 2^30 (it cannot be compiled here): check them, and
    its block, chunk, segment and batch constants, against the models."""
    import re

    from zkdl_tpu_torch.utils import build

    src = (build.CSRC / "fr_inverse.cu").read_text()

    def words(name, bits=32, count="NL"):
        (body,) = re.findall(rf"{name}\[{count}\] = \{{(.*?)\}};", src, re.S)
        return sum(int(v, 16) << (bits * i) for i, v in enumerate(re.findall(r"0x([0-9a-f]+)", body)))

    def const(name):
        (v,) = re.findall(rf"\b{name} = ([0-9]+);", src)
        return int(v)

    assert words("ONE_MONT") == HF.one_mont
    assert words("R3_MOD_P") == R3 == HF.mont(HF.mont(HF.mont(1)))
    assert words("P30", 30, "9") == _limbs30(P30) == fr.P_INT
    assert const("P_INV30") == P_INV30 == 1
    assert const("THREADS") == K7_THREADS and const("TARGET_CHUNKS") == K7_TARGET_CHUNKS
    assert const("MAX_SEGMENTS") == K7_MAX_SEGMENTS
    assert const("MAX_BATCHES") == K7_MAX_BATCHES
    assert "LAST_LEAVES = 2 * TARGET_CHUNKS / THREADS + MAX_SEGMENTS;" in src
