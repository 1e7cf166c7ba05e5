"""The port's NTT (``tensor/fft.py``: ``ntt``, ``intt``, ``poly_mul``, K10's
plain version) against the JAX package's ``tensor/fft.py``, recorded by
``record_slice14.py``; and a word-level model of K10 (``csrc/fr_ntt.cu``):
field.cuh's CIOS product and reduced sums, the kernel's stage schedule and
index arithmetic, run on the recorded inputs."""

import re

import numpy as np
import pytest
import torch

from slice14_fixture import rec, same, t
from zkdl_tpu.tensor import fft as jfft
from zkdl_tpu_torch.field import fr
from zkdl_tpu_torch.tensor import fft
from zkdl_tpu_torch.utils import build

P = fr.P_INT
SIZES = (1, 2, 8, 16, 256)


def _ints(a) -> list[int]:
    return fr.to_ints(np.asarray(a))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_equals_jax(n, inverse):
    x = t(f"ntt/x{n}")
    assert same((fft.intt if inverse else fft.ntt)(x), f"ntt/{'inv' if inverse else 'fwd'}{n}")


@pytest.mark.parametrize("kind", ["zeros", "pm1"])
def test_ntt_of_constant_vectors_equals_jax(kind):
    x = torch.from_numpy(fr.from_ints([0 if kind == "zeros" else P - 1] * 8))
    assert same(fft.ntt(x), f"ntt/{kind}_fwd") and same(fft.intt(x), f"ntt/{kind}_inv")


@pytest.mark.parametrize("na,nb", [(5, 4), (9, 8), (100, 29)])
def test_poly_mul_equals_jax(na, nb):
    assert same(fft.poly_mul(t(f"ntt/poly_a{na}"), t(f"ntt/poly_b{nb}")), f"ntt/poly{na}x{nb}")


def test_tower_cases():
    """tests/test_tower.py's NTT cases on the JAX package's inputs: the
    roundtrip, the naive DFT and poly_mul against schoolbook."""
    x = t("ntt/tower_rt_x")
    assert same(fft.intt(fft.ntt(x)), "ntt/tower_rt") and torch.equal(fft.intt(fft.ntt(x)), x)
    x = t("ntt/tower_dft_x")
    got = fft.ntt(x)
    assert same(got, "ntt/tower_dft")
    vals = [v * fr.SPEC.r_inv % P for v in _ints(x)]
    w = fft._omega(3, False)
    naive = [sum(vals[j] * pow(w, i * j, P) for j in range(8)) % P for i in range(8)]
    assert [v * fr.SPEC.r_inv % P for v in _ints(got)] == naive
    assert same(fft.poly_mul(t("ntt/tower_pa"), t("ntt/tower_pb")), "ntt/tower_poly")


def test_constants_and_twiddles_equal_jax():
    assert fft.ROOT_INT == jfft.ROOT_INT and fft.TWO_ADICITY == jfft.TWO_ADICITY
    for log_n in range(0, 21):
        for inv in (False, True):
            assert fft._omega(log_n, inv) == jfft._omega(log_n, inv)
    for log_n in (1, 3, 6):
        for inv in (False, True):
            table = fft.twiddles(log_n, inv, torch.device("cpu")).numpy()
            n = 1 << log_n
            for s, want in enumerate(jfft._stage_twiddles(log_n, inv), start=1):
                m = 1 << s
                assert np.array_equal(table[:: n // m][: m // 2], np.asarray(want))
        assert np.array_equal(fft._bitrev_perm(log_n), jfft._bitrev_perm(log_n))


def test_ntt_rejects_bad_shapes_and_devices():
    with pytest.raises(ValueError):
        fft.ntt(torch.zeros((3, 8), dtype=torch.uint32))
    with pytest.raises(ValueError):
        fft.ntt(torch.zeros((4, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        fft.ntt(torch.zeros((4, 8), dtype=torch.uint32, device="meta"))


# ---------------------------------------------------------------------------
# K10's word-level model
# ---------------------------------------------------------------------------

SRC = (build.CSRC / "fr_ntt.cu").read_text()
M32 = 0xFFFFFFFF
PW = [(P >> (32 * i)) & M32 for i in range(8)]
NP0 = 0xFFFFFFFF


def _w(v: int) -> list[int]:
    return [(v >> (32 * i)) & M32 for i in range(8)]


def _v(w) -> int:
    return sum(x << (32 * i) for i, x in enumerate(w))


def sub_p_if_gte(t_, hi):
    """field.cuh:sub_p_if_gte."""
    d, borrow = [], 0
    for i in range(8):
        s = (t_[i] - PW[i] - borrow) % (1 << 64)
        d.append(s & M32)
        borrow = (s >> 32) & 1
    ge = hi != 0 or borrow == 0
    return d if ge else list(t_[:8])


def mont_mul(a, b):
    """field.cuh:mont_mul<FrSpec> (CIOS, 64-bit intermediates), word for word."""
    t_ = [0] * 10
    for i in range(8):
        c = 0
        for j in range(8):
            s = a[j] * b[i] + t_[j] + c
            assert s < 1 << 64
            t_[j], c = s & M32, s >> 32
        s = t_[8] + c
        t_[8], t_[9] = s & M32, s >> 32
        m = (t_[0] * NP0) & M32
        s = m * PW[0] + t_[0]
        c = s >> 32
        for j in range(1, 8):
            s = m * PW[j] + t_[j] + c
            t_[j - 1], c = s & M32, s >> 32
        s = t_[8] + c
        t_[7] = s & M32
        t_[8] = (t_[9] + (s >> 32)) & M32
    return sub_p_if_gte(t_, t_[8])


def mod_add(a, b):
    s, c = [], 0
    for i in range(8):
        v = a[i] + b[i] + c
        s.append(v & M32)
        c = v >> 32
    return sub_p_if_gte(s, c)


def mod_sub(a, b):
    d, borrow = [], 0
    for i in range(8):
        v = (a[i] - b[i] - borrow) % (1 << 64)
        d.append(v & M32)
        borrow = (v >> 32) & 1
    r, c = [], 0
    for i in range(8):
        v = d[i] + (PW[i] if borrow else 0) + c
        r.append(v & M32)
        c = v >> 32
    return r


def butterfly(lo, hi, w, do_scale, scale):
    """fr_ntt.cu:butterfly."""
    t_ = mont_mul(hi, w)
    hi = mod_sub(lo, t_)
    lo = mod_add(lo, t_)
    if do_scale:
        lo, hi = mont_mul(lo, scale), mont_mul(hi, scale)
    return lo, hi


def brev(idx: int, log_n: int) -> int:
    return int(f"{idx:032b}"[::-1], 2) >> (32 - log_n) if log_n else 0


def k10_model(x: np.ndarray, inverse: bool, local_log: int) -> np.ndarray:
    """zk_fr_ntt's launches: ntt_local over blocks of 2^L outputs (L =
    min(local_log, log_n)), then ntt_stage for each stage above L, the
    inverse's scale in the last stage."""
    n = x.shape[0]
    log_n = n.bit_length() - 1
    tw = fft.twiddles(log_n, inverse, torch.device("cpu")).numpy()
    W = [list(map(int, r)) for r in tw]
    scale = list(map(int, fft._n_inv(log_n)))
    L = min(local_log, log_n)
    chunk = 1 << L
    out = [None] * n
    for blk in range(n >> L):
        base = blk << L
        sh = []
        for i in range(chunk):
            v = list(map(int, x[brev(base + i, log_n)]))
            if L == 0 and inverse:
                v = mont_mul(v, scale)
            sh.append(v)
        for s in range(1, L + 1):
            half = 1 << (s - 1)
            for t_ in range(chunk // 2):
                j = t_ & (half - 1)
                lo = ((t_ >> (s - 1)) << s) + j
                sh[lo], sh[lo + half] = butterfly(sh[lo], sh[lo + half], W[j << (log_n - s)],
                                                  inverse and L == log_n and s == L, scale)
        out[base : base + chunk] = sh
    for s in range(L + 1, log_n + 1):
        half = 1 << (s - 1)
        for t_ in range(n // 2):
            j = t_ & (half - 1)
            lo = ((t_ >> (s - 1)) << s) + j
            out[lo], out[lo + half] = butterfly(out[lo], out[lo + half], W[j << (log_n - s)],
                                                inverse and s == log_n, scale)
    return np.array(out, dtype=np.uint32)


@pytest.mark.parametrize("n", [1, 2, 8, 16, 256])
@pytest.mark.parametrize("local_log", [1, 2, 10])
def test_k10_model_equals_jax(n, local_log):
    """The kernel's schedule, with its shared-memory stages cut at
    local_log (the kernel's LOCAL_LOG is 10), gives the JAX transforms."""
    for inverse in (False, True):
        got = k10_model(rec(f"ntt/x{n}"), inverse, local_log)
        assert np.array_equal(got, rec(f"ntt/{'inv' if inverse else 'fwd'}{n}")), (n, inverse)


def test_k10_model_on_reduction_edges():
    """Every input p - 1 or 0 and every twiddle: products and sums of
    field.cuh's words stay reduced (below p) where the chains carry most."""
    x = np.array(fr.from_ints([P - 1, 0, P - 1, 1, P - 2, P - 1, 0, P - 1]))
    for inverse in (False, True):
        got = k10_model(x, inverse, 2)
        assert all(_v(r) < P for r in got)
        assert np.array_equal(got, fft.ntt_plain(torch.from_numpy(x), 3, inverse).numpy())


def test_k10_model_mirrors_the_source():
    """The index arithmetic and launch parameters the model runs are the
    kernel's."""
    src = " ".join(SRC.split())
    for line in ("constexpr int LOCAL_LOG = 10;",
                 "const uint32_t src = log_n == 0 ? 0u : __brev(idx) >> (32 - log_n);",
                 "const int lo = ((t >> (s - 1)) << s) + j;",
                 "load(tw + ((size_t)j << (log_n - s)) * NL, w);",
                 "const bool do_scale = scale_last && s == L;",
                 "if (L == 0 && scale_last) mont_mul<FrSpec>(v, scale.w, v);",
                 "inverse && L == log_n, sc);",
                 "(uint32_t*)out, (const uint32_t*)tw, log_n, s, inverse && s == log_n, sc);",
                 "mont_mul<FrSpec>(hi, w, t); mod_sub<FrSpec>(lo, t, hi); mod_add<FrSpec>(lo, t, lo);"):
        assert line in src, line
    assert re.search(r"const long long lo = \(\(t >> \(s - 1\)\) << s\) \+ j;", src)


@pytest.mark.parametrize("log_n", [1, 2, 5, 12])
def test_ntt_bound_counts_the_products_the_transform_needs(log_n):
    """chip_smoke.py's K10 bound charges one Fr product to each butterfly
    whose twiddle w^j is not w^0 = 1, and n/2 more to the inverse, whose
    n^-1 is folded into the last stage (lo n^-1 +- hi (w n^-1))."""
    import chip_smoke

    n = 1 << log_n
    products = sum(n // (1 << s) for s in range(1, log_n + 1) for j in range(1 << (s - 1)) if j)
    for inverse in (False, True):
        ops = (products + (n // 2 if inverse else 0)) * chip_smoke.FR_MUL_IMAD
        want = max(32 * (2 * n + n // 2) / chip_smoke.HBM_BYTES_PER_S, ops / chip_smoke.IMAD_PER_S) * 1e3
        assert chip_smoke.ntt_bound(log_n, inverse)[0] == pytest.approx(want, rel=1e-12)
