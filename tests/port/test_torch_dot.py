"""K3 (the Fr dot): its plain versions against the JAX package, its launch
planner against the limits the kernel source states, and a word-level model
of the kernel's lazy product against exact integers."""

import re

import jax
import numpy as np
import pytest
import torch

from port_helpers import rand_planar
from zkdl_tpu.field import pallas_fr as jpf
from zkdl_tpu.field import planar as jplanar
from zkdl_tpu_torch.field import fr, kernels
from zkdl_tpu_torch.utils import build

SRC = (build.CSRC / "fr_kernels.cu").read_text()
M32 = (1 << 32) - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("ZKDL_PALLAS_INTERPRET", "1")


def test_dot_many_plain_matches_pallas_dot_many(interpret):
    """Four pairs of unequal lengths, and the first three of them.

    The reference is pallas_fr.dot_many's own computation, finalize_cols of
    the stacked dot_cols_raw accumulators of the zero-padded pairs, with the
    Pallas kernel vmapped over the pairs (one interpret-mode trace instead
    of one per pair). finalize_cols reduces each column on its own, so its
    first three columns are dot_many of the first three pairs."""
    lengths = (1, 64, 1000, 2048)
    pairs = [(rand_planar(40 + i, n), rand_planar(50 + i, n)) for i, n in enumerate(lengths)]
    stacked = [np.stack([np.pad(p[k], [(0, 0), (0, jpf.BLOCK - p[k].shape[1])]) for p in pairs]) for k in (0, 1)]
    want = np.asarray(jpf.finalize_cols(jax.vmap(jpf.dot_cols_raw)(*stacked)))
    tpairs = [(_t(a), _t(b)) for a, b in pairs]
    np.testing.assert_array_equal(kernels.dot_many_plain(tpairs).numpy(), want)
    np.testing.assert_array_equal(kernels.dot_many_plain(tpairs[:3]).numpy(), want[:, :3])


def test_dot_plain_all_p_minus_1_matches_planar_dot():
    """Every product at its largest, (p - 1)^2: the worst case of the lazy sums."""
    pm1 = np.ascontiguousarray(np.repeat(fr.from_int(fr.P_INT - 1)[:, None], 1 << 12, axis=1))
    want = np.asarray(jax.jit(jplanar.dot)(pm1, pm1))
    np.testing.assert_array_equal(kernels.dot_plain(_t(pm1), _t(pm1)).numpy(), want)


def test_kernel_source_matches_the_wrapper():
    """fr_kernels.cu's K3 constants: R^2 mod p, the accumulator's width and
    bound, the block and pair limits the planner and wrapper rely on."""
    r2 = re.search(r"R2\[8\] = \{(.*?)\};", SRC, re.S).group(1)
    assert [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", r2)] == [int(x) for x in fr.SPEC.R2_limbs]
    log_terms = _const("MAX_TERMS_LOG2")
    assert kernels.DOT_MAX_TERMS == 1 << log_terms
    # a thread's sum of DOT_MAX_TERMS products, each < p^2, fits ACC_WORDS words
    assert kernels.DOT_MAX_TERMS * (fr.P_INT - 1) ** 2 < 1 << (32 * _const("ACC_WORDS"))
    assert kernels.DOT_MAX_THREADS == _const("DOT_MAX_THREADS")
    assert kernels.DOT_MAX_PAIRS == _const("DOT_MAX_PAIRS")
    assert kernels.DOT_TARGET_BLOCKS == 132 * _const("DOT_BLOCKS_PER_SM")  # one resident wave


NS = sorted({1, 2, 3, 31, 33, 255, 256, 257, 1023, 2047, 4095, (1 << 20) + 37} | {1 << k for k in range(24)})


@pytest.mark.parametrize("slots", [1, 3, 4, 2048, 8192])
def test_plan_dot_stays_within_the_kernel_limits(slots):
    for n in NS:
        G, threads = kernels.plan_dot(n, slots)
        assert G >= 1 and 32 <= threads <= kernels.DOT_MAX_THREADS and threads % 32 == 0
        assert slots * G <= (kernels.DOT_SCRATCH_BLOCKS if G > 1 else (1 << 31) - 1)
        # the kernel's loop: two elements per step of G * threads, one odd tail
        terms = 2 * -(-n // (2 * G * threads)) + 1
        assert terms <= kernels.DOT_MAX_TERMS, (n, slots)
        assert G == 1 or slots * G <= kernels.DOT_TARGET_BLOCKS
        if n <= 32 * kernels.DOT_MIN_TERMS:
            assert (G, threads) == (1, 32), n  # short dots: one warp
    with pytest.raises(ValueError):
        kernels.plan_dot(-1, slots)


# ---------------------------------------------------------------------------
# word-level model of csrc/fr_kernels.cu:mul_acc (PTX add/mad carry semantics)
# ---------------------------------------------------------------------------


def _mad_row4(w, base, a4, b):
    """w[base .. base + 8] += sum_k a4[k] b 2^(64 k): mad.lo.cc / madc.hi.cc
    pairs, then addc into w[base + 8] (its carry out is dropped, as in PTX)."""
    c = 0
    for k, ak in enumerate(a4):
        p = ak * b
        for h, part in ((2 * k, p & M32), (2 * k + 1, p >> 32)):
            s = w[base + h] + part + c
            w[base + h], c = s & M32, s >> 32
    w[base + 8] = (w[base + 8] + c) & M32


def _int(words) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


def _mul_acc(a, b):
    """The E and O word arrays of one product a * b."""
    E, O = [0] * 17, [0] * 16
    ev, od = a[0::2], a[1::2]
    for r in range(0, 8, 2):
        _mad_row4(E, r, ev, b[r])
        _mad_row4(O, r + 1, od, b[r])
        _mad_row4(O, r + 1, ev, b[r + 1])
        _mad_row4(E, r + 2, od, b[r + 1])
    return E, O


@pytest.mark.parametrize("kind", ["all_ones", "p_minus_1", "random"])
def test_lazy_product_schedule_loses_no_carry(kind):
    """The even/odd row schedule of mul_acc computes a * b exactly, even for
    limbs of 2^32 - 1 (beyond canonical), and E's carry word past 2^512
    stays 0, as the kernel's carry argument says."""
    if kind == "all_ones":
        pairs = [([M32] * 8, [M32] * 8)]
    elif kind == "p_minus_1":
        pm1 = [int(x) for x in fr.from_int(fr.P_INT - 1)]
        pairs = [(pm1, pm1)]
    else:
        a, b = rand_planar(61, 32), rand_planar(62, 32)
        pairs = [([int(x) for x in a[:, e]], [int(x) for x in b[:, e]]) for e in range(32)]
    for a, b in pairs:
        E, O = _mul_acc(a, b)
        assert _int(E) + _int(O) == _int(a) * _int(b)
        assert E[16] == 0
