"""The port's batch inversion (K7's plain version and an integer model of
K7's schedule), logUp lookup, natural-order sumcheck provers and general
field matmul, held on the CPU against the JAX package's outputs recorded by
``record_attention.py`` (no JAX at run time)."""

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


def _k7_model(xs: list[int]) -> list[int]:
    """csrc/fr_inverse.cu's schedule on Montgomery ints: chunks of
    ceil(n / TARGET_CHUNKS) elements, runs of chunk products over THREADS
    threads, forward and backward block scans, one inverse of the total,
    and the walks back."""
    n, target, threads = len(xs), 2048, 256
    one = HF.one_mont
    chunk = -(-n // target)
    T = -(-n // chunk)
    pre = [0] * n
    tot = []
    for t in range(T):
        s, e = t * chunk, min(t * chunk + chunk, n)
        acc = xs[s]
        pre[s] = acc
        for i in range(s + 1, e):
            acc = HF.mul(acc, xs[i])
            pre[i] = acc
        tot.append(acc)
    per = -(-T // threads)
    lp, runs = [0] * T, []
    for j in range(threads):
        s, e = j * per, min(j * per + per, T)
        acc = one
        for t in range(s, e):
            acc = HF.mul(acc, tot[t])
            lp[t] = acc
        runs.append(acc)
    fwd, bwd = list(runs), list(runs)
    for j in range(1, threads):
        fwd[j] = HF.mul(fwd[j - 1], fwd[j])
    for j in range(threads - 2, -1, -1):
        bwd[j] = HF.mul(bwd[j], bwd[j + 1])
    inv_total = HF.inv(fwd[-1]) if fwd[-1] else 0  # the Fermat power: 0 for 0
    tinv = [0] * T
    for j in range(threads):
        s, e = j * per, min(j * per + per, T)
        il = inv_total
        if j + 1 < threads:
            il = HF.mul(il, bwd[j + 1])
        if j > 0:
            il = HF.mul(il, fwd[j - 1])
        for t in range(e - 1, s - 1, -1):
            tinv[t] = HF.mul(lp[t - 1], il) if t > s else il
            il = HF.mul(il, tot[t])
    out = [0] * n
    for t in range(T):
        s, e = t * chunk, min(t * chunk + chunk, n)
        il = tinv[t]
        for i in range(e - 1, s, -1):
            out[i] = HF.mul(pre[i - 1], il)
            il = HF.mul(il, xs[i])
        out[s] = il
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 257, 2049, 4096, 5000])
def test_k7_schedule_inverts(n):
    rng = np.random.default_rng(n)
    xs = [int.from_bytes(rng.bytes(32), "little") % (fr.P_INT - 1) + 1 for _ in range(n)]
    assert _k7_model(xs) == [HF.inv(x) for x in xs]
    xs[n // 2] = 0
    assert _k7_model(xs) == [0] * n


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
    """csrc/fr_inverse.cu hard-codes mont(1) and p - 2 (it cannot be
    compiled here): check them, and its chunk target, against the model."""
    import re

    from zkdl_tpu_torch.utils import build

    src = (build.CSRC / "fr_inverse.cu").read_text()

    def words(name):
        (body,) = re.findall(rf"{name}\[NL\] = \{{(.*?)\}};", src, re.S)
        return sum(int(v, 16) << (32 * i) for i, v in enumerate(re.findall(r"0x([0-9a-f]+)u", body)))

    assert words("ONE_MONT") == HF.one_mont
    assert words("P_MINUS_2") == fr.P_INT - 2
    assert re.search(r"TARGET_CHUNKS = 2048;", src) and re.search(r"THREADS = 256;", src)
