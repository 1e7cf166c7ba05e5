"""K9's plain version (the canonical cross-rank Fr sum, B17) against the
JAX package's psum_fr and reduce_mod_p (tests/port/fixtures/slice13_jax.npz),
a word-level model of csrc/fr_collect.cu, and the collectives on four gloo
ranks against one rank's sum; the launcher's failure and device rules."""

import numpy as np
import pytest
import torch

import sharded_runs
import slice13_fixture as fx
from zkdl_tpu_torch.field import fr, kernels, mp
from zkdl_tpu_torch.parallel import collectives, multihost

P = fr.P_INT
M32 = (1 << 32) - 1


def limb_sums(values: np.ndarray) -> torch.Tensor:
    """(n, k, 8) per-rank canonical values -> (k, 8) int64 limb sums, as
    the all-reduce of their limbs gives them."""
    return torch.from_numpy(values.astype(np.int64).sum(0))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_collect_plain_equals_psum_fr(n):
    got = kernels.collect(limb_sums(fx.rec(f"collect/values{n}")))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), fx.rec(f"collect/psum{n}"))


def test_reduce_mod_p_edges():
    got = collectives.reduce_mod_p(fx.t("collect/limbs9"))
    np.testing.assert_array_equal(got.numpy(), fx.rec("collect/reduced"))


def k9_words(sums: list[int]) -> list[int]:
    """csrc/fr_collect.cu:fr_collect_kernel word for word on one value: the
    eight limb sums carried into nine 32-bit words, then for j = 7 ... 0 the
    nine-word subtraction of p 2^j (word k: p_k << j | p_(k-1) >> (32 - j)),
    kept where no borrow is left."""
    w, carry = [], 0
    for k in range(8):
        v = sums[k] + carry
        w.append(v & M32)
        carry = v >> 32
    w.append(carry & M32)
    p = [int(x) for x in mp.limbs_from_int(P, 8)]
    for j in range(7, -1, -1):
        d, borrow = [], 0
        for k in range(9):
            lo = (p[k] << j) & M32 if k < 8 else 0
            hi = 0 if j == 0 or k == 0 else p[k - 1] >> (32 - j)
            s = w[k] - (lo | hi) - borrow
            d.append(s & M32)
            borrow = 1 if s < 0 else 0
        if not borrow:
            w = d
    return w[:8]


def _edge_sums() -> np.ndarray:
    """Limb sums of n copies of p - 1 (n up to 255, K9's limit), of zeros,
    of R mod p, and of random canonical values over 3, 17 and 200 ranks."""
    rng = np.random.default_rng(5)
    rows = []
    for n in (1, 2, 3, 4, 8, 128, 255):
        rows.append(mp.limbs_from_int(P - 1, 8).astype(np.int64) * n)
    rows.append(np.zeros(8, np.int64))
    rows.append(fr.ONE_MONT.astype(np.int64) * 200)
    for n in (3, 17, 200):
        vals = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
        vals[:, 7] %= np.uint64(fr.P_TOP_LIMB)
        rows.append(vals.astype(np.int64).sum(0))
    return np.stack(rows)


@pytest.mark.parametrize("row", range(12))
def test_k9_word_model(row):
    sums = _edge_sums()[row]
    want = kernels.collect(torch.from_numpy(sums[None].copy()))[0].numpy()
    assert k9_words([int(x) for x in sums]) == [int(x) for x in want]
    total = sum(int(x) << (32 * k) for k, x in enumerate(sums))
    assert mp.int_from_limbs(want) == total % P


def test_collect_rejects_other_inputs():
    with pytest.raises(ValueError):
        kernels.collect(torch.zeros((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.collect(torch.zeros((2, 9), dtype=torch.int64))


def test_psum_over_four_gloo_ranks(shared_tmp):
    """fr_sum_local_then_psum of four ranks' blocks equals one rank's
    fr_sum of the whole; psum_fr of the recorded values equals the JAX
    psum_fr; the same on every rank; the plain version counts no launch."""
    d = sharded_runs.run_dir(shared_tmp, 4)
    outs = sharded_runs.kernel_outputs(d, 4)
    np.testing.assert_array_equal(outs[0]["fr_sum"], outs[0]["fr_sum_whole"])
    np.testing.assert_array_equal(outs[0]["psum"], fx.rec("collect/psum4"))
    for o in outs[1:]:
        for k in ("fr_sum", "psum"):
            np.testing.assert_array_equal(o[k], outs[0][k])
    assert all(int(o["_collect_launches"][0]) == 0 for o in outs)


def test_failing_rank_fails_the_launch(tmp_path):
    """A rank that raises while the other waits in a collective: the
    launch kills both and raises, well inside its deadline."""
    import time

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1"):
        multihost.launch(f"{sharded_runs.RANK_SCRIPT}:fail", 2, "gloo", "cpu", timeout_s=120,
                         workdir=str(tmp_path))
    assert time.perf_counter() - t0 < 120


@pytest.mark.parametrize("device, backend, world, error", [
    ("cpu", "nccl", 2, ValueError),
    ("cuda", "gloo", 2, RuntimeError),
    ("cuda:0", "nccl", 2, RuntimeError),
    ("mps", "gloo", 2, ValueError),
])
def test_rank_device_rules(device, backend, world, error):
    """NCCL on the CPU, a card where there is none, another device: each
    raises before any process group is made (this host has no card)."""
    with pytest.raises(error):
        multihost._pick_device(device, 0, world, backend)
