"""The port's key derivation (``utils/prng.py``) and keyed draws against
``jax.random`` and the JAX package: PRNGKey, split, fold_in and bits on
several keys and shapes, random_fr/random_int, and the dlogs of the
auxiliary generators. No G1 compile: only the drawn Fr values are
compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zkdl_tpu.field import fr as jfr
from zkdl_tpu.tensor import fr_ops as jfr_ops
from zkdl_tpu_torch.commit import pedersen
from zkdl_tpu_torch.tensor import fr_ops
from zkdl_tpu_torch.utils import prng

SEEDS = [0, 1, 61, 0x5A6B, 0xFFFFFFFF]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(key))
    for n in (1, 2, 3, 8, 2048):
        np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), n), np.asarray(jax.random.split(key, n)))
    for data in (0, 1, 7, 1024, 2048, 1 << 20, 0xFFFFFFFF):
        np.testing.assert_array_equal(prng.fold_in(prng.PRNGKey(seed), data),
                                      np.asarray(jax.random.fold_in(key, data)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (16,), (1025,), (1, 8), (5, 8), (64, 8), (2048, 8)])
def test_bits_equal_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.bits(key, shape, dtype=jnp.uint32))
    np.testing.assert_array_equal(prng.bits(prng.PRNGKey(seed), shape), want)
    sub = jax.random.split(key, 3)[2]  # a derived key, both words nonzero
    np.testing.assert_array_equal(prng.bits(prng.split(prng.PRNGKey(seed), 3)[2], shape),
                                  np.asarray(jax.random.bits(sub, shape, dtype=jnp.uint32)))


def test_layer_keys_of_the_zkdl256_build_draw_jax_generators():
    """The 8 layer keys of split(PRNGKey(0), 8) at n = 2048 (bench.py's
    zkdl256 build) and aux_generators' fold_in(PRNGKey(0x5A6B), size)."""
    keys = prng.split(prng.PRNGKey(0), 8)
    jkeys = jax.random.split(jax.random.PRNGKey(0), 8)
    np.testing.assert_array_equal(keys, np.asarray(jkeys))
    for k, jk in zip(keys, jkeys):
        np.testing.assert_array_equal(fr_ops.random_fr(k, 2048, "cpu").numpy(), np.asarray(jfr_ops.random_fr(jk, 2048)))
    for size in (8, 64, 2048):
        np.testing.assert_array_equal(prng.fold_in(prng.PRNGKey(0x5A6B), size),
                                      np.asarray(jax.random.fold_in(jax.random.PRNGKey(0x5A6B), size)))


@pytest.mark.parametrize("seed,n", [(0, 1), (3, 7), (61, 64), (0x5A6B, 1000)])
def test_random_fr_equals_jax(seed, n):
    got = fr_ops.random_fr(prng.PRNGKey(seed), n, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfr_ops.random_fr(jax.random.PRNGKey(seed), n)))


@pytest.mark.parametrize("seed,n,num_bits", [(0, 1, 8), (5, 33, 16), (61, 256, 1), (9, 100, 31)])
def test_random_int_equals_jax(seed, n, num_bits):
    got = fr_ops.random_int(prng.PRNGKey(seed), n, num_bits, "cpu")
    want = jfr_ops.random_int(jax.random.PRNGKey(seed), n, num_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size", [4, 16])
def test_aux_generators_dlogs_equal_jax(size):
    key = jax.random.fold_in(jax.random.PRNGKey(0x5A6B), size)
    want = jfr.mont(jfr_ops.random_fr(key, size))
    gens = pedersen.aux_generators(size, "cpu")
    np.testing.assert_array_equal(gens.dlogs.numpy(), np.asarray(want))


def test_key_ranges_are_checked():
    with pytest.raises(ValueError):
        prng.PRNGKey(-1)
    with pytest.raises(ValueError):
        prng.fold_in(prng.PRNGKey(0), 1 << 32)
