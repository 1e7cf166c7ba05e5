"""Counter-based key derivation: the ``jax.random`` threefry2x32 stream.

The JAX package draws every generator's discrete log from a ``jax.random``
key (``tensor/fr_ops.py:random_fr``, ``commit/pedersen.py:setup``,
``models/mlp.py:from_float_weights``). This module reproduces those draws
bit for bit, with JAX's defaults: the threefry2x32 implementation with
``jax_threefry_partitionable`` on, where the counter of element i of a draw
of any shape is i itself (its row-major flat index, as a 64-bit value split
into a high and a low word), and a 32-bit draw is the XOR of the two output
words.

A key is a ``(2,)`` uint32 numpy array, as ``jax.random.PRNGKey`` gives.
Everything runs in numpy uint32 on the host: a layer's setup draws at most
2048 x 8 words, so this is key derivation, not a hot operation; the drawn
values reach the device once.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 block cipher (20 rounds) of the counter pairs
    (x0, x1) under key, elementwise. Returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, dtype=np.uint32) + ks[0]
    x1 = np.asarray(x1, dtype=np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _counters(shape) -> tuple[np.ndarray, np.ndarray]:
    """(high, low) words of each element's 64-bit row-major flat index."""
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for 0 <= seed < 2^32: the key (0, seed)."""
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"PRNGKey: seed {seed} outside [0, 2^32)")
    return np.array([0, seed], dtype=np.uint32)


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """jax.random.split(key, n): (n, 2) uint32, key i enciphers counter i."""
    y0, y1 = threefry2x32(key, *_counters((n,)))
    return np.stack([y0, y1], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """jax.random.fold_in(key, data) for 0 <= data < 2^32: the key
    enciphers the counter pair (0, data)."""
    if not 0 <= data < 1 << 32:
        raise ValueError(f"fold_in: data {data} outside [0, 2^32)")
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return np.array([y0[0], y1[0]], dtype=np.uint32)


def bits(key: np.ndarray, shape) -> np.ndarray:
    """jax.random.bits(key, shape, dtype=uint32): uniform uint32 words."""
    shape = tuple(int(s) for s in shape)
    y0, y1 = threefry2x32(key, *_counters(shape))
    return y0 ^ y1
