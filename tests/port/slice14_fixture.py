"""The JAX package's arrays and outputs that ``record_slice14.py`` recorded
(the tower, NTT, windowed, cheap-softmax, (n, 8)-op, planar-op and native
cases), read once per process."""

from __future__ import annotations

import functools
import json
import pathlib

import numpy as np
import torch

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


@functools.lru_cache(maxsize=None)
def recorded() -> tuple[dict, dict]:
    with np.load(FIXTURES / "slice14_jax.npz") as z:
        keys = json.loads(bytes(z["__keys__"]).decode())
        arrays = {k: z[v] for k, v in keys.items()}
    return arrays, json.loads((FIXTURES / "slice14_jax.json").read_text())["recorded"]


def rec(key: str) -> np.ndarray:
    return recorded()[0][key]


def t(key: str) -> torch.Tensor:
    """A recorded array as a CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(rec(key)))


def meta(key: str):
    return recorded()[1][key]


def same(got: torch.Tensor, key: str) -> bool:
    want = rec(key)
    got = got.cpu().numpy()
    return got.shape == want.shape and np.array_equal(got, want)
