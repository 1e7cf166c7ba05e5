"""The JAX package's arrays and verdicts that ``record_slice11.py`` recorded,
read once per process."""

from __future__ import annotations

import functools
import json
import pathlib

import numpy as np

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


@functools.lru_cache(maxsize=None)
def recorded() -> tuple[dict, dict]:
    with np.load(FIXTURES / "slice11_jax.npz") as z:
        keys = json.loads(bytes(z["__keys__"]).decode())
        arrays = {k: z[v] for k, v in keys.items()}
    return arrays, json.loads((FIXTURES / "slice11_jax.json").read_text())


def rec(key: str) -> np.ndarray:
    return recorded()[0][key]


def verdict(name: str) -> tuple[bool, str]:
    ok, msg = recorded()[1]["verdicts"][name]
    return bool(ok), msg


def proof_arrays(prefix: str) -> dict:
    """The recorded proof under prefix: {path: array} as proof_io flattens it."""
    return {k[len(prefix) + 1:]: v for k, v in recorded()[0].items()
            if k.startswith(prefix + ":") and not k.endswith("__skeleton__")}
