"""The JAX package's arrays and verdicts that ``record_slice13.py`` recorded,
read once per process, and the 8-wide model they were recorded on, built by
the port."""

from __future__ import annotations

import functools
import json
import pathlib

import numpy as np
import torch

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
NPZ = FIXTURES / "slice13_jax.npz"


@functools.lru_cache(maxsize=None)
def recorded() -> tuple[dict, dict]:
    with np.load(NPZ) as z:
        keys = json.loads(bytes(z["__keys__"]).decode())
        arrays = {k: z[v] for k, v in keys.items()}
    return arrays, json.loads((FIXTURES / "slice13_jax.json").read_text())


def rec(key: str) -> np.ndarray:
    return recorded()[0][key]


def t(key: str) -> torch.Tensor:
    """A recorded array as a CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(rec(key)))


def verdict(name: str) -> tuple[bool, str]:
    ok, msg = recorded()[1]["verdicts"][name]
    return bool(ok), msg


def proof_arrays(prefix: str) -> dict:
    """The recorded proof under prefix: {path: array} as proof_io flattens it."""
    return {k[len(prefix) + 1:]: v for k, v in recorded()[0].items()
            if k.startswith(prefix + ":") and not k.endswith("__skeleton__")}


def tiny_model():
    """tests/test_sharded_model.py:tiny on the CPU, built by the port:
    (model, X), generators from PRNGKey(0)."""
    from zkdl_tpu_torch.commit import pedersen
    from zkdl_tpu_torch.models import mlp, quantize
    from zkdl_tpu_torch.utils import prng

    rng = np.random.default_rng(11)
    dims = [8, 8, 8]
    weights = [(rng.standard_normal((dims[i], dims[i + 1])) * 0.4).astype(np.float32)
               for i in range(len(dims) - 1)]
    model = mlp.MLP.from_float_weights(weights, prng.PRNGKey(0), device="cpu")
    X = pedersen.to_mont_rows(quantize.load_input(rng.standard_normal((8, dims[0])).astype(np.float32), "cpu"))
    return model, X


def flat(proof) -> dict:
    """{path: array} of a port proof, as proof_io flattens it."""
    from zkdl_tpu_torch.io import proof_io

    out: dict = {}
    proof_io.flatten(proof, "p", out)
    return {k: np.asarray(v) for k, v in out.items()}


def differing(got: dict, want: dict) -> list:
    """The keys where two flattened proofs differ, or that one lacks."""
    return sorted(k for k in set(got) | set(want)
                  if k not in got or k not in want or not np.array_equal(got[k], want[k]))
