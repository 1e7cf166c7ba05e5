"""Shared inputs of the attention tests: the JAX recorder's fixture
(``record_attention.py``), proof trees as flattened arrays, the recorder's
tampers and tests/test_attention.py's tiny block on the CPU. Imports
nothing of JAX."""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from zkdl_tpu_torch.commit import pedersen
from zkdl_tpu_torch.models import quantize
from zkdl_tpu_torch.utils import prng


ATTENTION_FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "attention_jax"


def attention_fixture() -> tuple[dict, dict]:
    """The JAX recorder's arrays (tests/port/record_attention.py) and its
    JSON (tamper list, verdicts), loaded once per process."""
    global _ATTENTION
    if _ATTENTION is None:
        import json

        with np.load(str(ATTENTION_FIXTURE) + ".npz") as z:
            keys = json.loads(bytes(z["__keys__"]).decode())
            arrays = {k: z[v] for k, v in keys.items()}
        meta = json.loads(pathlib.Path(str(ATTENTION_FIXTURE) + ".json").read_text())
        _ATTENTION = (arrays, meta)
    return _ATTENTION


_ATTENTION = None


def recorded_proof(prefix: str) -> dict:
    """The recorded proof `prefix` as {flattened path: array}."""
    arrays, _ = attention_fixture()
    out = {k[len(prefix) + 1 :]: v for k, v in arrays.items() if k.startswith(prefix + ":")}
    out.pop("__skeleton__", None)
    return out


def flat_arrays(proof) -> dict:
    """A port proof tree as {flattened path: numpy array} (proof_io's names)."""
    from zkdl_tpu_torch.io import proof_io

    arrays: dict = {}
    proof_io.flatten(proof, "p", arrays)
    return arrays


def assert_same_arrays(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want))[:10])
    bad = [k for k in want if got[k].shape != want[k].shape or not np.array_equal(got[k], want[k])]
    assert not bad, (what, bad[:10])


def tampered_copy(proof, path, index):
    """The proof with the word at `index` of its array `path` plus one
    (uint32, wrapping), as the JAX recorder tampers."""
    from zkdl_tpu_torch.io import proof_io

    arrays: dict = {}
    skel = proof_io.flatten(proof, "p", arrays)
    arrays = {k: np.array(v) for k, v in arrays.items()}
    if path is not None:
        arrays[path][tuple(index)] += np.uint32(1)
    return proof_io._unflatten(skel, arrays, torch.device("cpu"))


def tiny_attention():
    """tests/test_attention.py's block on the CPU: seq 4, d 8, weights and
    input from default_rng(0), generators from PRNGKey(0)."""
    from zkdl_tpu_torch.models import zkattention

    rng = np.random.default_rng(0)
    ws = [(rng.standard_normal((8, 8)) * 0.3).astype(np.float32) for _ in range(4)]
    attn = zkattention.ZkAttention.from_float(4, *ws, prng.PRNGKey(0), "cpu")
    X = pedersen.to_mont_rows(quantize.load_input(rng.standard_normal((4, 8)).astype(np.float32), "cpu"))
    return attn, X
