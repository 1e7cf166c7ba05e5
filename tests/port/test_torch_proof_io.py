"""Proof I/O of the port: the JAX package's npz schema, both ways.

The golden proof written by the JAX package loads into the port's classes
(its skeleton predates the optional ReLU fields) and the port's verifier
accepts it on the golden model; the port's file of a chained proof holds the
JAX package's paths, dtypes and values; dump -> load -> dump is the
identity; loading a JAX-written file imports nothing of JAX."""

import json
import pathlib
import subprocess
import sys

import numpy as np

from port_helpers import GOLDEN, golden_model, to_jax
from zkdl_tpu.io import proof_io as jproof_io
from zkdl_tpu_torch.io import proof_io
from zkdl_tpu_torch.models.mlp import MLPProof

ROOT = pathlib.Path(__file__).resolve().parents[2]


def npz_arrays(path) -> dict:
    """{path in the proof tree: array} of an npz written by dump_proof."""
    with np.load(path, allow_pickle=False) as z:
        keys = json.loads(bytes(z["__skeleton__"]).decode())["keys"]
        return {p: z[k] for p, k in keys.items()}


def assert_same_arrays(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for p in want:
        assert got[p].dtype == want[p].dtype, p
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)


def test_golden_npz_loads_and_verifies():
    model, X = golden_model()
    Y = model.infer(X)[0]
    proof = proof_io.load_proof(str(GOLDEN), device="cpu")
    assert isinstance(proof, MLPProof)
    assert proof.relu_proofs[0].a_polys is None  # a field the stale skeleton lacks
    assert model.verify(proof, Y_hat=Y) == (True, "")
    got = {}
    proof_io.flatten(proof, "p", got)
    assert_same_arrays(got, npz_arrays(GOLDEN))


def test_port_dump_equals_jax_dump(chained, tmp_path):
    proof_io.dump_proof(chained.proof, str(tmp_path / "port.npz"))
    jproof_io.dump_proof(to_jax(chained.proof), str(tmp_path / "jax.npz"))
    assert_same_arrays(npz_arrays(tmp_path / "port.npz"), npz_arrays(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)  # the same a{i} key map


def test_dump_load_dump_is_identity(chained, tmp_path):
    first, second = str(tmp_path / "first.npz"), str(tmp_path / "second.npz")
    proof_io.dump_proof(chained.proof, first)
    proof_io.dump_proof(proof_io.load_proof(first, device="cpu"), second)
    assert_same_arrays(npz_arrays(second), npz_arrays(first))
    with np.load(first) as a, np.load(second) as b:
        assert bytes(a["__skeleton__"]) == bytes(b["__skeleton__"])


LOAD_WITHOUT_JAX = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "zkdl_tpu"):
            raise ImportError(f"forbidden import: {name}")
        return None

for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "zkdl_tpu")]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())
from zkdl_tpu_torch.io import proof_io
proof = proof_io.load_proof(sys.argv[1], device="cpu")
print(type(proof).__module__, len(proof.fc_proofs))
"""


def test_loading_a_jax_file_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", LOAD_WITHOUT_JAX, str(GOLDEN)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["zkdl_tpu_torch.models.mlp", "2"]
