"""The port reproduces the JAX package's golden proof (tests/fixtures/
golden_config1.npz) array for array: tests/test_golden_fixture.py's model
(2 layers of width 64, batch 1, ``port_helpers.golden_model``) proved with
SeededRng(12345), unchained, on the CPU."""

import json

import numpy as np

from port_helpers import GOLDEN, golden_model
from zkdl_tpu_torch.io.proof_io import flatten
from zkdl_tpu_torch.sumcheck.transcript import SeededRng


def test_port_proof_equals_golden_fixture():
    model, X = golden_model()
    Y, Z, A, aux = model.infer(X)
    proof = model.prove(X, Y, Z, A, aux, SeededRng(12345), chain=False)

    got = {}
    flatten(proof, "p", got)
    want = np.load(GOLDEN, allow_pickle=False)
    keymap = json.loads(bytes(want["__skeleton__"]).decode())["keys"]
    assert sorted(got) == sorted(keymap)
    for path, key in keymap.items():
        assert got[path].dtype == want[key].dtype, path
        np.testing.assert_array_equal(got[path], want[key], err_msg=path)
