"""The port reproduces the JAX package's golden proof (tests/fixtures/
golden_config1.npz) array for array: tests/test_golden_fixture.py's model
(2 layers of width 64, batch 1) proved with SeededRng(12345), unchained.

The generator dlogs come from the JAX package's threefry draws (setup parity
is a later slice); everything else - quantization, commitments, inference,
every sumcheck, the openings' G1 points - is the port's, on the CPU."""

import json
import pathlib

import jax
import numpy as np
import torch

from zkdl_tpu.tensor import fr_ops as jfr_ops
from zkdl_tpu_torch.commit import pedersen
from zkdl_tpu_torch.io.proof_io import flatten
from zkdl_tpu_torch.models import convert, quantize, zkfc
from zkdl_tpu_torch.sumcheck.transcript import SeededRng

FIXTURE = pathlib.Path(__file__).resolve().parents[1] / "fixtures" / "golden_config1.npz"


def test_port_proof_equals_golden_fixture():
    rng = np.random.default_rng(2024)
    dims = [64, 64, 64]
    weights = [(rng.standard_normal((dims[i], dims[i + 1])) * 0.4).astype(np.float32) for i in range(2)]
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    gen = zkfc.ZkFC.gen_size_for(64, 64)
    layers = []
    for i, w in enumerate(weights):
        raw = torch.from_numpy(np.array(jfr_ops.random_fr(keys[i], gen)))
        dlogs = pedersen.to_mont_rows(raw).numpy()
        layers.append((quantize.load_weights(w, "cpu").numpy(), dlogs, 64, 64))
    model = convert.mlp_from_arrays(layers, device="cpu")
    X = pedersen.to_mont_rows(quantize.load_input(rng.standard_normal((1, 64)).astype(np.float32), "cpu"))
    Y, Z, A, aux = model.infer(X)
    proof = model.prove(X, Y, Z, A, aux, SeededRng(12345), chain=False)

    got = {}
    flatten(proof, "p", got)
    want = np.load(FIXTURE, allow_pickle=False)
    keymap = json.loads(bytes(want["__skeleton__"]).decode())["keys"]
    assert sorted(got) == sorted(keymap)
    for path, key in keymap.items():
        assert got[path].dtype == want[key].dtype, path
        np.testing.assert_array_equal(got[path], want[key], err_msg=path)
