"""The JAX package's verifier, with Fiat-Shamir transcript replay, accepts
the port's chained proof and rejects it with one limb flipped."""

import numpy as np
import pytest

from port_helpers import jax_model, to_jax
from zkdl_tpu.sumcheck.transcript import FiatShamir as JaxFiatShamir
from zkdl_tpu_torch.bench import make_weights
from zkdl_tpu_torch.commit import pedersen
from zkdl_tpu_torch.models import mlp, quantize
from zkdl_tpu_torch.sumcheck.transcript import FiatShamir


@pytest.fixture(scope="module")
def proved():
    dims, batch = [8, 8, 8], 2
    model = mlp.MLP.from_float_weights(make_weights(dims, np.random.default_rng(60)),
                                       np.random.default_rng(61), device="cpu")
    x = np.random.default_rng(62).standard_normal((batch, dims[0])).astype(np.float32)
    X = pedersen.to_mont_rows(quantize.load_input(x, "cpu"))
    Y, Z, A, aux = model.infer(X)
    proof = model.prove(X, Y, Z, A, aux, FiatShamir())
    return jax_model(model), proof, to_jax(X), to_jax(Y)


@pytest.mark.parametrize("where", [None, "fc", "relu"])
def test_jax_verifier_on_port_chained_proof(proved, where):
    jm, proof, X, Y = proved
    jp = to_jax(proof)
    if where == "fc":
        polys = np.asarray(jp.fc_proofs[0].ip_polys).copy()
        polys[0, 1, 0] ^= 1
        jp.fc_proofs[0].ip_polys = polys
    elif where == "relu":
        polys = np.asarray(jp.relu_proofs[0].a_polys).copy()
        polys[1, 2, 3] ^= 1
        jp.relu_proofs[0].a_polys = polys
    ok, msg = jm.verify(jp, X=X, Y_hat=Y, transcript=JaxFiatShamir())
    assert ok == (where is None), msg
