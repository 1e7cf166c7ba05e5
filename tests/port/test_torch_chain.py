"""The JAX package's verifier, with Fiat-Shamir transcript replay, accepts
the port's chained proof and rejects it with one limb flipped."""

import numpy as np
import pytest

from port_helpers import jax_model, to_jax
from zkdl_tpu.sumcheck.transcript import FiatShamir as JaxFiatShamir


@pytest.mark.parametrize("where", [None, "fc", "relu"])
def test_jax_verifier_on_port_chained_proof(chained, where):
    jm, X, Y = jax_model(chained.model), to_jax(chained.X), to_jax(chained.Y)
    jp = to_jax(chained.proof)
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
