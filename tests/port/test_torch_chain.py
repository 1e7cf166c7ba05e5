"""Whole-proof parity of the port's chained Fiat-Shamir proof with the JAX
package's (the 8-wide, 2-layer ``chained`` fixture): both packages build the
model from the same weights and PRNGKey, with bit-equal generators and
commitments; the port's grouped proof equals the JAX prover's array for
array; the JAX verifier, with transcript replay, accepts the port's proof
and rejects it with one limb flipped."""

import numpy as np
import pytest

from port_helpers import jax_model, to_jax
from zkdl_tpu.sumcheck.transcript import FiatShamir as JaxFiatShamir
from zkdl_tpu_torch.io.proof_io import flatten


def proof_arrays(proof) -> dict:
    """{path in the proof tree: numpy array} of either package's proof."""
    out = {}
    flatten(proof, "p", out)
    return out


def assert_same_arrays(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def test_model_from_key_equals_jax_model(chained, jax_chained):
    """Generator dlogs and points, row-commitment dlogs and points, per
    layer; the input and the output."""
    want = jax_chained.arrays()
    got = {"X": chained.X, "Y": chained.Y}
    for i, layer in enumerate(chained.model.layers):
        for part in ("gens", "com"):
            obj = getattr(layer, part)
            got[f"{i}.{part}.dlogs"] = obj.dlogs
            for coord in ("x", "y", "z"):
                got[f"{i}.{part}.points.{coord}"] = getattr(obj.points, coord)
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)


def test_grouped_proof_equals_jax_prover(chained, jax_chained):
    assert_same_arrays(proof_arrays(chained.proof), proof_arrays(jax_chained.proof(interleave=False)))


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
