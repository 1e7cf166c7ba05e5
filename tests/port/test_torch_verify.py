"""The port's verifier (``MLP.verify``) against the JAX package's on the same
proofs: the 8-wide, 2-layer chained Fiat-Shamir proof of ``conftest.chained``
with one value tampered in each place a proof or statement can be changed,
verified with and without transcript replay; the layer verifiers; the
unchained SeededRng proof; and the committed-aux knobs (the tier itself is
held against the JAX package in test_torch_committed.py)."""

import copy
import dataclasses

import pytest
import torch

from port_helpers import jax_model, to_jax
from test_torch_chain import assert_same_arrays, proof_arrays
from zkdl_tpu.models import zkfc as jzkfc, zkrelu as jzkrelu
from zkdl_tpu.sumcheck.transcript import FiatShamir as JaxFiatShamir
from zkdl_tpu_torch import config
from zkdl_tpu_torch.commit import pedersen
from zkdl_tpu_torch.models import mlp, zkfc, zkrelu
from zkdl_tpu_torch.sumcheck import protocols as sc
from zkdl_tpu_torch.sumcheck.transcript import FiatShamir, SeededRng


def flip(t: torch.Tensor, idx) -> torch.Tensor:
    """A copy of the uint32 tensor t with the low bit of t[idx] flipped."""
    a = t.numpy().copy()
    a[idx] ^= 1
    return torch.from_numpy(a)


def tamper(case: str, model, proof, X, Y):
    """(model, proof, X, Y) with one value changed; the inputs stay intact."""
    proof = copy.deepcopy(proof)
    fc, relu = proof.fc_proofs, proof.relu_proofs
    if case == "fc ip_polys":
        fc[0].ip_polys = flip(fc[0].ip_polys, (0, 1, 0))
    elif case == "relu a_polys":
        relu[0].a_polys = flip(relu[0].a_polys, (1, 2, 3))
    elif case == "relu mag_polys":
        relu[0].mag_polys = flip(relu[0].mag_polys, (2, 0, 5))
    elif case == "relu x_at_va":
        relu[0].x_at_va = flip(relu[0].x_at_va, (0,))
    elif case == "relu a_point":
        relu[0].a_point = flip(relu[0].a_point, (0, 0))
    elif case == "opening round point":
        rp = fc[1].opening.round_points[0]
        fc[1].opening.round_points[0] = rp._replace(x=flip(rp.x, (1, 0)))
    elif case == "final_scalar":
        fc[-1].opening.final_scalar = flip(fc[-1].opening.final_scalar, (0,))
    elif case == "com_at_u_row":
        c = fc[0].opening.com_at_u_row
        fc[0].opening.com_at_u_row = c._replace(y=flip(c.y, (3,)))
    elif case == "row commitment":
        layers = list(model.layers)
        com = layers[1].com
        points = com.points._replace(x=flip(com.points.x, (2, 0)))
        layers[1] = dataclasses.replace(layers[1], com=pedersen.RowCommitments(points, com.dlogs))
        model = mlp.MLP(layers)
    elif case == "X":
        X = flip(X, (3, 0))
    elif case == "Y_hat":
        Y = flip(Y, (1, 0))
    elif case == "u_in":
        fc[0].u_in = flip(fc[0].u_in, (0, 0))
    else:
        assert case == "none", case
    return model, proof, X, Y


CASES = ["none", "fc ip_polys", "relu a_polys", "relu mag_polys", "relu x_at_va", "relu a_point",
         "opening round point", "final_scalar", "com_at_u_row", "row commitment", "X", "Y_hat", "u_in"]


@pytest.mark.parametrize("replay", [True, False], ids=["fiat-shamir", "no-replay"])
@pytest.mark.parametrize("case", CASES)
def test_port_verdict_equals_jax_verdict(chained, case, replay):
    model, proof, X, Y = tamper(case, chained.model, chained.proof, chained.X, chained.Y)
    got = model.verify(proof, X=X, Y_hat=Y, transcript=FiatShamir() if replay else None)
    want = jax_model(model).verify(to_jax(proof), X=to_jax(X), Y_hat=to_jax(Y),
                                   transcript=JaxFiatShamir() if replay else None)
    assert got == (bool(want[0]), want[1])
    assert got[0] == (case == "none"), got


def test_layer_verifiers_equal_jax(chained):
    """zkfc.verify on each layer's own commitments and on the other layer's
    (com(u_row) mismatch), zkrelu.verify and verify_chained."""
    layers, proof = chained.model.layers, chained.proof
    jlayers, jp = jax_model(chained.model).layers, to_jax(proof)
    for i, fc in enumerate(proof.fc_proofs):
        for j in range(len(layers)):
            got = zkfc.verify(layers[j].com, fc)
            assert got == jzkfc.verify(jlayers[j].com, jp.fc_proofs[i])
            assert got == ((True, "") if i == j else (False, "open: com(u_row) mismatch"))
    for i, rp in enumerate(proof.relu_proofs):
        assert zkrelu.verify(rp) == jzkrelu.verify(jp.relu_proofs[i]) == (True, "")
        a_claim = sc.scalars_to_ints(proof.fc_proofs[i + 1].ip_finals)[0]
        assert zkrelu.verify_chained(rp, a_claim) == jzkrelu.verify_chained(jp.relu_proofs[i], a_claim) == (True, "")


def test_unchained_proof_verdicts_equal_jax(chained):
    c = chained
    proof = c.model.prove(c.X, c.Y, c.Z, c.A, c.aux, SeededRng(7), chain=False)
    jm, jp = jax_model(c.model), to_jax(proof)
    assert c.model.verify(proof, Y_hat=c.Y) == (True, "")
    assert jm.verify(jp, Y_hat=to_jax(c.Y)) == (True, "")
    want = (False, "input anchor requires a chained proof")
    assert c.model.verify(proof, X=c.X, Y_hat=c.Y) == want
    assert jm.verify(jp, X=to_jax(c.X), Y_hat=to_jax(c.Y)) == want


def test_aux_coms_without_openings_rejected(chained, committed):
    """The committed-aux tier is ported: a proof that carries a ReLU's aux
    commitments without their openings never passes. Under replay both
    verifiers reject it where the absorbed commitments move the draws;
    without replay both raise on the missing openings."""
    c = chained
    proof = copy.deepcopy(c.proof)
    proof.relu_proofs[0].aux_coms = committed[False].relu_proofs[0].aux_coms
    jm, jp = jax_model(c.model), to_jax(proof)
    want = (False, "transcript: relu[0].u_z_bin not derived from the transcript")
    assert c.model.verify(proof, X=c.X, Y_hat=c.Y, transcript=FiatShamir()) == want
    assert jm.verify(jp, X=to_jax(c.X), Y_hat=to_jax(c.Y), transcript=JaxFiatShamir()) == want
    with pytest.raises(Exception):
        c.model.verify(proof, Y_hat=c.Y)
    with pytest.raises(Exception):
        jm.verify(jp, Y_hat=to_jax(c.Y))


def test_commit_aux_config_makes_prove_raise(chained, committed, monkeypatch):
    """config's commit_aux (ZKDL_COMMIT_AUX) is MLP.prove's default tier: an
    unchained prove then raises, as the JAX prover does, and a chained one
    is the committed proof."""
    c = chained
    monkeypatch.setattr(config, "_CONFIG", config.Config(commit_aux=True))
    with pytest.raises(ValueError, match="committed aux requires chained mode"):
        c.model.prove(c.X, c.Y, c.Z, c.A, c.aux, FiatShamir(), chain=False)
    proof = c.model.prove(c.X, c.Y, c.Z, c.A, c.aux, FiatShamir())
    assert_same_arrays(proof_arrays(proof), proof_arrays(committed[False]))
