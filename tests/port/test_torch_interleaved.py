"""Round-interleaved Fiat-Shamir in the port against the JAX package, on
the 8-wide, 2-layer ``chained`` fixture: the port's interleaved proof equals
the JAX prover's array for array; each package's verifier accepts the
other's proof; single-fault tampered copies get the JAX verifier's verdict
and reason; the proof round-trips through both packages' proof files; the
split round kernels give the grouped rounds' polynomials."""

import copy

import chip_smoke
import numpy as np
import pytest
import torch

from port_helpers import jax_model, rand_planar, to_jax
from test_torch_chain import assert_same_arrays, proof_arrays
from zkdl_tpu.io import proof_io as jproof_io
from zkdl_tpu.sumcheck.transcript import FiatShamir as JaxFiatShamir
from zkdl_tpu_torch.io import proof_io
from zkdl_tpu_torch.sumcheck import planar_protocols as pp
from zkdl_tpu_torch.sumcheck.transcript import FiatShamir, Replay


def flip(t: torch.Tensor, idx) -> torch.Tensor:
    a = t.numpy().copy()
    a[idx] ^= 1
    return torch.from_numpy(a)


def test_interleaved_proof_equals_jax_prover(chained_interleaved, jax_chained):
    assert_same_arrays(proof_arrays(chained_interleaved), proof_arrays(jax_chained.proof(interleave=True)))


def test_interleaved_stream_differs_from_grouped(chained, chained_interleaved):
    assert not np.array_equal(chained.proof.relu_proofs[0].v_z_bin.numpy(),
                              chained_interleaved.relu_proofs[0].v_z_bin.numpy())


def test_verifiers_accept_each_others_interleaved_proofs(chained, chained_interleaved, jax_chained, tmp_path):
    c = chained
    jm = jax_model(c.model)
    assert jm.verify(to_jax(chained_interleaved), X=to_jax(c.X), Y_hat=to_jax(c.Y),
                     transcript=JaxFiatShamir(), interleaved=True) == (True, "")
    jproof_io.dump_proof(jax_chained.proof(interleave=True), str(tmp_path / "jax.npz"))
    moved = proof_io.load_proof(str(tmp_path / "jax.npz"), device="cpu")
    assert c.model.verify(moved, X=c.X, Y_hat=c.Y, transcript=FiatShamir(), interleaved=True) == (True, "")


def test_unchained_interleaved_proof_equals_jax(chained, jax_chained):
    """chain=False with the interleaved schedule: u_recover is drawn (no
    A-product sumcheck) and X(u_recover) is still stored and absorbed. The
    port's proof equals the JAX prover's; both verifiers replay it to the
    end and refuse it only for the input anchor, which needs a chained
    proof; a tampered u_recover fails both replays with the same reason."""
    c = chained
    proof = c.model.prove(c.X, c.Y, c.Z, c.A, c.aux, FiatShamir(), chain=False, interleave=True)
    assert proof.relu_proofs[0].a_polys is None and proof.relu_proofs[0].x_at_va is not None
    assert_same_arrays(proof_arrays(proof), proof_arrays(jax_chained.proof(interleave=True, chain=False)))
    jm = jax_model(c.model)
    tampered = copy.deepcopy(proof)
    tampered.relu_proofs[0].u_recover = flip(tampered.relu_proofs[0].u_recover, (1, 2))
    for p, reason in ((proof, "input anchor requires a chained proof"),
                      (tampered, "transcript: relu[0].u_recover not derived from the transcript")):
        want = jm.verify(to_jax(p), X=to_jax(c.X), Y_hat=to_jax(c.Y), transcript=JaxFiatShamir(), interleaved=True)
        assert (bool(want[0]), want[1]) == (False, reason)
        assert c.model.verify(p, X=c.X, Y_hat=c.Y, transcript=FiatShamir(), interleaved=True) == (False, reason)


def tamper(case: str, proof, Y):
    proof = copy.deepcopy(proof)
    fc, relu = proof.fc_proofs, proof.relu_proofs
    if case == "fc ip_polys":
        fc[0].ip_polys = flip(fc[0].ip_polys, (1, 0, 2))
    elif case == "fc z_claim":
        fc[1].z_claim = flip(fc[1].z_claim, (0,))
    elif case == "relu mag_polys":
        relu[0].mag_polys = flip(relu[0].mag_polys, (0, 0, 0))
    elif case == "relu rem_polys":
        relu[0].rem_polys = flip(relu[0].rem_polys, (3, 1, 4))
    elif case == "relu a_polys":
        relu[0].a_polys = flip(relu[0].a_polys, (1, 2, 3))
    elif case == "relu hp_polys":
        relu[0].hp_polys = flip(relu[0].hp_polys, (2, 1, 0))
    elif case == "relu mag_bits_at_u":
        relu[0].mag_bits_at_u = flip(relu[0].mag_bits_at_u, (4, 0))
    elif case == "relu x_at_va":
        relu[0].x_at_va = flip(relu[0].x_at_va, (0,))
    elif case == "relu x_at_va missing":
        relu[0].x_at_va = None
    elif case == "u_in":
        fc[0].u_in = flip(fc[0].u_in, (0, 0))
    elif case == "final_scalar":
        fc[-1].opening.final_scalar = flip(fc[-1].opening.final_scalar, (0,))
    elif case == "Y_hat":
        Y = flip(Y, (1, 0))
    else:
        assert case == "none", case
    return proof, Y


CASES = ["none", "fc ip_polys", "fc z_claim", "relu mag_polys", "relu rem_polys", "relu a_polys",
         "relu hp_polys", "relu mag_bits_at_u", "relu x_at_va", "relu x_at_va missing", "u_in",
         "final_scalar", "Y_hat"]


# A missing x_at_va is caught by the replay alone: without it the JAX
# verifier's chain check dereferences the field.
PAIRS = [(case, replay) for case in CASES for replay in (True, False)
         if replay or case != "relu x_at_va missing"]


@pytest.mark.parametrize("case,replay", PAIRS,
                         ids=[f"{c}-{'fiat-shamir' if r else 'no-replay'}" for c, r in PAIRS])
def test_tampered_interleaved_verdict_equals_jax(chained, chained_interleaved, case, replay):
    c = chained
    proof, Y = tamper(case, chained_interleaved, c.Y)
    got = c.model.verify(proof, X=c.X, Y_hat=Y, transcript=FiatShamir() if replay else None, interleaved=True)
    want = jax_model(c.model).verify(to_jax(proof), X=to_jax(c.X), Y_hat=to_jax(Y),
                                     transcript=JaxFiatShamir() if replay else None, interleaved=True)
    assert got == (bool(want[0]), want[1])
    assert got[0] == (case == "none"), got


@pytest.mark.parametrize("fault", chip_smoke.INTERLEAVED_FAULTS, ids=lambda f: f"{f[0]}[{f[1]}].{f[2]}")
def test_chip_smoke_faults_get_the_jax_reason(chained, chained_interleaved, fault):
    """The faults that chip_smoke.py injects into zkdl256's interleaved proof
    on the card (no JAX there), with the reasons it requires: the JAX
    verifier's, here."""
    kind, i, field, idx, reason = fault
    c = chained
    proof = copy.deepcopy(chained_interleaved)
    p = getattr(proof, kind)[i]
    setattr(p, field, flip(getattr(p, field), idx))
    want = jax_model(c.model).verify(to_jax(proof), X=to_jax(c.X), Y_hat=to_jax(c.Y),
                                     transcript=JaxFiatShamir(), interleaved=True)
    assert (bool(want[0]), want[1]) == (False, reason)
    assert c.model.verify(proof, X=c.X, Y_hat=c.Y, transcript=FiatShamir(), interleaved=True) == (False, reason)


def test_interleaved_proof_round_trips_both_ways(chained_interleaved, jax_chained, tmp_path):
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    proof_io.dump_proof(chained_interleaved, port_file)
    assert_same_arrays(proof_arrays(jproof_io.load_proof(port_file)), proof_arrays(chained_interleaved))
    jproof = jax_chained.proof(interleave=True)
    jproof_io.dump_proof(jproof, jax_file)
    loaded = proof_io.load_proof(jax_file, device="cpu")
    assert loaded.relu_proofs[0].x_at_va is not None
    assert_same_arrays(proof_arrays(loaded), proof_arrays(jproof))


@pytest.mark.parametrize("n", [2, 16])
def test_interleaved_rounds_equal_grouped_rounds_on_the_same_challenges(n):
    """With the fold challenges the interleaved transcript drew replayed up
    front, the grouped provers emit the same polynomials and finals."""
    r = n.bit_length() - 1
    a, b = torch.from_numpy(rand_planar(90, n)), torch.from_numpy(rand_planar(91, n))
    bits = torch.from_numpy(np.random.default_rng(92).integers(0, 2, n).astype(bool))
    u = torch.from_numpy(rand_planar(93, r).T.copy())
    polys, finals, x = pp.inner_product_prove_interleaved(a, b, FiatShamir())
    want = pp.inner_product_prove(a, b, x)
    assert torch.equal(polys, want[0]) and torch.equal(finals, want[1])
    polys, final, v = pp.binary_prove_bits_interleaved(bits, u, FiatShamir(b"bin"))
    want = pp.binary_prove_bits(bits, u, Replay([v]).random_vec(r))
    assert torch.equal(polys, want[0]) and torch.equal(final, want[1])
    polys, finals, v = pp.hadamard_prove_bits_interleaved(a, bits, u, FiatShamir(b"hp"))
    want = pp.hadamard_prove_bits(a, bits, u, v)
    assert torch.equal(polys, want[0]) and torch.equal(finals, want[1])
