"""The port's attention block on the CPU against the JAX package's, at
tests/test_attention.py's tiny size (seq 4, d 8): the build, every tensor of
the forward trace, the softmax witness, zkRescale's forward and proof, and
the opaque-generator commitments. The JAX side is the arrays that
``record_attention.py`` recorded (no JAX at run time); the proofs of the
whole block are in ``test_torch_zkattention.py``."""

import numpy as np
import pytest
import torch

from attention_helpers import assert_same_arrays, attention_fixture, flat_arrays, tiny_attention
from zkdl_tpu_torch.commit import pedersen
from zkdl_tpu_torch.field import mp
from zkdl_tpu_torch.models import zkrescale, zksoftmax
from zkdl_tpu_torch.sumcheck.transcript import FiatShamir

TRACE = ["X", "Q_raw", "Q", "K_raw", "K", "V_raw", "V", "Kt", "S_raw", "S", "P", "O_raw", "O", "Y_raw", "Y"]
AUX = [f"{t}_aux" for t in ("q", "k", "v", "s", "o", "y")]
WITNESS = ["h", "t", "rem8", "d_full", "d", "e", "E", "P", "r", "slack", "smax", "P_mont"]


def rec(key):
    return attention_fixture()[0][key]


@pytest.fixture(scope="module")
def block():
    attn, X = tiny_attention()
    Y, tr = attn.forward(X)
    return attn, X, Y, tr


def test_build_matches_jax(block):
    attn = block[0]
    for nm in ("wq", "wk", "wv", "wo"):
        fc = getattr(attn, nm)
        np.testing.assert_array_equal(fc.weights.numpy(), rec(f"model/{nm}/weights"))
        np.testing.assert_array_equal(fc.gens.dlogs.numpy(), rec(f"model/{nm}/gens_dlogs"))
        np.testing.assert_array_equal(fc.com.dlogs.numpy(), rec(f"model/{nm}/com_dlogs"))
        for c in "xyz":
            np.testing.assert_array_equal(getattr(fc.gens.points, c).numpy(), rec(f"model/{nm}/gens_{c}"))
            np.testing.assert_array_equal(getattr(fc.com.points, c).numpy(), rec(f"model/{nm}/com_{c}"))


@pytest.mark.parametrize("name", TRACE)
def test_forward_tensor_matches_jax(block, name):
    np.testing.assert_array_equal(block[3][name].numpy(), rec(f"trace/{name}"))


@pytest.mark.parametrize("name", AUX)
def test_forward_aux_matches_jax(block, name):
    sign, mag_bin, rem_bin = zkrescale.expand_aux(block[3][name])
    for key, got in (("sign", sign), ("mag_bin", mag_bin), ("rem_bin", rem_bin)):
        np.testing.assert_array_equal(got.numpy(), rec(f"trace/{name}/{key}"))


def test_forward_softmax_values_match_jax(block):
    tr = block[3]
    np.testing.assert_array_equal(tr["P_raw_vals"], rec("trace/P_raw_vals"))
    for key in WITNESS:
        got = tr["sm_wit"][key]
        np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got, rec(f"trace/sm_wit/{key}"))


def test_softmax_witness_matches_jax():
    wit = zksoftmax.softmax_witness(torch.from_numpy(rec("trace/S")), 4, 4, 8)
    for key in WITNESS:
        got = wit[key]
        np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got, rec(f"trace/sm_wit/{key}"))


def test_rescale_forward_matches_jax():
    Z, aux = zkrescale.forward(torch.from_numpy(rec("rescale/X")))
    np.testing.assert_array_equal(Z.numpy(), rec("rescale/Z"))
    for key, got in zip(("sign", "mag_bin", "rem_bin"), zkrescale.expand_aux(aux)):
        np.testing.assert_array_equal(got.numpy(), rec(f"rescale/{key}"))


def test_rescale_proof_matches_jax():
    X = torch.from_numpy(rec("rescale/X"))
    _, aux = zkrescale.forward(X)
    proof = zkrescale.prove(X, aux, FiatShamir())
    want = {k[len("rescale:"):]: v for k, v in attention_fixture()[0].items()
            if k.startswith("rescale:") and not k.endswith("__skeleton__")}
    assert_same_arrays(flat_arrays(proof), want, "rescale proof")
    assert zkrescale.verify(proof) == (True, "")


@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
def test_bit_tensor_commitment_equals_msm(share):
    """A 0/1 tensor's commitment by commit_bits' masked sums has the limbs of
    the general scalar-multiplication branch (pedersen.commit_msm), which
    the JAX package runs on every tensor."""
    gens = pedersen.nums_generators(8, "cpu")
    bits = torch.from_numpy((np.random.default_rng(7).random(64) < share).astype(np.uint32))
    raw = torch.zeros((64, 8), dtype=torch.int64)
    raw[:, 0] = mp.i64(bits)
    via_bits = pedersen.commit(gens, pedersen.to_mont_rows(mp.u32(raw))).points
    via_msm = pedersen.commit_msm([(gens, mp.u32(raw))])[0]
    for a, b in zip(via_bits, via_msm):
        assert torch.equal(a, b)


def test_commit_many_equals_commit_one_at_a_time():
    g4, g8 = pedersen.nums_generators(4, "cpu"), pedersen.nums_generators(8, "cpu")
    rng = np.random.default_rng(3)
    raws = [rng.integers(0, 1 << 20, size=(n, 8), dtype=np.uint32) * (np.arange(8) < 2) for n in (16, 32, 8)]
    ts = [pedersen.to_mont_rows(torch.from_numpy(r.astype(np.uint32))) for r in raws]
    items = [(g4, ts[0]), (g8, ts[1]), (g4, ts[2])]
    many = pedersen.commit_many(items)
    for (g, t), com in zip(items, many):
        one = pedersen.commit_msm([(g, pedersen.from_mont_rows(t))])[0]
        for a, b in zip(com.points, one):
            assert torch.equal(a, b)


@pytest.mark.parametrize("chunk", [5, 16])
def test_commit_msm_chunks_equal_one_launch(monkeypatch, chunk):
    """commit_msm in launches of `chunk` products (each gathering its own
    generators; the chunks cut rows and cross from one tensor to the next)
    gives the limbs of one launch over every product."""
    g4, g8 = pedersen.nums_generators(4, "cpu"), pedersen.nums_generators(8, "cpu")
    rng = np.random.default_rng(4)
    raws = [torch.from_numpy((rng.integers(0, 1 << 12, size=(n, 8), dtype=np.uint32) * (np.arange(8) < 1))
                             .astype(np.uint32)) for n in (12, 16)]
    items = [(g4, raws[0]), (g8, raws[1])]
    whole = pedersen.commit_msm(items)
    monkeypatch.setattr(pedersen, "_MSM_CHUNK", chunk)
    for a, b in zip(pedersen.commit_msm(items), whole):
        for u, v in zip(a, b):
            assert torch.equal(u, v)


def test_attention_from_jax_arrays(block):
    """models/convert.py carries a JAX block's weights and dlogs over: the
    rebuilt generators and row commitments equal the JAX package's."""
    from zkdl_tpu_torch.models import convert

    layers = [(rec(f"model/{nm}/weights"), rec(f"model/{nm}/gens_dlogs"), 8, 8) for nm in ("wq", "wk", "wv", "wo")]
    attn = convert.attention_from_arrays(4, layers, device="cpu")
    for nm in ("wq", "wk", "wv", "wo"):
        for c in "xyz":
            np.testing.assert_array_equal(getattr(getattr(attn, nm).com.points, c).numpy(), rec(f"model/{nm}/com_{c}"))
    np.testing.assert_array_equal(attn.forward(block[1])[0].numpy(), rec("trace/Y"))


def test_zkrelu_prove_on_expanded_aux_matches_jax():
    """zkrelu.prove takes the reference convention's expanded aux (the JAX
    rescale proof is zkrelu.prove on it) and gives the same proof."""
    from zkdl_tpu_torch.models import zkrelu

    X = torch.from_numpy(rec("rescale/X"))
    aux = {k: torch.from_numpy(rec(f"rescale/{k}")) for k in ("sign", "mag_bin", "rem_bin")}
    want = {k[len("rescale:"):]: v for k, v in attention_fixture()[0].items()
            if k.startswith("rescale:") and not k.endswith("__skeleton__")}
    assert_same_arrays(flat_arrays(zkrelu.prove(X, aux, FiatShamir())), want, "zkrelu.prove")


def test_softmax_committed_alone_verifies_with_replay():
    """zksoftmax.prove_committed (S committed under the circuit's own name)
    on the recorded scores: accepted with Fiat-Shamir replay; a swapped
    point is refused by the replay."""
    S = torch.from_numpy(rec("trace/S"))
    wit = zksoftmax.softmax_witness(S, 4, 4, 8)
    proof = zksoftmax.prove_committed(S, wit, 4, 4, 8, FiatShamir())
    assert zksoftmax.verify(proof, transcript=FiatShamir()) == (True, "")
    u = proof.u_rec.numpy().copy()
    u[0, 0] += np.uint32(1)
    proof.u_rec = torch.from_numpy(u)
    assert zksoftmax.verify(proof, transcript=FiatShamir()) == (False, "transcript: u_rec not transcript-derived")
