"""The port's checkpointed proving (``io/proof_io.py``: ``ProofCheckpoint``,
``prove_mlp_checkpointed``) on the 8-wide ``chained`` fixture, against
``tests/test_proof_io.py``'s two resume tests and the JAX prover's proofs
of the same model (conftest's ``jax_chained``): a checkpointed proof, and
one resumed from its files with some layers removed, serialize to the bytes
of the uninterrupted proof, in the grouped and the committed tiers; the
JAX package's own checkpoint files of its proofs resume in the port to the
JAX proofs, array for array."""

import os

import pytest

from test_torch_chain import assert_same_arrays, proof_arrays
from zkdl_tpu_torch.io import proof_io
from zkdl_tpu_torch.sumcheck.transcript import FiatShamir, SeededRng

# the layers proved last in the backwards loop: relu[0], then fc[0]
LAST = ("relu_000.npz", "fc_000.npz")


def prove(c, ckpt, challenges, commit_aux=False):
    return proof_io.prove_mlp_checkpointed(c.model, c.X, c.Y, c.Z, c.A, c.aux, challenges, ckpt,
                                           commit_aux=commit_aux)


def test_checkpoint_resume_identical_seeded(chained, tmp_path):
    """tests/test_proof_io.py::test_checkpoint_resume_identical: SeededRng(9)."""
    c = chained
    full = c.model.prove(c.X, c.Y, c.Z, c.A, c.aux, SeededRng(9))
    ckpt = proof_io.ProofCheckpoint(tmp_path / "ckpt")
    assert proof_io.serialize(prove(c, ckpt, SeededRng(9))) == proof_io.serialize(full)
    assert sorted(os.listdir(ckpt.dir)) == ["fc_000.npz", "fc_001.npz", "relu_000.npz"]
    resumed = prove(c, proof_io.ProofCheckpoint(ckpt.dir), SeededRng(9))
    assert proof_io.serialize(resumed) == proof_io.serialize(full)


@pytest.mark.parametrize("tier", ["grouped", "committed"])
def test_checkpoint_resume_fiatshamir(chained, committed, tmp_path, tier):
    """tests/test_proof_io.py::test_checkpoint_resume_fiatshamir, in both
    tiers: proved with checkpoints, resumed from all of them, and resumed
    after the files of the layers proved last were removed; each
    byte-identical to the uninterrupted proof (which equals the JAX
    prover's: test_torch_chain, test_torch_committed)."""
    c = chained
    aux = tier == "committed"
    want = proof_io.serialize(committed[False] if aux else c.proof)
    ckpt = proof_io.ProofCheckpoint(tmp_path / tier)
    assert proof_io.serialize(prove(c, ckpt, FiatShamir(), aux)) == want
    assert proof_io.serialize(prove(c, ckpt, FiatShamir(), aux)) == want
    for name in LAST:
        os.remove(os.path.join(ckpt.dir, name))
    assert proof_io.serialize(prove(c, ckpt, FiatShamir(), aux)) == want


def test_checkpointed_committed_needs_chained_mode(chained, tmp_path):
    c = chained
    with pytest.raises(ValueError, match="committed aux requires chained mode"):
        proof_io.prove_mlp_checkpointed(c.model, c.X, c.Y, c.Z, c.A, c.aux, FiatShamir(),
                                        proof_io.ProofCheckpoint(tmp_path), chain=False, commit_aux=True)


@pytest.mark.parametrize("tier", ["grouped", "committed"])
def test_resume_from_the_jax_packages_checkpoint_files(chained, jax_chained, tmp_path, tier):
    """(Last in the file: it waits for the session's JAX proofs.) The JAX
    package's ProofCheckpoint writes its proof's layers; the port resumes
    from those files (all of them, then with the last-proved layers removed
    and proved again) to the JAX proof, array for array."""
    from zkdl_tpu.io import proof_io as jproof_io

    c = chained
    aux = tier == "committed"
    jp = jproof_io.load_proof(jax_chained.committed_proof_file(False)) if aux else jax_chained.proof(interleave=False)
    jckpt = jproof_io.ProofCheckpoint(str(tmp_path / "jax"))
    for i, p in enumerate(jp.fc_proofs):
        jckpt.save("fc", i, p)
    for i, p in enumerate(jp.relu_proofs):
        jckpt.save("relu", i, p)
    want = proof_arrays(jp)
    ckpt = proof_io.ProofCheckpoint(jckpt.dir)
    assert_same_arrays(proof_arrays(prove(c, ckpt, FiatShamir(), aux)), want)
    for name in LAST:
        os.remove(os.path.join(ckpt.dir, name))
    assert_same_arrays(proof_arrays(prove(c, ckpt, FiatShamir(), aux)), want)
