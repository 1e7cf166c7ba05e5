"""The port's attention-block proofs on the CPU against the JAX package's, at
tests/test_attention.py's tiny size (seq 4, d 8): both tiers equal the
recorded JAX proofs array for array (every poly, final, claim, challenge
vector and witness commitment limb); the port's verifier gives the JAX
verifier's verdict and reason on each recorded tamper case; the proofs
round-trip through the npz format, the JAX files load and verify.

The port's two proofs take about a minute on one CPU core (the plain
versions of the G1 kernels in the witness commitments): the first test
worker to need them makes them under a file lock in the session's
temporary directory and every other worker reads that file."""

import json
import os

import pytest
import torch

from attention_helpers import (ATTENTION_FIXTURE, assert_same_arrays, attention_fixture, flat_arrays,
                               recorded_proof, tampered_copy, tiny_attention)
from zkdl_tpu_torch.field import fr
from zkdl_tpu_torch.io import proof_io
from zkdl_tpu_torch.sumcheck.transcript import FiatShamir

TIERS = ("plain", "committed")
# the recorder's tamper cases, (name, tier, path, index, verify arguments)
TAMPERS = json.loads(open(str(ATTENTION_FIXTURE) + ".json").read())["tampers"]


@pytest.fixture(scope="session")
def attention_proofs(tmp_path_factory):
    """{tier: proof} of the tiny block, made once per session."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    paths = {tier: root / f"port_attention_{tier}.npz" for tier in TIERS}
    with FileLock(str(root / "port_attention.lock")):
        if not all(p.exists() for p in paths.values()):
            attn, X = tiny_attention()
            _, tr = attn.forward(X)
            for tier, path in paths.items():
                proof_io.dump_proof(attn.prove(tr, FiatShamir(), commit_witness=tier == "committed"), str(path))
    return {tier: proof_io.load_proof(str(p), device="cpu") for tier, p in paths.items()}


@pytest.fixture(scope="module")
def block():
    attn, X = tiny_attention()
    Y, _ = attn.forward(X)
    return attn, X, Y


@pytest.mark.parametrize("tier", TIERS)
def test_proof_matches_jax(attention_proofs, tier):
    assert_same_arrays(flat_arrays(attention_proofs[tier]), recorded_proof(tier), f"{tier} proof")


def _verify(block, proof, args):
    attn, X, Y = block
    kw = {}
    if "X" in args:
        kw["X"] = X
    if "Y" in args:
        kw["Y"] = Y
    if "Y_bad" in args:
        Y_bad = Y.clone()
        Y_bad[0] = torch.from_numpy(fr.from_ints([7 << 16], mont_form=True)[0])
        kw["Y"] = Y_bad
    if "transcript" in args:
        kw["transcript"] = FiatShamir()
    return attn.verify(proof, **kw)


@pytest.mark.parametrize("case", TAMPERS, ids=[t[0] for t in TAMPERS])
def test_verdict_matches_jax(attention_proofs, block, case):
    name, tier, path, index, args = case
    got = _verify(block, tampered_copy(attention_proofs[tier], path, index), args)
    assert got == tuple(attention_fixture()[1]["verdicts"][name])


@pytest.mark.parametrize("trace_case", ["P", "Q"])
def test_trace_tamper_verdict_matches_jax(trace_case):
    """tests/test_attention.py's two wrong traces: a P entry (plain tier) and
    a Q entry (committed tier, the rescale binding catches it)."""
    attn, X = tiny_attention()
    _, tr = attn.forward(X)
    if trace_case == "P":
        tr["P"] = tr["P"].clone()
        tr["P"][0] = torch.from_numpy(fr.from_ints([3 << 16], mont_form=True)[0])
        got, name = attn.verify(attn.prove(tr, FiatShamir())), "trace_softmax_P"
    else:
        tr["Q"] = tr["Q"].clone()
        tr["Q"][1] = torch.from_numpy(fr.from_ints([5 << 16], mont_form=True)[0])
        got, name = attn.verify(attn.prove(tr, FiatShamir(), commit_witness=True)), "trace_rescale_Q"
    assert got == tuple(attention_fixture()[1]["verdicts"][name])


@pytest.mark.parametrize("tier", TIERS)
def test_jax_proof_file_verifies(block, tier, tmp_path):
    """The recorded JAX proof, written in the npz schema and read back by the
    port (its class tags resolved to the port's), passes the port's
    verifier; the committed one also with Fiat-Shamir replay."""
    arrays, _ = attention_fixture()
    skel = json.loads(bytes(arrays[f"{tier}:__skeleton__"]).decode())
    proof = proof_io._unflatten(skel, recorded_proof(tier), torch.device("cpu"))
    path = tmp_path / "jax.npz"
    proof_io.dump_proof(proof, str(path))
    back = proof_io.load_proof(str(path), device="cpu")
    assert_same_arrays(flat_arrays(back), recorded_proof(tier), "round trip")
    args = ("X", "Y", "transcript") if tier == "committed" else ()
    assert _verify(block, back, args) == (True, "")


def test_chip_smoke_faults_are_the_recorded_ones():
    """chip_smoke.py's phase 7 expects, on the seq-128 proof, the JAX
    verifier's reasons on these tampers of the tiny proof."""
    import sys

    sys.path.insert(0, str(ATTENTION_FIXTURE.parents[3]))
    import chip_smoke

    recorded = {t[0]: t for t in TAMPERS}
    for name, path, index, args, reason in chip_smoke.ATTENTION_FAULTS:
        _, tier, r_path, r_index, r_args = recorded[name]
        assert (tier, r_path, r_index, list(r_args)) == ("committed", path, list(index) if index else None,
                                                         list(args))
        assert tuple(attention_fixture()[1]["verdicts"][name]) == (False, reason)
