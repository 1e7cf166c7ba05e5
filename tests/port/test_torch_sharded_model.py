"""The port's sharded prover (parallel/model.py:prove_sharded) on gloo ranks
of the CPU: the 8-wide model's unchained SeededRng(7) proof at 2, 4 and 8
ranks, and its chained Fiat-Shamir and committed-aux proofs at 4. Each
rank's serialized proof is the same bytes, equal array for array to the
single-device MLP.prove's (unchained) and to the JAX package's recorded
proofs (tests/port/fixtures/slice13_jax.npz: the (n, 8) single-device
proof, which the JAX prove_sharded equals at 2, 4 and 8 devices; the
planar single-device proofs of the chained and committed modes), and the
port's verifier accepts it; the dry run's launcher at 2 and 8 ranks."""

import io
import pathlib
import subprocess
import sys

import pytest

import sharded_runs
import slice13_fixture as fx
from zkdl_tpu_torch.io import proof_io
from zkdl_tpu_torch.sumcheck.transcript import FiatShamir, SeededRng

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def tiny():
    return fx.tiny_model()


def _proof(shared_tmp, n: int, mode: str):
    blobs = sharded_runs.proof_bytes(sharded_runs.run_dir(shared_tmp, n), n, mode)
    assert all(b == blobs[0] for b in blobs[1:]), "the ranks' proofs differ"
    return proof_io.load_proof(io.BytesIO(blobs[0]), device="cpu")


@pytest.fixture(scope="module")
def single_unchained(tiny):
    """The single-device MLP.prove(chain=False) of the 8-wide model."""
    model, X = tiny
    return fx.flat(model.prove(X, *model.infer(X), SeededRng(7), chain=False))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_unchained_proof(shared_tmp, tiny, single_unchained, n):
    proof = _proof(shared_tmp, n, "unchained")
    assert fx.differing(fx.flat(proof), fx.proof_arrays("model/nat")) == []
    assert fx.differing(fx.flat(proof), single_unchained) == []
    model, _ = tiny
    assert model.verify(proof) == (True, "")
    assert fx.verdict("nat") == (True, "")


@pytest.mark.parametrize("mode", ["chained", "committed"])
def test_chained_proofs_at_four_ranks(shared_tmp, tiny, mode):
    proof = _proof(shared_tmp, 4, mode)
    assert fx.differing(fx.flat(proof), fx.proof_arrays(f"{mode}/single")) == []
    model, X = tiny
    Y = fx.t("model/Y")
    assert model.verify(proof, X=X, Y_hat=Y, transcript=FiatShamir()) == (True, "")
    assert fx.verdict(f"{mode}_single") == (True, "")


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_launcher(n):
    out = subprocess.run([sys.executable, "-m", "zkdl_tpu_torch.parallel.dryrun", "--ranks", str(n),
                          "--device", "cpu", "--timeout", "600"], capture_output=True, text=True, timeout=660,
                         cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("dryrun OK"), out.stdout
