"""The port's CPU tests share the machine with the JAX tests' worker
processes: one intra-op thread per process keeps PyTorch from
oversubscribing the cores (each test's tensors are small).

``chained`` is the 8-wide, 2-layer model built from PRNGKey(KEY) and its
chained Fiat-Shamir proof (batch 2), proved once per worker and shared by
the tests that read it; ``chained_interleaved`` is its round-interleaved
proof, and ``committed`` its committed-aux proofs of both schedules.
``jax_chained`` gives the JAX package's model built from the same weights,
input and key, and its proofs of each kind, made once per session by two
processes of their own (``jax_proofs.py``, one per schedule) that the first
worker to need them starts: their XLA:CPU compiles run beside the other
tests."""

import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import jax_proofs

torch.set_num_threads(1)

KEY = jax_proofs.KEY  # the generator key of the chained fixture, PRNGKey(KEY) in both packages


@pytest.fixture(scope="session")
def chained():
    from zkdl_tpu_torch.commit import pedersen
    from zkdl_tpu_torch.models import mlp, quantize
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir
    from zkdl_tpu_torch.utils import prng

    weights, x = jax_proofs.weights_and_input()
    model = mlp.MLP.from_float_weights(weights, prng.PRNGKey(KEY), device="cpu")
    X = pedersen.to_mont_rows(quantize.load_input(x, "cpu"))
    Y, Z, A, aux = model.infer(X)
    proof = model.prove(X, Y, Z, A, aux, FiatShamir())
    return types.SimpleNamespace(model=model, X=X, Y=Y, Z=Z, A=A, aux=aux, proof=proof, weights=weights, x=x)


@pytest.fixture(scope="session")
def chained_interleaved(chained):
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir

    c = chained
    return c.model.prove(c.X, c.Y, c.Z, c.A, c.aux, FiatShamir(), interleave=True)


@pytest.fixture(scope="session")
def committed(chained):
    """The committed-aux proofs of ``chained``: {interleave: proof}."""
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir

    c = chained
    return {inter: c.model.prove(c.X, c.Y, c.Z, c.A, c.aux, FiatShamir(), interleave=inter, commit_aux=True)
            for inter in (False, True)}


class _JaxChained:
    """The JAX package's counterpart of ``chained``: its arrays and proofs,
    read from the files that the session's two ``jax_proofs.py`` processes
    write into the session's temporary directory. The first worker here
    starts them; a file whose process ended without it is made in the
    worker that needs it (under a file lock)."""

    def __init__(self, root):
        self.root = root
        self._maker = jax_proofs.Maker()
        self._helpers = []

    def start(self) -> None:
        """Start the two writer processes, once per session. They exit when
        the session's main process is gone (an xdist worker's parent)."""
        try:
            os.close(os.open(self.root / "jax_proofs.started", os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        except FileExistsError:
            return
        watch = os.getppid() if os.environ.get("PYTEST_XDIST_WORKER") else os.getpid()
        script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_proofs.py")
        for schedule in jax_proofs.ARTIFACTS:
            ended = self.root / f"jax_proofs_{schedule}.exit"
            try:
                with open(self.root / f"jax_proofs_{schedule}.log", "wb") as log:
                    # the shell records the exit status even when Python dies of a signal
                    self._helpers.append(subprocess.Popen(
                        ["bash", "-c", '"$1" "$2" "$3" "$4" "$5"; echo $? > "$6"', "jax_proofs", sys.executable,
                         script, str(self.root), schedule, str(watch), str(ended)],
                        stdout=log, stderr=subprocess.STDOUT))
            except OSError:
                ended.write_text("not started\n")  # the tests make the files themselves
                raise

    def _file(self, name: str) -> str:
        """The path of the file `name` of jax_proofs.PROOFS, once written."""
        from filelock import FileLock

        path = self.root / name
        ended = self.root / f"jax_proofs_{jax_proofs.schedule_of(name)}.exit"
        while not path.exists() and not ended.exists():
            time.sleep(0.5)
        if not path.exists():
            with FileLock(str(path) + ".lock"):
                if not path.exists():
                    self._maker.write(name, str(path))
        return str(path)

    def arrays(self) -> dict:
        """The JAX model's generator and commitment arrays per layer, X and Y."""
        with np.load(self._file("jax_model.npz")) as z:
            return {k: z[k] for k in z.files}

    def proof(self, interleave: bool, chain: bool = True):
        """The JAX prover's Fiat-Shamir proof (chained unless chain=False),
        read back through the JAX package's proof file."""
        from zkdl_tpu.io import proof_io as jproof_io

        return jproof_io.load_proof(self._file(jax_proofs.proof_name(interleave, chain)))

    def committed_proof_file(self, interleave: bool) -> str:
        """The path of the JAX prover's committed-aux Fiat-Shamir proof file
        of this schedule."""
        return self._file(jax_proofs.proof_name(interleave, commit_aux=True))


@pytest.fixture(scope="session")
def shared_tmp(tmp_path_factory):
    """A directory that every xdist worker of the session shares."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


@pytest.fixture(scope="session")
def jax_chained(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    # xdist workers share the parent of their own temporary directories
    jc = _JaxChained(base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base)
    jc.start()
    return jc
