"""The port's CPU tests share the machine with the JAX tests' worker
processes: one intra-op thread per process keeps PyTorch from
oversubscribing the cores (each test's tensors are small).

``chained`` is the 8-wide, 2-layer model built from PRNGKey(61) and its
chained Fiat-Shamir proof (batch 2), proved once per worker and shared by
the tests that read it; ``chained_interleaved`` is its round-interleaved
proof. ``jax_chained`` is the JAX package's model built from the same
weights, input and key, with its own proofs of both schedules, each made
once per session at its first use: XLA:CPU compiles are their cost."""

import os
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

KEY = 61  # the generator key of the chained fixture, PRNGKey(KEY) in both packages


@pytest.fixture(scope="session")
def chained():
    from zkdl_tpu_torch.bench import make_weights
    from zkdl_tpu_torch.commit import pedersen
    from zkdl_tpu_torch.models import mlp, quantize
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir
    from zkdl_tpu_torch.utils import prng

    dims, batch = [8, 8, 8], 2
    weights = make_weights(dims, np.random.default_rng(60))
    model = mlp.MLP.from_float_weights(weights, prng.PRNGKey(KEY), device="cpu")
    x = np.random.default_rng(62).standard_normal((batch, dims[0])).astype(np.float32)
    X = pedersen.to_mont_rows(quantize.load_input(x, "cpu"))
    Y, Z, A, aux = model.infer(X)
    proof = model.prove(X, Y, Z, A, aux, FiatShamir())
    return types.SimpleNamespace(model=model, X=X, Y=Y, Z=Z, A=A, aux=aux, proof=proof, weights=weights, x=x)


@pytest.fixture(scope="session")
def chained_interleaved(chained):
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir

    c = chained
    return c.model.prove(c.X, c.Y, c.Z, c.A, c.aux, FiatShamir(), interleave=True)


class _JaxChained:
    """The JAX package's counterpart of ``chained``. Its model's arrays and
    its proofs are made once per test session, by the first worker that
    needs each, and shared with the other workers through files in the
    session's temporary directory (a file lock orders them)."""

    def __init__(self, c, root):
        self.c, self.root = c, root
        self._model = None

    def _jax_model(self):
        """(model, X, Y, Z, A, aux) of the JAX package, built in this worker."""
        if self._model is None:
            import jax
            from zkdl_tpu.field import fr
            from zkdl_tpu.models import mlp as jmlp, quantize as jquantize

            model = jmlp.MLP.from_float_weights(self.c.weights, jax.random.PRNGKey(KEY))
            X = fr.mont(jquantize.load_input(self.c.x))
            self._model = (model, X, *model.infer(X))
        return self._model

    def _once(self, name: str, make):
        from filelock import FileLock

        path = self.root / name
        with FileLock(str(path) + ".lock"):
            if not path.exists():
                make(str(path) + ".tmp")
                os.replace(str(path) + ".tmp", path)
        return str(path)

    def arrays(self) -> dict:
        """The JAX model's generator and commitment arrays per layer, X and Y."""

        def make(path):
            model, X, Y = self._jax_model()[:3]
            out = {"X": np.asarray(X), "Y": np.asarray(Y)}
            for i, layer in enumerate(model.layers):
                for part in ("gens", "com"):
                    obj = getattr(layer, part)
                    out[f"{i}.{part}.dlogs"] = np.asarray(obj.dlogs)
                    for coord in ("x", "y", "z"):
                        out[f"{i}.{part}.points.{coord}"] = np.asarray(getattr(obj.points, coord))
            with open(path, "wb") as f:
                np.savez(f, **out)

        with np.load(self._once("jax_model.npz", make)) as z:
            return {k: z[k] for k in z.files}

    def proof(self, interleave: bool, chain: bool = True):
        """The JAX prover's Fiat-Shamir proof (chained unless chain=False),
        read back through the JAX package's proof file."""
        from zkdl_tpu.io import proof_io as jproof_io
        from zkdl_tpu.sumcheck.transcript import FiatShamir

        def make(path):
            model, X, Y, Z, A, aux = self._jax_model()
            jproof_io.dump_proof(model.prove(X, Y, Z, A, aux, FiatShamir(), chain=chain, interleave=interleave),
                                 path)

        name = ("jax_proof_interleaved" if interleave else "jax_proof_grouped") + ("" if chain else "_unchained")
        return jproof_io.load_proof(self._once(name + ".npz", make))


@pytest.fixture(scope="session")
def jax_chained(chained, tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    # xdist workers share the parent of their own temporary directories
    return _JaxChained(chained, base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base)
