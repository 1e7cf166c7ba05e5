"""The JAX package's side of the port tests' chained model: its generator and
commitment arrays and its Fiat-Shamir proofs, each written once per test
session to a file that every test worker reads.

The model is ``conftest.chained``'s: dims [8, 8, 8], batch 2, the weights
and input below, generators from PRNGKey(KEY). Its XLA:CPU compiles take
minutes, so ``conftest.jax_chained`` starts this script in two processes of
their own when the session first needs a JAX proof, one per schedule, and
the tests wait for the files while other tests run:

    python tests/port/jax_proofs.py DIR grouped|interleaved WATCH_PID

writes the files of ARTIFACTS[schedule] into DIR in that order, each by an
atomic rename, and exits early when WATCH_PID (the test session's main
process) is gone. A test whose file never came makes it itself
(``Maker.write``)."""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np

DIMS, BATCH, KEY = [8, 8, 8], 2, 61

# file -> MLP.prove's schedule and tier (None: the model's arrays)
PROOFS = {
    "jax_model.npz": None,
    "jax_proof_grouped.npz": {"interleave": False},
    "jax_proof_grouped_committed.npz": {"interleave": False, "commit_aux": True},
    "jax_proof_interleaved.npz": {"interleave": True},
    "jax_proof_interleaved_unchained.npz": {"interleave": True, "chain": False},
    "jax_proof_interleaved_committed.npz": {"interleave": True, "commit_aux": True},
}
ARTIFACTS = {
    "grouped": ("jax_model.npz", "jax_proof_grouped.npz", "jax_proof_grouped_committed.npz"),
    "interleaved": ("jax_proof_interleaved.npz", "jax_proof_interleaved_unchained.npz",
                    "jax_proof_interleaved_committed.npz"),
}


def proof_name(interleave: bool, chain: bool = True, commit_aux: bool = False) -> str:
    name = ("jax_proof_interleaved" if interleave else "jax_proof_grouped") + ("" if chain else "_unchained")
    return name + ("_committed" if commit_aux else "") + ".npz"


def schedule_of(name: str) -> str:
    return next(s for s, names in ARTIFACTS.items() if name in names)


def weights_and_input():
    """The chained model's float weights and its (BATCH, DIMS[0]) input."""
    from zkdl_tpu_torch.bench import make_weights

    weights = make_weights(DIMS, np.random.default_rng(60))
    x = np.random.default_rng(62).standard_normal((BATCH, DIMS[0])).astype(np.float32)
    return weights, x


class Maker:
    """Builds the JAX model once and writes any file of PROOFS."""

    def __init__(self):
        self._model = None

    def _jax_model(self):
        """(model, X, Y, Z, A, aux) of the JAX package."""
        if self._model is None:
            import jax
            from zkdl_tpu.field import fr
            from zkdl_tpu.models import mlp as jmlp, quantize as jquantize

            weights, x = weights_and_input()
            model = jmlp.MLP.from_float_weights(weights, jax.random.PRNGKey(KEY))
            X = fr.mont(jquantize.load_input(x))
            self._model = (model, X, *model.infer(X))
        return self._model

    def write(self, name: str, path: str) -> None:
        from zkdl_tpu.io import proof_io as jproof_io
        from zkdl_tpu.sumcheck.transcript import FiatShamir

        model, X, Y, Z, A, aux = self._jax_model()
        tmp = f"{path}.{os.getpid()}.tmp"
        kw = PROOFS[name]
        if kw is None:
            out = {"X": np.asarray(X), "Y": np.asarray(Y)}
            for i, layer in enumerate(model.layers):
                for part in ("gens", "com"):
                    obj = getattr(layer, part)
                    out[f"{i}.{part}.dlogs"] = np.asarray(obj.dlogs)
                    for coord in ("x", "y", "z"):
                        out[f"{i}.{part}.points.{coord}"] = np.asarray(getattr(obj.points, coord))
            with open(tmp, "wb") as f:
                np.savez(f, **out)
        else:
            jproof_io.dump_proof(model.prove(X, Y, Z, A, aux, FiatShamir(), **kw), tmp)
        os.replace(tmp, path)


def _exit_with(pid: int) -> None:
    """End this process once pid is gone (the session was stopped)."""
    while True:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            os._exit(3)
        time.sleep(1.0)


def main(root: str, schedule: str, watch_pid: int) -> None:
    threading.Thread(target=_exit_with, args=(watch_pid,), daemon=True).start()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_enable_async_dispatch", False)  # as tests/conftest.py
    maker = Maker()
    for name in ARTIFACTS[schedule]:
        path = os.path.join(root, name)
        if not os.path.exists(path):
            maker.write(name, path)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]))
