"""The port's CPU tests share the machine with the JAX tests' worker
processes: one intra-op thread per process keeps PyTorch from
oversubscribing the cores (each test's tensors are small).

``chained`` is the 8-wide, 2-layer model and its chained Fiat-Shamir proof
(batch 2), proved once per worker and shared by the tests that read it."""

import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(scope="session")
def chained():
    from zkdl_tpu_torch.bench import make_weights
    from zkdl_tpu_torch.commit import pedersen
    from zkdl_tpu_torch.models import mlp, quantize
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir

    dims, batch = [8, 8, 8], 2
    model = mlp.MLP.from_float_weights(make_weights(dims, np.random.default_rng(60)),
                                       np.random.default_rng(61), device="cpu")
    x = np.random.default_rng(62).standard_normal((batch, dims[0])).astype(np.float32)
    X = pedersen.to_mont_rows(quantize.load_input(x, "cpu"))
    Y, Z, A, aux = model.infer(X)
    proof = model.prove(X, Y, Z, A, aux, FiatShamir())
    return types.SimpleNamespace(model=model, X=X, Y=Y, Z=Z, A=A, aux=aux, proof=proof)
