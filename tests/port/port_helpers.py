"""Shared inputs for the port's CPU tests: seeded Fr tensors with edge values,
proof conversion between the port (torch) and the JAX package, and the
golden fixture's model."""

from __future__ import annotations

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import torch

from zkdl_tpu.commit import pedersen as jpedersen
from zkdl_tpu.curve import g1 as jg1
from zkdl_tpu.models import mlp as jmlp, zkfc as jzkfc, zkrelu as jzkrelu
from zkdl_tpu_torch.commit import pedersen
from zkdl_tpu_torch.curve import g1
from zkdl_tpu_torch.field import fr
from zkdl_tpu_torch.models import mlp, quantize
from zkdl_tpu_torch.utils import prng

GOLDEN = pathlib.Path(__file__).resolve().parents[1] / "fixtures" / "golden_config1.npz"

P = fr.P_INT
EDGES = np.stack([fr.ZERO, fr.from_int(1), fr.from_int(P - 1), fr.ONE_MONT])  # 0, 1, p-1, R mod p


def rand_fr(seed: int, n: int) -> np.ndarray:
    """(n, 8) canonical Fr limbs from a numpy seed; the edge values first."""
    a = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8), dtype=np.uint32)
    a[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    k = min(n, len(EDGES))
    a[:k] = EDGES[:k]
    return a


def rand_planar(seed: int, n: int) -> np.ndarray:
    """(8, n) planar canonical Fr, contiguous."""
    return np.ascontiguousarray(rand_fr(seed, n).T)


_JAX_CLASSES = {
    "ZkFCProof": jzkfc.ZkFCProof,
    "ZkReluProof": jzkrelu.ZkReluProof,
    "OpeningProof": jpedersen.OpeningProof,
    "MLPProof": jmlp.MLPProof,
    "AuxCommitments": jzkrelu.AuxCommitments,
    "RowCommitments": jpedersen.RowCommitments,
    "FoldOpening": jpedersen.FoldOpening,
}


def to_jax(obj):
    """A port proof tree -> the JAX package's proof classes (same field names)."""
    if isinstance(obj, torch.Tensor):
        return jnp.asarray(obj.cpu().numpy())
    if isinstance(obj, g1.G1Jac):
        return jg1.G1Jac(*(to_jax(c) for c in obj))
    if isinstance(obj, list):
        return [to_jax(x) for x in obj]
    if obj is None:
        return None
    cls = _JAX_CLASSES[type(obj).__name__]
    return cls(**{f.name: to_jax(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def jax_model(port_model) -> jmlp.MLP:
    """JAX MLP object holding the port model's weights and commitments."""
    layers = []
    for l in port_model.layers:
        com = jpedersen.RowCommitments(points=to_jax(l.com.points), dlogs=to_jax(l.com.dlogs))
        gens = jpedersen.Generators(points=to_jax(l.gens.points), dlogs=to_jax(l.gens.dlogs), glv_safe=True)
        layers.append(jzkfc.ZkFC(l.in_size, l.out_size, to_jax(l.weights), gens, com))
    return jmlp.MLP(layers)


def golden_model():
    """tests/test_golden_fixture.py's model on the CPU: 2 layers of width 64,
    batch 1, generators from PRNGKey(0); returns (model, X). Built by the
    port alone."""
    rng = np.random.default_rng(2024)
    dims = [64, 64, 64]
    weights = [(rng.standard_normal((dims[i], dims[i + 1])) * 0.4).astype(np.float32) for i in range(2)]
    model = mlp.MLP.from_float_weights(weights, prng.PRNGKey(0), device="cpu")
    X = pedersen.to_mont_rows(quantize.load_input(rng.standard_normal((1, 64)).astype(np.float32), "cpu"))
    return model, X
