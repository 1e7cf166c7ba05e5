"""Quantized MLP: build, inference and the backwards proving loop.

Counterpart of ``zkdl_tpu/models/mlp.py``: ``absorb_statement`` (:38-49),
``MLP.from_float_weights``/``infer``/``prove`` (:57-163, planar path,
chained by default), ``MLPProof`` and ``prove_timed`` (:378-388).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..sumcheck.transcript import ChallengeSource, FiatShamir
from ..utils.runtime import resolve_device
from . import zkfc, zkrelu


def absorb_statement(challenges: ChallengeSource, layers, X, Y_hat) -> None:
    """Bind the Fiat-Shamir transcript to the public statement before any
    challenge is drawn: every layer's row commitments (x, y, z), the public
    input X and the claimed output Y_hat, in the JAX package's byte layout."""
    for layer in layers:
        challenges.absorb_array(layer.com.points.x)
        challenges.absorb_array(layer.com.points.y)
        challenges.absorb_array(layer.com.points.z)
    challenges.absorb_array(X)
    challenges.absorb_array(Y_hat)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class MLP:
    layers: list[zkfc.ZkFC]

    @classmethod
    def from_float_weights(cls, weights: Sequence[np.ndarray], rng: np.random.Generator,
                           device="cuda") -> "MLP":
        """weights: float (in, out) matrices; each layer's generators are
        drawn from `rng` in order. Sizes must chain."""
        dev = resolve_device(device)
        layers = []
        for i, w in enumerate(weights):
            layers.append(zkfc.ZkFC.from_float(w, rng, dev))
            if i > 0 and layers[i - 1].out_size != layers[i].in_size:
                raise ValueError("Incompatible layer sizes")
        return cls(layers)

    @property
    def n_params(self) -> int:
        return sum(l.weights.shape[0] for l in self.layers)

    def infer(self, X: torch.Tensor):
        """X: (batch*in, 8) Montgomery. Returns (Y_hat, Z_list, A_list, aux_list)."""
        Z_list, A_list, aux_list = [], [], []
        A = X
        for layer in self.layers[:-1]:
            Z = layer(A)
            A, aux = zkrelu.forward_compact(Z)
            Z_list.append(Z)
            A_list.append(A)
            aux_list.append(aux)
        return self.layers[-1](A), Z_list, A_list, aux_list

    def prove(self, X, Y_hat, Z_list, A_list, aux_list, challenges: ChallengeSource | None = None,
              chain: bool = True, on_layer: Callable[[str, int], None] | None = None) -> "MLPProof":
        """Backwards proving loop: output FC first, then (relu_i, fc_i) down to
        layer 0. chain=True links every FC's output claim to the adjacent
        ReLU's sumchecks (GKR-style); chain=False gives independent per-layer
        proofs. on_layer(kind, i) is called after each layer proof (kind
        "fc" or "relu"), e.g. to time the layers."""
        if challenges is None:
            challenges = FiatShamir()
        absorb_statement(challenges, self.layers, X, Y_hat)
        n = len(self.layers)
        fc_proofs: list = [None] * n
        relu_proofs: list = [None] * (n - 1)
        fc_proofs[n - 1] = zkfc.prove_planar(self.layers[n - 1], A_list[n - 2] if n >= 2 else X,
                                             Y_hat, challenges)
        if on_layer:
            on_layer("fc", n - 1)
        for i in range(n - 2, -1, -1):
            A_prev = A_list[i - 1] if i > 0 else X
            if chain:
                w = torch.cat([fc_proofs[i + 1].u_in, fc_proofs[i + 1].u_bs], dim=0)
                relu_proofs[i] = zkrelu.prove_planar(Z_list[i], aux_list[i], challenges, chain_point=w)
                if on_layer:
                    on_layer("relu", i)
                fc_proofs[i] = zkfc.prove_planar(self.layers[i], A_prev, Z_list[i], challenges,
                                                 z_point=relu_proofs[i].u_recover)
            else:
                relu_proofs[i] = zkrelu.prove_planar(Z_list[i], aux_list[i], challenges)
                if on_layer:
                    on_layer("relu", i)
                fc_proofs[i] = zkfc.prove_planar(self.layers[i], A_prev, Z_list[i], challenges)
            if on_layer:
                on_layer("fc", i)
        return MLPProof(fc_proofs, relu_proofs)


@dataclasses.dataclass
class MLPProof:
    fc_proofs: list
    relu_proofs: list


def prove_timed(model: MLP, X, batch_size: int, challenges=None, **prove_kwargs):
    """Inference (untimed), then the timed proving loop, ended by a device
    synchronize. Returns (proof, seconds_per_data_point)."""
    dev = X.device
    Y_hat, Z_list, A_list, aux_list = model.infer(X)
    _sync(dev)
    t0 = time.perf_counter()
    proof = model.prove(X, Y_hat, Z_list, A_list, aux_list, challenges, **prove_kwargs)
    _sync(dev)
    return proof, (time.perf_counter() - t0) / batch_size
