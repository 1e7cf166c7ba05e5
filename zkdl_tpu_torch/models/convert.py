"""Build the port's layers, MLP and attention block from a JAX model's parameters.

The weights and generator dlogs arrive as numpy uint32 arrays (``ZkFC.weights``
(in*out, 8) and ``ZkFC.gens.dlogs`` (gen, 8), both Montgomery); the port
recomputes the generator points and the row commitments from them, so a
JAX model and its port commit to the same group elements.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..commit import pedersen
from ..utils.runtime import resolve_device
from .mlp import MLP
from .zkattention import ZkAttention
from .zkfc import ZkFC


def layer_from_arrays(weights_mont, dlogs, in_size: int, out_size: int, device="cuda") -> ZkFC:
    dev = resolve_device(device)
    W = torch.from_numpy(np.ascontiguousarray(weights_mont, dtype=np.uint32)).to(dev)
    D = torch.from_numpy(np.ascontiguousarray(dlogs, dtype=np.uint32)).to(dev)
    if W.shape != (in_size * out_size, 8):
        raise ValueError(f"weights {tuple(W.shape)} != ({in_size * out_size}, 8)")
    if D.shape[0] != ZkFC.gen_size_for(in_size, out_size):
        raise ValueError(f"{D.shape[0]} dlogs for a {in_size}x{out_size} layer")
    gens = pedersen.generators_from_dlogs(D)
    return ZkFC(in_size, out_size, W, gens, pedersen.commit(gens, W))


def mlp_from_arrays(layers: Sequence[tuple], device="cuda") -> MLP:
    """layers: [(weights_mont, dlogs, in_size, out_size), ...]."""
    return MLP([layer_from_arrays(*l, device=device) for l in layers])


def attention_from_arrays(seq: int, layers: Sequence[tuple], device="cuda") -> ZkAttention:
    """A JAX ZkAttention's four projections wq, wk, wv, wo, each
    (weights_mont, dlogs, d_model, d_model), as the port's block."""
    if len(layers) != 4:
        raise ValueError(f"an attention block has 4 projections, got {len(layers)}")
    fcs = [layer_from_arrays(*l, device=device) for l in layers]
    return ZkAttention(seq, fcs[0].in_size, *fcs)
