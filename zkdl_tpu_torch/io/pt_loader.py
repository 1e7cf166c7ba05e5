"""TorchScript model and tensor loading (the port's copy of
``zkdl_tpu/io/pt_loader.py``).

Semantics of the reference's load_model: iterate the numeric submodule
attributes "0", "1", ... of the scripted model, skip those without a
``weight`` (ReLU), take each Linear weight and transpose it to (in, out).
Both loaders put their result on an explicit device.
"""

from __future__ import annotations

import torch


def load_mlp_weights(model_path: str, device="cpu") -> list[torch.Tensor]:
    """float32 weight matrices transposed to (in, out), in layer order, on
    `device`."""
    m = torch.jit.load(model_path, map_location="cpu")
    weights: list[torch.Tensor] = []
    i = 0
    while hasattr(m, str(i)):
        sub = getattr(m, str(i))
        if hasattr(sub, "weight"):
            weights.append(sub.weight.detach().to(torch.float32).t().contiguous().to(device))
        i += 1
    if not weights:
        raise ValueError(f"no Linear weights found in {model_path}")
    for a, b in zip(weights, weights[1:]):
        if a.shape[1] != b.shape[0]:
            raise ValueError("Incompatible layer sizes")
    return weights


def load_tensor(tensor_path: str, device="cpu") -> torch.Tensor:
    """A tensor saved by gen_benchmark.save_tensor (a scripted Module with
    the parameter "0"), float32 on `device`."""
    m = torch.jit.load(tensor_path, map_location="cpu")
    for _, p in m.named_parameters():
        return p.detach().to(torch.float32).to(device)
    raise ValueError(f"no parameter found in {tensor_path}")
