"""Generate the benchmark MLPs as TorchScript files (the port's copy of
``zkdl_tpu/models/gen_benchmark.py``).

    python -m zkdl_tpu_torch.models.gen_benchmark [outdir] [--small]

Writes traced_model.pt, sample_input.pt and sample_output.pt. The full model
is the 18.2M-parameter zkDL benchmark (784 -> 1000 -> 1773 x 5 -> 1124 ->
1000, bias-free, ReLU, batch 256); --small writes a 2-layer 64-wide model
(batch 4) for tests. The weights and the input come from
``torch.manual_seed(seed)`` on the CPU, so both packages' generators write
the same files.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.nn as nn

FULL_DIMS = [784, 1000, 1773, 1773, 1773, 1773, 1773, 1124, 1000]
SMALL_DIMS = [64, 64, 64]


def save_tensor(t: torch.Tensor, fn: str) -> None:
    """Save t as a scripted Module with the one parameter "0"."""
    m = nn.Module()
    m.register_parameter("0", nn.Parameter(t))
    torch.jit.script(m).save(fn)


def generate(outdir: str, small: bool = False, seed: int = 0, batch: int | None = None) -> str:
    torch.manual_seed(seed)
    dims = SMALL_DIMS if small else FULL_DIMS
    batch = batch or (4 if small else 256)
    layers = []
    for i in range(len(dims) - 1):
        layers.append(nn.Linear(dims[i], dims[i + 1], bias=False))
        if i < len(dims) - 2:
            layers.append(nn.ReLU())
    model = nn.Sequential(*layers)
    model.eval()

    sample_input = torch.randn(batch, dims[0])
    with torch.no_grad():
        sample_output = model(sample_input)

    os.makedirs(outdir, exist_ok=True)
    save_tensor(sample_input, os.path.join(outdir, "sample_input.pt"))
    save_tensor(sample_output, os.path.join(outdir, "sample_output.pt"))
    path = os.path.join(outdir, "traced_model.pt")
    torch.jit.trace(model, sample_input[:1]).save(path)
    return path


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    outdir = args[0] if args else "bench_model"
    generate(outdir, small="--small" in sys.argv)
    print(f"wrote {outdir}/traced_model.pt, sample_input.pt, sample_output.pt")
