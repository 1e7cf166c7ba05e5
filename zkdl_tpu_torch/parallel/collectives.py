"""Modular-arithmetic-safe collectives over a mesh of torch.distributed ranks.

Counterpart of ``zkdl_tpu/parallel/collectives.py`` (``reduce_mod_p``,
``psum_fr``, ``fr_sum_local_then_psum``, :35-58), kernel B17. The JAX
version splits each Fr value into 16-bit digits so that ``psum`` keeps the
carries. The port's limbs are int64 already, so one ``all_reduce(SUM)`` of
the eight limbs of every rank's canonical values is exact (each limb sum <
n_ranks 2^32), and K9 (``field/kernels.py:collect``, ``csrc/fr_collect.cu``)
turns the sums into the canonical value: bit-identical to a single-device
modular sum, which keeps the transcript the same on every rank. A call's
values go in one all-reduce and one K9 launch.

Backends (``dist.get_backend`` of the axis's group):
- NCCL carries CUDA tensors; a CPU tensor raises.
- gloo carries CPU tensors. A CUDA tensor under gloo (two ranks sharing one
  card, where NCCL refuses the duplicate GPU) is staged through host memory
  by ``_gloo_staged``: copied to the host, reduced or gathered there, and
  copied back. Nothing else changes a tensor's device or a backend.

``STATS`` counts the collectives that ran (an axis of one rank runs none)
and their bytes on this rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..field import kernels, mp
from ..tensor import fr_ops

STATS = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0, "all_gather_bytes": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def _gloo_staged(t: torch.Tensor, op) -> torch.Tensor:
    """op(host copy of t) under gloo for a CUDA tensor t: the collective
    runs on a host copy and its result is copied back to t's card."""
    return op(t.cpu()).to(t.device)


def _run(t: torch.Tensor, group, op) -> torch.Tensor:
    """op(t) on the backend of `group`: NCCL takes CUDA tensors only, gloo
    CPU tensors, CUDA ones staged through host memory."""
    backend = dist.get_backend(group)
    if backend == dist.Backend.NCCL:
        if t.device.type != "cuda":
            raise ValueError(f"NCCL carries CUDA tensors only, got one on {t.device}")
        return op(t)
    if backend == dist.Backend.GLOO:
        return _gloo_staged(t, op) if t.device.type == "cuda" else op(t)
    raise ValueError(f"no collective path for backend {backend!r}")


def all_reduce_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Elementwise sum of x (int64) over the mesh axis (a new tensor)."""
    group = mesh.group(axis)
    if group is None:
        return x
    STATS["all_reduce"] += 1
    STATS["all_reduce_bytes"] += x.numel() * x.element_size()

    def op(t):
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    return _run(x.contiguous(), group, op)


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's x (same shape) over the mesh axis, concatenated along
    dim 0 in the axis's index order. uint32 travels as int32 bits."""
    group = mesh.group(axis)
    if group is None:
        return x
    n = mesh.size(axis)
    STATS["all_gather"] += 1
    STATS["all_gather_bytes"] += x.numel() * x.element_size() * n
    bits = x.contiguous().view(torch.int32) if x.dtype == torch.uint32 else x.contiguous()

    def op(t):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts)

    out = _run(bits, group, op)
    return out.view(torch.uint32) if x.dtype == torch.uint32 else out


def reduce_mod_p(limbs9: torch.Tensor) -> torch.Tensor:
    """(k, 9) uint32 words of values < 2^8 p -> canonical (k, 8) mod p
    (collectives.py:reduce_mod_p): the ninth word joins the eighth as its
    high half, then K9 (the plain version on a CPU tensor)."""
    s = mp.i64(limbs9[:, :8]).clone()
    s[:, 7] += mp.i64(limbs9[:, 8]) << 32
    return kernels.collect(s)


def psum_fr(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Modular sum of canonical Fr values (..., 8) over the mesh axis: one
    all-reduce of their int64 limbs and one K9 launch; canonical result,
    the same on every rank of the axis."""
    shape = x.shape
    rows = mp.i64(x.reshape(-1, 8))
    if rows.shape[0] == 0:
        return x
    return kernels.collect(all_reduce_sum(rows, mesh, axis)).reshape(shape)


def fr_sum_local_then_psum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum the local (n, 8) block, then psum_fr across the axis -> (8,)."""
    return psum_fr(fr_ops.fr_sum(t), mesh, axis)
