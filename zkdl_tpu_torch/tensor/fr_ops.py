"""Shape helpers of ``zkdl_tpu/tensor/fr_ops.py`` used by the prover."""

from __future__ import annotations

import torch


def ceil_log2(n: int) -> int:
    """Matches the reference ceilLog2."""
    if n == 0:
        return 0
    return int(n - 1).bit_length()


def pad_to(t: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the leading axis to length n."""
    if t.shape[0] == n:
        return t
    if t.shape[0] > n:
        raise ValueError(f"pad_to: length {t.shape[0]} > {n}")
    pad = torch.zeros((n - t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    return torch.cat([t, pad], dim=0)
