"""Fixed-point quantization of floats into Fr.

Counterpart of ``zkdl_tpu/models/quantize.py`` (:18-67): x -> round(|x * 2^16|)
(half away from zero, computed in float32), embedded sign-aware into Fr
(negatives as p - |v|); the batch loaders zero-pad both dims to the next
power of two.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..field import fr, mp, planar
from ..tensor import fr_ops

SCALE_BITS = config.get().scale_bits  # 16 unless ZKDL_SCALE_BITS sets another
SCALE = 1 << SCALE_BITS


def float_to_fr(x: torch.Tensor) -> torch.Tensor:
    """float[...] -> planar uint32 (8, ...) canonical (non-Montgomery) Fr,
    bit-compatible with the JAX quantizer (f32 scale, f32 round half away)."""
    x = x.to(torch.float32) * torch.tensor(float(SCALE), dtype=torch.float32)
    rounded = torch.floor(torch.abs(x) + torch.tensor(0.5, dtype=torch.float32))
    mag = rounded.to(torch.int64) & mp.M32
    limbs = torch.zeros((8, *x.shape), dtype=torch.int64, device=x.device)
    limbs[0] = mag
    neg = (x < 0) & (mag != 0)
    negated = mp.mod_sub(fr.SPEC.P_limbs, torch.zeros_like(limbs), limbs)
    return mp.u32(torch.where(neg.unsqueeze(0), negated, limbs))


def pad_pow2_2d(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad a 2-D float tensor to next-power-of-two dims."""
    r, c = x.shape
    rp = 1 << fr_ops.ceil_log2(r)
    cp = 1 << fr_ops.ceil_log2(c)
    return torch.nn.functional.pad(x, (0, cp - c, 0, rp - r))


def _float32(x, device) -> torch.Tensor:
    """A float array or tensor (any device) as a float32 tensor on device."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, dtype=np.float32)
    return torch.as_tensor(x, device=device).to(torch.float32)


def load_weights(w, device) -> torch.Tensor:
    """Float weight matrix (in, out) -> padded Montgomery Fr (in_p*out_p, 8)."""
    w = pad_pow2_2d(_float32(w, device))
    q = float_to_fr(w).reshape(8, -1)
    return planar.from_planar(planar.to_mont(q)).contiguous()


def load_input(x, device) -> torch.Tensor:
    """Float input batch (batch, dim) -> padded NON-Montgomery Fr (n, 8)."""
    x = pad_pow2_2d(_float32(x, device))
    return planar.from_planar(float_to_fr(x).reshape(8, -1)).contiguous()


def dequantize(t: torch.Tensor, scale_bits: int) -> np.ndarray:
    """(n, 8) canonical non-Montgomery Fr -> float64 signed fixed point."""
    vals = fr.to_ints(mp.host(t))
    half = fr.P_INT // 2
    return np.array([(v if v <= half else v - fr.P_INT) / (1 << scale_bits) for v in vals])
