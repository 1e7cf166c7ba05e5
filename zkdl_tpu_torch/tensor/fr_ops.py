"""Shape helpers, keyed draws and the MLE evaluations of
``zkdl_tpu/tensor/fr_ops.py`` (``me_step``/``me_eval`` :69-92,
``partial_me_step``/``partial_me`` :95-126, ``random_fr`` :129,
``random_int`` :140)."""

from __future__ import annotations

import numpy as np
import torch

from ..field import fr, mp, planar
from ..utils import prng


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


def random_fr(key: np.ndarray, n: int, device) -> torch.Tensor:
    """(n, 8) uint32 raw Fr values drawn from `key`, those of the JAX
    package's random_fr: 8 uniform u32 limbs, the top one reduced mod
    P_TOP_LIMB (near-uniform, as the reference's FrTensor::random)."""
    bits = prng.bits(key, (n, 8))
    bits[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    return torch.from_numpy(bits).to(device)


def random_int(key: np.ndarray, n: int, num_bits: int, device) -> torch.Tensor:
    """(n, 8) raw Fr of centered num_bits-wide integers drawn from `key`:
    (u32 & (2^num_bits - 1)) - 2^(num_bits-1) mod p, as the JAX package's
    random_int."""
    small = prng.bits(key, (n,)) & np.uint32((1 << num_bits) - 1)
    t = np.zeros((8, n), dtype=np.uint32)
    t[0] = small
    offset = mp.limbs_from_int(1 << (num_bits - 1), 8)
    dev = torch.device(device)
    out = planar.sub(torch.from_numpy(t).to(dev), planar.const(offset, n, dev))
    return planar.from_planar(out).contiguous()


def _me_step_planar(tp: torch.Tensor, x) -> torch.Tensor:
    """One fold of planar (8, n): out[:, i] = t[:, 2i] + x*(t[:, 2i+1] - t[:, 2i]),
    the odd tail zero-padded. The product by the host scalar x is K2."""
    if tp.shape[1] % 2:
        tp = torch.cat([tp, torch.zeros((8, 1), dtype=tp.dtype, device=tp.device)], dim=1)
    a0, a1 = tp[:, 0::2], tp[:, 1::2]
    return planar.add(a0, planar.mul_scalar(planar.sub(a1, a0), x))


def me_step(t: torch.Tensor, x) -> torch.Tensor:
    """One multilinear-extension fold of (n, 8) Montgomery t by the host
    scalar x (8,): out[i] = t[2i] + x*(t[2i+1] - t[2i]), zero-padding an odd
    tail (fr_ops.py:me_step). Returns ((n+1)//2, 8)."""
    return planar.from_planar(_me_step_planar(planar.to_planar(t), mp.host(x))).contiguous()


def me_eval(t: torch.Tensor, u) -> torch.Tensor:
    """The MLE of (n, 8) Montgomery t at the point u ((r, 8) Montgomery
    challenges, any device) -> (8,), on t's device (fr_ops.py:me_eval).

    Folds along u[0] first, on t's natural row index (u[0] binds the lowest
    index bit); requires 2^(r-1) < n <= 2^r."""
    n, r = t.shape[0], u.shape[0]
    if not (1 << r) // 2 < n <= (1 << r):
        raise ValueError(f"me_eval: {n} rows for a {r}-variable point")
    u = mp.host(u)
    tp = planar.to_planar(t)
    for i in range(r):
        tp = _me_step_planar(tp, u[i])
    return tp[:, 0].contiguous()


def _partial_me_step_planar(tp: torch.Tensor, x, window: int) -> torch.Tensor:
    """One windowed fold of planar (8, n): windows 2w and 2w + 1 (of `window`
    columns each) become a0 + x*(a1 - a0), a short tail zero-padded. The
    product by the host scalar x is K2."""
    n = tp.shape[1]
    nw = (n + 2 * window - 1) // (2 * window)
    if n < nw * 2 * window:
        tp = torch.cat([tp, torch.zeros((8, nw * 2 * window - n), dtype=tp.dtype, device=tp.device)], dim=1)
    tw = tp.reshape(8, nw, 2, window)
    a0, a1 = tw[:, :, 0], tw[:, :, 1]
    return planar.add(a0, planar.mul_scalar(planar.sub(a1, a0), x)).reshape(8, nw * window)


def partial_me_step(t: torch.Tensor, x, window: int) -> torch.Tensor:
    """Windowed fold of (n, 8) Montgomery t by the host scalar x (8,): pairs
    windows of `window` rows, keeping the inner window axis
    (fr_ops.py:partial_me_step)."""
    tp = planar.to_planar(t).contiguous()
    return planar.from_planar(_partial_me_step_planar(tp, mp.host(x), window)).contiguous()


def partial_me(t: torch.Tensor, u, window: int) -> torch.Tensor:
    """Fold the outer axis of (n, 8) Montgomery t along every challenge of
    u ((r, 8) Montgomery, any device; u[0] first), windows of `window` rows
    (fr_ops.py:partial_me); on the planar layout, one K2 fold a level.
    Requires n > window * 2^(r-1)."""
    u = mp.host(u)
    n, r = t.shape[0], u.shape[0]
    if r == 0 or not n > window * (1 << (r - 1)):
        raise ValueError(f"partial_me: {n} rows, window {window}, {r} challenges")
    tp = planar.to_planar(t).contiguous()
    for i in range(r):
        tp = _partial_me_step_planar(tp, u[i], window)
    return planar.from_planar(tp).contiguous()
