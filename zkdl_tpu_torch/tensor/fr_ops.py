"""Shape helpers, keyed draws, sums and the MLE evaluations of
``zkdl_tpu/tensor/fr_ops.py`` (``fr_sum`` :43, ``me_step``/``me_eval``
:69-92, ``partial_me_step``/``partial_me`` :95-126, ``random_fr`` :129,
``random_int`` :140, ``from_u32`` :151), and the (n, 8) Montgomery tensors
of small integers that the attention circuits build (``mont_from_u64``,
``mont_bits``), and the remaining (n, 8) element ops of
``zkdl_tpu/field/fr.py`` (:37-58: ``double``, ``sqr``, ``unmont``,
``pow_static``, ``is_zero``, ``eq``, ``select``, ``zeros``), each on the
planar kernels (K1, K2) or plain integer code."""

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


def fr_sum(t: torch.Tensor) -> torch.Tensor:
    """Modular sum of the (n, 8) elements -> (8,) (fr_ops.py:fr_sum; one
    value whatever the order)."""
    if t.shape[0] == 0:
        return torch.zeros(8, dtype=torch.uint32, device=t.device)
    return planar.lazy_sum(planar.to_planar(t)).contiguous()


def from_u32(vals: torch.Tensor) -> torch.Tensor:
    """Lift (n,) integers below 2^32 into (n, 8) raw Fr limbs."""
    out = torch.zeros((*vals.shape, 8), dtype=torch.int64, device=vals.device)
    out[..., 0] = mp.i64(vals) if vals.dtype == torch.uint32 else vals.to(torch.int64) & mp.M32
    return mp.u32(out)


def _rows(p: torch.Tensor) -> torch.Tensor:
    return planar.from_planar(p).contiguous()


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise (a + b) mod p of (n, 8) tensors (b may broadcast)."""
    return _rows(planar.add(planar.to_planar(a), planar.to_planar(b)))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _rows(planar.sub(planar.to_planar(a), planar.to_planar(b)))


def neg(a: torch.Tensor) -> torch.Tensor:
    return _rows(planar.neg(planar.to_planar(a)))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery product of (n, 8) tensors (K1); b may
    broadcast."""
    a, b = torch.broadcast_tensors(a, b)
    return _rows(planar.mul(planar.to_planar(a), planar.to_planar(b)))


def double(a: torch.Tensor) -> torch.Tensor:
    return _rows(planar.double(planar.to_planar(a)))


def sqr(a: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery square (K1)."""
    return mul(a, a)


def pow_static(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e elementwise for (n, 8) Montgomery a and a host exponent e >= 0,
    square and multiply from e's top bit (K1); one value whatever the
    order (fr.py:pow_static)."""
    out = ones_mont(a.shape[0], a.device)
    for b in range(int(e).bit_length() - 1, -1, -1):
        out = sqr(out)
        if (e >> b) & 1:
            out = mul(out, a)
    return out


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """(n, 8) -> bool (n,)."""
    return (a.view(torch.int32) == 0).all(-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.view(torch.int32) == b.view(torch.int32)).all(-1)


def select(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where(pred, a, b) of (n, 8) tensors, pred bool (n,)."""
    return mp.where(pred.unsqueeze(-1), a, b)


def zeros(n: int, device) -> torch.Tensor:
    return torch.zeros((n, 8), dtype=torch.uint32, device=device)


def ones_mont(n: int, device) -> torch.Tensor:
    """(n, 8) Montgomery ones."""
    return _rows(planar.ones_mont(n, device))


def const(limbs, n: int, device) -> torch.Tensor:
    """(n, 8) copies of one host element."""
    return _rows(planar.const(limbs, n, device))


def to_mont(t: torch.Tensor) -> torch.Tensor:
    """(n, 8) raw -> (n, 8) Montgomery (K2)."""
    return planar.from_planar(planar.to_mont(planar.to_planar(t))).contiguous()


def unmont(t: torch.Tensor) -> torch.Tensor:
    """(n, 8) Montgomery -> (n, 8) raw (K2)."""
    return planar.from_planar(planar.from_mont(planar.to_planar(t))).contiguous()


def mont_from_u64(vals, device) -> torch.Tensor:
    """(n,) unsigned integers (numpy) -> (n, 8) Montgomery Fr of their LOW 32
    bits. The JAX package builds these tensors with 64-bit types disabled
    (``zksoftmax._mont_from_u64``: ``jnp.asarray`` of a uint64 array keeps
    the low 32 bits and the high limb shifts out to 0), so the port keeps
    exactly those bits."""
    low = torch.from_numpy(np.asarray(vals).astype(np.uint64) & np.uint64(0xFFFFFFFF)).to(torch.int64)
    return to_mont(from_u32(low.to(device)))


def bits_of(vals, width: int, device) -> torch.Tensor:
    """(n,) unsigned integers (numpy) -> (n * width,) 0/1 uint32, bit k of
    element j at j * width + k, from the LOW 32 bits of each value
    (zksoftmax._bits_tensor: 64-bit types are disabled there, so bits 32
    and up are 0)."""
    low = torch.from_numpy(np.asarray(vals).astype(np.uint64) & np.uint64(0xFFFFFFFF)).to(torch.int64).to(device)
    shifts = torch.arange(width, device=device)
    bits = torch.where(shifts < 32, (low[:, None] >> shifts.clamp(max=31)) & 1, 0)
    return mp.u32(bits.reshape(-1))


def mont_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N,) 0/1 uint32 -> (N, 8) Montgomery Fr: mont(1) where set, else 0."""
    one = torch.from_numpy(fr.ONE_MONT.view(np.int32)).to(bits.device)
    return torch.where((bits.view(torch.int32) != 0)[:, None], one, 0).view(torch.uint32)


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
