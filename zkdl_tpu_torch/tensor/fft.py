"""Radix-2 NTT over Fr: ``ntt``, ``intt``, ``poly_mul`` and kernel K10.

Counterpart of ``zkdl_tpu/tensor/fft.py``: the constants (``TWO_ADICITY``,
``ROOT_INT``), ``_omega`` and ``_bitrev_perm`` are copied; ``_ntt_core``
(:71-85: a bit-reversal permutation, then log n stages of butterflies
lo +- hi w^j on an (n/m, m, 8) view, the inverse ending with a product
by n^-1) is K10 (``csrc/fr_ntt.cu``) on a CUDA
tensor and ``ntt_plain`` on a CPU one. Fr values have one reduced form, so
both are bit-equal to the JAX function.

Both take their twiddles from one table of n/2 values W[k] = w^k
(``twiddles``): stage s's w_s^j is W[j n / 2^s]. The table is built on the
tensor's device by doubling (log n products by host powers of w, K2 on the
card) once per size and direction, and kept.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..field import fr, kernels, mp, planar
from ..field.kernels import Kernel
from ..utils import build
from . import fr_ops

TWO_ADICITY = 32
assert (fr.P_INT - 1) % (1 << TWO_ADICITY) == 0
assert (fr.P_INT - 1) % (1 << (TWO_ADICITY + 1)) != 0

# primitive 2^32-th root of unity (value domain)
ROOT_INT = pow(7, (fr.P_INT - 1) >> TWO_ADICITY, fr.P_INT)
assert pow(ROOT_INT, 1 << (TWO_ADICITY - 1), fr.P_INT) == fr.P_INT - 1, "7 must generate the full 2-adic subgroup"

NTT = Kernel("fr_ntt", "zkdl_tpu_torch/csrc/fr_ntt.cu", "zkdl_tpu/tensor/fft.py:71")
KERNELS = (NTT,)


@functools.lru_cache(maxsize=None)
def _omega(log_n: int, inverse: bool) -> int:
    assert log_n <= TWO_ADICITY
    w = pow(ROOT_INT, 1 << (TWO_ADICITY - log_n), fr.P_INT)
    if inverse:
        w = pow(w, fr.P_INT - 2, fr.P_INT)
    return w


@functools.lru_cache(maxsize=None)
def _bitrev_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _mont_limbs(v: int) -> np.ndarray:
    return mp.limbs_from_int(v * fr.SPEC.r % fr.P_INT, 8)


@functools.lru_cache(maxsize=None)
def twiddles(log_n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """(n/2, 8) Montgomery W[k] = w^k, w = _omega(log_n, inverse), on
    `device`: W[k:2k] = W[:k] w^k for k = 1, 2, 4, ... (products by host
    scalars, K2 on the card). Empty for log_n = 0."""
    half = (1 << log_n) // 2
    w = _omega(log_n, inverse)
    t = torch.empty((8, half), dtype=torch.uint32, device=device)
    if half:
        t[:, :1] = torch.from_numpy(_mont_limbs(1).reshape(8, 1)).to(device)
    k = 1
    while k < half:
        t[:, k : 2 * k] = planar.mul_scalar(t[:, :k].contiguous(), _mont_limbs(pow(w, k, fr.P_INT)))
        k *= 2
    return planar.from_planar(t).contiguous()


def _n_inv(log_n: int) -> np.ndarray:
    """n^-1 R mod p, the inverse's last factor (fft.py:83)."""
    return mp.limbs_from_int(pow(1 << log_n, fr.P_INT - 2, fr.P_INT) * fr.SPEC.r % fr.P_INT, 8)


def ntt_plain(a: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """_ntt_core in plain PyTorch on any device: (n, 8) Montgomery -> (n, 8)."""
    n = 1 << log_n
    p = mp.take(planar.to_planar(a), torch.from_numpy(_bitrev_perm(log_n)).to(a.device), 1)
    W = planar.to_planar(twiddles(log_n, inverse, a.device))
    for s in range(1, log_n + 1):
        m = 1 << s
        tw = W[:, :: n // m][:, : m // 2]
        v = p.reshape(8, n // m, m)
        lo, hi = v[:, :, : m // 2], v[:, :, m // 2 :]
        t = kernels.mul_plain(hi.contiguous(), tw.unsqueeze(1).expand(8, n // m, m // 2).contiguous())
        p = torch.cat([planar.add(lo, t), planar.sub(lo, t)], dim=2).reshape(8, n)
    if inverse:
        p = kernels.mul_scalar_plain(p.contiguous(), _n_inv(log_n))
    return planar.from_planar(p).contiguous()


def _lib() -> ctypes.CDLL:
    lib = build.load("fr_ntt")
    if not getattr(lib, "_zk_typed", False):
        P = ctypes.c_void_p
        lib.zk_fr_ntt.argtypes = [P, P, P, ctypes.c_int, ctypes.c_int, P, P, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int)]
        lib.zk_fr_ntt.restype = ctypes.c_int
        lib._zk_typed = True
    return lib


def _ntt_core(a: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    if a.dtype != torch.uint32 or a.dim() != 2 or a.shape != (1 << log_n, 8):
        raise ValueError(f"ntt: expected uint32 ({1 << log_n}, 8), got {a.dtype} {tuple(a.shape)}")
    if a.device.type == "cpu":
        return ntt_plain(a, log_n, inverse)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    src = a.contiguous()
    tw = twiddles(log_n, inverse, a.device)
    out = torch.empty_like(src)
    scale = np.ascontiguousarray(_n_inv(log_n))
    idx = a.device.index
    launched = ctypes.c_int(0)
    rc = _lib().zk_fr_ntt(src.data_ptr(), out.data_ptr(), tw.data_ptr() if tw.numel() else None, log_n,
                          int(inverse), scale.ctypes.data, torch._C._cuda_getCurrentRawStream(idx), idx,
                          ctypes.byref(launched))
    NTT.launches += launched.value  # the local stages' launch and one a stage above them
    if rc != 0:
        raise RuntimeError(f"{NTT.name}: CUDA error {rc}")
    return out


def _log_n(a: torch.Tensor) -> int:
    n = a.shape[0]
    log_n = n.bit_length() - 1
    if n != 1 << log_n or log_n > TWO_ADICITY:
        raise ValueError(f"NTT size must be a power of two <= 2^32, got {n}")
    return log_n


def ntt(a: torch.Tensor) -> torch.Tensor:
    """Forward NTT of a (n, 8) Montgomery Fr tensor, n = 2^k."""
    return _ntt_core(a, _log_n(a), False)


def intt(a: torch.Tensor) -> torch.Tensor:
    """Inverse NTT (exact: intt(ntt(x)) == x)."""
    return _ntt_core(a, _log_n(a), True)


def poly_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Polynomial product via NTT: coefficients (na, 8) x (nb, 8) -> (na + nb
    - 1 padded to 2^k, 8), a zero-padded convolution (fft.py:poly_mul)."""
    n = 1 << fr_ops.ceil_log2(a.shape[0] + b.shape[0] - 1)
    fa = ntt(fr_ops.pad_to(a, n))
    fb = ntt(fr_ops.pad_to(b, n))
    return intt(fr_ops.mul(fa, fb))
