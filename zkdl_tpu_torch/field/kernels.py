"""Planar Fr kernels K1-K3: CUDA wrappers, their plain versions, launch counts.

Counterpart of ``zkdl_tpu/field/pallas_fr.py``. Each wrapper takes planar
uint32 (8, ...) tensors. On a CPU tensor it runs the plain PyTorch version;
on a CUDA tensor it launches the kernel of ``csrc/fr_kernels.cu`` (built at
first use) or raises: there is no fallback between the two.

| wrapper      | kernel             | replaces (TPU)                        |
| ------------ | ------------------ | ------------------------------------- |
| mul          | K1 fr_mul          | pallas_fr.py:_mul_kernel (:156)       |
| mul_scalar   | K2 fr_mul_scalar   | pallas_fr.py:_mul_scalar_kernel (:163)|
| dot/dot_many | K3 fr_dot          | pallas_fr.py:_dot_cols_kernel (:186)  |

Bounds on an H100 (csrc/fr_kernels.cu has the derivation): all three are
memory-bound, K1/K2 at 96/64 B per element, K3 at 64 B per element read.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..utils import build
from . import mp
from .fr import SPEC

N_LIMBS = 8
SOURCE = "zkdl_tpu_torch/csrc/fr_kernels.cu"
_PLAIN_CHUNK = 1 << 16  # columns per plain-version step (bounds its int64 temporaries)
_DOT_THREADS = 256
_DOT_TARGET_BLOCKS = 1056  # 8 blocks per SM on 132 SMs


@dataclasses.dataclass
class Kernel:
    """A hand-written kernel's identity and its launch count (incremented by
    its wrapper once per launch, never by the plain version)."""

    name: str
    source: str
    replaces: str
    launches: int = 0


MUL = Kernel("fr_mul", SOURCE, "zkdl_tpu/field/pallas_fr.py:156")
MUL_SCALAR = Kernel("fr_mul_scalar", SOURCE, "zkdl_tpu/field/pallas_fr.py:163")
DOT = Kernel("fr_dot", SOURCE, "zkdl_tpu/field/pallas_fr.py:186")
KERNELS = (MUL, MUL_SCALAR, DOT)

_P = ctypes.c_void_p
_I = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.load("fr_kernels")
    if not getattr(lib, "_zk_typed", False):
        lib.zk_fr_mul.argtypes = [_P, _I, _P, _I, _P, _I, _P]
        lib.zk_fr_mul_scalar.argtypes = [_P, _I, _P, _P, _I, _P]
        lib.zk_fr_dot.argtypes = [_P, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P]
        for f in (lib.zk_fr_mul, lib.zk_fr_mul_scalar, lib.zk_fr_dot):
            f.restype = ctypes.c_int
        lib._zk_typed = True
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _check_planar(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.uint32 or t.dim() < 1 or t.shape[0] != N_LIMBS:
            raise ValueError(f"expected planar uint32 (8, ...), got {t.dtype} {tuple(t.shape)}")


def _on_cuda(*ts: torch.Tensor) -> bool:
    """False for CPU tensors (plain version); True for CUDA ones. Mixed or
    other devices raise."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def _rows(x: torch.Tensor):
    """(8, ...) -> (8, N) with unit element stride, and its limb stride."""
    r = x.reshape(N_LIMBS, -1)
    if r.shape[1] > 1 and r.stride(1) != 1:
        r = r.contiguous()
    return r, r.stride(0)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _host_scalar(s) -> np.ndarray:
    if isinstance(s, torch.Tensor):
        if s.device.type != "cpu":
            raise TypeError("mul_scalar takes a host scalar (challenges live on the host)")
        s = s.numpy()
    s = np.ascontiguousarray(np.asarray(s, dtype=np.uint32).reshape(N_LIMBS))
    return s


# ---------------------------------------------------------------------------
# plain versions (CPU path and on-card reference)
# ---------------------------------------------------------------------------


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery product, plain PyTorch (radix-2^16 REDC)."""
    shape = a.shape
    a2, b2 = a.reshape(N_LIMBS, -1), b.reshape(N_LIMBS, -1)
    n = a2.shape[1]
    out = torch.empty((N_LIMBS, n), dtype=torch.uint32, device=a.device)
    for s in range(0, n, _PLAIN_CHUNK):
        e = min(n, s + _PLAIN_CHUNK)
        out[:, s:e] = mp.u32(mp.mont_mul(SPEC, mp.i64(a2[:, s:e]), mp.i64(b2[:, s:e])))
    return out.reshape(shape)


def mul_scalar_plain(a: torch.Tensor, s) -> torch.Tensor:
    st = torch.from_numpy(_host_scalar(s)).to(a.device)
    st = st.reshape((N_LIMBS,) + (1,) * (a.dim() - 1)).expand(a.shape)
    return mul_plain(a, st)


def _lift_plain(hi: torch.Tensor) -> torch.Tensor:
    return mp.mont_mul(SPEC, hi, mp.const(SPEC.R2_limbs, hi))


def dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_e mont(a_e * b_e) mod p over the last axis; broadcasts batch dims."""
    a, b = torch.broadcast_tensors(a, b)
    if a.shape[-1] == 0:
        return torch.zeros(a.shape[:-1], dtype=torch.uint32, device=a.device)
    prod = mp.i64(mul_plain(a.contiguous(), b.contiguous()))
    return mp.u32(mp.reduce_digit_sums(SPEC, mp.digit_sums(prod), _lift_plain))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery product a*b*R^-1 of planar (8, ...) tensors of
    one shape (broadcast beforehand). Bit-identical to pallas_fr.mul."""
    _check_planar(a, b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if not _on_cuda(a, b):
        return mul_plain(a, b)
    a2, sa = _rows(a)
    b2, sb = _rows(b)
    n = a2.shape[1]
    out = torch.empty((N_LIMBS, n), dtype=torch.uint32, device=a.device)
    if n:
        with torch.cuda.device(a.device):
            rc = _lib().zk_fr_mul(a2.data_ptr(), sa, b2.data_ptr(), sb, out.data_ptr(), n, _stream(a))
        _check(rc, "fr_mul")
        MUL.launches += 1
    return out.reshape(a.shape)


def mul_scalar(a: torch.Tensor, s) -> torch.Tensor:
    """a * s for planar a (8, ...) and a HOST scalar s (8,) u32 (numpy array
    or CPU tensor), passed to the kernel by value. Montgomery."""
    _check_planar(a)
    sv = _host_scalar(s)
    if not _on_cuda(a):
        return mul_scalar_plain(a, sv)
    a2, sa = _rows(a)
    n = a2.shape[1]
    out = torch.empty((N_LIMBS, n), dtype=torch.uint32, device=a.device)
    if n:
        with torch.cuda.device(a.device):
            rc = _lib().zk_fr_mul_scalar(a2.data_ptr(), sa, sv.ctypes.data, out.data_ptr(), n, _stream(a))
        _check(rc, "fr_mul_scalar")
        MUL_SCALAR.launches += 1
    return out.reshape(a.shape)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Modular sum of elementwise Montgomery products over the LAST axis.

    a, b: planar (8, *batch, n); one of them may carry size-1 batch dims (a
    table shared by every batch entry, e.g. (8, M, n) . (8, 1, n)).
    Returns (8, *batch). Bit-identical to zkdl_tpu planar.dot / pallas_fr.dot.
    """
    _check_planar(a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if not _on_cuda(a, b):
        return dot_plain(a, b)
    n = shape[-1]
    batch = shape[1:-1]
    B = int(np.prod(batch)) if batch else 1
    if a.shape != shape:  # put the full operand first (the product commutes)
        a, b = b, a
    if a.shape != shape:
        raise ValueError(f"dot: neither operand has the full shape {tuple(shape)}")
    out = torch.empty((N_LIMBS, B), dtype=torch.uint32, device=a.device)
    if n == 0:
        return out.zero_().reshape((N_LIMBS, *batch))
    a3 = a.reshape(N_LIMBS, B, n)
    if a3.stride(2) != 1:
        a3 = a3.contiguous()
    if b.shape == shape:
        b3 = b.reshape(N_LIMBS, B, n)
        if b3.stride(2) != 1:
            b3 = b3.contiguous()
        sb0, sb1 = b3.stride(0), b3.stride(1)
    else:  # shared table: every batch entry reads the same (8, n)
        b3 = b.reshape(N_LIMBS, n)
        if b3.stride(1) != 1:
            b3 = b3.contiguous()
        sb0, sb1 = b3.stride(0), 0
    G = max(1, min(-(-n // (_DOT_THREADS * 8)), _DOT_TARGET_BLOCKS // B))
    partials = torch.empty((B * G * N_LIMBS,), dtype=torch.uint32, device=a.device)
    with torch.cuda.device(a.device):
        rc = _lib().zk_fr_dot(
            a3.data_ptr(), a3.stride(0), a3.stride(1), b3.data_ptr(), sb0, sb1,
            n, B, G, partials.data_ptr(), out.data_ptr(), _stream(a),
        )
    _check(rc, "fr_dot")
    DOT.launches += 1
    return out.reshape((N_LIMBS, *batch))


def dot_many(pairs) -> torch.Tensor:
    """[(a, b), ...] flat dots -> (8, len(pairs))."""
    return torch.stack([dot(a, b) for a, b in pairs], dim=1)
