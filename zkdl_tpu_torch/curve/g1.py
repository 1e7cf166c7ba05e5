"""BLS12-381 G1 in Jacobian coordinates: the fixed-base comb (kernel K4).

Counterpart of the parts of ``zkdl_tpu/curve/g1.py`` on the prover's path:
``G1Jac``, ``identity``, ``is_identity``, ``select``, ``double``,
``add_mixed``, ``_comb_table`` and ``generator_pow``. Points are three
uint32 (..., 12) Montgomery Fp tensors; z == 0 encodes the identity.

``generator_pow`` on a CUDA tensor launches K4 (``csrc/g1_comb.cu``), which
replaces the XLA loop of g1.py:generator_pow (:378-397): a warp walks the 64
windows of one scalar, its two teams computing the independent Fp products
of each formula level side by side, one limb per lane. On a CPU tensor it
runs ``generator_pow_plain``, the same branchless comb as the JAX code over
the plain Fp ops. Bounded on an H100 by the chain of dependent Fp products
of one scalar (5 levels per nonzero window), not by the multiply rate.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..field import fp, mp
from ..field.kernels import Kernel
from ..utils import build
from . import host_g1


class G1Jac(NamedTuple):
    """Jacobian point tensor; x, y, z: uint32 (..., 12) Fp in Montgomery form."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def shape(self):
        return self.x.shape[:-1]


COMB = Kernel("g1_comb", "zkdl_tpu_torch/csrc/g1_comb.cu", "zkdl_tpu/curve/g1.py:378")

_COMB_W = 4
_COMB_WINDOWS = 256 // _COMB_W


def identity(shape=(), device="cpu") -> G1Jac:
    z = torch.zeros((*shape, 12), dtype=torch.uint32, device=device)
    return G1Jac(z, z.clone(), z.clone())


def is_identity(p: G1Jac) -> torch.Tensor:
    return (mp.i64(p.z) == 0).all(-1)


def select(pred: torch.Tensor, a: G1Jac, b: G1Jac) -> G1Jac:
    pe = pred.unsqueeze(-1)
    return G1Jac(mp.where(pe, a.x, b.x), mp.where(pe, a.y, b.y), mp.where(pe, a.z, b.z))


# --- plain formulas on the limb-leading int64 working form (fp.*_w) ---------


def _select_w(pred, a, b):
    return tuple(torch.where(pred.unsqueeze(0), u, v) for u, v in zip(a, b))


def _muls_w(*pairs):
    """Independent Fp products in one batched call (fewer, larger ops)."""
    a = torch.stack([p[0] for p in pairs], dim=1)
    b = torch.stack([p[1] for p in pairs], dim=1)
    return fp.mul_w(a, b).unbind(1)


def _double_w(p):
    """dbl-2009-l with identity passthrough (g1.py:double :90-103)."""
    x, y, z = p
    a, b, yz = _muls_w((x, x), (y, y), (y, z))
    (c,) = _muls_w((b, b))
    xb = fp.add_w(x, b)
    e = fp.add_w(fp.double_w(a), a)
    d, f = _muls_w((xb, xb), (e, e))
    d = fp.double_w(fp.sub_w(fp.sub_w(d, a), c))
    z3 = fp.double_w(yz)
    x3 = fp.sub_w(fp.sub_w(f, d), d)
    c8 = fp.double_w(fp.double_w(fp.double_w(c)))
    (y3,) = _muls_w((fp.sub_w(d, x3), e))
    y3 = fp.sub_w(y3, c8)
    return _select_w(fp.is_zero_w(z), p, (x3, y3, z3))


def _add_mixed_w(p, qx, qy):
    """madd-2007-bl with the edge cases of g1.py:add_mixed (:135-158): equal
    points take double(p) (computed only when some element needs it), the
    identity takes the lifted q."""
    x, y, z = p
    qx, qy = qx.expand_as(x), qy.expand_as(x)
    z1z1, qyz = _muls_w((z, z), (qy, z))
    u2, s2 = _muls_w((qx, z1z1), (qyz, z1z1))
    h = fp.sub_w(u2, x)
    r = fp.double_w(fp.sub_w(s2, y))
    zh = fp.add_w(z, h)
    hh, rr, zh2 = _muls_w((h, h), (r, r), (zh, zh))
    i = fp.double_w(fp.double_w(hh))
    j, v = _muls_w((h, i), (x, i))
    x3 = fp.sub_w(fp.sub_w(rr, j), fp.double_w(v))
    y3a, yj = _muls_w((fp.sub_w(v, x3), r), (y, j))
    y3 = fp.sub_w(y3a, fp.double_w(yj))
    z3 = fp.sub_w(fp.sub_w(zh2, z1z1), hh)
    out = (x3, y3, z3)
    same = fp.eq_w(x, u2) & fp.eq_w(y, s2)
    if bool(same.any()):
        out = _select_w(same, _double_w(p), out)
    one = mp.const(fp.ONE_MONT, x).expand_as(x)
    return _select_w(fp.is_zero_w(z), (qx, qy, one), out)


def double(p: G1Jac) -> G1Jac:
    out = _double_w(tuple(fp.to_work(c) for c in p))
    return G1Jac(*(fp.from_work(c) for c in out))


def add_mixed(p: G1Jac, qx: torch.Tensor, qy: torch.Tensor) -> G1Jac:
    """p + (qx, qy) for an affine point q (never the identity)."""
    out = _add_mixed_w(tuple(fp.to_work(c) for c in p), fp.to_work(qx), fp.to_work(qy))
    return G1Jac(*(fp.from_work(c) for c in out))


# --- fixed-base comb ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _comb_table() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-precomputed (64, 16, 12) Montgomery-Fp affine x and y of
    k * 2^(4j) * G, and an identity mask (64, 16) (k = 0 slots are zero
    placeholders, never read). Same table as g1.py:_comb_table."""
    n_w, n_k = _COMB_WINDOWS, 1 << _COMB_W
    xs = np.zeros((n_w, n_k, 12), dtype=np.uint32)
    ys = np.zeros((n_w, n_k, 12), dtype=np.uint32)
    ident = np.zeros((n_w, n_k), dtype=bool)
    row = [host_g1.IDENTITY, host_g1.GENERATOR]
    for k in range(2, n_k):
        row.append(host_g1.add(row[k - 1], host_g1.GENERATOR))
    for j in range(n_w):
        for k in range(n_k):
            aff = host_g1.to_affine(row[k])
            if aff is None:
                ident[j, k] = True
            else:
                xs[j, k] = mp.limbs_from_int(fp.SPEC.to_mont_int(aff[0]), 12)
                ys[j, k] = mp.limbs_from_int(fp.SPEC.to_mont_int(aff[1]), 12)
        if j + 1 < n_w:
            for _ in range(_COMB_W):
                row = [host_g1.double(p) for p in row]
    return xs, ys, ident


@functools.lru_cache(maxsize=None)
def _comb_table_on(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    xs, ys, _ = _comb_table()
    return torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)


def _digits(scalar: torch.Tensor) -> torch.Tensor:
    """(N, 8) raw scalars -> (N, 64) 4-bit windows, LSB first."""
    shifts = torch.arange(0, 32, _COMB_W, device=scalar.device)
    d = (mp.i64(scalar).unsqueeze(-1) >> shifts) & 15
    return d.reshape(scalar.shape[0], _COMB_WINDOWS)


def generator_pow_plain(scalar: torch.Tensor) -> G1Jac:
    """G ^ scalar, plain PyTorch: the branchless comb of g1.py:generator_pow
    (64 add_mixed + select steps) over the plain Fp ops."""
    n = scalar.shape[0]
    tx, ty = _comb_table_on(scalar.device)
    digits = _digits(scalar)
    zero = torch.zeros((12, n), dtype=torch.int64, device=scalar.device)
    out = (zero, zero, zero)
    for j in range(_COMB_WINDOWS):
        d = digits[:, j]
        qx = fp.to_work(mp.take(tx[j], d, 0))
        qy = fp.to_work(mp.take(ty[j], d, 0))
        added = _add_mixed_w(out, qx, qy)
        out = _select_w(d == 0, out, added)
    return G1Jac(*(fp.from_work(c) for c in out))


def _comb_lib() -> ctypes.CDLL:
    lib = build.load("g1_comb")
    if not getattr(lib, "_zk_typed", False):
        P = ctypes.c_void_p
        lib.zk_g1_comb.argtypes = [P, P, P, P, P, P, ctypes.c_longlong, P, ctypes.c_int]
        lib.zk_g1_comb.restype = ctypes.c_int
        lib._zk_typed = True
    return lib


def generator_pow(scalar: torch.Tensor) -> G1Jac:
    """G ^ scalar for raw (non-Montgomery) uint32 (..., 8) scalars; all 256
    bits are used. Group-equal to double-and-add, and limb-for-limb equal to
    zkdl_tpu's generator_pow (same comb, same formulas)."""
    if scalar.dtype != torch.uint32 or scalar.shape[-1] != 8:
        raise ValueError(f"expected uint32 (..., 8) scalars, got {scalar.dtype} {tuple(scalar.shape)}")
    lead = scalar.shape[:-1]
    s2 = scalar.reshape(-1, 8)
    n = s2.shape[0]
    if scalar.device.type == "cpu":
        out = generator_pow_plain(s2)
    elif scalar.device.type == "cuda":
        s2 = s2.contiguous()
        tx, ty = _comb_table_on(scalar.device)
        pts = torch.empty((3, n, 12), dtype=torch.uint32, device=scalar.device)
        if n:
            idx = scalar.device.index
            rc = _comb_lib().zk_g1_comb(
                s2.data_ptr(), tx.data_ptr(), ty.data_ptr(),
                pts[0].data_ptr(), pts[1].data_ptr(), pts[2].data_ptr(), n,
                torch._C._cuda_getCurrentRawStream(idx), idx,
            )
            if rc != 0:
                raise RuntimeError(f"g1_comb: CUDA error {rc}")
            COMB.launches += 1
        out = G1Jac(*pts)
    else:
        raise ValueError(f"unsupported device {scalar.device}")
    return G1Jac(*(c.reshape(*lead, 12) for c in out))
