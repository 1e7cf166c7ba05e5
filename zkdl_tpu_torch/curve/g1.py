"""BLS12-381 G1 in Jacobian coordinates: the fixed-base comb (kernel K4) and
the variable-base arithmetic (kernels K5, K6 and K8).

Counterpart of ``zkdl_tpu/curve/g1.py``: ``G1Jac``, ``identity``,
``is_identity``, ``neg``, ``select``, ``double``, ``add``, ``add_mixed``,
``scalar_mul``, the GLV split (``glv_decompose``, ``endomorphism``,
``_window_digits``, ``_mk_table``) and ``scalar_mul_glv``, ``_comb_table``,
``generator_pow``, ``g1_sum``, ``me_step`` and ``me_eval``. Points are three
uint32 (..., 12) Montgomery Fp tensors; z == 0 encodes the identity.

``generator_pow`` on a CUDA tensor launches K4 (``csrc/g1_comb.cu``), which
replaces the XLA loop of g1.py:generator_pow (:378-397): a warp walks the 64
windows of one scalar, its two teams computing the independent Fp products
of each formula level side by side, one limb per lane. On a CPU tensor it
runs ``generator_pow_plain``, the same branchless comb as the JAX code over
the plain Fp ops. Bounded on an H100 by the chain of dependent Fp products
of one scalar (5 levels per nonzero window), not by the multiply rate.

``scalar_mul`` on CUDA tensors launches K5 and ``add`` (with the tree sums
``g1_sum``/``sum_rows``, the bit-masked first level ``add_bits`` and the
MLE folds built on it) K6, both in ``csrc/g1_var.cu``; the formulas of
g1.py:add (:106-132), double (:90-103) and scalar_mul (:168-184) value for
value, so the Jacobian limbs equal the JAX package's. K5 runs a point's
products on two teams of lanes (K4's teams, ``csrc/fp_team.cuh``), one,
four or sixteen points a warp, chosen by the launch's size
(``SCALAR_MUL_FORMS``). K6 lists each block's generic pairs and runs them
densely, one thread an add. On CPU tensors they run ``scalar_mul_plain``/``add_plain``/``add_bits_plain``.

``scalar_mul_glv`` on CUDA tensors launches K8 (``csrc/g1_glv.cu``), which
replaces the XLA loop of g1.py:scalar_mul_glv (:302-326) limb for limb: the
scalar split in the kernel, a point's two 16-entry tables in shared memory
or in a device scratch, the window walk on K8's own carry-chain Fp product
(``csrc/fp_chain.cuh``) in the forms of ``GLV_FORMS``. On CPU tensors it
runs ``scalar_mul_glv_plain``.

``scalar_mul_windowed`` on CUDA tensors launches K13 (``csrc/g1_win.cu``),
which replaces the XLA loop of g1.py:scalar_mul_windowed (:187-214) limb
for limb: a point's 16-entry table, then 64 4-bit windows from the top,
four doubles and one add each, on K8's lane teams and formulas
(``csrc/g1_team.cuh``) in the forms of ``WINDOWED_FORMS``. On CPU tensors
it runs ``scalar_mul_windowed_plain``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..field import fp, fr, host, mp
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
SCALAR_MUL = Kernel("g1_scalar_mul", "zkdl_tpu_torch/csrc/g1_var.cu", "zkdl_tpu/curve/g1.py:168")
ADD = Kernel("g1_add", "zkdl_tpu_torch/csrc/g1_var.cu", "zkdl_tpu/curve/g1.py:106")
GLV = Kernel("g1_scalar_mul_glv", "zkdl_tpu_torch/csrc/g1_glv.cu", "zkdl_tpu/curve/g1.py:302")
KERNELS = (COMB, SCALAR_MUL, ADD, GLV)  # the kernels of the MLP's and the attention block's paths
WINDOWED = Kernel("g1_scalar_mul_windowed", "zkdl_tpu_torch/csrc/g1_win.cu", "zkdl_tpu/curve/g1.py:187")
# K5's layouts (csrc/g1_var.cu): chosen by the launch's size, or forced
SCALAR_MUL_FORMS = {"auto": 0, "warp": 1, "quad": 2, "pair": 3}
# K8's forms (csrc/g1_glv.cu): four lanes a point with the tables in shared
# memory, two lanes a point with the tables in a device scratch; chosen by
# the launch's size, or forced
GLV_FORMS = {"auto": 0, "four": 1, "pair": 2}
# K13's forms (csrc/g1_win.cu): K8's layouts with one table a point, in
# shared memory (four) or in a device scratch (pair)
WINDOWED_FORMS = {"auto": 0, "four": 1, "pair": 2}

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


def _add_w(p, q):
    """add-2007-bl with the edge cases of g1.py:add (:106-132), in its select
    order: equal points take double(p) (computed only when some element
    needs it), then q == O takes p, then p == O takes q. p = -q runs the
    generic formula to z3 = 0."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2, y1z2, y2z1 = _muls_w((z1, z1), (z2, z2), (y1, z2), (y2, z1))
    u1, u2, s1, s2 = _muls_w((x1, z2z2), (x2, z1z1), (y1z2, z2z2), (y2z1, z1z1))
    h = fp.sub_w(u2, u1)
    h2 = fp.double_w(h)
    r = fp.double_w(fp.sub_w(s2, s1))
    zz = fp.add_w(z1, z2)
    i, rr, zz2 = _muls_w((h2, h2), (r, r), (zz, zz))
    j, v = _muls_w((h, i), (u1, i))
    x3 = fp.sub_w(fp.sub_w(fp.sub_w(rr, j), v), v)
    y3a, s1j, z3 = _muls_w((fp.sub_w(v, x3), r), (s1, j), (fp.sub_w(fp.sub_w(zz2, z1z1), z2z2), h))
    out = (x3, fp.sub_w(y3a, fp.double_w(s1j)), z3)
    same = fp.eq_w(u1, u2) & fp.eq_w(s1, s2)
    if bool(same.any()):
        out = _select_w(same, _double_w(p), out)
    out = _select_w(fp.is_zero_w(z2), p, out)
    return _select_w(fp.is_zero_w(z1), q, out)


def _neg_w(p):
    """(x, 0 - y mod p, z): g1.py:neg with fp.neg = mod_sub(0, y)."""
    x, y, z = p
    return x, fp.sub_w(torch.zeros_like(y), y), z


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


# --- variable-base arithmetic: K5 (scalar_mul) and K6 (add) ----------------

_PLAIN_CHUNK = 1 << 15  # points per step of the plain versions (bounds their temporaries)


def _flat(p: G1Jac) -> G1Jac:
    return G1Jac(*(c.reshape(-1, 12) for c in p))


def _device(*ts: torch.Tensor) -> torch.device:
    """The one device of the operands: CPU (plain versions) or CUDA
    (kernels); mixed or other devices raise."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_points(*ps: G1Jac) -> None:
    for p in ps:
        for c in p:
            if c.dtype != torch.uint32 or c.shape[-1] != 12:
                raise ValueError(f"expected uint32 (..., 12) coordinates, got {c.dtype} {tuple(c.shape)}")


def _chunked(n: int, step):
    """Concatenate step(lo, hi) (each a G1Jac of (hi - lo,) points) over
    chunks of the n points."""
    parts = [step(lo, min(lo + _PLAIN_CHUNK, n)) for lo in range(0, n, _PLAIN_CHUNK)]
    if not parts:
        return None
    return G1Jac(*(torch.cat([getattr(q, c) for q in parts]) for c in ("x", "y", "z")))


def _work(p: G1Jac, lo: int, hi: int):
    return tuple(fp.to_work(c[lo:hi]) for c in p)


def _stored(w) -> G1Jac:
    return G1Jac(*(fp.from_work(c) for c in w))


def add_plain(p: G1Jac, q: G1Jac, neg_q: bool = False) -> G1Jac:
    """add(p, -q if neg_q else q) of (n,) point vectors, plain PyTorch."""
    p, q = _flat(p), _flat(q)
    n = p.x.shape[0]

    def step(lo, hi):
        qw = _work(q, lo, hi)
        return _stored(_add_w(_work(p, lo, hi), _neg_w(qw) if neg_q else qw))

    return _chunked(n, step) or identity((0,), p.x.device)


def _leaves(bits: torch.Tensor, gens: G1Jac) -> G1Jac:
    """bits[e] != 0 ? G[e mod gen] : O for every e (the masked leaves of
    pedersen._commit_bits_rows)."""
    gen = gens.x.shape[0]
    idx = torch.arange(bits.shape[0], device=bits.device) % gen
    g = G1Jac(*(mp.take(c, idx, 0) for c in gens))
    return select(bits.view(torch.int32) != 0, g, identity((bits.shape[0],), bits.device))


def add_bits_plain(bits: torch.Tensor, gens: G1Jac) -> G1Jac:
    """The bit mode of K6, plain: leaf(2i) + leaf(2i + 1) for the (2n,)
    0/1 words bits, leaf(e) = bits[e] != 0 ? G[e mod gen] : O."""
    leaves = _leaves(bits, gens)
    return add_plain(G1Jac(*(c[0::2] for c in leaves)), G1Jac(*(c[1::2] for c in leaves)))


def _scalar_bits(scalar: torch.Tensor) -> torch.Tensor:
    """(N, 8) raw scalars -> (N, 256) bool bits, LSB first."""
    shifts = torch.arange(32, device=scalar.device)
    return ((mp.i64(scalar).unsqueeze(-1) >> shifts) & 1).reshape(scalar.shape[0], 256) == 1


def _scalar_mul_w(p, bits):
    """g1.py:scalar_mul's loop (out = bit ? add(out, acc) : out, acc =
    double(acc)) over the working form: bit b adds into the points whose
    scalar has it set and doubles the points whose scalar has a higher bit
    set (past a scalar's top bit its acc is not read again), so every
    point's limbs are those of the full loop."""
    n = bits.shape[0]
    out = [torch.zeros_like(c) for c in p]
    acc = [c.clone() for c in p]
    idx = torch.arange(n, device=bits.device)
    tops = torch.where(bits.any(1), 255 - bits.flip(1).to(torch.int32).argmax(1), -1)
    for b in range(int(tops.max()) + 1 if n else 0):
        sel = idx[bits[:, b]]
        if sel.numel():
            for c, r in zip(out, _add_w(tuple(c[:, sel] for c in out), tuple(c[:, sel] for c in acc))):
                c[:, sel] = r
        live = idx[tops > b]
        if live.numel():
            for c, r in zip(acc, _double_w(tuple(c[:, live] for c in acc))):
                c[:, live] = r
    return tuple(out)


def scalar_mul_plain(p: G1Jac, scalar: torch.Tensor) -> G1Jac:
    """scalar * p for (n,) points and raw (non-Montgomery) scalars, (n, 8)
    or one (8,) for all, plain PyTorch."""
    p = _flat(p)
    n = p.x.shape[0]
    sc = scalar.reshape(-1, 8).expand(n, 8) if scalar.dim() == 1 else scalar.reshape(n, 8)
    return _chunked(n, lambda lo, hi: _stored(_scalar_mul_w(_work(p, lo, hi), _scalar_bits(sc[lo:hi])))) \
        or identity((0,), p.x.device)


def _var_lib() -> ctypes.CDLL:
    lib = build.load("g1_var")
    if not getattr(lib, "_zk_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_longlong
        lib.zk_g1_scalar_mul_form.argtypes = [ctypes.c_int, P, P, P, I, P, I, P, P, P, I, P, ctypes.c_int]
        lib.zk_g1_add.argtypes = [P, P, P, I, P, P, P, I, ctypes.c_int, P, I, P, P, P, I, P, ctypes.c_int]
        lib.zk_g1_scalar_mul_form.restype = lib.zk_g1_add.restype = ctypes.c_int
        lib._zk_typed = True
    return lib


def _rows_and_stride(p: G1Jac) -> tuple[G1Jac, int]:
    """p as (n, 12) coordinates that share one element stride in words (a
    strided view as it is, anything else made contiguous)."""
    cs = [c.reshape(-1, 12) for c in p]
    n = cs[0].shape[0]
    stride = cs[0].stride(0) if n > 1 else 12
    if any(c.stride(1) != 1 or (n > 1 and c.stride(0) != stride) for c in cs):
        cs, stride = [c.contiguous() for c in cs], 12
    return G1Jac(*cs), stride


def _launch(kernel: Kernel, fn, dev: torch.device, n: int, *args) -> G1Jac:
    """Launch fn(*args, out x, y, z, n, stream, device) into a new (n,)
    point vector; count the launch."""
    pts = torch.empty((3, n, 12), dtype=torch.uint32, device=dev)
    if n:
        rc = fn(*args, pts[0].data_ptr(), pts[1].data_ptr(), pts[2].data_ptr(), n,
                torch._C._cuda_getCurrentRawStream(dev.index), dev.index)
        if rc != 0:
            raise RuntimeError(f"{kernel.name}: CUDA error {rc}")
        kernel.launches += 1
    return G1Jac(*pts)


def _add(p: G1Jac, q: G1Jac, neg_q: bool) -> G1Jac:
    _check_points(p, q)
    shape = p.shape
    if q.shape != shape:
        raise ValueError(f"add: point shapes {tuple(shape)} and {tuple(q.shape)}")
    dev = _device(*p, *q)
    if dev.type == "cpu":
        out = add_plain(p, q, neg_q)
    else:
        (pr, ps), (qr, qs) = _rows_and_stride(p), _rows_and_stride(q)
        out = _launch(ADD, _var_lib().zk_g1_add, dev, pr.x.shape[0],
                      *(c.data_ptr() for c in pr), ps, *(c.data_ptr() for c in qr), qs, int(neg_q), None, 0)
    return G1Jac(*(c.reshape(*shape, 12) for c in out))


def neg(p: G1Jac) -> G1Jac:
    """(x, -y, z) (g1.py:neg), plain PyTorch on any device."""
    _, y, _ = _neg_w((None, fp.to_work(p.y), None))
    return G1Jac(p.x, fp.from_work(y), p.z)


def add(p: G1Jac, q: G1Jac) -> G1Jac:
    """Elementwise p + q (g1.py:add, limb for limb): K6 on CUDA tensors, the
    plain version on CPU ones."""
    return _add(p, q, neg_q=False)


def add_bits(bits: torch.Tensor, gens: G1Jac) -> G1Jac:
    """One bit-masked tree level: leaf(2i) + leaf(2i + 1) for the (2n,) 0/1
    uint32 words bits, leaf(e) = bits[e] != 0 ? G[e mod gen] : O (the first
    level of pedersen._commit_bits_rows, its leaves never stored): K6's bit
    mode on CUDA tensors, the plain version on CPU ones."""
    _check_points(gens)
    if bits.dtype != torch.uint32 or bits.dim() != 1 or bits.shape[0] % 2:
        raise ValueError(f"add_bits: expected an even uint32 (2n,) vector, got {bits.dtype} {tuple(bits.shape)}")
    dev = _device(bits, *gens)
    if dev.type == "cpu":
        return add_bits_plain(bits, gens)
    g = G1Jac(*(c.reshape(-1, 12).contiguous() for c in gens))
    bits = bits.contiguous()
    return _launch(ADD, _var_lib().zk_g1_add, dev, bits.shape[0] // 2,
                   *(c.data_ptr() for c in g), 12, None, None, None, 0, 0, bits.data_ptr(), g.x.shape[0])


def scalar_mul(p: G1Jac, scalar: torch.Tensor, form: str = "auto") -> G1Jac:
    """scalar * p by g1.py:scalar_mul's LSB-first double-and-add (limb for
    limb). scalar: raw (non-Montgomery) uint32, one per point (*p.shape, 8)
    or one (8,) for all. K5 on CUDA tensors, in the layout ``form`` (a key
    of SCALAR_MUL_FORMS; every form gives the same bits), the plain version
    on CPU ones."""
    _check_points(p)
    shape = p.shape
    if scalar.dtype != torch.uint32 or scalar.shape[-1] != 8 or (
            scalar.dim() != 1 and tuple(scalar.shape[:-1]) != tuple(shape)):
        raise ValueError(f"scalar_mul: scalars {scalar.dtype} {tuple(scalar.shape)} for points {tuple(shape)}")
    dev = _device(scalar, *p)
    if dev.type == "cpu":
        out = scalar_mul_plain(p, scalar)
    else:
        pr, ps = _rows_and_stride(p)
        sc = scalar.reshape(-1, 8).contiguous()
        out = _launch(SCALAR_MUL, functools.partial(_var_lib().zk_g1_scalar_mul_form, SCALAR_MUL_FORMS[form]), dev,
                      pr.x.shape[0], *(c.data_ptr() for c in pr), ps, sc.data_ptr(), 0 if scalar.dim() == 1 else 8)
    return G1Jac(*(c.reshape(*shape, 12) for c in out))


# --- GLV scalar multiplication: K8 ------------------------------------------
#
# g1.py:225-327. BLS12-381 G1 has the endomorphism phi(x, y) = (beta x, y)
# with phi(P) = lambda P, lambda = X^2 - 1 for the BLS parameter X. A scalar
# s < r splits by integer division as s = s1 + lambda s2 (both < 2^128), and
# s P = s1 P + s2 phi(P) by a dual 4-bit window walk over 33 windows.

_X_BLS = -0xD201000000010000
_LAMBDA_INT = _X_BLS**2 - 1  # 128 bits
_BETA_INT = 0x1A0111EA397FE699EC02408663D4DE85AA0D857D89759AD4897D29650FB85F9B409427EB4F49FFFD8BFD00000000AAAC
_M_BARRETT = (1 << 256) // _LAMBDA_INT  # 129 bits

assert fr.P_INT == _X_BLS**4 - _X_BLS**2 + 1, "BLS parameter"
assert (_LAMBDA_INT**2 + _LAMBDA_INT + 1) % fr.P_INT == 0, "lambda order"
assert pow(_BETA_INT, 3, fp.P_INT) == 1 and _BETA_INT != 1, "beta order"

_BETA_MONT = mp.limbs_from_int(fp.SPEC.to_mont_int(_BETA_INT), 12)
_GLV_WINDOW = 4
_GLV_BITS = 132  # ceil over 129 to a window multiple
_GLV_WINDOWS = _GLV_BITS // _GLV_WINDOW


def glv_decompose(scalar: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 8) raw scalars -> (s1, s2), (..., 8) each, with s = s1 +
    lambda s2 and 0 <= s1 < lambda (g1.py:glv_decompose :251): the exact
    integer division, on the host. For s < 2^128 lambda (every s < r) this
    is the JAX Barrett division's result; above it the JAX quotient loses
    its bits past 2^128, and this one keeps them (s2 < 2^129)."""
    rows = mp.host(scalar).reshape(-1, 8)
    qr = [divmod(mp.int_from_limbs(r), _LAMBDA_INT) for r in rows]
    s1 = np.stack([mp.limbs_from_int(r, 8) for _, r in qr]) if qr else np.zeros((0, 8), np.uint32)
    s2 = np.stack([mp.limbs_from_int(q, 8) for q, _ in qr]) if qr else np.zeros((0, 8), np.uint32)
    return tuple(torch.from_numpy(a).to(scalar.device).reshape(scalar.shape) for a in (s1, s2))


def _endo_w(p):
    x, y, z = p
    return fp.mul_w(x, mp.const(_BETA_MONT, x).expand_as(x)), y, z


def endomorphism(p: G1Jac) -> G1Jac:
    """phi(x, y, z) = (beta x, y, z): one Fp product (g1.py:endomorphism :276)."""
    return _stored(_endo_w(tuple(fp.to_work(c) for c in p)))


def _window_digits(scalar: torch.Tensor) -> torch.Tensor:
    """(..., 8) -> int64 (..., 33) 4-bit windows of the low 5 limbs, LSB
    first (g1.py:_window_digits :287)."""
    shifts = torch.arange(0, 32, _GLV_WINDOW, device=scalar.device)
    d = (mp.i64(scalar[..., :5]).unsqueeze(-1) >> shifts) & ((1 << _GLV_WINDOW) - 1)
    return d.reshape(*scalar.shape[:-1], 40)[..., :_GLV_WINDOWS]


def _mk_table_w(p):
    """[O, p, add(t[1], p), ..., add(t[14], p)] (g1.py:_mk_table :294) as
    three int64 (16, 12, n) stacks of the working form."""
    zero = torch.zeros_like(p[0])
    table = [(zero, zero, zero), p]
    for k in range(2, 1 << _GLV_WINDOW):
        table.append(_add_w(table[k - 1], p))
    return tuple(torch.stack([t[c] for t in table]) for c in range(3))


def _lookup_w(table, d):
    """Entry d[i] of every point i's table (the take_along_axis of g1.py:313)."""
    idx = d.view(1, 1, -1).expand(1, 12, d.shape[0])
    return tuple(torch.gather(t, 0, idx)[0] for t in table)


def _scalar_mul_glv_w(p, scalar):
    """g1.py:scalar_mul_glv's walk over the working form: from the identity,
    per window from the top four doubles, an add of t1[d1] and one of
    t2[d2]. The windows above the highest nonzero digit of every point are
    skipped: there the walk doubles the identity (0, 0, 0) and adds table[0]
    = (0, 0, 0), which leaves the same limbs."""
    s1, s2 = glv_decompose(scalar)
    d1, d2 = _window_digits(s1), _window_digits(s2)
    t1, t2 = _mk_table_w(p), _mk_table_w(_endo_w(p))
    live = ((d1 != 0) | (d2 != 0)).any(0).nonzero()
    zero = torch.zeros_like(p[0])
    out = (zero, zero, zero)
    for i in range(int(live.max()) if live.numel() else -1, -1, -1):
        for _ in range(_GLV_WINDOW):
            out = _double_w(out)
        out = _add_w(out, _lookup_w(t1, d1[:, i]))
        out = _add_w(out, _lookup_w(t2, d2[:, i]))
    return out


def scalar_mul_glv_plain(p: G1Jac, scalar: torch.Tensor) -> G1Jac:
    """scalar * p by g1.py:scalar_mul_glv (:302-326), limb for limb, for
    (n,) points and (n, 8) raw scalars, plain PyTorch on any device."""
    p = _flat(p)
    n = p.x.shape[0]
    sc = scalar.reshape(n, 8)
    return _chunked(n, lambda lo, hi: _stored(_scalar_mul_glv_w(_work(p, lo, hi), sc[lo:hi]))) \
        or identity((0,), p.x.device)


def _glv_lib() -> ctypes.CDLL:
    lib = build.load("g1_glv")
    if not getattr(lib, "_zk_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_longlong
        lib.zk_g1_glv.argtypes = [ctypes.c_int, P, P, P, I, P, P, P, P, P, I, P, ctypes.c_int]
        lib.zk_g1_glv.restype = ctypes.c_int
        lib.zk_g1_glv_scratch_words.argtypes = [ctypes.c_int, I, ctypes.c_int]
        lib.zk_g1_glv_scratch_words.restype = I
        lib._zk_typed = True
    return lib


def scalar_mul_glv(p: G1Jac, scalar: torch.Tensor, form: str = "auto") -> G1Jac:
    """scalar * p by g1.py:scalar_mul_glv, limb for limb (group-equal to
    scalar_mul, not limb-equal). scalar: raw uint32 (*p.shape, 8), one per
    point. K8 on CUDA tensors, in the form ``form`` (a key of GLV_FORMS;
    every form gives the same bits), with a device scratch for its tables
    (4608 bytes a point) where the form keeps them there; the plain version
    on CPU ones. The endomorphism split is group-correct for points in the
    order-r subgroup only (the JAX package's glv_safe generators)."""
    _check_points(p)
    shape = p.shape
    if scalar.dtype != torch.uint32 or tuple(scalar.shape) != (*shape, 8):
        raise ValueError(f"scalar_mul_glv: scalars {scalar.dtype} {tuple(scalar.shape)} for points {tuple(shape)}")
    dev = _device(scalar, *p)
    if dev.type == "cpu":
        out = scalar_mul_glv_plain(p, scalar)
    else:
        pr, ps = _rows_and_stride(p)
        n = pr.x.shape[0]
        sc = scalar.reshape(-1, 8).contiguous()
        lib = _glv_lib()
        words = lib.zk_g1_glv_scratch_words(GLV_FORMS[form], n, dev.index)
        if words < 0:
            raise RuntimeError(f"{GLV.name}: no scratch size for form {form!r} on {dev}")
        table = torch.empty(words, dtype=torch.uint32, device=dev) if words else None
        out = _launch(GLV, functools.partial(lib.zk_g1_glv, GLV_FORMS[form]), dev, n,
                      *(c.data_ptr() for c in pr), ps, sc.data_ptr(), None if table is None else table.data_ptr())
    return G1Jac(*(c.reshape(*shape, 12) for c in out))


# --- fixed 4-bit windows: K13 ------------------------------------------------


def _scalar_mul_windowed_w(p, digits):
    """g1.py:scalar_mul_windowed's walk over the working form: the table of
    _mk_table_w (the same adds), then per window from the top four doubles
    and an add of t[digit]. The windows above every point's highest nonzero
    digit are skipped: there the walk doubles (0, 0, 0) and adds t[0] =
    (0, 0, 0), which leaves the same limbs."""
    table = _mk_table_w(p)
    live = (digits != 0).any(0).nonzero()
    zero = torch.zeros_like(p[0])
    out = (zero, zero, zero)
    for i in range(int(live.max()) if live.numel() else -1, -1, -1):
        for _ in range(_COMB_W):
            out = _double_w(out)
        out = _add_w(out, _lookup_w(table, digits[:, i]))
    return out


def scalar_mul_windowed_plain(p: G1Jac, scalar: torch.Tensor) -> G1Jac:
    """scalar * p by g1.py:scalar_mul_windowed (window 4), limb for limb,
    for (n,) points and (n, 8) raw scalars, plain PyTorch on any device."""
    p = _flat(p)
    n = p.x.shape[0]
    sc = scalar.reshape(n, 8)
    return _chunked(n, lambda lo, hi: _stored(_scalar_mul_windowed_w(_work(p, lo, hi), _digits(sc[lo:hi])))) \
        or identity((0,), p.x.device)


def _win_lib() -> ctypes.CDLL:
    lib = build.load("g1_win")
    if not getattr(lib, "_zk_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_longlong
        lib.zk_g1_windowed.argtypes = [ctypes.c_int, P, P, P, I, P, P, P, P, P, I, P, ctypes.c_int]
        lib.zk_g1_windowed.restype = ctypes.c_int
        lib.zk_g1_windowed_scratch_words.argtypes = [ctypes.c_int, I, ctypes.c_int]
        lib.zk_g1_windowed_scratch_words.restype = I
        lib._zk_typed = True
    return lib


def scalar_mul_windowed(p: G1Jac, scalar: torch.Tensor, form: str = "auto") -> G1Jac:
    """scalar * p by g1.py:scalar_mul_windowed's fixed 4-bit windows (its
    default window), limb for limb (group-equal to scalar_mul, not
    limb-equal). scalar: raw uint32 (*p.shape, 8), one per point. K13 on
    CUDA tensors, in the form ``form`` (a key of WINDOWED_FORMS; every form
    gives the same bits), with a device scratch for its tables (2304 bytes
    a point) where the form keeps them there; the plain version on CPU
    ones."""
    _check_points(p)
    shape = p.shape
    if scalar.dtype != torch.uint32 or tuple(scalar.shape) != (*shape, 8):
        raise ValueError(f"scalar_mul_windowed: scalars {scalar.dtype} {tuple(scalar.shape)} for points {tuple(shape)}")
    dev = _device(scalar, *p)
    if dev.type == "cpu":
        out = scalar_mul_windowed_plain(p, scalar)
    else:
        pr, ps = _rows_and_stride(p)
        n = pr.x.shape[0]
        sc = scalar.reshape(-1, 8).contiguous()
        lib = _win_lib()
        words = lib.zk_g1_windowed_scratch_words(WINDOWED_FORMS[form], n, dev.index)
        if words < 0:
            raise RuntimeError(f"{WINDOWED.name}: no scratch size for form {form!r} on {dev}")
        table = torch.empty(words, dtype=torch.uint32, device=dev) if words else None
        out = _launch(WINDOWED, functools.partial(lib.zk_g1_windowed, WINDOWED_FORMS[form]), dev, n,
                      *(c.data_ptr() for c in pr), ps, sc.data_ptr(), None if table is None else table.data_ptr())
    return G1Jac(*(c.reshape(*shape, 12) for c in out))


def sum_rows(p: G1Jac, plain: bool = False) -> G1Jac:
    """(R, W) points -> (R,) row sums by g1.py:g1_sum's pairwise tree along
    each row (:413-430): level by level out[:, i] = p[:, 2i] + p[:, 2i + 1],
    an odd row padded with the identity at its end. One add a level
    (add_plain with plain=True, on any device)."""
    R, W = p.shape
    if W == 0:
        raise ValueError("sum_rows: empty rows")
    while W > 1:
        if W % 2:
            pad = identity((R, 1), p.x.device)
            p = G1Jac(*(torch.cat([c, d], 1) for c, d in zip(p, pad)))
            W += 1
        flat = G1Jac(*(c.reshape(R * W, 12) for c in p))
        p = (add_plain if plain else add)(G1Jac(*(c[0::2] for c in flat)), G1Jac(*(c[1::2] for c in flat)))
        W //= 2
        p = G1Jac(*(c.reshape(R, W, 12) for c in p))
    return G1Jac(*(c.reshape(R, 12) for c in p))


def g1_sum(p: G1Jac) -> G1Jac:
    """Sum of an (n,) point vector by g1.py:g1_sum's pairwise tree -> ()."""
    s = sum_rows(G1Jac(*(c.reshape(1, -1, 12) for c in p)))
    return G1Jac(*(c[0] for c in s))


def sum_bit_rows(bits2: torch.Tensor, gens: G1Jac, plain: bool = False) -> G1Jac:
    """(m, gen) 0/1 uint32 words -> (m,) row sums of bits2[r, j] ? G[j] : O
    by g1_sum's tree (pedersen._commit_bits_rows): an even row width starts
    with one bit-mode level (add_bits), an odd one from the selected leaves.
    plain=True runs the plain versions on any device."""
    m, gen = bits2.shape
    if gen % 2:
        leaves = _leaves(bits2.reshape(-1), gens)
        return sum_rows(G1Jac(*(c.reshape(m, gen, 12) for c in leaves)), plain)
    first = (add_bits_plain if plain else add_bits)(bits2.reshape(-1), gens)
    return sum_rows(G1Jac(*(c.reshape(m, gen // 2, 12) for c in first)), plain)


def me_step(ps: list[G1Jac], xs: list[int]) -> list[G1Jac]:
    """One G1 multilinear fold (g1.py:me_step :433-452) of each even-length
    point vector ps[k] by its challenge xs[k] (a Montgomery Fr int), the
    vectors side by side: out[i] = a0 + x (a1 + (-a0)), a0 = p[2i], a1 =
    p[2i + 1], the challenge unmonted on the host. Three launches for all
    the vectors: two adds (the first with q negated) and a scalar_mul with a
    scalar per point."""
    dev = ps[0].x.device
    halves = [p.x.shape[0] // 2 for p in ps]
    scalars = np.repeat(np.stack([fr.from_int(host.fr.unmont(x)) for x in xs]), halves, axis=0)
    p = G1Jac(*(torch.cat(cs) for cs in zip(*ps)))
    a0 = G1Jac(*(c[0::2] for c in p))
    a1 = G1Jac(*(c[1::2] for c in p))
    out = add(a0, scalar_mul(_add(a1, a0, neg_q=True), torch.from_numpy(scalars).to(dev)))
    return [G1Jac(*cs) for cs in zip(*(c.split(halves) for c in out))]


def me_evals(ps: list[G1Jac], us: list[list[int]]) -> list[G1Jac]:
    """G1 MLEs (g1.py:me_eval :455-462) of several (n_k,) point vectors, each
    at its own point u_k (Montgomery Fr ints, u_k[0] binding the lowest
    index bit; 2^(r_k - 1) < n_k <= 2^r_k) -> one () point each, folded
    side by side (me_step). A vector is padded with the identity to 2^r_k
    up front, as the JAX verifier pads on its device: the identity's limbs
    (0, 0, 0) fold to themselves, so this equals me_step's padding of each
    odd level limb for limb."""
    ps = list(ps)
    for k, (p, u) in enumerate(zip(ps, us)):
        n, r = p.x.shape[0], len(u)
        if not (1 << r) // 2 < n <= (1 << r):
            raise ValueError(f"me_eval: {n} points for a {r}-variable point")
        if n < (1 << r):
            pad = identity(((1 << r) - n,), p.x.device)
            ps[k] = G1Jac(*(torch.cat([c, d]) for c, d in zip(p, pad)))
    for level in range(max((len(u) for u in us), default=0)):
        live = [k for k, u in enumerate(us) if level < len(u)]
        for k, f in zip(live, me_step([ps[k] for k in live], [us[k][level] for k in live])):
            ps[k] = f
    return [G1Jac(*(c[0] for c in p)) for p in ps]


def me_eval(p: G1Jac, u_mont) -> G1Jac:
    """G1 MLE of the (n,) points at u ((r, 8) Montgomery, any device; u[0]
    binds the lowest index bit) -> () (g1.py:me_eval :455-462); requires
    2^(r-1) < n <= 2^r."""
    return me_evals([p], [fr.to_ints(mp.host(u_mont))])[0]
