"""BLS12-381 G2 (the twist y^2 = x^3 + 4(1 + u) over Fp2) in Jacobian
coordinates: kernels K11 (scalar multiplication) and K12 (point addition).

Counterpart of ``zkdl_tpu/curve/g2.py``: ``G2Jac``/``G2Affine``,
``identity``, ``is_identity``, ``neg``, ``select``, ``double``, ``add``,
``add_mixed``, ``scalar_mul``, ``g2_sum``, ``msm``, ``find_point_host``,
``affine_from_host``, ``jac_from_host`` and ``to_affine_host``. Points are
three ``Fp2`` pairs of uint32 (..., 12) Montgomery tensors; z == 0 encodes
the identity. No point needs to lie in the r-torsion subgroup
(``find_point_host`` does not clear the cofactor).

``scalar_mul`` on CUDA tensors launches K11 and ``add`` (with ``g2_sum``'s
tree levels and so ``msm``) K12, both in ``csrc/g2.cu``: the formulas of
g2.py:double (:73-83), add (:86-112) and scalar_mul (:148-161) value for
value, so the Jacobian limbs equal the JAX package's. K11 runs a point on
a team of lanes (4, 8 or 16: ``SCALAR_MUL_FORMS``) from the programs of
``csrc/g2_prog.cuh`` (``curve/g2_program.py``). On CPU tensors they run
``scalar_mul_plain``/``add_plain``, the same formulas over the plain Fp2
ops of ``field/fp2.py``. ``double`` and ``add_mixed`` have no kernel (the
JAX package runs them only inside those loops and in tests).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..field import fp, fp2, mp
from ..field.fp2 import Fp2
from ..field.fp2 import host as hfp2
from ..field.kernels import Kernel
from ..utils import build
from . import g1


class G2Jac(NamedTuple):
    """Jacobian point tensor over Fp2; z == 0 encodes the identity."""

    x: Fp2
    y: Fp2
    z: Fp2

    @property
    def shape(self):
        return self.x.c0.shape[:-1]


class G2Affine(NamedTuple):
    x: Fp2
    y: Fp2


B_COEFF = (4, 4)  # 4(1 + u): the M-twist constant

SCALAR_MUL = Kernel("g2_scalar_mul", "zkdl_tpu_torch/csrc/g2.cu", "zkdl_tpu/curve/g2.py:148")
ADD = Kernel("g2_add", "zkdl_tpu_torch/csrc/g2.cu", "zkdl_tpu/curve/g2.py:86")
KERNELS = (SCALAR_MUL, ADD)
# K11's forms (csrc/g2.cu): 4, 8 or 16 lanes a point; chosen by the
# launch's size, or forced
SCALAR_MUL_FORMS = {"auto": 0, "four": 1, "eight": 2, "sixteen": 3}

_PLAIN_CHUNK = 1 << 12  # points per step of the plain versions (bounds their temporaries)


def identity(shape=(), device="cpu") -> G2Jac:
    return G2Jac(fp2.zeros(shape, device), fp2.zeros(shape, device), fp2.zeros(shape, device))


def is_identity(p: G2Jac) -> torch.Tensor:
    return fp2.is_zero(p.z)


def neg(p: G2Jac) -> G2Jac:
    return G2Jac(p.x, fp2.neg(p.y), p.z)


def select(pred: torch.Tensor, a: G2Jac, b: G2Jac) -> G2Jac:
    return G2Jac(fp2.select(pred, a.x, b.x), fp2.select(pred, a.y, b.y), fp2.select(pred, a.z, b.z))


# --- plain formulas on the working form (field/fp2.py's *_w) -----------------


def _work(p: G2Jac):
    return tuple(fp2.to_work(c) for c in p)


def _stored(w) -> G2Jac:
    return G2Jac(*(fp2.from_work(c) for c in w))


def _select_w(pred, a, b):
    return tuple(fp2.select_w(pred, u, v) for u, v in zip(a, b))


def _double_w(p):
    """dbl-2009-l (g2.py:double) with identity passthrough."""
    x, y, z = p
    a, b, yz = fp2.prods_w(("s", x), ("s", y), ("m", y, z))
    c, d = fp2.prods_w(("s", b), ("s", fp2.add_w(x, b)))
    d = fp2.double_w(fp2.sub_w(fp2.sub_w(d, a), c))
    e = fp2.add_w(fp2.double_w(a), a)
    (f,) = fp2.prods_w(("s", e))
    z3 = fp2.double_w(yz)
    x3 = fp2.sub_w(fp2.sub_w(f, d), d)
    c8 = fp2.double_w(fp2.double_w(fp2.double_w(c)))
    (de,) = fp2.prods_w(("m", fp2.sub_w(d, x3), e))
    return _select_w(fp2.is_zero_w(z), p, (x3, fp2.sub_w(de, c8), z3))


def _add_w(p, q):
    """add-2007-bl (g2.py:add) with its selects in order: equal points take
    double(p) (computed only where some element needs it), then q == O
    takes p, then p == O takes q."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2, y1z2, y2z1 = fp2.prods_w(("s", z1), ("s", z2), ("m", y1, z2), ("m", y2, z1))
    u1, u2, s1, s2 = fp2.prods_w(("m", x1, z2z2), ("m", x2, z1z1), ("m", y1z2, z2z2), ("m", y2z1, z1z1))
    h = fp2.sub_w(u2, u1)
    r = fp2.double_w(fp2.sub_w(s2, s1))
    i, rr, zz2 = fp2.prods_w(("s", fp2.double_w(h)), ("s", r), ("s", fp2.add_w(z1, z2)))
    j, v = fp2.prods_w(("m", h, i), ("m", u1, i))
    x3 = fp2.sub_w(fp2.sub_w(fp2.sub_w(rr, j), v), v)
    y3a, s1j, z3 = fp2.prods_w(("m", fp2.sub_w(v, x3), r), ("m", s1, j),
                               ("m", fp2.sub_w(fp2.sub_w(zz2, z1z1), z2z2), h))
    out = (x3, fp2.sub_w(y3a, fp2.double_w(s1j)), z3)
    same = fp2.eq_w(u1, u2) & fp2.eq_w(s1, s2)
    if bool(same.any()):
        out = _select_w(same, _double_w(p), out)
    out = _select_w(fp2.is_zero_w(z2), p, out)
    return _select_w(fp2.is_zero_w(z1), q, out)


def _add_mixed_w(p, qx, qy):
    """madd-2007-bl (g2.py:add_mixed): equal points take double(p), the
    identity takes the lifted q."""
    x, y, z = p
    qx = tuple(c.expand_as(x[0]) for c in qx)
    qy = tuple(c.expand_as(x[0]) for c in qy)
    z1z1, qyz = fp2.prods_w(("s", z), ("m", qy, z))
    u2, s2 = fp2.prods_w(("m", qx, z1z1), ("m", qyz, z1z1))
    h = fp2.sub_w(u2, x)
    r = fp2.double_w(fp2.sub_w(s2, y))
    hh, rr, zh2 = fp2.prods_w(("s", h), ("s", r), ("s", fp2.add_w(z, h)))
    i = fp2.double_w(fp2.double_w(hh))
    j, v = fp2.prods_w(("m", h, i), ("m", x, i))
    x3 = fp2.sub_w(fp2.sub_w(rr, j), fp2.double_w(v))
    y3a, yj = fp2.prods_w(("m", fp2.sub_w(v, x3), r), ("m", y, j))
    z3 = fp2.sub_w(fp2.sub_w(zh2, z1z1), hh)
    out = (x3, fp2.sub_w(y3a, fp2.double_w(yj)), z3)
    same = fp2.eq_w(x, u2) & fp2.eq_w(y, s2)
    if bool(same.any()):
        out = _select_w(same, _double_w(p), out)
    one = mp.const(fp.ONE_MONT, x[0]).expand_as(x[0])
    return _select_w(fp2.is_zero_w(z), (qx, qy, (one, torch.zeros_like(one))), out)


def _flat(p: G2Jac) -> G2Jac:
    return G2Jac(*(Fp2(c.c0.reshape(-1, 12), c.c1.reshape(-1, 12)) for c in p))


def _shaped(p: G2Jac, shape) -> G2Jac:
    return G2Jac(*(Fp2(c.c0.reshape(*shape, 12), c.c1.reshape(*shape, 12)) for c in p))


def _part(p: G2Jac, lo: int, hi: int):
    return tuple(fp2.to_work(Fp2(c.c0[lo:hi], c.c1[lo:hi])) for c in p)


def _chunked(n: int, device, step) -> G2Jac:
    """step(lo, hi) (a working-form point vector) over chunks of the n
    points, concatenated and stored."""
    parts = [_stored(step(lo, min(lo + _PLAIN_CHUNK, n))) for lo in range(0, n, _PLAIN_CHUNK)]
    if not parts:
        return identity((0,), device)
    return G2Jac(*(Fp2(torch.cat([getattr(q, c).c0 for q in parts]), torch.cat([getattr(q, c).c1 for q in parts]))
                   for c in ("x", "y", "z")))


def double(p: G2Jac) -> G2Jac:
    """dbl-2009-l (g2.py:double), plain PyTorch on any device."""
    shape = p.shape
    return _shaped(_stored(_double_w(_work(_flat(p)))), shape)


def add_mixed(p: G2Jac, q: G2Affine) -> G2Jac:
    """p + q for an affine q broadcast against p (g2.py:add_mixed), plain
    PyTorch on any device."""
    shape = p.shape
    qx, qy = (fp2.to_work(Fp2(c.c0.expand(*shape, 12).reshape(-1, 12), c.c1.expand(*shape, 12).reshape(-1, 12)))
              for c in q)
    return _shaped(_stored(_add_mixed_w(_work(_flat(p)), qx, qy)), shape)


def add_plain(p: G2Jac, q: G2Jac) -> G2Jac:
    """add(p, q) of (n,) point vectors, plain PyTorch."""
    p, q = _flat(p), _flat(q)
    return _chunked(p.x.c0.shape[0], p.x.c0.device, lambda lo, hi: _add_w(_part(p, lo, hi), _part(q, lo, hi)))


def _scalar_mul_w(p, bits):
    """g2.py:scalar_mul's loop (acc = bit ? add(acc, base) : acc, base =
    double(base)) over the working form, each bit's add on the points that
    have it set and each double on the points with a higher bit set (past
    its top bit a point's base is not read again): the limbs of the full
    loop."""
    n = bits.shape[0]
    acc = [tuple(torch.zeros_like(c) for c in f) for f in p]
    base = [tuple(c.clone() for c in f) for f in p]
    idx = torch.arange(n, device=bits.device)
    tops = torch.where(bits.any(1), 255 - bits.flip(1).to(torch.int32).argmax(1), -1)

    def sub(pt, sel):
        return tuple(tuple(c[:, sel] for c in f) for f in pt)

    def put(pt, sel, val):
        for f, v in zip(pt, val):
            for c, w in zip(f, v):
                c[:, sel] = w

    for b in range(int(tops.max()) + 1 if n else 0):
        sel = idx[bits[:, b]]
        if sel.numel():
            put(acc, sel, _add_w(sub(acc, sel), sub(base, sel)))
        live = idx[tops > b]
        if live.numel():
            put(base, live, _double_w(sub(base, live)))
    return tuple(acc)


def scalar_mul_plain(p: G2Jac, scalar: torch.Tensor) -> G2Jac:
    """scalar * p for (n,) points and raw scalars, (n, 8) or one (8,) for
    all, plain PyTorch."""
    p = _flat(p)
    n = p.x.c0.shape[0]
    sc = scalar.reshape(-1, 8).expand(n, 8) if scalar.dim() == 1 else scalar.reshape(n, 8)
    return _chunked(n, p.x.c0.device, lambda lo, hi: _scalar_mul_w(_part(p, lo, hi), g1._scalar_bits(sc[lo:hi])))


# --- the kernels -------------------------------------------------------------


def pack(p: G2Jac) -> torch.Tensor:
    """(n, 72) uint32 words a point, x.c0, x.c1, y.c0, y.c1, z.c0, z.c1 (the
    kernels' layout)."""
    p = _flat(p)
    return torch.stack([p.x.c0, p.x.c1, p.y.c0, p.y.c1, p.z.c0, p.z.c1], 1).reshape(-1, 72)


def unpack(t: torch.Tensor) -> G2Jac:
    v = t.reshape(-1, 6, 12)
    return G2Jac(Fp2(v[:, 0], v[:, 1]), Fp2(v[:, 2], v[:, 3]), Fp2(v[:, 4], v[:, 5]))


def _lib() -> ctypes.CDLL:
    lib = build.load("g2")
    if not getattr(lib, "_zk_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_longlong
        lib.zk_g2_scalar_mul.argtypes = [ctypes.c_int, P, P, I, P, P, I, P, ctypes.c_int]
        lib.zk_g2_scalar_mul_scratch_words.argtypes = [I]
        lib.zk_g2_scalar_mul_scratch_words.restype = I
        lib.zk_g2_add.argtypes = [P, I, P, I, P, I, P, ctypes.c_int]
        lib.zk_g2_scalar_mul.restype = lib.zk_g2_add.restype = ctypes.c_int
        lib._zk_typed = True
    return lib


def _check(*ps: G2Jac) -> torch.device:
    devs = set()
    for p in ps:
        for f in p:
            for c in f:
                if c.dtype != torch.uint32 or c.shape[-1] != 12:
                    raise ValueError(f"expected uint32 (..., 12) coordinates, got {c.dtype} {tuple(c.shape)}")
                devs.add(c.device)
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _run(kernel: Kernel, fn, dev: torch.device, n: int, *args) -> torch.Tensor:
    out = torch.empty((n, 72), dtype=torch.uint32, device=dev)
    if n:
        rc = fn(*args, out.data_ptr(), n, torch._C._cuda_getCurrentRawStream(dev.index), dev.index)
        if rc != 0:
            raise RuntimeError(f"{kernel.name}: CUDA error {rc}")
        kernel.launches += 1
    return out


def sum_level(t: torch.Tensor) -> torch.Tensor:
    """One g2_sum level on packed (2m, 72) points -> (m, 72): t[2i] +
    t[2i + 1]. K12 on the card, the halves read in place at a stride of
    two points; add_plain on the CPU."""
    m = t.shape[0] // 2
    if t.device.type == "cpu":
        return pack(add_plain(unpack(t[0::2]), unpack(t[1::2])))
    return _run(ADD, _lib().zk_g2_add, t.device, m, t.data_ptr(), 144, t[1:].data_ptr(), 144)


def add(p: G2Jac, q: G2Jac) -> G2Jac:
    """Elementwise p + q (g2.py:add, limb for limb): K12 on CUDA tensors,
    the plain version on CPU ones."""
    dev = _check(p, q)
    shape = p.shape
    if q.shape != shape:
        raise ValueError(f"add: point shapes {tuple(shape)} and {tuple(q.shape)}")
    if dev.type == "cpu":
        return _shaped(add_plain(p, q), shape)
    a, b = pack(p), pack(q)
    out = _run(ADD, _lib().zk_g2_add, dev, a.shape[0], a.data_ptr(), 72, b.data_ptr(), 72)
    return _shaped(unpack(out), shape)


def scalar_mul(p: G2Jac, scalar: torch.Tensor, form: str = "auto") -> G2Jac:
    """scalar * p by g2.py:scalar_mul's LSB-first double-and-add (limb for
    limb). scalar: raw (non-Montgomery) uint32, one per point (*p.shape, 8)
    or one (8,) for all. K11 on CUDA tensors, in the form ``form`` (a key of
    SCALAR_MUL_FORMS; every form gives the same bits), with a device scratch
    for its rings (4608 bytes a point); the plain version on CPU ones."""
    dev = _check(p)
    shape = p.shape
    if scalar.dtype != torch.uint32 or scalar.shape[-1] != 8 or scalar.device != dev or (
            scalar.dim() != 1 and tuple(scalar.shape[:-1]) != tuple(shape)):
        raise ValueError(f"scalar_mul: scalars {scalar.dtype} {tuple(scalar.shape)} for points {tuple(shape)}")
    if dev.type == "cpu":
        return _shaped(scalar_mul_plain(p, scalar), shape)
    a = pack(p)
    sc = scalar.reshape(-1, 8).contiguous()
    lib = _lib()
    ring = torch.empty(lib.zk_g2_scalar_mul_scratch_words(a.shape[0]), dtype=torch.uint32, device=dev)
    out = _run(SCALAR_MUL, functools.partial(lib.zk_g2_scalar_mul, SCALAR_MUL_FORMS[form]), dev, a.shape[0],
               a.data_ptr(), sc.data_ptr(), 0 if scalar.dim() == 1 else 8, ring.data_ptr())
    return _shaped(unpack(out), shape)


def g2_sum(p: G2Jac) -> G2Jac:
    """Pairwise tree reduction along the leading axis (g2.py:g2_sum): level
    by level out[i] = p[2i] + p[2i + 1], an odd level padded with the
    identity at its end (sum_level: one K12 launch a level on the card).
    -> (1,)."""
    _check(p)
    t = pack(p)
    while t.shape[0] > 1:
        if t.shape[0] % 2:
            t = torch.cat([t, torch.zeros((1, 72), dtype=t.dtype, device=t.device)])
        t = sum_level(t)
    return unpack(t)


def msm(points: G2Jac, scalars: torch.Tensor) -> G2Jac:
    """sum_i scalars_i P_i (g2.py:msm): scalar_mul, then g2_sum."""
    return g2_sum(scalar_mul(points, scalars))


# ---------------------------------------------------------------------------
# host-side curve points (tests and bases)
# ---------------------------------------------------------------------------


def _on_curve_host(x, y) -> bool:
    rhs = hfp2.add(hfp2.mul(hfp2.sqr(x), x), B_COEFF)
    return hfp2.sqr(y) == rhs


@functools.lru_cache(maxsize=None)
def find_point_host(seed: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """Deterministic try-and-increment: the first x = (seed + k) + seed u
    whose x^3 + b is a square. Returns affine (x, y) value pairs (not in
    the r-torsion subgroup)."""
    k = 0
    while True:
        x = ((seed + k) % fp2.P_INT, seed % fp2.P_INT)
        rhs = hfp2.add(hfp2.mul(hfp2.sqr(x), x), B_COEFF)
        y = hfp2.sqrt(rhs)
        if y is not None:
            assert _on_curve_host(x, y)
            return x, y
        k += 1


def affine_from_host(xy, shape=(), device="cpu") -> G2Affine:
    (x, y) = xy
    return G2Affine(fp2.from_ints(*x, shape, device), fp2.from_ints(*y, shape, device))


def jac_from_host(xy, shape=(), device="cpu") -> G2Jac:
    aff = affine_from_host(xy, shape, device)
    return G2Jac(aff.x, aff.y, fp2.ones_mont(shape, device))


def to_affine_host(p: G2Jac) -> tuple[tuple[int, int], tuple[int, int]] | None:
    """One point -> host affine values (None for the identity)."""
    z = fp2.to_ints(p.z)
    if z == (0, 0):
        return None
    x, y = fp2.to_ints(p.x), fp2.to_ints(p.y)
    zi = hfp2.inv(z)
    zi2 = hfp2.sqr(zi)
    return hfp2.mul(x, zi2), hfp2.mul(y, hfp2.mul(zi2, zi))
