"""ctypes binding of the native host G1 library (``native/zkdl_host.cpp``).

The library is built with g++ at first use (``utils/build.py``, keyed by the
source's hash), never at import. A failed build or load raises with the
compiler's output: there is no fallback to the pure-Python formulas, which
stay in ``curve/host_g1.py`` as the tests' oracle.

Points cross the boundary as plain-int Jacobian (x, y, z) triples (48 bytes
a coordinate, little-endian), scalars as 256-bit little-endian words. A
large batch is split over threads: ctypes releases the interpreter lock for
the call, and each thread's slice of the buffers is its own.

The library's other entry points (zkdl_tpu/native/__init__.py:145-192:
``g1_msm``, ``g1_sum``, ``g1_add_batch``, ``g1_eq``, ``fr_mont_mul_batch``)
take the same int forms and run on one thread.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os

from ..utils import build

_COORD = 48  # bytes of one Fp coordinate (6 u64 limbs)
_POINT = 3 * _COORD
_SCALAR = 32
_MASK256 = (1 << 256) - 1
_MIN_PER_THREAD = 8  # multiplications a thread takes at least (each ~0.5-1 ms; a thread starts in ~0.1 ms)


def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be."""
    L = build.load("zkdl_host")
    if not getattr(L, "_zk_typed", False):
        P = ctypes.c_void_p
        S = ctypes.c_size_t
        for f, args in ((L.zk_g1_scalar_mul_batch, [P, P, P, S]), (L.zk_g1_msm, [P, P, P, S]),
                        (L.zk_g1_sum, [P, P, S]), (L.zk_g1_add_batch, [P, P, P, S]),
                        (L.zk_fr_mont_mul_batch, [P, P, P, S])):
            f.argtypes, f.restype = args, None
        L.zk_g1_eq.argtypes, L.zk_g1_eq.restype = [P, P], ctypes.c_int
        L._zk_typed = True
    return L


def _threads(n: int) -> int:
    return max(1, min(len(os.sched_getaffinity(0)), n // _MIN_PER_THREAD))


def g1_scalar_mul_batch(points, scalars) -> list[tuple[int, int, int]]:
    """[k_i * P_i] for plain-int Jacobian triples P_i and ints k_i (taken
    mod 2^256, as the 256-step double-and-add of host_g1.scalar_mul does)."""
    n = len(points)
    if len(scalars) != n:
        raise ValueError(f"{n} points but {len(scalars)} scalars")
    if n == 0:
        return []
    L = lib()
    pts = _points_buf(points)
    ks = _ints_buf([int(k) & _MASK256 for k in scalars], _SCALAR)
    out = (ctypes.c_char * (_POINT * n))()
    base_p, base_k, base_o = ctypes.addressof(pts), ctypes.addressof(ks), ctypes.addressof(out)

    def run(lo: int, hi: int) -> None:
        L.zk_g1_scalar_mul_batch(base_p + _POINT * lo, base_k + _SCALAR * lo, base_o + _POINT * lo, hi - lo)

    t = _threads(n)
    if t == 1:
        run(0, n)
    else:
        cuts = [n * i // t for i in range(t + 1)]
        with concurrent.futures.ThreadPoolExecutor(t) as ex:
            for f in [ex.submit(run, cuts[i], cuts[i + 1]) for i in range(t)]:
                f.result()
    return _points_of(out.raw, n)


def _points_buf(points):
    return (ctypes.c_char * (_POINT * len(points))).from_buffer_copy(
        b"".join(int(c).to_bytes(_COORD, "little") for p in points for c in p))


def _ints_buf(vals, width: int):
    return (ctypes.c_char * (width * len(vals))).from_buffer_copy(
        b"".join(int(v).to_bytes(width, "little") for v in vals))


def _points_of(raw: bytes, count: int) -> list[tuple[int, int, int]]:
    return [tuple(int.from_bytes(raw[o + j * _COORD : o + (j + 1) * _COORD], "little") for j in range(3))
            for o in range(0, _POINT * count, _POINT)]


def g1_msm(points, scalars) -> tuple[int, int, int]:
    """sum_i k_i P_i for plain-int Jacobian triples and ints k_i (mod 2^256)."""
    if len(scalars) != len(points):
        raise ValueError(f"{len(points)} points but {len(scalars)} scalars")
    out = (ctypes.c_char * _POINT)()
    lib().zk_g1_msm(_points_buf(points), _ints_buf([int(k) & _MASK256 for k in scalars], _SCALAR), out, len(points))
    return _points_of(out.raw, 1)[0]


def g1_sum(points) -> tuple[int, int, int]:
    out = (ctypes.c_char * _POINT)()
    lib().zk_g1_sum(_points_buf(points), out, len(points))
    return _points_of(out.raw, 1)[0]


def g1_add_batch(ps, qs) -> list[tuple[int, int, int]]:
    if len(ps) != len(qs):
        raise ValueError(f"{len(ps)} and {len(qs)} points")
    out = (ctypes.c_char * (_POINT * len(ps)))()
    lib().zk_g1_add_batch(_points_buf(ps), _points_buf(qs), out, len(ps))
    return _points_of(out.raw, len(ps))


def g1_eq(p, q) -> bool:
    """Affine equality of two plain-int Jacobian triples."""
    return bool(lib().zk_g1_eq(_points_buf([p]), _points_buf([q])))


def fr_mont_mul_batch(a_vals, b_vals) -> list[int]:
    """Montgomery products of Montgomery-form Fr ints (a b R^-1 mod r)."""
    if len(a_vals) != len(b_vals):
        raise ValueError(f"{len(a_vals)} and {len(b_vals)} values")
    n = len(a_vals)
    out = (ctypes.c_char * (32 * n))()
    lib().zk_fr_mont_mul_batch(_ints_buf(a_vals, 32), _ints_buf(b_vals, 32), out, n)
    raw = out.raw
    return [int.from_bytes(raw[32 * i : 32 * (i + 1)], "little") for i in range(n)]
