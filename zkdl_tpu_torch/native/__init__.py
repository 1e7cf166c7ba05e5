"""ctypes binding of the native host G1 library (``native/zkdl_host.cpp``).

The library is built with g++ at first use (``utils/build.py``, keyed by the
source's hash), never at import. A failed build or load raises with the
compiler's output: there is no fallback to the pure-Python formulas, which
stay in ``curve/host_g1.py`` as the tests' oracle.

Points cross the boundary as plain-int Jacobian (x, y, z) triples (48 bytes
a coordinate, little-endian), scalars as 256-bit little-endian words. A
large batch is split over threads: ctypes releases the interpreter lock for
the call, and each thread's slice of the buffers is its own.
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
        L.zk_g1_scalar_mul_batch.argtypes = [P, P, P, ctypes.c_size_t]
        L.zk_g1_scalar_mul_batch.restype = None
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
    pts = (ctypes.c_char * (_POINT * n)).from_buffer_copy(
        b"".join(c.to_bytes(_COORD, "little") for p in points for c in p))
    ks = (ctypes.c_char * (_SCALAR * n)).from_buffer_copy(
        b"".join((int(k) & _MASK256).to_bytes(_SCALAR, "little") for k in scalars))
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
    raw = out.raw
    return [tuple(int.from_bytes(raw[o + j * _COORD : o + (j + 1) * _COORD], "little") for j in range(3))
            for o in range(0, _POINT * n, _POINT)]
