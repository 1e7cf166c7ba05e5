"""Planar Fr kernels K1-K3: CUDA wrappers, their plain versions, launch counts.

Counterpart of ``zkdl_tpu/field/pallas_fr.py``. Each wrapper takes planar
uint32 (8, ...) tensors. On a CPU tensor it runs the plain PyTorch version;
on a CUDA tensor it launches the kernel of ``csrc/fr_kernels.cu`` (built at
first use) or raises: there is no fallback between the two.

| wrapper              | kernel             | replaces (TPU)                        |
| -------------------- | ------------------ | ------------------------------------- |
| mul                  | K1 fr_mul          | pallas_fr.py:_mul_kernel (:156)       |
| mul_scalar           | K2 fr_mul_scalar   | pallas_fr.py:_mul_scalar_kernel (:163)|
| dot/dot_many         | K3 fr_dot          | pallas_fr.py:_dot_cols_kernel (:186)  |
| batch_inverse(_many) | K7 fr_batch_inverse| sumcheck/lookup.py:batch_inverse (:55)|
| collect              | K9 fr_collect      | parallel/collectives.py:reduce_mod_p (:35) |

Bounds on an H100 (csrc/fr_kernels.cu has the derivation): all three are
memory-bound, K1/K2 at 96/64 B per element, K3 at 64 B per element read
(128 multiply-adds of its lazy product take less time than the bytes). K3
serves ``dot`` and every ``dot_many`` call in one launch each; ``plan_dot``
sets its grid. K7 (``csrc/fr_inverse.cu``, an XLA scan on the TPU) is
bound by its chain of dependent products: a product tree over the grid and
one binary-GCD inverse a segment (``batch_inverse_many`` inverts several
tensors in one call). K9 (``csrc/fr_collect.cu``, XLA code on the TPU) turns
the all-reduced int64 limb sums of canonical values into their canonical
sum, one thread a value: bytes-bound.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import struct

import numpy as np
import torch

from ..utils import build
from . import mp
from .fr import SPEC

N_LIMBS = 8
SOURCE = "zkdl_tpu_torch/csrc/fr_kernels.cu"
_PLAIN_CHUNK = 1 << 16  # columns per plain-version step (bounds its int64 temporaries)

# K3 launch geometry (csrc/fr_kernels.cu:fr_dot_kernel)
DOT_MAX_PAIRS = 8  # pairs of one dot_many launch
DOT_MAX_THREADS = 128
DOT_TARGET_BLOCKS = 792  # one wave over all slots: 6 blocks per SM (DOT_BLOCKS_PER_SM) on 132 SMs
DOT_MIN_TERMS = 16  # products per thread before a slot takes more threads or blocks
DOT_MAX_TERMS = 1 << 32  # products per thread the kernel's accumulator holds (MAX_TERMS_LOG2)
DOT_SCRATCH_BLOCKS = 4096  # per-block partials and per-slot counters of one launch
_MAX_GRID = (1 << 31) - 1


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
INVERSE = Kernel("fr_batch_inverse", "zkdl_tpu_torch/csrc/fr_inverse.cu", "zkdl_tpu/sumcheck/lookup.py:55")
COLLECT = Kernel("fr_collect", "zkdl_tpu_torch/csrc/fr_collect.cu", "zkdl_tpu/parallel/collectives.py:35")
FR_KERNELS = (MUL, MUL_SCALAR, DOT)  # the MLP's paths run these three
KERNELS = (*FR_KERNELS, INVERSE, COLLECT)

_P = ctypes.c_void_p
_I = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.load("fr_kernels")
    if not getattr(lib, "_zk_typed", False):
        lib.zk_fr_mul.argtypes = [_P, _I, _P, _I, _P, _I, _P]
        lib.zk_fr_mul_scalar.argtypes = [_P, _I, _P, _P, _I, _P]
        lib.zk_fr_dot.argtypes = [ctypes.c_char_p]
        for f in (lib.zk_fr_mul, lib.zk_fr_mul_scalar, lib.zk_fr_dot):
            f.restype = ctypes.c_int
        lib._zk_typed = True
    return lib


def _inverse_lib() -> ctypes.CDLL:
    lib = build.load("fr_inverse")
    if not getattr(lib, "_zk_typed", False):
        lib.zk_fr_batch_inverse.argtypes = [_P, _P, _P, ctypes.c_int, _P, _P, _P, ctypes.c_int]
        lib.zk_fr_batch_inverse.restype = ctypes.c_int
        lib.zk_fr_batch_inverse_scratch.argtypes = [_P, ctypes.c_int]
        lib.zk_fr_batch_inverse_scratch.restype = _I
        lib._zk_typed = True
    return lib


def _collect_lib() -> ctypes.CDLL:
    lib = build.load("fr_collect")
    if not getattr(lib, "_zk_typed", False):
        lib.zk_fr_collect.argtypes = [_P, _P, _I, _P, ctypes.c_int]
        lib.zk_fr_collect.restype = ctypes.c_int
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


def _broadcast(sa: torch.Size, sb: torch.Size) -> torch.Size:
    """torch.broadcast_shapes of two shapes, without its host cost."""
    if sa == sb:
        return sa
    d = len(sa) - len(sb)
    sa, sb = (1,) * -d + tuple(sa), (1,) * d + tuple(sb)
    out = []
    for x, y in zip(sa, sb):
        if x != y and 1 not in (x, y):
            raise ValueError(f"shapes {sa} and {sb} do not broadcast")
        out.append(y if x == 1 else x)
    return torch.Size(out)


def _unit_last(x: torch.Tensor) -> torch.Tensor:
    """x itself when its last axis has unit stride (or one element), else a
    contiguous copy."""
    return x if x.shape[-1] <= 1 or x.stride(-1) == 1 else x.contiguous()


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


def dot_many_plain(pairs) -> torch.Tensor:
    """[(a, b), ...] -> (8, len(pairs), *batch): dot_plain of each pair. The
    pairs may differ in length, not in batch shape."""
    return torch.stack([dot_plain(a, b) for a, b in pairs], dim=1)


# ---------------------------------------------------------------------------
# K3 launch plan and scratch
# ---------------------------------------------------------------------------


def plan_dot(n: int, slots: int) -> tuple[int, int]:
    """Grid of one K3 launch over `slots` dots of length n: (blocks per slot,
    threads per block).

    A slot takes as many warps (up to DOT_MAX_THREADS) and then blocks as
    give each thread DOT_MIN_TERMS products, all slots together at most
    about DOT_TARGET_BLOCKS blocks. Raises if a thread would add more
    products than the kernel's accumulator holds, or the grid would exceed
    its limit (the scratch's, when a slot spans several blocks)."""
    if n < 0 or slots < 1:
        raise ValueError(f"plan_dot: n={n}, slots={slots}")
    want = -(-n // DOT_MIN_TERMS)
    threads = min(DOT_MAX_THREADS, max(32, 1 << (max(want, 1) - 1).bit_length()))
    G = max(1, min(-(-n // (threads * DOT_MIN_TERMS)), DOT_TARGET_BLOCKS // slots))
    terms = 2 * -(-n // (2 * G * threads)) + 1  # two per loop step, one odd tail
    if terms > DOT_MAX_TERMS or slots * G > (DOT_SCRATCH_BLOCKS if G > 1 else _MAX_GRID):
        raise ValueError(f"plan_dot: n={n} over {slots} slots exceeds the kernel's limits")
    return G, threads


@functools.lru_cache(maxsize=None)
def _dot_scratch(device: int, stream: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Partials and zeroed counters of the multi-block regime, one pair of
    buffers per (device, stream), kept for the process: launches on one
    stream run in order, and each launch leaves its counters at 0."""
    dev = torch.device("cuda", device)
    partials = torch.empty((DOT_SCRATCH_BLOCKS * N_LIMBS,), dtype=torch.uint32, device=dev)
    return partials, torch.zeros((DOT_SCRATCH_BLOCKS,), dtype=torch.int32, device=dev)


@functools.lru_cache(maxsize=None)
def _dot_args(k: int) -> struct.Struct:
    return struct.Struct(f"{10 + 6 * k}q")


def _dot_launch(ops, n: int, B: int, device: torch.device) -> torch.Tensor:
    """One K3 launch over the pairs `ops` ((a_ptr, sa0, sa1, b_ptr, sb0, sb1)
    each, operands (8, B, n)) -> (8, len(ops) * B)."""
    slots = len(ops) * B
    out = torch.empty((N_LIMBS, slots), dtype=torch.uint32, device=device)
    if slots == 0:
        return out
    G, threads = plan_dot(n, slots)
    idx = device.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    partials, counters = _dot_scratch(idx, stream)
    args = [len(ops), n, B, G, threads, idx, out.data_ptr(), partials.data_ptr(), counters.data_ptr(), stream]
    for op in ops:
        args.extend(op)
    _check(_lib().zk_fr_dot(_dot_args(len(ops)).pack(*args)), "fr_dot")
    DOT.launches += 1
    return out


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
    One K3 launch.
    """
    _check_planar(a, b)
    if not _on_cuda(a, b):
        return dot_plain(a, b)
    shape = _broadcast(a.shape, b.shape)
    n = shape[-1]
    batch = shape[1:-1]
    B = math.prod(batch)
    if a.shape != shape:  # put the full operand first (the product commutes)
        a, b = b, a
    if a.shape != shape:
        raise ValueError(f"dot: neither operand has the full shape {tuple(shape)}")
    a3 = _unit_last(a.reshape(N_LIMBS, B, n))
    if b.shape == shape:
        b3 = _unit_last(b.reshape(N_LIMBS, B, n))
        sb1 = b3.stride(1)
    else:  # shared table: every batch entry reads the same (8, n)
        b3 = _unit_last(b.reshape(N_LIMBS, n))
        sb1 = 0
    op = (a3.data_ptr(), a3.stride(0), a3.stride(1), b3.data_ptr(), b3.stride(0), sb1)
    return _dot_launch([op], n, B, a.device).reshape((N_LIMBS, *batch))


def dot_many(pairs) -> torch.Tensor:
    """[(a, b), ...] flat dots -> (8, len(pairs)), in one K3 launch.

    On the card every operand is (8, n) of one n (the halves of one sumcheck
    round; strided views are read in place) and there are at most
    DOT_MAX_PAIRS pairs; the plain version takes any shapes."""
    pairs = list(pairs)
    uniq = {id(t): t for p in pairs for t in p}  # a round's pairs share operands
    ts = list(uniq.values())
    _check_planar(*ts)
    if not _on_cuda(*ts):
        return dot_many_plain(pairs)
    shape = ts[0].shape
    if len(shape) != 2 or any(t.shape != shape for t in ts):
        raise ValueError(f"dot_many: every operand must be one (8, n) shape, got {[tuple(t.shape) for t in ts]}")
    if not 1 <= len(pairs) <= DOT_MAX_PAIRS:
        raise ValueError(f"dot_many: {len(pairs)} pairs, 1 to {DOT_MAX_PAIRS} per launch")
    unit = {k: _unit_last(t) for k, t in uniq.items()}  # copies live until after the launch
    ptr = {k: (t.data_ptr(), t.stride(0)) for k, t in unit.items()}
    ops = [(*ptr[id(a)], 0, *ptr[id(b)], 0) for a, b in pairs]
    return _dot_launch(ops, shape[1], 1, ts[0].device)


# ---------------------------------------------------------------------------
# K7: batched inversion
# ---------------------------------------------------------------------------

_P_MINUS_2 = SPEC.p - 2


def _scan_plain(p: torch.Tensor, reverse: bool) -> torch.Tensor:
    """Inclusive prefix (or suffix) products of planar (8, n) by doubling
    steps of the plain product."""
    n = p.shape[1]
    d = 1
    while d < n:
        q = p.clone()
        if reverse:
            q[:, : n - d] = mul_plain(p[:, : n - d].contiguous(), p[:, d:].contiguous())
        else:
            q[:, d:] = mul_plain(p[:, d:].contiguous(), p[:, : n - d].contiguous())
        p, d = q, 2 * d
    return p


def _pow_plain(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e of planar (8, k), Montgomery, left to right over e's bits."""
    acc = torch.from_numpy(SPEC.ONE_mont.reshape(N_LIMBS, 1)).to(a.device).expand(a.shape).contiguous()
    for b in range(e.bit_length() - 1, -1, -1):
        acc = mul_plain(acc, acc)
        if (e >> b) & 1:
            acc = mul_plain(acc, a)
    return acc


def batch_inverse_plain(x: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse of (n, 8) Montgomery rows, plain PyTorch:
    Montgomery's trick with prefix and suffix products by doubling steps
    and one Fermat power of the total, out_i = pre_(i-1) * total^-1 *
    suf_(i+1). A zero anywhere makes every output zero (lookup.py)."""
    n = x.shape[0]
    p = x.transpose(0, 1).contiguous()  # (8, n)
    if n == 0:
        return x.clone()
    pre, suf = _scan_plain(p, False), _scan_plain(p, True)
    tinv = _pow_plain(pre[:, n - 1 :], _P_MINUS_2)
    one = torch.from_numpy(SPEC.ONE_mont.reshape(N_LIMBS, 1)).to(x.device)
    left = torch.cat([one, pre[:, : n - 1]], dim=1)
    right = torch.cat([suf[:, 1:], one], dim=1)
    out = mul_plain(mul_plain(left, right), tinv.expand(N_LIMBS, n).contiguous())
    return out.transpose(0, 1).contiguous()


@functools.lru_cache(maxsize=None)
def _inverse_counter(device: int, stream: int) -> torch.Tensor:
    """K7's ticket, one zero word per (device, stream), kept for the process:
    launches on one stream run in order, and each leaves it at 0."""
    return torch.zeros((1,), dtype=torch.int32, device=torch.device("cuda", device))


def batch_inverse_many(xs) -> list[torch.Tensor]:
    """[x^-1 elementwise for each x], x (n, 8) uint32 Montgomery rows: K7 on
    CUDA tensors, all segments in one call (two launches, counted as one;
    the kernel's limits on segments and rows raise), a batch_inverse_plain
    call a segment on CPU ones.
    Each segment keeps the JAX function's zero rule on its own: a zero input
    makes every output of its segment zero, and no other."""
    xs = list(xs)
    for x in xs:
        if x.dtype != torch.uint32 or x.dim() != 2 or x.shape[1] != N_LIMBS:
            raise ValueError(f"batch_inverse: expected uint32 (n, 8) rows, got {x.dtype} {tuple(x.shape)}")
    if not xs or not _on_cuda(*xs):
        return [batch_inverse_plain(x) for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    live = [(x.contiguous(), o) for x, o in zip(xs, outs) if x.shape[0]]  # copies live until after the launch
    if live:
        S = len(live)
        ns = (ctypes.c_longlong * S)(*(x.shape[0] for x, _ in live))
        lib = _inverse_lib()
        words = lib.zk_fr_batch_inverse_scratch(ns, S)
        if words < 0:
            raise ValueError(f"batch_inverse_many: segments of {list(ns)} rows exceed K7's limits "
                             "(csrc/fr_inverse.cu: MAX_SEGMENTS segments, 2^31 - 1 rows in all)")
        dev = live[0][0].device
        idx = dev.index
        stream = torch._C._cuda_getCurrentRawStream(idx)
        scratch = torch.empty((words,), dtype=torch.uint32, device=dev)
        rc = lib.zk_fr_batch_inverse((ctypes.c_void_p * S)(*(x.data_ptr() for x, _ in live)),
                                     (ctypes.c_void_p * S)(*(o.data_ptr() for _, o in live)), ns, S,
                                     scratch.data_ptr(), _inverse_counter(idx, stream).data_ptr(), stream, idx)
        _check(rc, "fr_batch_inverse")
        INVERSE.launches += 1
    return outs


def batch_inverse(x: torch.Tensor) -> torch.Tensor:
    """x^-1 elementwise for (n, 8) uint32 Montgomery rows (the JAX function
    takes them nonzero): batch_inverse_many of one segment. A zero input
    makes every output zero, as in the JAX function."""
    return batch_inverse_many([x])[0]


# ---------------------------------------------------------------------------
# K9: canonical cross-rank sums
# ---------------------------------------------------------------------------

def collect_plain(sums: torch.Tensor) -> torch.Tensor:
    """(k, 8) int64 limb sums -> (k, 8) uint32 canonical values, plain PyTorch."""
    return mp.u32(mp.reduce_limb_sums(SPEC, sums.transpose(0, 1))).transpose(0, 1).contiguous()


def collect(sums: torch.Tensor) -> torch.Tensor:
    """The canonical sums mod p of k Fr values added limb by limb across at
    most 255 ranks (S < 2^8 p: csrc/fr_collect.cu's nine words and eight
    subtractions): (k, 8) int64 limb sums (an all-reduce's output, each <
    2^40) -> (k, 8) uint32. K9 on a CUDA tensor, the plain version on a CPU
    one."""
    if sums.dtype != torch.int64 or sums.dim() != 2 or sums.shape[1] != N_LIMBS:
        raise ValueError(f"collect: expected int64 (k, 8) limb sums, got {sums.dtype} {tuple(sums.shape)}")
    if not _on_cuda(sums):
        return collect_plain(sums)
    s = sums.contiguous()
    out = torch.empty(s.shape, dtype=torch.uint32, device=s.device)
    if s.shape[0]:
        idx = s.device.index
        rc = _collect_lib().zk_fr_collect(s.data_ptr(), out.data_ptr(), s.shape[0],
                                          torch._C._cuda_getCurrentRawStream(idx), idx)
        _check(rc, "fr_collect")
        COLLECT.launches += 1
    return out
