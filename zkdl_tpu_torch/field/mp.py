"""Multi-precision modular arithmetic on limb tensors, in plain PyTorch.

Counterpart of ``zkdl_tpu/field/mp.py``. The python-int helpers and
``FieldSpec`` are copied as they are. The tensor arithmetic is written for
PyTorch's integer support, which differs from XLA's:

- ``torch.uint32`` is a storage type only: it converts to and from ``int64``
  and views as ``int32``, but has no arithmetic, comparison, ``where`` or
  gather on the card. So limbs are stored as ``uint32`` and widened to
  ``int64`` for arithmetic; data movement (gathers, selects) runs on the
  ``int32`` view of the same bits.
- The working form is LIMB-LEADING ``int64[L, ...]`` (the planar layout of
  ``field/planar.py``): limb ``i`` of every element is one tensor row, so each
  limb step is one elementwise op over all elements.
- Carries of additions resolve with the packed-integer prefix trick of
  ``zkdl_tpu/field/mp.py:_prefix_carry`` (fixed op count, no host sync).
- Montgomery products run in radix 2^16 (a 16x16-bit product is exact in
  int64 with room for column sums). This is the plain reference the CUDA
  kernels are checked against; on the card the kernels replace it.

All values are kept canonical (< p), so results are bit-identical to the JAX
package whatever the algorithm.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

M16 = 0xFFFF
M32 = 0xFFFFFFFF


def limbs_from_int(x: int, n_limbs: int) -> np.ndarray:
    """Python int -> little-endian u32 limb vector."""
    out = np.zeros((n_limbs,), dtype=np.uint32)
    for i in range(n_limbs):
        out[i] = (x >> (32 * i)) & 0xFFFFFFFF
    return out


def int_from_limbs(limbs) -> int:
    limbs = np.asarray(limbs, dtype=np.uint32)
    x = 0
    for i in reversed(range(limbs.shape[-1])):
        x = (x << 32) | int(limbs[..., i])
    return x


def digits_from_int(x: int, n_digits: int) -> np.ndarray:
    out = np.zeros((n_digits,), dtype=np.uint32)
    for i in range(n_digits):
        out[i] = (x >> (16 * i)) & 0xFFFF
    return out


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static parameters of a prime field with 2^(32*n_limbs) Montgomery radix."""

    name: str
    p: int
    n_limbs: int

    @property
    def n_digits(self) -> int:
        return 2 * self.n_limbs

    @functools.cached_property
    def r(self) -> int:
        return 1 << (32 * self.n_limbs)

    @functools.cached_property
    def r_inv(self) -> int:
        return pow(self.r, -1, self.p)

    @functools.cached_property
    def r2(self) -> int:
        return (self.r * self.r) % self.p

    @functools.cached_property
    def np_full(self) -> int:  # -p^-1 mod R
        return (-pow(self.p, -1, self.r)) % self.r

    @functools.cached_property
    def P_limbs(self) -> np.ndarray:
        return limbs_from_int(self.p, self.n_limbs)

    @functools.cached_property
    def ONE_mont(self) -> np.ndarray:  # R mod p
        return limbs_from_int(self.r % self.p, self.n_limbs)

    @functools.cached_property
    def R2_limbs(self) -> np.ndarray:
        return limbs_from_int(self.r2, self.n_limbs)

    @functools.cached_property
    def ZERO(self) -> np.ndarray:
        return np.zeros((self.n_limbs,), dtype=np.uint32)

    def to_int(self, limbs) -> int:
        return int_from_limbs(limbs)

    def from_int(self, x: int) -> np.ndarray:
        return limbs_from_int(x % self.p, self.n_limbs)

    def to_mont_int(self, x: int) -> int:
        return (x * self.r) % self.p

    def from_mont_int(self, x: int) -> int:
        return (x * self.r_inv) % self.p


# ---------------------------------------------------------------------------
# storage <-> working form
# ---------------------------------------------------------------------------


def host(x) -> np.ndarray:
    """uint32 array or tensor (any device) -> host numpy uint32 array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.uint32)


def i64(t: torch.Tensor) -> torch.Tensor:
    """uint32 (or small non-negative int) tensor -> int64 values."""
    return t.to(torch.int64)


def u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> uint32 storage."""
    return x.to(torch.uint32)


def where(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where that also takes uint32 operands (selected as int32 bits)."""
    if a.dtype == torch.uint32:
        return torch.where(pred, a.view(torch.int32), b.view(torch.int32)).view(torch.uint32)
    return torch.where(pred, a, b)


def take(t: torch.Tensor, index: torch.Tensor, dim: int) -> torch.Tensor:
    """index_select that also takes uint32 tensors (gathered as int32 bits)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).index_select(dim, index).view(torch.uint32)
    return t.index_select(dim, index)


@functools.lru_cache(maxsize=None)
def _const(values: tuple, device: torch.device, ndim: int) -> torch.Tensor:
    """Constant int64 column (len(values), 1, ..., 1) cached per device."""
    t = torch.tensor(values, dtype=torch.int64, device=device)
    return t.reshape((len(values),) + (1,) * (ndim - 1))


def const(values, like: torch.Tensor) -> torch.Tensor:
    """Limb-leading int64 constant broadcastable against `like` (L, ...)."""
    return _const(tuple(int(v) for v in values), like.device, like.dim())


# ---------------------------------------------------------------------------
# carries (fixed op count: no host sync on the card)
# ---------------------------------------------------------------------------


def _prefix_carries(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """gen/prop: bool (L, ...), disjoint. Returns int64 (L + 1, ...) where row k
    is the carry INTO limb k (row L: carry out of the top limb).

    Packs the L flags into one integer per element; the machine addition of
    A = gen and B = gen | prop computes every carry of the chain at once
    (cin = (A + B) ^ A ^ B), as zkdl_tpu/field/mp.py:_prefix_carry does."""
    L = gen.shape[0]
    w = const([1 << k for k in range(L)], gen.to(torch.int64))
    A = (gen.to(torch.int64) * w).sum(0)
    B = A | (prop.to(torch.int64) * w).sum(0)
    cin = (A + B) ^ A ^ B
    shifts = const(range(L + 1), w)
    return (cin.unsqueeze(0) >> shifts) & 1


def raw_add(a: torch.Tensor, b: torch.Tensor):
    """Limbwise a + b of int64 limb tensors (L, ...). Returns (limbs, carry_out)."""
    s = a + b
    low = s & M32
    c = _prefix_carries(s > M32, low == M32)
    return (low + c[:-1]) & M32, c[-1]


def raw_sub(a: torch.Tensor, b: torch.Tensor):
    """Limbwise a - b. Returns (limbs mod 2^(32L), borrow_out)."""
    d = a - b
    c = _prefix_carries(d < 0, d == 0)
    return (d - c[:-1]) & M32, c[-1]


def mod_add(P: np.ndarray, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for canonical a, b (p < 2^(32L - 1): no carry out)."""
    s, _ = raw_add(a, b)
    d, borrow = raw_sub(s, const(P, s))
    return torch.where(borrow.bool(), s, d)


def mod_sub(P: np.ndarray, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d, borrow = raw_sub(a, b)
    fixed, _ = raw_add(d, const(P, d))
    return torch.where(borrow.bool(), fixed, d)


def sub_p_if_gte(P: np.ndarray, r: torch.Tensor) -> torch.Tensor:
    d, borrow = raw_sub(r, const(P, r))
    return torch.where(borrow.bool(), r, d)


def gte(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a >= b over limb-leading tensors -> bool (...)."""
    _, borrow = raw_sub(a, b)
    return borrow == 0


# ---------------------------------------------------------------------------
# Montgomery product, radix 2^16 (plain reference of the CUDA kernels)
# ---------------------------------------------------------------------------


def to_digits(x: torch.Tensor) -> torch.Tensor:
    """(L, ...) int64 limbs -> (2L, ...) 16-bit digits, little-endian."""
    return torch.stack([x & M16, x >> 16], 1).reshape(2 * x.shape[0], *x.shape[1:])


def from_digits(d: torch.Tensor) -> torch.Tensor:
    return d[0::2] | (d[1::2] << 16)


def normalize_digits(cols: torch.Tensor) -> torch.Tensor:
    """(K, ...) non-negative int64 column sums (each < 2^40) -> K normalized
    16-bit digits; the carry out of the top digit is dropped. Fixed op count:
    three carry-save passes bring every column to <= 2^16 + 1, then one
    packed prefix pass resolves the remaining 0/1 carries (K <= 62)."""
    for _ in range(3):
        c = cols >> 16
        cols = (cols & M16) + torch.cat([torch.zeros_like(c[:1]), c[:-1]])
    cin = _prefix_carries(cols > M16, cols == M16)
    return (cols + cin[:-1]) & M16


def digit_sums(x: torch.Tensor) -> torch.Tensor:
    """(L, ..., n) int64 limbs -> (2L, ...) sums of each 16-bit digit over the
    last axis (exact in int64 for n < 2^24)."""
    return to_digits(x).sum(-1)


def reduce_digit_sums(spec: FieldSpec, cols: torch.Tensor, lift) -> torch.Tensor:
    """(2L, ...) int64 digit-column sums (each < 2^40) of a value S -> (L, ...)
    int64 canonical S mod p.

    S = low + c * 2^(32L) with low < 2^(32L) < 3p (two conditional
    subtractions) and a small overflow word c, whose c * R mod p is
    `lift(c_limbs)` = mont(c * R^2) (one Montgomery product by R^2 mod p),
    the reduction of zkdl_tpu/field/planar.py:masked_sum."""
    L = spec.n_limbs
    limbs = cols[0::2] + (cols[1::2] << 16)
    out = []
    carry = torch.zeros_like(limbs[0])
    for i in range(L):
        v = limbs[i] + carry
        out.append(v & M32)
        carry = v >> 32
    low = torch.stack(out)
    for _ in range(2):
        low = sub_p_if_gte(spec.P_limbs, low)
    hi = torch.cat([carry.unsqueeze(0), torch.zeros_like(low[1:])])
    return mod_add(spec.P_limbs, low, lift(hi))


def reduce_limb_sums(spec: FieldSpec, sums: torch.Tensor) -> torch.Tensor:
    """(L, ...) non-negative int64 limb sums of a value S = sum_i sums[i]
    2^(32 i) < 2^8 p (the limbs of at most 255 canonical values added limb
    by limb, each sum < 2^40) -> (L, ...) int64 canonical S mod p: carried
    into L + 1 32-bit words, then p 2^j subtracted where it fits, j = 7 ... 0
    (zkdl_tpu/parallel/collectives.py:reduce_mod_p). The plain version of
    K9 (csrc/fr_collect.cu)."""
    L = spec.n_limbs
    words = []
    carry = torch.zeros_like(sums[0])
    for i in range(L):
        v = sums[i] + carry
        words.append(v & M32)
        carry = v >> 32
    v = torch.stack(words + [carry])
    for j in range(7, -1, -1):
        d, borrow = raw_sub(v, const(limbs_from_int(spec.p << j, L + 1), v))
        v = torch.where(borrow.bool(), v, d)
    return v[:L]


@functools.lru_cache(maxsize=None)
def _toeplitz(digits: tuple, n_rows: int, device: torch.device) -> torch.Tensor:
    """float64 (n_rows, D): row k holds the constant's digit k - i in column
    i, so T @ x gives the column sums of x times the constant (< 2^37)."""
    D = len(digits)
    T = torch.zeros((n_rows, D), dtype=torch.float64)
    for k in range(n_rows):
        for i in range(D):
            if 0 <= k - i < D:
                T[k, i] = float(digits[k - i])
    return T.to(device)


def _columns_const(x: torch.Tensor, const_int: int, n_cols: int) -> torch.Tensor:
    """Column sums of the digits x (D, ...) times a constant, columns >=
    n_cols dropped: one float64 product with its Toeplitz matrix (exact)."""
    D = x.shape[0]
    T = _toeplitz(tuple(int(v) for v in digits_from_int(const_int, D)), min(n_cols, 2 * D - 1), x.device)
    cols = (T @ x.reshape(D, -1).to(torch.float64)).to(torch.int64).reshape(T.shape[0], *x.shape[1:])
    if n_cols <= 2 * D - 1:
        return cols
    return torch.cat([cols, torch.zeros_like(cols[: n_cols - 2 * D + 1])])


def _columns_var(ad: torch.Tensor, bd: torch.Tensor) -> torch.Tensor:
    """Schoolbook column sums of two digit tensors (D, ...), 2D - 1 columns:
    one shifted multiply-add per digit of a (int64, each column < 2^37)."""
    D = ad.shape[0]
    cols = torch.zeros((2 * D - 1, *ad.shape[1:]), dtype=torch.int64, device=ad.device)
    for i in range(D):
        cols[i : i + D] += ad[i] * bd
    return cols


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b*R^-1 mod p on limb-leading int64 tensors (L, ...); full-word REDC in
    radix 2^16 (zkdl_tpu/field/mp.py:mont_mul). Requires a*b < p*R."""
    D = spec.n_digits
    a, b = torch.broadcast_tensors(a, b)
    cols = _columns_var(to_digits(a), to_digits(b))
    T = normalize_digits(torch.cat([cols, torch.zeros_like(cols[:1])]))  # a*b < p*R: 2D digits
    low = T[:D]
    m = normalize_digits(_columns_const(low, spec.np_full, D))
    total = _columns_const(m, spec.p, 2 * D + 1)
    total[: 2 * D] += T
    r = from_digits(normalize_digits(total)[D : 2 * D])  # (T + m p) / R < 2p
    return sub_p_if_gte(spec.P_limbs, r)
