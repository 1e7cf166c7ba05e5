"""Planar sumcheck provers: the rounds of ``zkdl_tpu/sumcheck/planar_protocols.py``.

Tensors live in bit-reversed planar storage (``tensor/planar_ops.py``), so
every round combines the two contiguous halves; the products and dots are
the K1-K3 kernels. The point-anchored provers (binary, Hadamard) evaluate
each round against a prefix of ONE eq table of u[1:], rescaled by a running
product of (1-u_j)^-1 computed on the host (``host_scales``). Binary round 0
runs on packed bits and is multiplication-free; Hadamard round 0 turns the
products by its bit operand into selects.

The rounds run down to size 1. The JAX package's scan tails and fused tails
(``TAIL_N``/``FUSE_N``) are XLA compile-time workarounds and emit the same
stream, so they have no counterpart here.

Challenges (u, v) are host uint32 (r, 8) tensors or arrays: fold challenges
reach the kernels by value. Each round is its polynomial (``_*_round_poly``)
then its fold (``_fold_half``, ``_fold_bits0``). One loop per protocol runs
them for the grouped provers, which take every challenge up front, and for
the round-interleaved ones (:368-446 of the JAX file), which absorb each
round's polynomial before drawing its fold challenge. Binary and Hadamard
take a bit operand packed (its round 0 specialised) or a general planar one
(round 0 the general round, its scale 1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import fr, host, mp, planar
from ..tensor import planar_ops as pops

HF = host.fr


def host_scales(u) -> np.ndarray:
    """scale[i] = prod_{1<=j<=i} (1-u[j])^-1 (Montgomery), for i in
    0..len(u)-1, on the host. Returns (len(u), 8) limbs."""
    u_ints = fr.to_ints(mp.host(u))
    one = HF.one_mont
    s = one
    out = [one]
    for j in range(1, len(u_ints)):
        d_val = HF.unmont(HF.sub(one, u_ints[j]))
        inv_val = pow(d_val, -1, fr.P_INT) if d_val else 0
        s = HF.mul(s, HF.mont(inv_val))
        out.append(s)
    return np.stack([mp.limbs_from_int(x, 8) for x in out])


def _halves(a: torch.Tensor):
    h = a.shape[-1] // 2
    return a[..., :h], a[..., h:]


def _polys(stacked: torch.Tensor, scale) -> torch.Tensor:
    """(8, 3) coefficient columns -> rescaled (3, 8) round polynomial."""
    return planar.mul_scalar(stacked, scale).transpose(0, 1).contiguous()


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------


def _fold_half(a, d, x):
    """Planar fold a (8, n) -> (8, n/2) at challenge x: a0 + x d, where
    d = a1 - a0 is the difference the round's polynomial computed."""
    return planar.add(a[:, : a.shape[1] // 2], planar.mul_scalar(d, x))


def _fold_bits0(bits, neq, x):
    """Fold packed bits (bool (n,)) at challenge x -> planar (8, n/2);
    neq = the halves' inequality, as round 0's polynomial computed it."""
    b0, b1 = _halves(bits)
    return _fold_bits(b0, b1, neq, x)


def _ip_round_poly(a, b):
    """a, b: (8, n) bit-rev planar. Returns the round polynomial
    (c0, c1, c2) (3, 8) and the halves' differences (da, db)."""
    a0, a1 = _halves(a)
    b0, b1 = _halves(b)
    da = planar.sub(a1, a0)
    db = planar.sub(b1, b0)
    dots = planar.dot_many([(a0, b0), (a0, db), (b0, da), (da, db)])  # (8, 4)
    c1 = planar.add(dots[:, 1], dots[:, 2])
    return torch.stack([dots[:, 0], c1, dots[:, 3]]), da, db


def _bin_round_poly(a, w, scale):
    """General binary round: a (8, n); w = eq-table prefix (8, n/2); scale
    corrects the table's accumulated (1-u_j) factors. Returns the poly
    and d = a1 - a0."""
    a0, a1 = _halves(a)
    d = planar.sub(a1, a0)
    aw = planar.mul(a0, w)
    dw = planar.mul(d, w)
    # c0 = sum (a0^2 - a0) w ; c1 = sum (2 a0 - 1) d w ; c2 = sum d^2 w
    dots = planar.dot_many([(a0, aw), (d, aw), (d, dw)])
    c0 = planar.sub(dots[:, 0], planar.lazy_sum(aw))
    c1 = planar.sub(planar.double(dots[:, 1]), planar.lazy_sum(dw))
    return _polys(torch.stack([c0, c1, dots[:, 2]], dim=1), scale), d


def _fold_bits(b0, b1, neq, x):
    """Fold packed bits at challenge x: a 4-way select among {0, 1, x, 1-x}."""
    h = b0.shape[0]
    dev = b0.device
    x_int = fr.to_ints(x)[0]
    one_minus_x = mp.limbs_from_int(HF.sub(HF.one_mont, x_int), 8)
    hi_val = planar.select(b1, planar.const(x, h, dev), planar.const(one_minus_x, h, dev))
    eqv = planar.select(b0, planar.ones_mont(h, dev), planar.const(fr.ZERO, h, dev))
    return planar.select(neq, hi_val, eqv)


def _bin_round0_poly(bits, w):
    """Mul-free binary round 0 on packed bits (bool (n,), bit-rev storage):
    c0 = 0, c2 = sum_{a0 != a1} w, c1 = -c2. Returns the poly and neq."""
    b0, b1 = _halves(bits)
    neq = b0 != b1
    c2 = planar.masked_sum(neq, w)
    return torch.stack([torch.zeros_like(c2), planar.neg(c2), c2]), neq


def _hp_round_poly(a, b, w, scale):
    """General Hadamard round: a, b (8, n); w (8, n/2). Returns the poly
    and (da, db)."""
    a0, a1 = _halves(a)
    b0, b1 = _halves(b)
    da = planar.sub(a1, a0)
    db = planar.sub(b1, b0)
    bw = planar.mul(b0, w)
    dbw = planar.mul(db, w)
    dots = planar.dot_many([(a0, bw), (da, bw), (a0, dbw), (da, dbw)])
    c1 = planar.add(dots[:, 1], dots[:, 2])
    return _polys(torch.stack([dots[:, 0], c1, dots[:, 3]], dim=1), scale), da, db


def _hp_round0_poly(a, bits, w):
    """Hadamard round 0 with a bit-valued b: its products become selects.
    Returns the poly, da and neq."""
    a0, a1 = _halves(a)
    b0, b1 = _halves(bits)
    da = planar.sub(a1, a0)
    neq = b0 != b1
    zero = torch.zeros_like(a0)
    # c0 = sum a0*b0*w ; c1 = sum (a0*db + b0*da)*w ; c2 = sum da*db*w
    a0db = planar.select(neq, planar.select(b1, a0, planar.neg(a0)), zero)
    dadb = planar.select(neq, planar.select(b1, da, planar.neg(da)), zero)
    dots = planar.dot_many([
        (planar.select(b0, a0, zero), w),
        (planar.add(a0db, planar.select(b0, da, zero)), w),
        (dadb, w),
    ])
    return dots.transpose(0, 1).contiguous(), da, neq


def _eq_table(u_tail, device) -> torch.Tensor:
    """eq table of u_tail in bit-reversed storage -> (8, 2^len)."""
    return pops.eq_table_rev(u_tail, device)


def _empty_polys(device) -> torch.Tensor:
    return torch.zeros((0, 3, 8), dtype=torch.uint32, device=device)


def _bit_final(bit: torch.Tensor) -> torch.Tensor:
    """A single stored bit as an Fr element (8,): mont(1) or 0."""
    one = planar.ones_mont(1, bit.device)[:, 0]
    return mp.where(bit.reshape(()), one, torch.zeros_like(one))


# ---------------------------------------------------------------------------
# provers
# ---------------------------------------------------------------------------
#
# Each protocol's rounds run once, in ``_*_rounds``, and take the fold
# challenge of round i from next_challenge(i, poly). The grouped provers
# read it from the challenges drawn up front (``_given``); the
# round-interleaved ones (textbook sumcheck Fiat-Shamir) absorb the round's
# polynomial and then draw it (``_Interleaved``): one host round trip per
# round, with the same round polynomials and folds.


def _given(xs):
    """next_challenge of the grouped schedule: the i-th of xs (host (r, 8))."""
    xs = mp.host(xs)
    return lambda i, poly: xs[i]


class _Interleaved:
    """next_challenge of the round-interleaved schedule: absorbs the round's
    polynomial, then draws its fold challenge; keeps what it drew."""

    def __init__(self, challenges):
        self.challenges, self.drawn = challenges, []

    def __call__(self, i, poly) -> np.ndarray:
        self.challenges.absorb_array(poly)
        self.drawn.append(mp.host(self.challenges.random_vec(1))[0])
        return self.drawn[-1]

    def tensor(self) -> torch.Tensor:
        """The drawn fold challenges as a host (r, 8) tensor."""
        return torch.from_numpy(np.stack(self.drawn) if self.drawn else np.zeros((0, 8), np.uint32))


def _ip_rounds(a_rev, b_rev, r, next_challenge):
    if a_rev.shape[1] != (1 << r):
        raise ValueError(f"inner_product_prove: size {a_rev.shape[1]} != 2^{r}")
    polys = []
    for i in range(r):
        p, da, db = _ip_round_poly(a_rev, b_rev)
        x = next_challenge(i, p)
        a_rev, b_rev = _fold_half(a_rev, da, x), _fold_half(b_rev, db, x)
        polys.append(p)
    finals = torch.stack([a_rev[:, 0], b_rev[:, 0]])
    return (torch.stack(polys) if polys else _empty_polys(a_rev.device)), finals


def _bin_rounds(a_rev, u, next_challenge):
    """a_rev: packed bits (bool (2^r,)), whose round 0 is multiplication-free,
    or a general planar (8, 2^r) operand."""
    r = u.shape[0]
    bits = a_rev.dtype == torch.bool
    if a_rev.shape[-1] != (1 << r):
        raise ValueError(f"binary_prove: size {a_rev.shape[-1]} != 2^{r}")
    dev = a_rev.device
    if r == 0:
        return _empty_polys(dev), (_bit_final(a_rev[0]) if bits else a_rev[:, 0])
    table = _eq_table(u[1:], dev)
    scales = host_scales(u)
    if bits:
        p, neq = _bin_round0_poly(a_rev, table)
        a_rev = _fold_bits0(a_rev, neq, next_challenge(0, p))
    else:
        p, d = _bin_round_poly(a_rev, table, scales[0])
        a_rev = _fold_half(a_rev, d, next_challenge(0, p))
    polys = [p]
    for i in range(1, r):
        p, d = _bin_round_poly(a_rev, table[:, : a_rev.shape[1] // 2], scales[i])
        a_rev = _fold_half(a_rev, d, next_challenge(i, p))
        polys.append(p)
    return torch.stack(polys), a_rev[:, 0]


def _hp_rounds(a_rev, b_rev, u, next_challenge):
    """b_rev: packed bits (bool (2^r,)), whose round 0 turns products into
    selects, or a general planar (8, 2^r) operand."""
    r = u.shape[0]
    n = a_rev.shape[1]
    bits = b_rev.dtype == torch.bool
    if n != (1 << r) or b_rev.shape[-1] != n:
        raise ValueError(f"hadamard_prove: sizes {n}, {b_rev.shape[-1]} != 2^{r}")
    dev = a_rev.device
    if r == 0:
        return _empty_polys(dev), torch.stack([a_rev[:, 0], _bit_final(b_rev[0]) if bits else b_rev[:, 0]])
    table = _eq_table(u[1:], dev)
    scales = host_scales(u)
    if bits:
        p, da, neq = _hp_round0_poly(a_rev, b_rev, table)
        x = next_challenge(0, p)
        a_rev, b_rev = _fold_half(a_rev, da, x), _fold_bits0(b_rev, neq, x)
    else:
        p, da, db = _hp_round_poly(a_rev, b_rev, table, scales[0])
        x = next_challenge(0, p)
        a_rev, b_rev = _fold_half(a_rev, da, x), _fold_half(b_rev, db, x)
    polys = [p]
    for i in range(1, r):
        p, da, db = _hp_round_poly(a_rev, b_rev, table[:, : a_rev.shape[1] // 2], scales[i])
        x = next_challenge(i, p)
        a_rev, b_rev = _fold_half(a_rev, da, x), _fold_half(b_rev, db, x)
        polys.append(p)
    return torch.stack(polys), torch.stack([a_rev[:, 0], b_rev[:, 0]])


def inner_product_prove(a_rev, b_rev, u):
    """a_rev, b_rev: (8, 2^r) bit-rev planar; u: host (r, 8).
    Returns (polys (r, 3, 8), finals (2, 8))."""
    return _ip_rounds(a_rev, b_rev, u.shape[0], _given(u))


def binary_prove_bits(bits_rev, u, v):
    """Binary sumcheck on packed bits: bits_rev bool (2^r,) bit-rev storage;
    u, v host (r, 8). Returns (polys (r, 3, 8), final (8,))."""
    return _bin_rounds(bits_rev, mp.host(u), _given(v))


def binary_prove(a_rev, u, v):
    """Binary sumcheck on a general planar operand a_rev (8, 2^r), bit-rev
    storage; u, v host (r, 8). Returns (polys (r, 3, 8), final (8,))."""
    return _bin_rounds(a_rev, mp.host(u), _given(v))


def hadamard_prove(a_rev, b_rev, u, v):
    """Hadamard sumcheck of a (.) b, both general planar (8, 2^r) bit-rev;
    u, v host (r, 8). Returns (polys (r, 3, 8), finals (2, 8))."""
    return _hp_rounds(a_rev, b_rev, mp.host(u), _given(v))


def hadamard_prove_bits(a_rev, bits_rev, u, v):
    """Hadamard sumcheck of a (.) b with b bit-valued (packed bool (2^r,)).
    a_rev: (8, 2^r) bit-rev; u, v host (r, 8). Returns (polys, finals (2, 8))."""
    return _hp_rounds(a_rev, bits_rev, mp.host(u), _given(v))


def inner_product_prove_interleaved(a_rev, b_rev, challenges):
    """Round-interleaved inner-product sumcheck: absorbs round i's poly,
    THEN draws fold challenge u[i]. Returns (polys (r, 3, 8), finals (2, 8),
    u (r, 8)): u is an output of the transcript, not an input."""
    nc = _Interleaved(challenges)
    return (*_ip_rounds(a_rev, b_rev, a_rev.shape[1].bit_length() - 1, nc), nc.tensor())


def binary_prove_bits_interleaved(bits_rev, u, challenges):
    """Round-interleaved binary sumcheck on packed bits: the anchor point u
    (host (r, 8)) is an input, the fold challenges v are transcript outputs.
    Returns (polys, final (8,), v (r, 8))."""
    nc = _Interleaved(challenges)
    return (*_bin_rounds(bits_rev, mp.host(u), nc), nc.tensor())


def hadamard_prove_bits_interleaved(a_rev, bits_rev, u, challenges):
    """Round-interleaved Hadamard sumcheck of a (.) b, b bit-valued (packed
    bool (2^r,)); u host (r, 8) is the anchor. Returns (polys, finals (2, 8),
    v (r, 8))."""
    nc = _Interleaved(challenges)
    return (*_hp_rounds(a_rev, bits_rev, mp.host(u), nc), nc.tensor())
