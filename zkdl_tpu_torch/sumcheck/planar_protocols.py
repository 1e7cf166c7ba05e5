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
reach the kernels by value.
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


def _ip_round(a, b, x):
    """a, b: (8, n) bit-rev planar. Emits (c0, c1, c2) (3, 8) and folded halves."""
    a0, a1 = _halves(a)
    b0, b1 = _halves(b)
    da = planar.sub(a1, a0)
    db = planar.sub(b1, b0)
    dots = planar.dot_many([(a0, b0), (a0, db), (b0, da), (da, db)])  # (8, 4)
    c1 = planar.add(dots[:, 1], dots[:, 2])
    poly = torch.stack([dots[:, 0], c1, dots[:, 3]])
    a_n = planar.add(a0, planar.mul_scalar(da, x))
    b_n = planar.add(b0, planar.mul_scalar(db, x))
    return poly, a_n, b_n


def _bin_round(a, w, scale, x):
    """General binary round: a (8, n); w = eq-table prefix (8, n/2); scale
    corrects the table's accumulated (1-u_j) factors; x = fold challenge."""
    a0, a1 = _halves(a)
    d = planar.sub(a1, a0)
    aw = planar.mul(a0, w)
    dw = planar.mul(d, w)
    # c0 = sum (a0^2 - a0) w ; c1 = sum (2 a0 - 1) d w ; c2 = sum d^2 w
    dots = planar.dot_many([(a0, aw), (d, aw), (d, dw)])
    c0 = planar.sub(dots[:, 0], planar.lazy_sum(aw))
    c1 = planar.sub(planar.double(dots[:, 1]), planar.lazy_sum(dw))
    poly = _polys(torch.stack([c0, c1, dots[:, 2]], dim=1), scale)
    return poly, planar.add(a0, planar.mul_scalar(d, x))


def _fold_bits(b0, b1, neq, x):
    """Fold packed bits at challenge x: a 4-way select among {0, 1, x, 1-x}."""
    h = b0.shape[0]
    dev = b0.device
    x_int = fr.to_ints(x)[0]
    one_minus_x = mp.limbs_from_int(HF.sub(HF.one_mont, x_int), 8)
    hi_val = planar.select(b1, planar.const(x, h, dev), planar.const(one_minus_x, h, dev))
    eqv = planar.select(b0, planar.ones_mont(h, dev), planar.const(fr.ZERO, h, dev))
    return planar.select(neq, hi_val, eqv)


def _bin_round0_bits(bits, w, x):
    """Mul-free binary round 0 on packed bits (bool (n,), bit-rev storage):
    c0 = 0, c2 = sum_{a0 != a1} w, c1 = -c2."""
    b0, b1 = _halves(bits)
    neq = b0 != b1
    c2 = planar.masked_sum(neq, w)
    poly = torch.stack([torch.zeros_like(c2), planar.neg(c2), c2])
    return poly, _fold_bits(b0, b1, neq, x)


def _hp_round(a, b, w, scale, x):
    """General Hadamard round: a, b (8, n); w (8, n/2); fold challenge x."""
    a0, a1 = _halves(a)
    b0, b1 = _halves(b)
    da = planar.sub(a1, a0)
    db = planar.sub(b1, b0)
    bw = planar.mul(b0, w)
    dbw = planar.mul(db, w)
    dots = planar.dot_many([(a0, bw), (da, bw), (a0, dbw), (da, dbw)])
    c1 = planar.add(dots[:, 1], dots[:, 2])
    poly = _polys(torch.stack([dots[:, 0], c1, dots[:, 3]], dim=1), scale)
    a_n = planar.add(a0, planar.mul_scalar(da, x))
    b_n = planar.add(b0, planar.mul_scalar(db, x))
    return poly, a_n, b_n


def _hp_round0_bits(a, bits, w, x):
    """Hadamard round 0 with a bit-valued b: its products become selects."""
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
    b_n = _fold_bits(b0, b1, neq, x)
    a_n = planar.add(a0, planar.mul_scalar(da, x))
    return dots.transpose(0, 1).contiguous(), a_n, b_n


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


def inner_product_prove(a_rev, b_rev, u):
    """a_rev, b_rev: (8, 2^r) bit-rev planar; u: host (r, 8).
    Returns (polys (r, 3, 8), finals (2, 8))."""
    u = mp.host(u)
    r = u.shape[0]
    if a_rev.shape[1] != (1 << r):
        raise ValueError(f"inner_product_prove: size {a_rev.shape[1]} != 2^{r}")
    polys = []
    for i in range(r):
        p, a_rev, b_rev = _ip_round(a_rev, b_rev, u[i])
        polys.append(p)
    finals = torch.stack([a_rev[:, 0], b_rev[:, 0]])
    return (torch.stack(polys) if polys else _empty_polys(a_rev.device)), finals


def binary_prove_bits(bits_rev, u, v):
    """Binary sumcheck on packed bits: bits_rev bool (2^r,) bit-rev storage;
    u, v host (r, 8). Returns (polys (r, 3, 8), final (8,))."""
    u, v = mp.host(u), mp.host(v)
    r = u.shape[0]
    if bits_rev.shape[0] != (1 << r):
        raise ValueError(f"binary_prove_bits: size {bits_rev.shape[0]} != 2^{r}")
    dev = bits_rev.device
    if r == 0:
        return _empty_polys(dev), _bit_final(bits_rev[0])
    table = _eq_table(u[1:], dev)
    scales = host_scales(u)
    p0, a_rev = _bin_round0_bits(bits_rev, table, v[0])
    polys = [p0]
    for i in range(1, r):
        p, a_rev = _bin_round(a_rev, table[:, : a_rev.shape[1] // 2], scales[i], v[i])
        polys.append(p)
    return torch.stack(polys), a_rev[:, 0]


def hadamard_prove_bits(a_rev, bits_rev, u, v):
    """Hadamard sumcheck of a (.) b with b bit-valued (packed bool (2^r,)).
    a_rev: (8, 2^r) bit-rev; u, v host (r, 8). Returns (polys, finals (2, 8))."""
    u, v = mp.host(u), mp.host(v)
    r = u.shape[0]
    n = a_rev.shape[1]
    if n != (1 << r) or bits_rev.shape[0] != n:
        raise ValueError(f"hadamard_prove_bits: sizes {n}, {bits_rev.shape[0]} != 2^{r}")
    dev = a_rev.device
    if r == 0:
        return _empty_polys(dev), torch.stack([a_rev[:, 0], _bit_final(bits_rev[0])])
    table = _eq_table(u[1:], dev)
    scales = host_scales(u)
    p0, a_rev, b_rev = _hp_round0_bits(a_rev, bits_rev, table, v[0])
    polys = [p0]
    for i in range(1, r):
        p, a_rev, b_rev = _hp_round(a_rev, b_rev, table[:, : a_rev.shape[1] // 2], scales[i], v[i])
        polys.append(p)
    return torch.stack(polys), torch.stack([a_rev[:, 0], b_rev[:, 0]])
