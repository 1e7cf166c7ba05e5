"""zkFC: quantized fully-connected layer (exact field matmul) + its prover.

Counterpart of ``zkdl_tpu/models/zkfc.py``: ``field_matmul`` (:47),
``_signed_digits``, ``_combine_columns``, ``_lift_cols_to_mont``,
``field_matmul_fast`` (:86-195), ``ZkFC`` (:202-233), ``ZkFCProof``,
``_fc_prove_core`` (:248), ``_fc_prep_planar`` (:260-292), ``prove``
(:295), ``prove_planar`` (grouped and round-interleaved, :313-372) and
``verify`` (:375-397). ``prove`` is ``prove_planar`` without a chain point:
the same draws and stream, with the opening ``pedersen.open_planar``, which
emits ``pedersen.open``'s proof on the transparent setup (the JAX package
asserts both equalities).

Forward: every operand lies in (-2^47, 2^47) (the protocol's own bound), so
Z = X @ W over Fr is computed exactly from 7-bit signed digits with two int8
matrix products (``torch._int_mm``; int32 sums < 2^26) and lifted back into
Montgomery Fr with one field product per output element.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..commit import pedersen
from ..field import mp, planar
from ..sumcheck import planar_protocols as pp
from ..sumcheck import protocols as sc
from ..sumcheck.transcript import ChallengeSource
from ..tensor import fr_ops
from ..tensor import planar_ops as pops

_N_DIGITS = 7  # 7-bit digits x 7 = 49 bits, covers the 48-bit bound
_DIGIT_BITS = 7
_N_COLS = 2 * _N_DIGITS - 1


_MATMUL_CHUNK = 1 << 22  # products per K3 launch of field_matmul (bounds its operand copies)


def field_matmul(X: torch.Tensor, W: torch.Tensor, in_size: int, out_size: int) -> torch.Tensor:
    """Z = X @ W over Fr (Montgomery), exact for any operands: X (batch*in,
    8), W (in*out, 8) -> (batch*out, 8). Each output is one lazy dot (K3)
    over the in axis, a chunk of output rows per launch."""
    batch = X.shape[0] // in_size
    Xp = planar.to_planar(X).reshape(8, batch, 1, in_size)
    Wt = planar.to_planar(W).reshape(8, in_size, out_size).transpose(1, 2).reshape(8, 1, out_size, in_size)
    rows = max(1, _MATMUL_CHUNK // max(1, out_size * in_size))
    parts = []
    for lo in range(0, batch, rows):
        k = min(rows, batch - lo)
        a = Xp[:, lo : lo + k].expand(8, k, out_size, in_size).reshape(8, k * out_size, in_size)
        b = Wt.expand(8, k, out_size, in_size).reshape(8, k * out_size, in_size)
        parts.append(planar.dot(a, b))
    return planar.from_planar(torch.cat(parts, dim=1)).contiguous()


def _signed_digits(v: torch.Tensor):
    """Montgomery Fr (n, 8) -> (pos_digits, neg_digits) int8 (n, 7) of the
    value's magnitude, split by sign (values must lie in (-2^47, 2^47))."""
    x = planar.from_mont(planar.to_planar(v))  # (8, n) raw value, canonical
    x64 = mp.i64(x)
    hi_or = x64[2] | x64[3] | x64[4] | x64[5] | x64[6] | x64[7]
    pos = (x64[1] <= 32767) & (hi_or == 0)  # x <= 2^47 - 1
    negx = mp.i64(planar.neg(x))
    lo = torch.where(pos, x64[0], negx[0])
    hi = torch.where(pos, x64[1], negx[1])
    digits = []
    for k in range(_N_DIGITS):
        s = _DIGIT_BITS * k
        if s < 32:
            d = lo >> s
            if s > 32 - _DIGIT_BITS:
                d = d | (hi << (32 - s))
        else:
            d = hi >> (s - 32)
        digits.append(d & 0x7F)
    dig = torch.stack(digits, dim=-1).to(torch.int8)  # (n, 7)
    posb = pos.unsqueeze(-1)
    zero = torch.zeros_like(dig)
    return torch.where(posb, dig, zero), torch.where(posb, zero, dig)


def _int8_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """int8 (m, k) @ (k, n) -> int32, exact. torch._int_mm on the card needs
    m > 16 and k, n multiples of 8, and cuBLASLt refuses some row counts
    that are not a multiple of 32 (28 rows, at batch 4): pad with zeros and
    cut the result."""
    m, k = A.shape
    n = B.shape[1]
    mp_, kp, np_ = -(-m // 32) * 32, -(-k // 8) * 8, -(-n // 8) * 8
    if (mp_, kp) != (m, k):
        A = torch.nn.functional.pad(A, (0, kp - k, 0, mp_ - m))
    if (kp, np_) != (k, n):
        B = torch.nn.functional.pad(B, (0, np_ - n, 0, kp - k))
    return torch._int_mm(A.contiguous(), B.contiguous())[:m, :n]


def _combine_columns(R: torch.Tensor) -> torch.Tensor:
    """(b, d1, d2, o) int32 -> (b, o, 13) int64 column sums c = d1 + d2."""
    b, _, _, o = R.shape
    cols = torch.zeros((_N_COLS, b, o), dtype=torch.int64, device=R.device)
    for d1 in range(_N_DIGITS):
        for d2 in range(_N_DIGITS):
            cols[d1 + d2] += R[:, d1, d2, :]
    return cols.permute(1, 2, 0)


def _lift_cols_to_mont(cols: torch.Tensor) -> torch.Tensor:
    """(..., 13) int64 radix-2^7 column sums (each < 2^30) -> planar (8, ...)
    Montgomery Fr of V = sum_c cols_c * 2^(7c) (V < 2^114 < p): V's 16-bit
    digits by shifted adds, then one Montgomery product by R^2 (K2)."""
    digs = [torch.zeros(cols.shape[:-1], dtype=torch.int64, device=cols.device) for _ in range(16)]
    for c in range(cols.shape[-1]):
        q, r0 = divmod(_DIGIT_BITS * c, 16)
        vc = cols[..., c]
        digs[q] = digs[q] + ((vc << r0) & mp.M16)
        digs[q + 1] = digs[q + 1] + ((vc >> (16 - r0)) & mp.M16)
        if r0 > 2:  # vc < 2^30: a third slot exists only when 30 + r0 > 32
            digs[q + 2] = digs[q + 2] + (vc >> (32 - r0))
    raw = mp.from_digits(mp.normalize_digits(torch.stack(digs)))
    return planar.to_mont(mp.u32(raw))


def field_matmul_fast(X: torch.Tensor, W: torch.Tensor, in_size: int, out_size: int) -> torch.Tensor:
    """Z = X @ W over Fr for (batch*in, 8) X and (in*out, 8) W, Montgomery,
    exact while every operand is in (-2^47, 2^47)."""
    batch = X.shape[0] // in_size
    xp, xn = _signed_digits(X)
    wp, wn = _signed_digits(W)
    A = torch.cat(
        [xp.reshape(batch, in_size, _N_DIGITS), xn.reshape(batch, in_size, _N_DIGITS)], dim=1
    ).transpose(1, 2).reshape(batch * _N_DIGITS, 2 * in_size)
    Wp = wp.reshape(in_size, out_size, _N_DIGITS).transpose(1, 2).reshape(in_size, _N_DIGITS * out_size)
    Wn = wn.reshape(in_size, out_size, _N_DIGITS).transpose(1, 2).reshape(in_size, _N_DIGITS * out_size)
    Bpos = torch.cat([Wp, Wn], dim=0)  # xp@wp + xn@wn
    Bneg = torch.cat([Wn, Wp], dim=0)  # xp@wn + xn@wp

    def mm(B):
        # 2*in_size <= 2^12 terms of 127^2: int32 sums < 2^26
        return _int8_matmul(A, B).reshape(batch, _N_DIGITS, _N_DIGITS, out_size)

    Zp = planar.sub(_lift_cols_to_mont(_combine_columns(mm(Bpos))),
                    _lift_cols_to_mont(_combine_columns(mm(Bneg))))
    return Zp.movedim(0, -1).reshape(batch * out_size, 8)


@dataclasses.dataclass
class ZkFC:
    """Layer parameters. weights: (in_size*out_size, 8) Montgomery, padded to
    powers of two; gens: generator vector; com: row commitments (m,)."""

    in_size: int
    out_size: int
    weights: torch.Tensor
    gens: pedersen.Generators
    com: pedersen.RowCommitments

    @staticmethod
    def gen_size_for(in_size: int, out_size: int) -> int:
        return 1 << ((fr_ops.ceil_log2(in_size * out_size) + 1) // 2)

    @classmethod
    def from_float(cls, w: np.ndarray, key: np.ndarray, device) -> "ZkFC":
        """w: float (in, out) unpadded. Quantizes, pads, commits; the
        generators are drawn from the prng key `key`."""
        from . import quantize

        weights = quantize.load_weights(w, device)
        in_p = 1 << fr_ops.ceil_log2(w.shape[0])
        out_p = 1 << fr_ops.ceil_log2(w.shape[1])
        gens = pedersen.setup(key, cls.gen_size_for(in_p, out_p), device)
        return cls(in_p, out_p, weights, gens, pedersen.commit(gens, weights))

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        if X.shape[0] % self.in_size:
            raise ValueError(f"input rows {X.shape[0]} not a multiple of {self.in_size}")
        return field_matmul_fast(X, self.weights, self.in_size, self.out_size)


@dataclasses.dataclass
class ZkFCProof:
    u_bs: torch.Tensor
    u_in: torch.Tensor
    u_out: torch.Tensor
    ip_polys: torch.Tensor  # (log in, 3, 8)
    ip_finals: torch.Tensor  # (2, 8): X'(u_in), W'(u_in)
    z_claim: torch.Tensor  # (8,)  Z(u_out || u_bs)
    opening: pedersen.OpeningProof


def _fc_prep_planar(X, W, Z, u_bs, u_out, in_size, out_size):
    """Planar prep of the matmul sumcheck: each multi-variable fold is one
    eq-weighted contraction (K3 with a batch axis); only the inner-product
    operands come out bit-reversed."""
    dev = X.device
    batch = X.shape[0] // in_size
    lb = fr_ops.ceil_log2(batch)
    X3 = fr_ops.pad_to(X.reshape(batch, in_size, 8), 1 << lb)
    Xp = pops.bitrev_axis(X3.permute(2, 1, 0), axis=1)  # (8, I, B2)
    X_folded = planar.dot(Xp, pops.eq_table(u_bs, dev)[:, None, :]) if lb else Xp[:, :, 0]

    Wp = pops.bitrev_axis(W.reshape(in_size, out_size, 8).permute(2, 0, 1), axis=1)  # (8, I, O)
    W_folded = planar.dot(Wp, pops.eq_table(u_out, dev)[:, None, :])  # (8, I) bit-rev

    u_full = np.concatenate([u_out, u_bs], axis=0)
    Zp = planar.to_planar(fr_ops.pad_to(Z, 1 << u_full.shape[0]))
    z_claim = planar.dot(Zp, pops.eq_table(u_full, dev))
    return X_folded, W_folded, z_claim


def fc_prove_core(X, W, Z, u_bs, u_in, u_out, in_size: int, out_size: int):
    """The matmul sumcheck (zkfc.py:_fc_prove_core): X folded along the
    batch axis at u_bs, W along the out axis at u_out, the inner-product
    sumcheck over u_in, and the output claim Z(u_out || u_bs). Returns
    (ip_polys, ip_finals, z_claim)."""
    X_folded, W_folded, z_claim = _fc_prep_planar(X, W, Z, mp.host(u_bs), mp.host(u_out), in_size, out_size)
    ip_polys, ip_finals = pp.inner_product_prove(X_folded, W_folded, mp.host(u_in))
    return ip_polys, ip_finals, z_claim


def prove(layer: ZkFC, X: torch.Tensor, Z: torch.Tensor, challenges: ChallengeSource) -> ZkFCProof:
    """zkfc.py:prove: draws (u_bs, u_in, u_out), the matmul sumcheck, the
    weight opening at u_out || u_in; absorbs ip_polys and z_claim."""
    return prove_planar(layer, X, Z, challenges)


def prove_planar(layer: ZkFC, X: torch.Tensor, Z: torch.Tensor, challenges: ChallengeSource,
                 z_point=None, interleave: bool = False) -> ZkFCProof:
    """Matmul sumcheck + weight opening. Challenge order (u_bs, u_in, u_out).

    Chained mode: z_point (host (log_out + log_batch, 8)) fixes
    (u_out || u_bs) to the adjacent ReLU's shared point; only u_in is drawn.

    interleave=True: the round-interleaved schedule. u_bs and u_out (the
    statement's evaluation point) are drawn first, the claim Z(u_out||u_bs)
    is absorbed, then the inner-product sumcheck absorbs each round's
    polynomial before drawing that round's fold challenge: u_in is an
    output of the transcript."""
    batch = X.shape[0] // layer.in_size
    lo = fr_ops.ceil_log2(layer.out_size)
    log_in = fr_ops.ceil_log2(layer.in_size)
    u_in = None
    if z_point is None:
        u_bs = challenges.random_vec(fr_ops.ceil_log2(batch))
        if not interleave:
            u_in = challenges.random_vec(log_in)
        u_out = challenges.random_vec(lo)
    else:
        if z_point.shape[0] != lo + fr_ops.ceil_log2(batch):
            raise ValueError(f"z_point {tuple(z_point.shape)} vs out bits {lo}, batch {batch}")
        u_out, u_bs = z_point[:lo], z_point[lo:]
        if not interleave:
            u_in = challenges.random_vec(log_in)
    X_folded, W_folded, z_claim = _fc_prep_planar(
        X, layer.weights, Z, u_bs.numpy(), u_out.numpy(), layer.in_size, layer.out_size
    )
    if interleave:
        challenges.absorb_array(z_claim)
        ip_polys, ip_finals, u_in = pp.inner_product_prove_interleaved(X_folded, W_folded, challenges)
    else:
        ip_polys, ip_finals = pp.inner_product_prove(X_folded, W_folded, u_in)
    u_w = torch.cat([u_out, u_in], dim=0)
    opening = pedersen.open_planar(layer.gens, layer.weights, layer.com, u_w)
    proof = ZkFCProof(u_bs, u_in, u_out, ip_polys, ip_finals, z_claim, opening)
    if not interleave:
        challenges.absorb_array(ip_polys)
        challenges.absorb_array(z_claim)
    return proof


def verify_claims(proof: ZkFCProof) -> tuple[bool, str]:
    """The matmul sumcheck and the weight opening, on the proof alone. The
    initial claim is the proof's Z(u_out||u_bs); the W-side final claim must
    equal the opening's final scalar (the same MLE point)."""
    u_in = sc.scalars_to_ints(proof.u_in)
    claim = sc.scalars_to_ints(proof.z_claim)[0]
    res = sc.inner_product_verify(sc.polys_to_ints(proof.ip_polys), u_in, claim)
    if not res.ok:
        return False, "ip: " + res.reason
    fa, fb = sc.scalars_to_ints(proof.ip_finals)
    if not sc.inner_product_check_final(res, fa, fb):
        return False, "ip: final product mismatch"
    u_w = sc.scalars_to_ints(proof.u_out) + u_in
    ok, msg = pedersen.verify_open(proof.opening, u_w, expected_value=fb)
    if not ok:
        return False, "open: " + msg
    return True, ""


def verify_binding(layer_com: pedersen.RowCommitments, proof: ZkFCProof) -> tuple[bool, str]:
    """The opening's com(u_row) against the layer's row commitments: the
    verifier's one heavy step (a native G1 fold over every row)."""
    u_w = sc.scalars_to_ints(proof.u_out) + sc.scalars_to_ints(proof.u_in)
    ok, msg = pedersen.verify_open_against_com(proof.opening, layer_com, u_w)
    if not ok:
        return False, "open: " + msg
    return True, ""


def verify(layer_com: pedersen.RowCommitments, proof: ZkFCProof) -> tuple[bool, str]:
    """Verify the matmul sumcheck, the weight opening and its binding to
    the layer's row commitments (zkfc.py:verify)."""
    ok, msg = verify_claims(proof)
    if not ok:
        return ok, msg
    return verify_binding(layer_com, proof)
