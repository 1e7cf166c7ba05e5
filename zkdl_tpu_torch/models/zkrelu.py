"""zkReLU: quantized ReLU with compact auxiliary bit witnesses + its prover.

Counterpart of ``zkdl_tpu/models/zkrelu.py``: the width constants (:43-46),
``_width_consts``/``_split_mag`` (:81-118), ``forward`` (:121-149, the
expanded aux of the (n, 8) reference path), ``forward_compact`` (:153-180),
``ZkReluProof`` (:258-306), ``_layout_body``/``_claims_body`` (:352-394),
``prove_planar`` in grouped and chained modes (:419-507) and its
round-interleaved schedule ``_prove_planar_interleaved`` (:510-602), the
host verifiers ``verify`` (:739-773) and ``verify_chained`` (:605-647), and
the committed-aux tier: ``AuxCommitments``, ``_expand_aux(_bits)``,
``_aux_gens``, ``commit_aux``, ``_absorb_aux_coms`` (:183-254), the
openings of both provers, ``_eq_weights`` (:651) and ``verify_committed``
(:665-736).
Per element of the pre-activation X (Montgomery Fr at scale 2^32),
x = unmont(X) read as a signed 48-bit fixed-point value: positive iff
x <= 2^47 - 1; mag is x or x + 2^47 (biased, negative); rem is a signed
16-bit remainder; the output is sign * mont((mag - rem) >> 16), ReLU fused
with the /2^16 requantization.
All 64-bit math runs on int64 (lo, hi) u32 pairs, as the JAX code does on u32.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import config
from ..commit import pedersen
from ..field import fr, host, mp, planar
from ..sumcheck import planar_protocols as pp
from ..sumcheck import protocols as sc
from ..sumcheck.transcript import ChallengeSource
from ..tensor import fr_ops
from ..tensor import planar_ops as pops

HF = host.fr


# The width constants (zkrelu.py:set_widths): Q, the mag_rescaled bit width;
# R, the remainder width (R-1 magnitude bits + sign); the requantization
# shift SCALE_OUT_BITS == R, mag_rescaled = (mag - rem) >> R. The reference's
# 32 and 16 (zkrelu.cu:74-77) unless ZKDL_RELU_MAG_BITS/ZKDL_RELU_REM_BITS
# set others (config.py).
Q, R = config.get().relu_mag_bits, config.get().relu_rem_bits
# R <= 31: _split_mag shifts 32-bit words by R and by 32 - R
if not (2 <= R <= 31 and 1 <= Q <= 32 and Q + R <= 64):
    raise ValueError(f"ReLU widths Q={Q}, R={R} out of range")
LOG_Q, LOG_R = (Q - 1).bit_length(), (R - 1).bit_length()
SCALE_OUT_BITS = R


@functools.lru_cache(maxsize=None)
def _width_consts(q: int, r: int):
    tb = q + r - 1
    return mp.limbs_from_int((1 << tb) - 1, 8), mp.limbs_from_int(1 << tb, 8)


def _split_mag(X: torch.Tensor, q: int, r: int):
    """(pos mask, rem_sign, rem_mag, mag_rescaled) per element, int64 (n,)."""
    pos_max, bias = _width_consts(q, r)
    x = mp.i64(planar.from_mont(planar.to_planar(X)))  # (8, n) raw, canonical
    pos = mp.gte(mp.const(pos_max, x), x)
    x_biased = mp.mod_add(fr.SPEC.P_limbs, x, mp.const(bias, x))
    lo = torch.where(pos, x[0], x_biased[0])
    hi = torch.where(pos, x[1], x_biased[1])
    rem_sign = (lo >> (r - 1)) & 1
    rem_mag = lo & ((1 << (r - 1)) - 1)
    # mag - rem on the (lo, hi) pair:
    #   rem >= 0: subtract rem_mag (borrow-free)
    #   rem <  0: add (2^(r-1) - rem_mag), carrying into hi (mod 2^32)
    lo_sum = lo + ((1 << (r - 1)) - rem_mag)
    lo_neg = lo_sum & mp.M32
    hi_neg = (hi + (lo_sum >> 32)) & mp.M32
    lo2 = torch.where(rem_sign == 1, lo_neg, lo - rem_mag)
    hi2 = torch.where(rem_sign == 1, hi_neg, hi)
    mag_rescaled = ((lo2 >> r) | (hi2 << (32 - r))) & mp.M32
    return pos, rem_sign, rem_mag, mag_rescaled


def forward_compact(X: torch.Tensor):
    """X: (n, 8) Montgomery. Returns (Z (n, 8), aux) with compact witnesses
    {"sign_bits", "mag", "rem_bits16"}: uint32 (n,) each."""
    n = X.shape[0]
    pos, rem_sign, rem_mag, mag_rescaled = _split_mag(X, Q, R)
    mag_limbs = torch.cat([mag_rescaled[None], torch.zeros((7, n), dtype=torch.int64, device=X.device)])
    mag_mont = planar.to_mont(mp.u32(mag_limbs))
    Zp = planar.select(pos, mag_mont, torch.zeros_like(mag_mont))
    aux = {
        "sign_bits": mp.u32(pos.to(torch.int64)),
        "mag": mp.u32(mag_rescaled),
        "rem_bits16": mp.u32(rem_mag | (rem_sign << (R - 1))),
    }
    return planar.from_planar(Zp).contiguous(), aux


def forward(X: torch.Tensor):
    """X: (n, 8) Montgomery. Returns (Z (n, 8), aux) with the expanded
    Montgomery 0/1 witnesses of the (n, 8) reference path
    (zkrelu.py:forward): {"sign": (n, 8), "mag_bin": (n*Q, 8), "rem_bin":
    (n*R, 8)}, bit k of element j at j*Q + k (j*R + k). Z is
    forward_compact's."""
    Z, compact = forward_compact(X)
    sign, mag_bin, rem_bin = _expand_aux(compact["sign_bits"], compact["mag"], compact["rem_bits16"], Q, R)
    return Z, {"sign": sign, "mag_bin": mag_bin, "rem_bin": rem_bin}


@dataclasses.dataclass
class AuxCommitments:
    """Row commitments to a ReLU's auxiliary witnesses over NUMS generators
    (zkrelu.py:AuxCommitments): sign (n,), mag_bin (n*Q,), rem_bin (n*R,)
    bits, in the standard layout (bit k of element j at j*Q + k)."""

    sign: pedersen.RowCommitments
    mag: pedersen.RowCommitments
    rem: pedersen.RowCommitments


def _expand_aux_bits(sign_bits, mag, rem_bits16, q: int, r: int):
    """Compact aux -> uint32 0/1 bit vectors in the standard layout: sign
    (n,), mag_bin (n*q,) with bit k of element j at j*q + k, rem_bin (n*r,)
    likewise (zkrelu.py:_expand_aux_bits)."""
    dev = mag.device
    mag_bits = (mp.i64(mag)[:, None] >> torch.arange(q, device=dev)) & 1
    rem_bits = (mp.i64(rem_bits16)[:, None] >> torch.arange(r, device=dev)) & 1
    return sign_bits, mp.u32(mag_bits.reshape(-1)), mp.u32(rem_bits.reshape(-1))


_mont_bits = fr_ops.mont_bits  # (N,) 0/1 uint32 -> (N, 8) Montgomery Fr


def _expand_aux(sign_bits, mag, rem_bits16, q: int, r: int):
    """Compact aux -> standard-layout Montgomery tensors sign (n, 8),
    mag_bin (n*q, 8), rem_bin (n*r, 8) (zkrelu.py:_expand_aux)."""
    return tuple(_mont_bits(b) for b in _expand_aux_bits(sign_bits, mag, rem_bits16, q, r))


def _aux_gens(size: int, device) -> pedersen.Generators:
    """The NUMS vector of an aux tensor of `size` elements: sqrt-sized,
    2^ceil(log2(size) / 2) (zkrelu.py:_aux_gens)."""
    return pedersen.nums_generators(1 << ((fr_ops.ceil_log2(size) + 1) // 2), device)


def commit_aux(aux: dict) -> AuxCommitments:
    """Commit the compact auxiliary witnesses of forward_compact
    (zkrelu.py:commit_aux): each bit tensor's rows as masked sums of NUMS
    generators (pedersen.commit_bits, no scalar multiplication)."""
    if Q != 1 << LOG_Q or R != 1 << LOG_R:
        raise ValueError("committed aux needs 2^k widths")
    sign_b, mag_b, rem_b = _expand_aux_bits(aux["sign_bits"], aux["mag"], aux["rem_bits16"], Q, R)
    dev = sign_b.device
    return AuxCommitments(*(pedersen.commit_bits(_aux_gens(b.shape[0], dev), b) for b in (sign_b, mag_b, rem_b)))


def _absorb_aux_coms(challenges: ChallengeSource, coms: AuxCommitments) -> None:
    """Absorb the commitments' Jacobian x, y, z before the layer's first draw."""
    for c in (coms.sign, coms.mag, coms.rem):
        challenges.absorb_array(c.points.x)
        challenges.absorb_array(c.points.y)
        challenges.absorb_array(c.points.z)


@dataclasses.dataclass
class ZkReluProof:
    # challenge vectors (recorded so the verifier in any challenge mode can replay)
    u_z_bin: torch.Tensor
    v_z_bin: torch.Tensor
    u_r_bin: torch.Tensor
    v_r_bin: torch.Tensor
    u_recover: torch.Tensor
    u_hp: torch.Tensor
    v_hp: torch.Tensor
    # sumcheck messages
    mag_polys: torch.Tensor  # (log n + 5, 3, 8)
    mag_final: torch.Tensor  # (8,)
    rem_polys: torch.Tensor
    rem_final: torch.Tensor
    hp_polys: torch.Tensor
    hp_finals: torch.Tensor  # (2, 8): X(v_hp), sign(v_hp)
    # bit recombination folds at u_recover
    mag_bits_at_u: torch.Tensor  # (Q, 8)
    rem_bits_at_u: torch.Tensor  # (R, 8)
    hp_claim: torch.Tensor  # (8,) MLE of X (.) sign at u_hp
    # chained mode (None when unchained)
    a_point: torch.Tensor | None = None  # (log n, 8)
    a_polys: torch.Tensor | None = None  # (log n, 3, 8)
    a_finals: torch.Tensor | None = None  # (2, 8): mont(mag)(v_a), sign(v_a)
    x_at_va: torch.Tensor | None = None  # (8,)
    # committed-aux tier (None otherwise): the aux commitments, the bit-axis
    # combiners w_q (LOG_Q, 8) and w_r (LOG_R, 8), and the openings of
    # mag_bin at v_z and at w_q || u_rec, rem_bin likewise, sign at v_hp and
    # at u_rec (= v_a)
    aux_coms: AuxCommitments | None = None
    w_q: torch.Tensor | None = None
    w_r: torch.Tensor | None = None
    open_mag_bin: pedersen.FoldOpening | None = None
    open_mag_rec: pedersen.FoldOpening | None = None
    open_rem_bin: pedersen.FoldOpening | None = None
    open_rem_rec: pedersen.FoldOpening | None = None
    open_sign_hp: pedersen.FoldOpening | None = None
    open_sign_rec: pedersen.FoldOpening | None = None


def _layout_body(X, aux_mag, aux_rem, aux_sign, log_size, q, r):
    """Challenge-independent layouts: bit matrices expanded into bit-reversed
    flat storage for the binary sumchecks, X/sign bit-reversed for the
    Hadamard, mont(mag) for the chained A-product; plus the plain-order
    tensors the claims need."""
    dev = X.device
    n2 = 1 << log_size
    pad = n2 - aux_mag.shape[0]
    mag = torch.nn.functional.pad(mp.i64(aux_mag), (0, pad))
    rem = torch.nn.functional.pad(mp.i64(aux_rem), (0, pad))
    sign = torch.nn.functional.pad(mp.i64(aux_sign), (0, pad))
    Xp = planar.to_planar(fr_ops.pad_to(X, n2))  # (8, n2) plain order

    revn = torch.from_numpy(pops.bitrev_indices(log_size)).to(dev)
    rev_q = torch.from_numpy(pops.bitrev_indices((q - 1).bit_length())).to(dev)
    rev_r = torch.from_numpy(pops.bitrev_indices((r - 1).bit_length())).to(dev)

    mag_bits = (mag[None, :] >> torch.arange(q, device=dev)[:, None]) & 1  # (q, n2)
    rem_bits = (rem[None, :] >> torch.arange(r, device=dev)[:, None]) & 1  # (r, n2)
    # binary-sumcheck inputs: stored[rev_q(k)*n2 + revn(j)] = bit_k(mag[j])
    mag_rev = (mag_bits[rev_q][:, revn] == 1).reshape(-1)
    rem_rev = (rem_bits[rev_r][:, revn] == 1).reshape(-1)

    X_rev = mp.take(Xp, revn, 1)
    sign_rev = sign[revn] == 1
    mag_limbs = torch.cat([mag[None, :], torch.zeros((7, n2), dtype=torch.int64, device=dev)])
    mag_mont_rev = mp.take(planar.to_mont(mp.u32(mag_limbs)), revn, 1)
    return mag_rev, rem_rev, X_rev, sign_rev, mag_mont_rev, mag_bits, rem_bits, Xp, sign


def _claims_body(mag_bits, rem_bits, Xp, sign, u_rec, u_hp):
    """Recombination folds at u_rec, the Hadamard claim MLE(X (.) sign)(u_hp)
    and X's MLE at u_rec."""
    dev = Xp.device
    E_rec = pops.eq_table(u_rec, dev)  # (8, n2) standard order
    mag_at_u = planar.masked_sum(mag_bits == 1, E_rec)  # (8, q)
    rem_at_u = planar.masked_sum(rem_bits == 1, E_rec)  # (8, r)
    E_hp = pops.eq_table(u_hp, dev)
    hp_claim = planar.dot(planar.select(sign == 1, Xp, torch.zeros_like(Xp)), E_hp)
    x_at_u = planar.dot(Xp, E_rec)
    return mag_at_u.transpose(0, 1).contiguous(), rem_at_u.transpose(0, 1).contiguous(), hp_claim, x_at_u


def _check_chain_point(chain_point, n: int, log_size: int) -> None:
    if chain_point.shape[0] != log_size:
        raise ValueError(f"chain point {tuple(chain_point.shape)} vs log size {log_size}")
    # the recombination identity assumes no zero-padded tail
    if n != (1 << log_size):
        raise ValueError("chained mode requires a power-of-two size")


def _begin_committed(challenges: ChallengeSource, aux_com, chain_point) -> None:
    """The committed tier's start: chained mode only; the commitments are
    absorbed before any draw of the layer."""
    if aux_com is not None:
        if chain_point is None:
            raise ValueError("committed aux requires chained mode")
        _absorb_aux_coms(challenges, aux_com)


def _open_aux(proof: ZkReluProof, n: int, aux: dict, aux_com: AuxCommitments, w_q, w_r) -> None:
    """Attach the commitments, w_q, w_r and the six openings, in the JAX
    order (zkrelu.py:prove_planar)."""
    sign_m, mag_bin, rem_bin = _expand_aux(aux["sign_bits"], aux["mag"], aux["rem_bits16"], Q, R)
    dev = sign_m.device
    g_s, g_m, g_r = _aux_gens(n, dev), _aux_gens(n * Q, dev), _aux_gens(n * R, dev)
    u_rec = mp.host(proof.u_recover)
    proof.aux_coms = aux_com
    proof.w_q, proof.w_r = w_q, w_r
    proof.open_mag_bin = pedersen.open_reveal(g_m, mag_bin, aux_com.mag, proof.v_z_bin)
    proof.open_mag_rec = pedersen.open_reveal(g_m, mag_bin, aux_com.mag, np.concatenate([mp.host(w_q), u_rec]))
    proof.open_rem_bin = pedersen.open_reveal(g_r, rem_bin, aux_com.rem, proof.v_r_bin)
    proof.open_rem_rec = pedersen.open_reveal(g_r, rem_bin, aux_com.rem, np.concatenate([mp.host(w_r), u_rec]))
    proof.open_sign_hp = pedersen.open_reveal(g_s, sign_m, aux_com.sign, proof.v_hp)
    proof.open_sign_rec = pedersen.open_reveal(g_s, sign_m, aux_com.sign, u_rec)


def prove_planar(X: torch.Tensor, aux: dict, challenges: ChallengeSource, chain_point=None,
                 aux_com: AuxCommitments | None = None, interleave: bool = False) -> ZkReluProof:
    """Planar prover on compact aux. Draw order: u_z, v_z, u_r, v_r, u_rec,
    u_hp, v_hp (the stream of zkdl_tpu's prove_planar).

    Chained mode (chain_point = w, host (log n, 8), the downstream FC's
    X-side point): also proves A = sign (.) mont(mag) with a Hadamard
    sumcheck anchored at w, whose fold point v_a is u_rec, and emits X(v_a).

    Committed tier (aux_com = commit_aux(aux), chained mode only): the
    commitments are absorbed before the first draw, w_q and w_r are drawn
    after v_hp, and the proof carries six revealed-fold openings.

    interleave=True runs the round-interleaved Fiat-Shamir schedule
    (``_prove_planar_interleaved``)."""
    if interleave:
        return _prove_planar_interleaved(X, aux, challenges, chain_point, aux_com)
    n = X.shape[0]
    log_size = fr_ops.ceil_log2(n)
    _begin_committed(challenges, aux_com, chain_point)
    u_z = challenges.random_vec(log_size + LOG_Q)
    v_z = challenges.random_vec(log_size + LOG_Q)
    u_r = challenges.random_vec(log_size + LOG_R)
    v_r = challenges.random_vec(log_size + LOG_R)
    u_rec = challenges.random_vec(log_size)  # == v_a in chained mode
    u_hp = challenges.random_vec(log_size)
    v_hp = challenges.random_vec(log_size)
    w_q = challenges.random_vec(LOG_Q) if aux_com is not None else None
    w_r = challenges.random_vec(LOG_R) if aux_com is not None else None

    (mag_rev, rem_rev, X_rev, sign_rev, mag_mont_rev,
     mag_bits, rem_bits, Xp, sign) = _layout_body(
        X, aux["mag"], aux["rem_bits16"], aux["sign_bits"], log_size, Q, R)
    mag_at_u, rem_at_u, hp_claim, x_at_u = _claims_body(
        mag_bits, rem_bits, Xp, sign, u_rec.numpy(), u_hp.numpy())
    mag_polys, mag_final = pp.binary_prove_bits(mag_rev, u_z, v_z)
    rem_polys, rem_final = pp.binary_prove_bits(rem_rev, u_r, v_r)
    hp_polys, hp_finals = pp.hadamard_prove_bits(X_rev, sign_rev, u_hp, v_hp)

    a_polys = a_finals = x_at_va = a_point = None
    if chain_point is not None:
        _check_chain_point(chain_point, n, log_size)
        a_point = chain_point
        a_polys, a_finals = pp.hadamard_prove_bits(mag_mont_rev, sign_rev, chain_point, u_rec)
        x_at_va = x_at_u

    proof = ZkReluProof(
        u_z, v_z, u_r, v_r, u_rec, u_hp, v_hp,
        mag_polys, mag_final, rem_polys, rem_final, hp_polys, hp_finals,
        mag_at_u, rem_at_u, hp_claim,
        a_point, a_polys, a_finals, x_at_va,
    )
    if aux_com is not None:
        _open_aux(proof, n, aux, aux_com, w_q, w_r)
    challenges.absorb_array(mag_polys)
    challenges.absorb_array(rem_polys)
    challenges.absorb_array(hp_polys)
    if a_polys is not None:
        challenges.absorb_array(a_polys)
    return proof


def _prove_planar_interleaved(X: torch.Tensor, aux: dict, challenges: ChallengeSource,
                              chain_point, aux_com: AuxCommitments | None) -> ZkReluProof:
    """The round-interleaved Fiat-Shamir schedule (zkrelu.py:510):

      [absorb aux commitments]                     (committed tier)
      u_z <- draw ; mag binary sumcheck            (absorb poly_i, draw v_z[i])
      u_r <- draw ; rem binary sumcheck            (absorb poly_i, draw v_r[i])
      chained:   A-product sumcheck at chain_point (absorb poly_i, draw v_a[i]);
                 u_rec := v_a
      unchained: u_rec <- draw
      u_hp <- draw
      absorb(mag_bits_at_u, rem_bits_at_u, hp_claim, X(u_rec))
      hp sumcheck of X (.) sign at u_hp            (absorb poly_i, draw v_hp[i])
      [w_q, w_r <- draw]                           (committed tier)

    Every fold challenge is drawn after its round's polynomial is absorbed.
    X(u_rec) is stored as x_at_va in both modes: the replaying verifier
    absorbs it from the proof."""
    n = X.shape[0]
    log_size = fr_ops.ceil_log2(n)
    _begin_committed(challenges, aux_com, chain_point)
    (mag_rev, rem_rev, X_rev, sign_rev, mag_mont_rev,
     mag_bits, rem_bits, Xp, sign) = _layout_body(
        X, aux["mag"], aux["rem_bits16"], aux["sign_bits"], log_size, Q, R)

    u_z = challenges.random_vec(log_size + LOG_Q)
    mag_polys, mag_final, v_z = pp.binary_prove_bits_interleaved(mag_rev, u_z, challenges)
    u_r = challenges.random_vec(log_size + LOG_R)
    rem_polys, rem_final, v_r = pp.binary_prove_bits_interleaved(rem_rev, u_r, challenges)

    a_polys = a_finals = a_point = None
    if chain_point is not None:
        _check_chain_point(chain_point, n, log_size)
        a_point = chain_point
        a_polys, a_finals, u_rec = pp.hadamard_prove_bits_interleaved(
            mag_mont_rev, sign_rev, chain_point, challenges)
    else:
        u_rec = challenges.random_vec(log_size)
    u_hp = challenges.random_vec(log_size)

    mag_at_u, rem_at_u, hp_claim, x_at_u = _claims_body(
        mag_bits, rem_bits, Xp, sign, u_rec.numpy(), u_hp.numpy())
    for claim in (mag_at_u, rem_at_u, hp_claim, x_at_u):
        challenges.absorb_array(claim)
    hp_polys, hp_finals, v_hp = pp.hadamard_prove_bits_interleaved(X_rev, sign_rev, u_hp, challenges)
    w_q = challenges.random_vec(LOG_Q) if aux_com is not None else None
    w_r = challenges.random_vec(LOG_R) if aux_com is not None else None
    proof = ZkReluProof(
        u_z, v_z, u_r, v_r, u_rec, u_hp, v_hp,
        mag_polys, mag_final, rem_polys, rem_final, hp_polys, hp_finals,
        mag_at_u, rem_at_u, hp_claim,
        a_point, a_polys, a_finals, x_at_u,
    )
    if aux_com is not None:
        _open_aux(proof, n, aux, aux_com, w_q, w_r)
    return proof


def verify(proof: ZkReluProof) -> tuple[bool, str]:
    """Both binary sumchecks, the Hadamard sumcheck against the claimed
    product MLE, and their final claims (zkrelu.py:verify)."""
    ints = sc.scalars_to_ints
    res = sc.binary_verify(sc.polys_to_ints(proof.mag_polys), ints(proof.u_z_bin), ints(proof.v_z_bin),
                           ints(proof.mag_final)[0])
    if not res.ok:
        return False, "mag_bin: " + res.reason
    res = sc.binary_verify(sc.polys_to_ints(proof.rem_polys), ints(proof.u_r_bin), ints(proof.v_r_bin),
                           ints(proof.rem_final)[0])
    if not res.ok:
        return False, "rem_bin: " + res.reason
    fa, fb = ints(proof.hp_finals)
    res = sc.hadamard_verify(sc.polys_to_ints(proof.hp_polys), ints(proof.u_hp), ints(proof.v_hp),
                             ints(proof.hp_claim)[0], fa, fb)
    if not res.ok:
        return False, "hadamard: " + res.reason
    return True, ""


def verify_chained(proof: ZkReluProof, a_claim: int) -> tuple[bool, str]:
    """Chained-mode checks (zkrelu.py:verify_chained): the A = sign (.) mag
    product sumcheck against the downstream FC's A-claim (a_claim, its
    ip_finals[0], Montgomery int), the bit recombinations against its
    finals, and the ReLU recombination identity at the shared point v_a
        X + 2^(Q+R-1) * (1 - sign) == 2^SCALE_OUT_BITS * mag + rem,
        rem = sum_{k<R-1} 2^k b_k - 2^(R-1) b_(R-1).
    (R here is the remainder width, not the Montgomery radix.)"""
    if proof.a_polys is None:
        return False, "proof is not chained"
    ints = sc.scalars_to_ints
    fa, fb = ints(proof.a_finals)  # mont(mag)(v_a), sign(v_a)
    res = sc.hadamard_verify(sc.polys_to_ints(proof.a_polys), ints(proof.a_point), ints(proof.u_recover),
                             a_claim, fa, fb)
    if not res.ok:
        return False, "a-product: " + res.reason
    m_rec = 0
    for k, b in enumerate(ints(proof.mag_bits_at_u)):
        m_rec = HF.add(m_rec, HF.mul(HF.mont(1 << k), b))
    if m_rec != fa:
        return False, "mag bit recombination != mag(v_a)"
    rem_claims = ints(proof.rem_bits_at_u)
    r_rec = 0
    for k in range(R - 1):
        r_rec = HF.add(r_rec, HF.mul(HF.mont(1 << k), rem_claims[k]))
    r_rec = HF.sub(r_rec, HF.mul(HF.mont(1 << (R - 1)), rem_claims[R - 1]))
    x_va = ints(proof.x_at_va)[0]
    lhs = HF.add(x_va, HF.mul(HF.mont(1 << (Q + R - 1)), HF.sub(HF.one_mont, fb)))
    rhs = HF.add(HF.mul(HF.mont(1 << SCALE_OUT_BITS), fa), r_rec)
    if lhs != rhs:
        return False, "recombination identity failed at v_a"
    return True, ""


def _eq_weights(w: list[int], m: int) -> list[int]:
    """eq(w, k) for k in range(m), Montgomery ints; w[0] binds the lowest
    index bit (zkrelu.py:_eq_weights)."""
    one = HF.one_mont
    out = [one]
    for wi in w:
        out = [HF.mul(e, HF.sub(one, wi)) for e in out] + [HF.mul(e, wi) for e in out]
    return out[:m]


def verify_committed(proof: ZkReluProof) -> tuple[bool, str]:
    """Committed-aux checks (zkrelu.py:verify_committed): every claim about
    the auxiliary witnesses is an opening of a commitment absorbed before
    the layer's draws: mag_bin at v_z (the binary sumcheck's final) and at
    w_q || u_rec (the eq(w_q)-weighted recombination folds), rem_bin
    likewise, sign at v_hp (the Hadamard final) and at u_rec = v_a (the
    A-product final). Each opening is checked against the NUMS vector the
    verifier regenerates; the six share their group math
    (pedersen.verify_reveals) and the first failing one, in this order,
    gives the reason."""
    if proof.aux_coms is None:
        return False, "proof has no aux commitments"
    if proof.a_polys is None:
        return False, "committed aux requires a chained proof"
    ints = sc.scalars_to_ints
    coms = proof.aux_coms
    u_rec = ints(proof.u_recover)

    def folded(w, claims, m):
        expect = 0
        for e, b in zip(_eq_weights(w, m), ints(claims)):
            expect = HF.add(expect, HF.mul(e, b))
        return expect

    w_q, w_r = ints(proof.w_q), ints(proof.w_r)
    checks = [
        ("mag_bin@v_z", proof.open_mag_bin, coms.mag, ints(proof.v_z_bin), ints(proof.mag_final)[0]),
        ("rem_bin@v_r", proof.open_rem_bin, coms.rem, ints(proof.v_r_bin), ints(proof.rem_final)[0]),
        ("mag_bin@w||u_rec", proof.open_mag_rec, coms.mag, w_q + u_rec, folded(w_q, proof.mag_bits_at_u, Q)),
        ("rem_bin@w||u_rec", proof.open_rem_rec, coms.rem, w_r + u_rec, folded(w_r, proof.rem_bits_at_u, R)),
        ("sign@v_hp", proof.open_sign_hp, coms.sign, ints(proof.v_hp), ints(proof.hp_finals)[1]),
        ("sign@v_a", proof.open_sign_rec, coms.sign, u_rec, ints(proof.a_finals)[1]),
    ]
    dev = coms.sign.points.x.device
    results = pedersen.verify_reveals([
        (opening, pedersen.nums_generators(1 << ((len(point) + 1) // 2), dev), com, point, expected)
        for _, opening, com, point, expected in checks
    ])
    for (what, *_), (ok, msg) in zip(checks, results):
        if not ok:
            return False, f"{what}: {msg}"
    return True, ""


def compact_aux(aux: dict) -> dict:
    """The reference convention's expanded aux (sign (n, 8), mag_bin
    (n*Q, 8), rem_bin (n*R, 8), Montgomery 0/1, bit k of element j at
    j*Q + k) -> the compact aux of forward_compact."""
    n = aux["sign"].shape[0]
    dev = aux["sign"].device

    def word(bin_t, width):
        bits = (mp.i64(bin_t) != 0).any(-1).reshape(n, width).to(torch.int64)
        return mp.u32((bits << torch.arange(width, device=dev)).sum(-1))

    return {"sign_bits": mp.u32((mp.i64(aux["sign"]) != 0).any(-1).to(torch.int64)),
            "mag": word(aux["mag_bin"], Q), "rem_bits16": word(aux["rem_bin"], R)}


def prove(X: torch.Tensor, aux: dict, challenges: ChallengeSource) -> ZkReluProof:
    """zkrelu.py:prove on the expanded aux (:308-350): the draw order and
    stream of prove_planar without a chain point, which the JAX package
    asserts equal (zkrelu.py:424)."""
    return prove_planar(X, compact_aux(aux), challenges)
