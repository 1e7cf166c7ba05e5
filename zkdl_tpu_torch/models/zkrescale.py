"""zkRescale: sign-preserving fixed-point requantization (scale 2^32 -> 2^16).

Counterpart of ``zkdl_tpu/models/zkrescale.py``: ``forward`` (:46),
``prove``/``verify`` (:87-93), ``_recombine_tensor``/``_abs_tensor``
(:122-152), ``RescaleBinding``, ``commit_witness``, ``prove_committed`` and
``verify_committed`` (:155-277).

Per element x of X (Montgomery Fr at scale 2^32): sign = [x <= 2^47 - 1];
mag = |x| (p - x for negatives); rem = the signed 16-bit remainder of mag
(round to nearest, sign at bit 15); mag_rescaled = (mag - rem) >> 16; Z =
+-mont(mag_rescaled). The aux has zkReLU's layout, so the proof is
zkReLU's (``zkrelu.prove_planar`` without a chain point, which emits the
stream of ``zkrelu.prove``). ``forward`` returns the aux compact, as
``zkrelu.forward_compact`` does: {"sign_bits", "mag", "rem_bits16"}, uint32
(n,) each; ``expand_aux`` gives the reference's Montgomery bit tensors
(sign (n, 8), mag_bin (n*32, 8), rem_bin (n*16, 8)).

The committed tier commits X, Z, sign, mag_bin, rem_bin and ABS = |X| and
proves two Hadamard sumchecks: X = (2 sign - 1) ABS at u1 and Z =
(2 sign - 1) MAGV at u2 (MAGV the recombined mag_bin), with ABS = 2^16 MAGV
+ REMV at the base proof's u_rec, every evaluation a commitment opening.
"""

from __future__ import annotations

import dataclasses

import torch

from ..commit import witness as wcommit
from ..field import fr, host, mp, planar
from ..sumcheck import protocols as sc
from ..sumcheck.transcript import ChallengeSource
from ..tensor import fr_ops
from . import zkrelu

HF = host.fr
Q, R = 32, 16  # the widths zkrescale.py hardcodes (15 remainder bits and a sign bit)
_POS_MAX = mp.limbs_from_int((1 << 47) - 1, 8)


def forward(X: torch.Tensor):
    """X: (n, 8) Montgomery at scale 2^32 -> (Z at scale 2^16, compact aux)."""
    x = mp.i64(planar.from_mont(planar.to_planar(X)))  # (8, n) raw, canonical
    pos = mp.gte(mp.const(_POS_MAX, x), x)
    neg_mag = mp.mod_sub(fr.SPEC.P_limbs, torch.zeros_like(x), x)  # p - x, exact below 2^47
    lo = torch.where(pos, x[0], neg_mag[0])
    hi = torch.where(pos, x[1], neg_mag[1])
    rem_sign = (lo >> 15) & 1
    rem_mag = lo & 32767
    lo_sum = lo + (32768 - rem_mag)
    lo2 = torch.where(rem_sign == 1, lo_sum & mp.M32, lo - rem_mag)
    hi2 = torch.where(rem_sign == 1, (hi + (lo_sum >> 32)) & mp.M32, hi)
    mag_rescaled = ((lo2 >> 16) | (hi2 << 16)) & mp.M32
    mag_m = fr_ops.to_mont(fr_ops.from_u32(mag_rescaled))
    Z = mp.where(pos[:, None], mag_m, fr_ops.neg(mag_m))
    aux = {"sign_bits": mp.u32(pos.to(torch.int64)), "mag": mp.u32(mag_rescaled),
           "rem_bits16": mp.u32(rem_mag | (rem_sign << 15))}
    return Z, aux


def expand_aux(aux: dict):
    """Compact aux -> (sign (n, 8), mag_bin (n*32, 8), rem_bin (n*16, 8))
    Montgomery 0/1 tensors, zkrescale.forward's aux of the JAX package."""
    return zkrelu._expand_aux(aux["sign_bits"], aux["mag"], aux["rem_bits16"], Q, R)


def _check_widths() -> None:
    if (zkrelu.Q, zkrelu.R) != (Q, R):
        raise ValueError(f"zkrescale needs the ReLU widths {Q}/{R}, not {zkrelu.Q}/{zkrelu.R}")


def prove(X: torch.Tensor, aux: dict, challenges: ChallengeSource) -> zkrelu.ZkReluProof:
    """zkReLU's proof surface (binary x2 + recombination + Hadamard)."""
    _check_widths()
    return zkrelu.prove_planar(X, aux, challenges)


def verify(proof) -> tuple[bool, str]:
    return zkrelu.verify(proof)


def _mont_signed(v: torch.Tensor) -> torch.Tensor:
    """(n,) int64 values below 2^62 in magnitude -> (n, 8) Montgomery Fr
    (negatives as p - |v|)."""
    a = v.abs()
    raw = torch.zeros((v.shape[0], 8), dtype=torch.int64, device=v.device)
    raw[:, 0], raw[:, 1] = a & mp.M32, a >> 32
    m = fr_ops.to_mont(mp.u32(raw))
    return mp.where((v < 0)[:, None], fr_ops.neg(m), m)


def magv_tensor(aux: dict) -> torch.Tensor:
    """MAGV = sum_k 2^k mag_k, the recombined mag_bin (_recombine_tensor)."""
    return _mont_signed(mp.i64(aux["mag"]))


def abs_tensor(aux: dict) -> torch.Tensor:
    """ABS = 2^16 MAGV + REMV, REMV = sum_{k<15} 2^k rem_k - 2^15 rem_15
    (_abs_tensor), from the compact aux (one exact value per element)."""
    rem = mp.i64(aux["rem_bits16"])
    return _mont_signed((mp.i64(aux["mag"]) << 16) + (rem & 32767) - ((rem >> 15) << 15))


@dataclasses.dataclass
class RescaleBinding:
    """Committed-tier rescale proof: the base zkReLU-shaped proof and the two
    product sumchecks binding X and Z to the committed aux."""

    base: zkrelu.ZkReluProof
    u1: torch.Tensor
    v1: torch.Tensor
    sa_polys: torch.Tensor
    sa_finals: torch.Tensor  # (2, 8): sign(v1), ABS(v1)
    sa_claim: torch.Tensor  # (8,) (sign .* ABS)(u1)
    u2: torch.Tensor
    v2: torch.Tensor
    sm_polys: torch.Tensor
    sm_finals: torch.Tensor  # (2, 8): sign(v2), MAGV(v2)
    sm_claim: torch.Tensor  # (8,) (sign .* MAGV)(u2)


def commit_witness(wc: wcommit.Committer, aux: dict, prefix: str) -> None:
    """Commit this rescale's aux tensors (before wc.absorb)."""
    sign_m, mag_bin, rem_bin = expand_aux(aux)
    wc.commit(f"{prefix}sign", sign_m)
    wc.commit(f"{prefix}mag", mag_bin)
    wc.commit(f"{prefix}rem", rem_bin)
    wc.commit(f"{prefix}abs", abs_tensor(aux))


def prove_committed(X: torch.Tensor, Z: torch.Tensor, aux: dict, wc: wcommit.Committer, prefix: str,
                    challenges: ChallengeSource, x_name: str, z_name: str) -> RescaleBinding:
    """Committed-tier prove. `wc` holds {prefix}{sign,mag,rem,abs}
    (commit_witness) and x_name/z_name, already absorbed."""
    base = prove(X, aux, challenges)
    log_q, log_r = fr_ops.ceil_log2(Q), fr_ops.ceil_log2(R)
    wc.open(f"{prefix}X@v_hp", x_name, base.v_hp)
    wc.open(f"{prefix}sign@v_hp", f"{prefix}sign", base.v_hp)
    wc.open(f"{prefix}mag@v_z", f"{prefix}mag", base.v_z_bin)
    wc.open(f"{prefix}rem@v_r", f"{prefix}rem", base.v_r_bin)
    wc.open_recombined(f"{prefix}mag.rec", f"{prefix}mag", base.u_recover, log_q)
    wc.open_recombined(f"{prefix}rem.rec", f"{prefix}rem", base.u_recover, log_r)
    wc.open_top_bit(f"{prefix}rem.top", f"{prefix}rem", base.u_recover, log_r)
    wc.open(f"{prefix}abs@u_rec", f"{prefix}abs", base.u_recover)

    sign_t = fr_ops.mont_bits(aux["sign_bits"])
    abs_t, magv_t = abs_tensor(aux), magv_tensor(aux)
    log_n = fr_ops.ceil_log2(X.shape[0])

    u1 = challenges.random_vec(log_n)
    v1 = challenges.random_vec(log_n)
    sa_polys, sa_finals = sc.hadamard_prove(sign_t, abs_t, u1, v1)
    sa_claim = fr_ops.me_eval(fr_ops.mul(sign_t, abs_t), u1)
    challenges.absorb_array(sa_polys)
    wc.open(f"{prefix}X@u1", x_name, u1)
    wc.open(f"{prefix}abs@u1", f"{prefix}abs", u1)
    wc.open(f"{prefix}sign@v1", f"{prefix}sign", v1)
    wc.open(f"{prefix}abs@v1", f"{prefix}abs", v1)

    u2 = challenges.random_vec(log_n)
    v2 = challenges.random_vec(log_n)
    sm_polys, sm_finals = sc.hadamard_prove(sign_t, magv_t, u2, v2)
    sm_claim = fr_ops.me_eval(fr_ops.mul(sign_t, magv_t), u2)
    challenges.absorb_array(sm_polys)
    wc.open(f"{prefix}Z@u2", z_name, u2)
    wc.open_recombined(f"{prefix}mag.rec_u2", f"{prefix}mag", u2, log_q)
    wc.open(f"{prefix}sign@v2", f"{prefix}sign", v2)
    wc.open_recombined(f"{prefix}mag.rec_v2", f"{prefix}mag", v2, log_q)

    return RescaleBinding(base, u1, v1, sa_polys, sa_finals, sa_claim, u2, v2, sm_polys, sm_finals, sm_claim)


def verify_committed(proof: RescaleBinding, ck: wcommit.Checker, prefix: str,
                     x_name: str, z_name: str) -> tuple[bool, str]:
    """The base proof's structure and the bindings (zkrescale.py:verify_committed)."""
    ok, msg = zkrelu.verify(proof.base)
    if not ok:
        return False, f"base: {msg}"
    b = proof.base
    ints = sc.scalars_to_ints
    log_q, log_r = fr_ops.ceil_log2(Q), fr_ops.ceil_log2(R)
    try:
        hp = ints(b.hp_finals)
        ck.require(f"{prefix}X@v_hp", x_name, ints(b.v_hp), hp[0], "X@v_hp")
        ck.require(f"{prefix}sign@v_hp", f"{prefix}sign", ints(b.v_hp), hp[1], "sign@v_hp")
        ck.require(f"{prefix}mag@v_z", f"{prefix}mag", ints(b.v_z_bin), ints(b.mag_final)[0], "mag binary final")
        ck.require(f"{prefix}rem@v_r", f"{prefix}rem", ints(b.v_r_bin), ints(b.rem_final)[0], "rem binary final")

        u_rec = ints(b.u_recover)
        magrec = ck.recombined(f"{prefix}mag.rec", f"{prefix}mag", u_rec, log_q)
        remfull = ck.recombined(f"{prefix}rem.rec", f"{prefix}rem", u_rec, log_r)
        remtop = ck.top_bit(f"{prefix}rem.top", f"{prefix}rem", u_rec, log_r)
        remv = HF.sub(remfull, HF.mul(HF.mont(1 << R), remtop))
        abs_urec = ck.value(f"{prefix}abs@u_rec", f"{prefix}abs", u_rec)
        if abs_urec != HF.add(HF.mul(HF.mont(1 << 16), magrec), remv):
            return False, "ABS != 2^16*mag + rem_signed at u_rec"

        u1, v1 = ints(proof.u1), ints(proof.v1)
        fa = ck.value(f"{prefix}sign@v1", f"{prefix}sign", v1)
        fb = ck.value(f"{prefix}abs@v1", f"{prefix}abs", v1)
        res = sc.hadamard_verify(sc.polys_to_ints(proof.sa_polys), u1, v1, ints(proof.sa_claim)[0], fa, fb)
        if not res.ok:
            return False, "sign*ABS sumcheck: " + res.reason
        x_u1 = ck.value(f"{prefix}X@u1", x_name, u1)
        abs_u1 = ck.value(f"{prefix}abs@u1", f"{prefix}abs", u1)
        two = HF.mont(2)
        if x_u1 != HF.sub(HF.mul(two, ints(proof.sa_claim)[0]), abs_u1):
            return False, "X != (2*sign-1)*ABS at u1"

        u2, v2 = ints(proof.u2), ints(proof.v2)
        fa = ck.value(f"{prefix}sign@v2", f"{prefix}sign", v2)
        fb = ck.recombined(f"{prefix}mag.rec_v2", f"{prefix}mag", v2, log_q)
        res = sc.hadamard_verify(sc.polys_to_ints(proof.sm_polys), u2, v2, ints(proof.sm_claim)[0], fa, fb)
        if not res.ok:
            return False, "sign*MAGV sumcheck: " + res.reason
        z_u2 = ck.value(f"{prefix}Z@u2", z_name, u2)
        mag_u2 = ck.recombined(f"{prefix}mag.rec_u2", f"{prefix}mag", u2, log_q)
        if z_u2 != HF.sub(HF.mul(two, ints(proof.sm_claim)[0]), mag_u2):
            return False, "Z != (2*sign-1)*mag at u2"
    except wcommit.BindingError as e:
        return False, f"binding: {e}"
    return True, ""
