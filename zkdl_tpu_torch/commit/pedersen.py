"""Pedersen multilinear commitment with split-and-fold opening, dlog fast path,
and the committed-aux tier's NUMS generators and revealed-fold openings.

Counterpart of ``zkdl_tpu/commit/pedersen.py``: ``Generators``,
``RowCommitments``, ``OpeningProof`` (:59-121), ``setup`` (:134-143),
``aux_generators`` (:146-155), ``commit`` with the dlog fast path and the
opaque-generator branch (:157-200), ``_smul`` (:98) and ``_g_pow`` (:129),
the split-and-fold openings of the (n, 8) reference path: ``me_open_fast``
with ``_me_open_fast_scalars_body`` (:208-253), the opaque-generator
``me_open`` (:256-287), ``open`` (:290-325), ``open_planar`` (:328-399),
the host verifier ``verify_open`` (:421-464) and ``verify_open_against_com``
(:803-826); the blinded tier: ``blinding_point``, ``BlindedRowCommitments``,
``commit_blinded``, ``open_blinded`` and ``verify_open_blinded``
(:483-579); and the
committed-aux tier: ``nums_generators`` (:607-643), ``commit_bits``
(:646-671), ``FoldOpening``, ``open_reveal`` and ``verify_reveal``
(:674-794).

The setup draws every generator's discrete log itself (a transparent
stand-in for an SRS, as the reference's demo does), so all G1 tensor work
of the ordinary tier collapses to Fr arithmetic on the dlogs: a row
commitment is G^(sum_i t_i r_i), each opening point a single G^sigma, through
the fixed-base comb (``curve/g1.py:generator_pow``, kernel K4).

The committed-aux tier has no dlogs: its NUMS generators are hashed to the
curve, so its commitments are masked generator sums (K6) and its verifier
recomputes a generator MSM (K8) and the row commitments' MLE (K5, K6)
(``curve/g1.py``) on the card for CUDA tensors, in the native host library
for CPU ones. ``me_open`` folds opaque generators in G1: each round's
products in one ``_smul`` launch (K8 on subgroup generators, K5 otherwise)
and its three sums by K6's tree.

Reference quirk kept: the opening's cross-term exponents are the Montgomery
REPRESENTATION bits of the scalars (the R-scaled group elements), exactly as
the JAX package and its verifier expect. The verifier tracks D_k = C_k^R:
    check: temp_A_k == D_k
    D_{k+1} = (1-u)^2 * temp0_k + u(1-u) * D_k + u^2 * temp1_k
    base:  D_final == final_gen^(mont_repr(final_scalar)).
Its scalar multiplications run in the native host library, a batch per call
(``host_g1.scalar_mul_batch``).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ..curve import convert, g1, host_g1
from ..field import fp, fr, host, mp, planar
from ..tensor import fr_ops
from ..tensor import planar_ops as pops
from ..utils import prng

HF = host.fr


@dataclasses.dataclass
class Generators:
    """Generator vector; dlogs (Montgomery (n, 8)) are present in the
    transparent setting: points[i] == unmont(dlogs[i]) * G. glv_safe is kept
    for field parity with the JAX class (setup's points are in the order-r
    subgroup by construction)."""

    points: g1.G1Jac
    dlogs: torch.Tensor | None = None
    glv_safe: bool = False

    @property
    def size(self) -> int:
        return self.points.x.shape[0]


@dataclasses.dataclass
class RowCommitments:
    """Per-row Pedersen commitments; dlogs carried along on the fast path."""

    points: g1.G1Jac  # (m,)
    dlogs: torch.Tensor | None = None  # (m, 8) mont


@dataclasses.dataclass
class OpeningProof:
    com_at_u_row: g1.G1Jac  # evaluation of the row-commitment vector at u_row
    round_points: list  # per round: G1Jac of shape (3,): (temp, temp0, temp1)
    final_gen: g1.G1Jac  # ()-shaped
    final_scalar: torch.Tensor  # (8,) mont


def to_mont_rows(t: torch.Tensor) -> torch.Tensor:
    """(n, 8) raw -> (n, 8) Montgomery (through the planar kernels)."""
    return planar.from_planar(planar.to_mont(planar.to_planar(t))).contiguous()


def from_mont_rows(t: torch.Tensor) -> torch.Tensor:
    return planar.from_planar(planar.from_mont(planar.to_planar(t))).contiguous()


def generators_from_dlogs(dlogs_mont: torch.Tensor) -> Generators:
    """Generators for given Montgomery dlogs (n, 8): points = G^unmont(dlog)."""
    points = g1.generator_pow(from_mont_rows(dlogs_mont))
    return Generators(points=points, dlogs=dlogs_mont, glv_safe=True)


def _smul(points: g1.G1Jac, scalars: torch.Tensor, glv_safe: bool) -> g1.G1Jac:
    """Scalar multiplication of each point by its raw scalar
    (pedersen.py:_smul): GLV (K8) where the bases are in the order-r
    subgroup (glv_safe), as the JAX package computes on an accelerator;
    double-and-add (K5) otherwise. The two agree in the group, not in their
    Jacobian limbs: no transcript absorbs a point made here."""
    if glv_safe:
        return g1.scalar_mul_glv(points, scalars)
    return g1.scalar_mul(points, scalars)


def _g_pow(scalar_1x8: torch.Tensor) -> g1.G1Jac:
    """G ^ (raw 256-bit value of scalar) for a (1, 8) scalar (pedersen.py:_g_pow): K4."""
    return g1.generator_pow(scalar_1x8)


def setup(key: np.ndarray, gen_size: int, device) -> Generators:
    """Generator vector r_i * G for the raw r_i that random_fr draws from
    `key` (a prng key, as ``jax.random.PRNGKey`` gives); the dlogs are
    stored as mont(r_i) for Fr math (pedersen.py:setup)."""
    scalars = fr_ops.random_fr(key, gen_size, device)
    points = g1.generator_pow(scalars)
    return Generators(points=points, dlogs=to_mont_rows(scalars), glv_safe=True)


def aux_generators(size: int, device) -> Generators:
    """The shared generator vector of the auxiliary-witness commitments
    (pedersen.py:aux_generators): the fixed key PRNGKey(0x5A6B) folded with
    the size, so prover and verifier regenerate the same vector. Nothing in
    either package calls it: the committed-aux tier draws nums_generators."""
    return setup(prng.fold_in(prng.PRNGKey(0x5A6B), size), size, device)


def commit(gens: Generators, t: torch.Tensor) -> RowCommitments:
    """Row commitments of t (m*gen_size, 8) Montgomery (pedersen.py:commit).

    Transparent setup (dlogs): sigma_row = sum_i t_i * r_i (one lazy dot per
    row, K3), then G^unmont(sigma) (K4). Opaque generators (NUMS, no dlogs):
    row r is sum_i unmont(t[r, i]) * g_i, each product by g1.scalar_mul (K5)
    and each row summed by g1_sum's tree (K6), as the JAX package's CPU
    branch computes it (its accelerator branch takes GLV, whose Jacobian
    limbs differ). A tensor whose every element is 0 or 1 takes the masked
    sum of commit_bits instead, which gives the same limbs: a product by 1
    is the generator's limbs and a product by 0 the identity (0, 0, 0)."""
    gen_size = gens.size
    if t.shape[0] % gen_size:
        raise ValueError(f"commit: {t.shape[0]} rows not a multiple of {gen_size}")
    m = t.shape[0] // gen_size
    if gens.dlogs is not None:
        sigma = _commit_rows_fast(t.reshape(m, gen_size, 8), gens.dlogs)
        return RowCommitments(points=g1.generator_pow(from_mont_rows(sigma)), dlogs=sigma)
    return commit_many([(gens, t)])[0]


_MSM_CHUNK = 1 << 18  # products per scalar_mul launch of commit_msm, and generator copies made at once


def commit_msm(gens_raws) -> list[g1.G1Jac]:
    """Row commitments of raw (unmonted) scalars over generator vectors,
    [(gens, raw (m*gen_size, 8)), ...] -> [(m,) points, ...]: every product
    in scalar_mul launches of _MSM_CHUNK points (K5; each launch's
    generators gathered for it alone, product i taking generator i mod
    gen_size of its vector), then a K6 tree per row, the rows of one
    generator size side by side."""
    tables, index, scalars, rows, base = [], [], [], [], 0
    for gens, raw in gens_raws:
        m = raw.shape[0] // gens.size
        tables.append(gens.points)
        index.append(base + torch.arange(gens.size, device=raw.device).repeat(m))
        scalars.append(raw)
        rows.append(m)
        base += gens.size
    table, index, scalars = _cat(tables), torch.cat(index), torch.cat(scalars)
    n = scalars.shape[0]
    prods = _cat([g1.scalar_mul(g1.G1Jac(*(mp.take(c, index[lo : lo + _MSM_CHUNK], 0) for c in table)),
                                scalars[lo : lo + _MSM_CHUNK].contiguous()) for lo in range(0, n, _MSM_CHUNK)])
    parts = _split(prods, [m * g.size for (g, _), m in zip(gens_raws, rows)])
    out: list = [None] * len(parts)
    for size in sorted({g.size for g, _ in gens_raws}):
        group = [k for k, (g, _) in enumerate(gens_raws) if g.size == size]
        sums = g1.sum_rows(g1.G1Jac(*(torch.cat([getattr(parts[k], c) for k in group]).reshape(-1, size, 12)
                                      for c in ("x", "y", "z"))))
        for k, p in zip(group, _split(sums, [rows[k] for k in group])):
            out[k] = p
    return out


def commit_many(items) -> list[RowCommitments]:
    """commit(gens, t) of each (gens, t) in items, opaque generators, all at
    once: the bit tensors' rows over one generator vector in one masked sum,
    every other tensor's products in one commit_msm. Each result equals
    commit(gens, t)."""
    out: list = [None] * len(items)
    wide = []
    for size in sorted({g.size for g, _ in items}):
        bits = []
        for k, (gens, t) in enumerate(items):
            if gens.size != size:
                continue
            raw = from_mont_rows(t)
            r64 = mp.i64(raw)
            if bool(((r64[:, 1:] == 0).all() & (r64[:, 0] <= 1).all()).item()):
                bits.append((k, raw[:, 0]))
            else:
                wide.append((k, gens, raw))
        if bits:
            gens = items[bits[0][0]][0]
            pts = g1.sum_bit_rows(torch.cat([b for _, b in bits]).reshape(-1, size), gens.points)
            for (k, b), p in zip(bits, _split(pts, [b.shape[0] // size for _, b in bits])):
                out[k] = RowCommitments(points=p)
    if wide:
        for (k, _, _), p in zip(wide, commit_msm([(g, raw) for _, g, raw in wide])):
            out[k] = RowCommitments(points=p)
    return out


def _commit_rows_fast(t3: torch.Tensor, dlogs: torch.Tensor) -> torch.Tensor:
    """(m, gen_size, 8) x (gen_size, 8) mont -> (m, 8) mont row sums."""
    tp = t3.permute(2, 0, 1)  # (8, m, gen_size)
    dp = planar.to_planar(dlogs)  # (8, gen_size)
    return planar.from_planar(planar.dot(tp, dp[:, None, :])).contiguous()


def _proof_points(pts: g1.G1Jac, r: int) -> tuple[list[g1.G1Jac], list[g1.G1Jac]]:
    """The comb's output of an opening -> (r round points of shape (3,), the
    points after them, one () point each)."""
    rounds = [g1.G1Jac(*(c[3 * i : 3 * i + 3] for c in pts)) for i in range(r)]
    return rounds, [g1.G1Jac(*(c[k] for c in pts)) for k in range(3 * r, pts.x.shape[0])]


def _split_fold_rounds(t_f, d, u_in):
    """The split-and-fold rounds (me_open_step) on bit-reversed planar t_f
    and dlogs d (8, 2^r), whose contiguous halves are the natural order's
    pairs: four dots per round. Returns (sigmas (3r, 8), final_scalar (8,),
    final_dlog_exp (8,) raw)."""
    sigmas = []
    for x in u_in:
        h = t_f.shape[1] // 2
        s0, s1 = t_f[:, :h], t_f[:, h:]
        d0, d1 = d[:, :h], d[:, h:]
        dots = planar.dot_many([(d0, s0), (d1, s1), (d1, s0), (d0, s1)])  # (8, 4)
        sigmas += [planar.add(dots[:, 0], dots[:, 1]), dots[:, 2], dots[:, 3]]
        t_f = planar.add(s0, planar.mul_scalar(planar.sub(s1, s0), x))
        # generators fold reversed by the value of u: r' = r1 + u (r0 - r1)
        d = planar.add(d1, planar.mul_scalar(planar.sub(d0, d1), x))
    sig_arr = torch.stack(sigmas) if sigmas else torch.zeros((0, 8), dtype=torch.uint32, device=t_f.device)
    return sig_arr, t_f[:, 0].contiguous(), planar.from_mont(d[:, 0:1])[:, 0]


def _me_open_fast_scalars_body(t: torch.Tensor, d: torch.Tensor, u_in):
    """Every round's cross-term scalars (3r, 8), the final folded scalar and
    the final generator's raw dlog exponent (pedersen.py:
    _me_open_fast_scalars_body) for natural-order t, d (2^r, 8)."""
    rev = lambda x: pops.bitrev_axis(planar.to_planar(x), axis=1)  # noqa: E731
    return _split_fold_rounds(rev(t), rev(d), mp.host(u_in))


def me_open_fast(t: torch.Tensor, dlogs: torch.Tensor, u_in):
    """Dlog-domain split-and-fold (pedersen.py:me_open_fast): the proof
    points of me_open on the generators of `dlogs`, each G^(raw bits of a
    Montgomery sum), all in one comb launch (K4). t, dlogs: (2^r, 8)
    Montgomery; u_in host (r, 8). Returns (round_points, final_gen,
    final_scalar)."""
    n, r = t.shape[0], u_in.shape[0]
    if n != 1 << r:
        raise ValueError(f"me_open_fast: {n} scalars for {r} rounds")
    sigmas, final_scalar, final_dlog_exp = _me_open_fast_scalars_body(t, dlogs, u_in)
    rounds, (final_gen,) = _proof_points(g1.generator_pow(torch.cat([sigmas, final_dlog_exp[None]])), r)
    return rounds, final_gen, final_scalar


def me_open(t: torch.Tensor, gens: g1.G1Jac, u_in, glv_safe: bool = False):
    """Opaque-generator split-and-fold (pedersen.py:me_open; Commitment::
    me_open, commitment.cu:43-81). t: (2^r, 8) Montgomery scalars, gens:
    (2^r,) points, u_in: (r, 8) Montgomery. Per round, the pairs (2i, 2i+1)
    give temp = sum g0^s0 + g1^s1, temp0 = sum g1^s0 and temp1 = sum g0^s1
    (the scalars' Montgomery representations as raw exponents), t folds to
    s0 + u (s1 - s0) and the generators to g1 + unmont(u) (g0 - g1). The
    round's five products run in one _smul launch (K8 where glv_safe, else
    K5), its three sums in one K6 tree. Returns (round_points, final_gen,
    final_scalar)."""
    n, r = t.shape[0], u_in.shape[0]
    if n != 1 << r or gens.shape != (n,):
        raise ValueError(f"me_open: {n} scalars, points {tuple(gens.shape)}, {r} rounds")
    u = mp.host(u_in)
    tp = planar.to_planar(t)
    round_points = []
    for i in range(r):
        s0, s1 = tp[:, 0::2], tp[:, 1::2]
        gg0, gg1 = g1.G1Jac(*(c[0::2] for c in gens)), g1.G1Jac(*(c[1::2] for c in gens))
        h = s0.shape[1]
        u_raw = torch.from_numpy(fr.from_int(HF.unmont(fr.to_ints(u[i][None])[0]))).to(t.device)
        rows = [planar.from_planar(x).contiguous() for x in (s0, s1)]
        prods = _split(_smul(_cat([gg0, gg1, gg1, gg0, g1.add(gg0, g1.neg(gg1))]),
                             torch.cat([rows[0], rows[1], rows[0], rows[1], u_raw.expand(h, 8)]), glv_safe),
                       [h] * 5)
        gens = g1.add(gg1, prods[4])
        tA = g1.add(prods[0], prods[1])
        round_points.append(g1.sum_rows(g1.G1Jac(*(torch.stack(cs) for cs in zip(tA, prods[2], prods[3])))))
        tp = planar.add(s0, planar.mul_scalar(planar.sub(s1, s0), u[i]))
    return round_points, g1.G1Jac(*(c[0] for c in gens)), planar.from_planar(tp)[0].contiguous()


def _row_and_in(u, m: int, gen_size: int, who: str):
    """(u_row, u_in) of host point u for m rows of gen_size generators."""
    log_m = fr_ops.ceil_log2(m)
    if gen_size != (1 << (u.shape[0] - log_m)):
        raise ValueError(f"{who}: gen size {gen_size} vs point {u.shape} and {log_m} row bits")
    return u[u.shape[0] - log_m :], u[: u.shape[0] - log_m]


def open(gens: Generators, t: torch.Tensor, com: RowCommitments, u) -> OpeningProof:
    """Opening of t at host point u ((log_rows + log_gen, 8))
    (pedersen.py:open; Commitment::open, commitment.cu:83-92). With dlogs,
    open_planar (the JAX fast path's proof); with opaque generators, t
    folded along u_row, com(u_row) by the G1 MLE (K5, K6) and me_open on the
    generators."""
    if gens.dlogs is not None and com.dlogs is not None:
        return open_planar(gens, t, com, u)
    u = mp.host(u)
    gen_size = gens.size
    u_row, u_in = _row_and_in(u, com.points.x.shape[0], gen_size, "open")
    t_folded = fr_ops.partial_me(t, u_row, gen_size) if u_row.shape[0] else t
    com_at = g1.me_eval(com.points, u_row) if u_row.shape[0] else g1.G1Jac(*(c[0] for c in com.points))
    rounds, final_gen, final_scalar = me_open(t_folded, gens.points, u_in, glv_safe=gens.glv_safe)
    return OpeningProof(com_at, rounds, final_gen, final_scalar)


def open_planar(gens: Generators, t: torch.Tensor, com: RowCommitments, u) -> OpeningProof:
    """Opening of t at host point u ((log_rows + log_gen, 8)): the scalar
    side on the planar kernels, then every proof point (3 per round, final
    generator, com(u_row)) in ONE comb launch."""
    if gens.dlogs is None or com.dlogs is None:
        raise ValueError("open_planar needs the transparent setup (dlogs)")
    u = mp.host(u)
    u_row, u_in = _row_and_in(u, com.points.x.shape[0], gens.size, "open_planar")
    sigmas, final_scalar, final_dlog_exp, com_exp = _open_planar_scalars(
        t, com.dlogs, gens.dlogs, u_row, u_in, gens.size
    )
    rounds, (final_gen, com_at) = _proof_points(
        g1.generator_pow(torch.cat([sigmas, final_dlog_exp[None], com_exp[None]])), u_in.shape[0])
    return OpeningProof(com_at, rounds, final_gen, final_scalar)


def _open_planar_scalars(t, com_dlogs, gen_dlogs, u_row, u_in, gen_size):
    """Scalar side of the opening (pedersen.py:_open_planar_scalars): the
    u_row fold of t is one eq-weighted contraction over the row axis; the
    split-and-fold rounds run on bit-reversed planar halves with four dots
    per round (me_open_step)."""
    dev = t.device
    m = t.shape[0] // gen_size
    lm = fr_ops.ceil_log2(m)
    t3 = t.reshape(m, gen_size, 8)
    if m < (1 << lm):
        t3 = fr_ops.pad_to(t3, 1 << lm)
    tp = pops.bitrev_axis(t3.permute(2, 1, 0), axis=1)  # (8, G, M2)
    if lm:
        row_table = pops.eq_table(u_row, dev)
        t_f = planar.dot(tp, row_table[:, None, :])  # (8, G) bit-rev
        com_sig = planar.dot(planar.to_planar(fr_ops.pad_to(com_dlogs, 1 << lm)), row_table)
    else:
        t_f = tp[:, :, 0]
        com_sig = planar.to_planar(com_dlogs)[:, 0]
    d = pops.bitrev_axis(planar.to_planar(gen_dlogs), axis=1)  # (8, G) bit-rev
    sig_arr, final_scalar, final_dlog_exp = _split_fold_rounds(t_f, d, u_in)
    return sig_arr, final_scalar, final_dlog_exp, planar.from_mont(com_sig[:, None])[:, 0]


# ---------------------------------------------------------------------------
# verifier (host)
# ---------------------------------------------------------------------------


def _point(p: g1.G1Jac) -> host_g1.JacPoint:
    """A ()-shaped point tensor -> its plain-int Jacobian point."""
    return convert.jac_from_device(p)[0]


def verify_open(proof: OpeningProof, u, expected_value: int | None = None) -> tuple[bool, str]:
    """Verify the split-and-fold opening.

    u: the full evaluation point as Montgomery ints (the list passed to the
    opening). expected_value: optional claimed MLE value of t at u
    (Montgomery int), checked against final_scalar. D_0 comes from the
    proof's own com_at_u_row; verify_open_against_com binds it to the
    commitment."""
    rounds = [convert.jac_from_device(rp) for rp in proof.round_points]
    u_in = list(u[: len(rounds)])
    one = HF.one_mont
    (D,) = host_g1.scalar_mul_batch([_point(proof.com_at_u_row)], [HF.r % fr.P_INT])  # C_0^R
    for k, (tA, t0, t1) in enumerate(rounds):
        if not host_g1.eq_points(tA, D):
            return False, f"round {k}: temp != D_k"
        uk = u_in[k]
        c0 = HF.mul(HF.sub(one, uk), HF.sub(one, uk))  # (1-u)^2
        cA = HF.mul(uk, HF.sub(one, uk))  # u(1-u)
        c1 = HF.mul(uk, uk)  # u^2
        # the exponents are the true integer values of the Montgomery products
        a, b, c = host_g1.scalar_mul_batch([t0, D, t1], [HF.unmont(c0), HF.unmont(cA), HF.unmont(c1)])
        D = host_g1.add(host_g1.add(a, b), c)
    fs_mont_repr = fr.to_ints(mp.host(proof.final_scalar)[None])[0]  # raw bits
    (fg,) = host_g1.scalar_mul_batch([_point(proof.final_gen)], [fs_mont_repr])
    if not host_g1.eq_points(fg, D):
        return False, "final: final_gen^final_scalar != D"
    if expected_value is not None and fs_mont_repr != expected_value:
        return False, "final scalar != expected MLE value"
    return True, ""


def verify_open_against_com(proof: OpeningProof, com: RowCommitments, u) -> tuple[bool, str]:
    """Bind the opening to the row commitments: fold them on the host down
    to com(u_row) (_fold_rows) and compare with the proof's com_at_u_row in
    affine form."""
    if not host_g1.eq_points(_point(proof.com_at_u_row), _fold_rows(com, u)):
        return False, "com(u_row) mismatch"
    return True, ""


def _fold_rows(com: RowCommitments, u) -> host_g1.JacPoint:
    """The row commitments' MLE at u_row (the last log_m entries of u) on
    the host: P_{2i} + u*(P_{2i+1} - P_{2i}) per level, an odd level padded
    with the identity, one native batch of scalar multiplications a level."""
    log_m = fr_ops.ceil_log2(com.points.x.shape[0])
    pts = convert.jac_from_device(com.points)
    for uk in list(u[len(u) - log_m :]) if log_m else []:
        if len(pts) % 2:
            pts.append(host_g1.IDENTITY)
        diffs = [host_g1.add(pts[2 * i + 1], host_g1.neg(pts[2 * i])) for i in range(len(pts) // 2)]
        steps = host_g1.scalar_mul_batch(diffs, [HF.unmont(uk)] * len(diffs))
        pts = [host_g1.add(pts[2 * i], s) for i, s in enumerate(steps)]
    return pts[0]


# ---------------------------------------------------------------------------
# blinded (hiding) commitments: C_row = G^sigma_row * H^b_row
# ---------------------------------------------------------------------------

_G1_COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB  # (x-1)^2 / 3

_BLINDING: dict = {}  # device -> H


def blinding_point(device) -> g1.G1Jac:
    """H, a (1,) point (pedersen.py:blinding_point :483-501): the first
    curve point of a domain-separated hash-to-curve stream (never the NUMS
    generators' stream), x = SHA256("zkdl-tpu/nums-blind/v1/<ctr>") ||
    SHA256(".../<ctr>/b") mod p with the smaller sqrt of x^3 + 4 as y,
    cofactor-cleared by the host double-and-add (the JAX code's Jacobian
    limbs); cached per device. The JAX loop never increments ctr and so
    never returns (ctr 0 gives no curve point); here ctr counts up, and H
    is the candidate of ctr 1."""
    dev = torch.device(device)
    if dev not in _BLINDING:
        p, ctr = fp.P_INT, 0
        while True:
            h1 = hashlib.sha256(f"zkdl-tpu/nums-blind/v1/{ctr}".encode()).digest()
            h2 = hashlib.sha256(f"zkdl-tpu/nums-blind/v1/{ctr}/b".encode()).digest()
            x = int.from_bytes(h1 + h2, "big") % p
            rhs = (x * x % p * x + 4) % p
            y = pow(rhs, (p + 1) // 4, p)
            if y * y % p == rhs:
                break
            ctr += 1
        pt = host_g1.scalar_mul(host_g1.JacPoint(x, min(y, p - y), 1), _G1_COFACTOR)
        if pt.is_identity():
            raise AssertionError("blinding point cofactor-cleared to identity")
        _BLINDING[dev] = convert.jac_to_device([pt], dev)
    return _BLINDING[dev]


@dataclasses.dataclass
class BlindedRowCommitments:
    """Hiding row commitments and the prover's blinders (secret; only their
    folds are revealed, one per opening)."""

    points: g1.G1Jac  # (m,) G^sigma_row * H^b_row
    blinders: torch.Tensor  # (m, 8) Montgomery

    @property
    def public(self) -> RowCommitments:
        return RowCommitments(points=self.points)


def commit_blinded(gens: Generators, t: torch.Tensor, key) -> BlindedRowCommitments:
    """Hiding commitment on the transparent setup (pedersen.py:commit_blinded
    :517-532): sigma_row by one lazy dot a row (K3), G^sigma_row by the comb
    (K4), fresh blinders b_row = random_fr(key, m) in Montgomery form,
    H^b_row by GLV (K8, as the JAX package on an accelerator; its CPU branch
    takes double-and-add, group-equal) and the sum (K6). No transcript
    absorbs these points."""
    if gens.dlogs is None:
        raise ValueError("blinded commit implemented on the fast path")
    gen_size = gens.size
    m = t.shape[0] // gen_size
    sigma = _commit_rows_fast(t.reshape(m, gen_size, 8), gens.dlogs)
    g_part = g1.generator_pow(from_mont_rows(sigma))
    raw = fr_ops.random_fr(key, m, t.device)  # unmont(b)
    H = blinding_point(t.device)
    h_part = g1.scalar_mul_glv(g1.G1Jac(*(c.expand(m, 12) for c in H)), raw)
    return BlindedRowCommitments(points=g1.add(g_part, h_part), blinders=to_mont_rows(raw))


def open_blinded(gens: Generators, t: torch.Tensor, com: BlindedRowCommitments, u):
    """Opening against a blinded commitment (pedersen.py:open_blinded
    :535-549): the transparent opening of the unblinded rows, whose
    com_at_u_row is G^sigma(u_row), and the blinders' fold b(u_row) ((8,)
    Montgomery; K2), the one blinder value revealed. Returns (proof, b_fold)."""
    u = mp.host(u)
    gen_size = gens.size
    m = com.points.x.shape[0]
    log_m = fr_ops.ceil_log2(m)
    if gen_size != (1 << (u.shape[0] - log_m)):
        raise ValueError(f"open_blinded: gen size {gen_size} vs point {u.shape} and {log_m} row bits")
    sigma = _commit_rows_fast(t.reshape(m, gen_size, 8), gens.dlogs)
    unblinded = RowCommitments(points=g1.generator_pow(from_mont_rows(sigma)), dlogs=sigma)
    proof = open_planar(gens, t, unblinded, u)
    b_fold = fr_ops.me_eval(com.blinders, u[u.shape[0] - log_m :]) if log_m else com.blinders[0]
    return proof, b_fold


def verify_open_blinded(proof: OpeningProof, com: RowCommitments, u, b_fold: int,
                        expected_value: int | None = None) -> tuple[bool, str]:
    """Verify an opening against blinded row commitments (pedersen.py:
    verify_open_blinded :552-579): fold the public points at u_row on the
    host (one native batch a level, as verify_open_against_com), unblind by
    H^-b(u_row), compare with the proof's com_at_u_row in affine form, then
    verify_open. b_fold: the revealed fold as a Montgomery int."""
    (hb,) = host_g1.scalar_mul_batch([_point(g1.G1Jac(*(c[0] for c in blinding_point("cpu"))))], [HF.unmont(b_fold)])
    if not host_g1.eq_points(_point(proof.com_at_u_row), host_g1.add(_fold_rows(com, u), host_g1.neg(hb))):
        return False, "unblinded com(u_row) mismatch"
    return verify_open(proof, u, expected_value=expected_value)


# ---------------------------------------------------------------------------
# committed-aux tier: NUMS generators, bit commitments, revealed-fold openings
# ---------------------------------------------------------------------------

_NUMS_STREAM: list = []  # accepted curve points (ctr, x, y), before cofactor clearing


def _nums_affine(count: int) -> list:
    """First `count` points of the deterministic try-and-increment stream
    (pedersen.py:_nums_affine): x = SHA256("zkdl-tpu/nums/v1/<ctr>") ||
    SHA256(".../<ctr>/b") mod p, y = the smaller sqrt of x^3 + 4 when it
    exists (p = 3 mod 4)."""
    p = fp.P_INT
    ctr = len(_NUMS_STREAM) and _NUMS_STREAM[-1][0] + 1
    while len(_NUMS_STREAM) < count:
        h1 = hashlib.sha256(f"zkdl-tpu/nums/v1/{ctr}".encode()).digest()
        h2 = hashlib.sha256(f"zkdl-tpu/nums/v1/{ctr}/b".encode()).digest()
        x = int.from_bytes(h1 + h2, "big") % p
        rhs = (x * x % p * x + 4) % p
        y = pow(rhs, (p + 1) // 4, p)
        if y * y % p == rhs:
            _NUMS_STREAM.append((ctr, x, min(y, p - y)))
        ctr += 1
    return _NUMS_STREAM[:count]


_NUMS_LONGEST: dict = {}  # device -> the longest NUMS vector made there


def nums_generators(size: int, device) -> Generators:
    """Nothing-up-my-sleeve generator vector (pedersen.py:nums_generators),
    prefix-stable across sizes: the hashed candidates, cofactor-cleared into
    the order-r subgroup by one scalar_mul (K5 on the card). Nobody knows
    their dlogs, so commitments over them bind. Point i depends on i alone,
    so a vector is the prefix of the longest one made on its device (made
    anew when a longer one is asked for)."""
    dev = torch.device(device)
    longest = _NUMS_LONGEST.get(dev)
    if longest is None or longest.size < size:
        cands = convert.jac_to_device([host_g1.JacPoint(x, y, 1) for (_, x, y) in _nums_affine(size)], dev)
        cof = torch.from_numpy(mp.limbs_from_int(_G1_COFACTOR, 8)).to(cands.x.device)
        pts = g1.scalar_mul(cands, cof)
        if bool(g1.is_identity(pts).any()):
            raise AssertionError("cofactor-cleared to identity")
        longest = _NUMS_LONGEST[dev] = Generators(points=pts, dlogs=None, glv_safe=True)
    if longest.size == size:
        return longest
    return Generators(points=g1.G1Jac(*(c[:size] for c in longest.points)), dlogs=None, glv_safe=True)


def commit_bits(gens: Generators, bits: torch.Tensor) -> RowCommitments:
    """Row commitments of a 0/1-valued tensor (pedersen.py:commit_bits,
    _commit_bits_rows): bits (m * gen_size,) uint32; row r's commitment is
    the sum of the generators G_j with bits[r * gen_size + j] != 0, by
    g1_sum's pairwise tree (K6, its first level in bit mode)."""
    gen_size = gens.size
    if bits.shape[0] % gen_size:
        raise ValueError(f"commit_bits: {bits.shape[0]} bits not a multiple of {gen_size}")
    m = bits.shape[0] // gen_size
    return RowCommitments(points=g1.sum_bit_rows(bits.reshape(m, gen_size), gens.points))


@dataclasses.dataclass
class FoldOpening:
    """Hyrax-style revealed-fold evaluation proof (pedersen.py:FoldOpening):
    the prover reveals the u_row-fold of the committed tensor; the verifier
    checks MSM_i g_i^unmont(t_folded_i) == the row commitments' MLE at u_row,
    and the MLE of t_folded at u_in against the claimed value."""

    t_folded: torch.Tensor  # (gen_size, 8) Montgomery


def open_reveal(gens: Generators, t: torch.Tensor, com: RowCommitments, u) -> FoldOpening:
    """Evaluation proof of t ((m * gen_size, 8) Montgomery) at the host
    point u against com: t folded along the row part of u (the last log m
    entries), fr_ops.partial_me with the generator axis as its window."""
    u = mp.host(u)
    gen_size = gens.size
    log_m = fr_ops.ceil_log2(com.points.x.shape[0])
    if gen_size != (1 << (u.shape[0] - log_m)):
        raise ValueError(f"open_reveal: gen size {gen_size} vs point {u.shape} and {log_m} row bits")
    t_folded = fr_ops.partial_me(t, u[u.shape[0] - log_m :], gen_size) if log_m else t
    return FoldOpening(t_folded=t_folded)


def verify_reveal(opening: FoldOpening, gens: Generators, com: RowCommitments, u,
                  expected_value: int | None = None) -> tuple[bool, str]:
    """Verify a FoldOpening (pedersen.py:verify_reveal), with its reasons.
    u: the full evaluation point as Montgomery ints; gens: the vector the
    commitment was built over."""
    return verify_reveals([(opening, gens, com, u, expected_value)])[0]


def _static_check(opening: FoldOpening, gens: Generators, com: RowCommitments, u) -> str | None:
    gen_size = gens.size
    shape = tuple(opening.t_folded.shape)
    if shape != (gen_size, 8):
        return f"fold shape {shape} != ({gen_size}, 8)"
    if len(u) != fr_ops.ceil_log2(com.points.x.shape[0]) + fr_ops.ceil_log2(gen_size):
        return "point length mismatch"
    if not gens.glv_safe:
        return "generators not subgroup-validated (run validate_subgroup)"
    return None


def _cat(points: list) -> g1.G1Jac:
    return g1.G1Jac(*(torch.cat([getattr(p, c) for p in points]) for c in ("x", "y", "z")))


def _split(p: g1.G1Jac, sizes: list[int]) -> list[g1.G1Jac]:
    parts = [c.split(sizes) for c in p]
    return [g1.G1Jac(*cs) for cs in zip(*parts)]


def verify_reveals(checks) -> list[tuple[bool, str]]:
    """verify_reveal of several openings, checks = [(opening, gens, com, u,
    expected_value)], returning each one's (ok, reason). Their group math
    shares launches: one scalar_mul for every MSM, one tree sum for the
    MSMs of each generator size, and the row-commitment MLEs folded side by
    side (g1.me_evals); for openings on the CPU it runs in the native host
    library instead."""
    results: list = [None] * len(checks)
    live = []
    for k, (opening, gens, com, u, _) in enumerate(checks):
        err = _static_check(opening, gens, com, u)
        if err is None:
            live.append(k)
        else:
            results[k] = (False, err)
    if not live:
        return results
    if checks[live[0]][2].points.x.device.type == "cpu":
        msms, mles, u_ins = _reveal_group_math_host(checks, live)
    else:
        msms, mles, u_ins = _reveal_group_math(checks, live)

    for k in live:
        opening, _, _, _, expected = checks[k]
        if not host_g1.eq_points(msms[k], mles[k]):
            results[k] = (False, "generator MSM != row-commitment MLE at u_row")
            continue
        if expected is not None:
            u_in = torch.from_numpy(fr.from_ints(u_ins[k], mont_form=False)) if u_ins[k] else \
                torch.zeros((0, 8), dtype=torch.uint32)
            value = fr.to_ints(mp.host(fr_ops.me_eval(opening.t_folded, u_in))[None])[0]
            if value != expected:
                results[k] = (False, "folded MLE value != expected")
                continue
        results[k] = (True, "")
    return results


def _split_point(com: RowCommitments, u) -> tuple[list[int], list[int]]:
    log_m = fr_ops.ceil_log2(com.points.x.shape[0])
    return list(u[len(u) - log_m :]), list(u[: len(u) - log_m])


def _reveal_group_math(checks, live):
    """The openings' MSMs and row-commitment MLEs on the device: every
    generator product in one GLV launch (K8, as the JAX package's
    _verify_reveal_dev on an accelerator; the verdict compares affine
    points), the sums and folds by K6, the folds' products by K5 (me_step
    takes double-and-add in both packages): ({k: msm}, {k: mle}) as host
    points, and {k: u_in}."""
    msm_pts = _cat([checks[k][1].points for k in live])
    msm_scalars = torch.cat([from_mont_rows(checks[k][0].t_folded) for k in live])
    products = _split(g1.scalar_mul_glv(msm_pts, msm_scalars), [checks[k][1].size for k in live])
    msms = {}
    for size in sorted({checks[k][1].size for k in live}):
        group = [i for i, k in enumerate(live) if checks[k][1].size == size]
        sums = g1.sum_rows(g1.G1Jac(*(torch.stack([getattr(products[i], c) for i in group]) for c in "xyz")))
        for j, i in enumerate(group):
            msms[live[i]] = g1.G1Jac(*(c[j] for c in sums))

    u_rows, u_ins = {}, {}
    for k in live:
        u_rows[k], u_ins[k] = _split_point(checks[k][2], checks[k][3])
    mles = dict(zip(live, g1.me_evals([checks[k][2].points for k in live], [u_rows[k] for k in live])))
    return ({k: _point(v) for k, v in msms.items()}, {k: _point(v) for k, v in mles.items()}, u_ins)


def _reveal_group_math_host(checks, live):
    """The same group math for openings on the CPU, in the native host
    library (one batch of scalar multiplications for every MSM, one a level
    for the MLE folds): the verifier compares the two points in affine
    form, so any correct computation of the group elements serves."""
    msm_pts, scalars, sizes = [], [], []
    for k in live:
        opening, gens, _, _, _ = checks[k]
        msm_pts += convert.jac_from_device(gens.points)
        scalars += fr.to_ints(mp.host(opening.t_folded), mont_form=True)
        sizes.append(gens.size)
    prods = host_g1.scalar_mul_batch(msm_pts, scalars)
    msms, at = {}, 0
    for k, size in zip(live, sizes):
        acc = host_g1.IDENTITY
        for q in prods[at : at + size]:
            acc = host_g1.add(acc, q)
        msms[k], at = acc, at + size
    vecs, u_rows, u_ins = {}, {}, {}
    for k in live:
        u_rows[k], u_ins[k] = _split_point(checks[k][2], checks[k][3])
        vecs[k] = convert.jac_from_device(checks[k][2].points)
    for level in range(max(len(u) for u in u_rows.values())):
        todo = [k for k in live if level < len(u_rows[k])]
        diffs, xs = [], []
        for k in todo:
            pts = vecs[k]
            if len(pts) % 2:
                pts.append(host_g1.IDENTITY)
            diffs += [host_g1.add(pts[2 * i + 1], host_g1.neg(pts[2 * i])) for i in range(len(pts) // 2)]
            xs += [HF.unmont(u_rows[k][level])] * (len(pts) // 2)
        steps = iter(host_g1.scalar_mul_batch(diffs, xs))
        for k in todo:
            pts = vecs[k]
            vecs[k] = [host_g1.add(pts[2 * i], next(steps)) for i in range(len(pts) // 2)]
    return msms, {k: vecs[k][0] for k in live}, u_ins
