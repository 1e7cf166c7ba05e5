"""zkSoftmax: the exp-consistent quantized-softmax circuit and its proof.

Counterpart of ``zkdl_tpu/models/zksoftmax.py``: the constants and tables
(:72-95), ``softmax_witness`` (:110), ``RangeProof``/``range_prove``,
``ZeroProductProof``/``zero_product_prove``, ``RowSumProof``/
``rowsum_prove`` (:170-301), ``_hs_and_smax``, ``_range_widths``,
``commit_witness`` (:309-359), ``ZkSoftmaxProof``, ``prove``,
``prove_committed``, ``_check_bound``, ``witness_names``,
``absorb_witness_coms``, ``replay_transcript`` and ``verify`` (:367-888).

The circuit (fixed point, S at scale 2^16, signed): Smax_i = sum_j h_ij S_ij
(h the row argmax one-hot), t = Smax - S >= 0, t = 2^8 d_full + rem8,
d = min(d_full, 2^12 - 1), e = EXPTAB[d] (a logUp lookup of the pairs
2^17 d + e), E_i = sum_j e_ij, e 2^16 = P E + r with 0 <= r < E, and
sum_j P_ij = 2^16 - slack_i. ``softmax_witness`` computes every value on
the host in 64-bit numpy, as the JAX package does (one copy of S to the
host). The Montgomery tensors of those values keep their low 32 bits
(``fr_ops.mont_from_u64``, ``fr_ops.bits_of``), as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..commit import witness as wcommit
from ..field import host, mp, planar
from ..sumcheck import lookup
from ..sumcheck import planar_protocols as pp
from ..sumcheck import protocols as sc
from ..sumcheck.transcript import ChallengeSource
from ..tensor import fr_ops
from ..tensor import planar_ops as pops
from . import quantize

HF = host.fr

D_BITS = 12
D_MAX = (1 << D_BITS) - 1
BUCKET_SHIFT = 8
D_FULL_BITS = 40  # t < 2^48, t >> 8 fits 40 bits
REM_BITS = 8
E_PAIR = 17  # e in [0, 2^16] needs 17 bits in the pair encoding
R_BITS = 17 + 11  # r < E <= cols * 2^16; cols <= 2^11


@functools.lru_cache(maxsize=None)
def exp_table_vals(d_model: int) -> np.ndarray:
    """EXPTAB[b] = round(exp(-b 2^BUCKET_SHIFT / (2^16 sqrt(d_model))) 2^16),
    EXPTAB[D_MAX] = 0."""
    b = np.arange(1 << D_BITS, dtype=np.float64)
    vals = np.rint(np.exp(-b * (1 << BUCKET_SHIFT) / (quantize.SCALE * np.sqrt(d_model))) * quantize.SCALE)
    vals = vals.astype(np.uint64)
    vals[D_MAX] = 0
    return vals


@functools.lru_cache(maxsize=None)
def pair_table_vals(d_model: int) -> np.ndarray:
    b = np.arange(1 << D_BITS, dtype=np.uint64)
    return (b << np.uint64(E_PAIR)) | exp_table_vals(d_model)


# ---------------------------------------------------------------------------
# witness generation
# ---------------------------------------------------------------------------


def _signed_values(S: torch.Tensor) -> np.ndarray:
    """(n, 8) Montgomery S -> int64 signed values on the host (negatives
    are p - |v|, with nonzero limbs above the second)."""
    x = planar.from_mont(planar.to_planar(S))  # (8, n) raw
    negx = planar.neg(x)
    x, negx = mp.host(x).astype(np.uint64), mp.host(negx).astype(np.uint64)
    neg_mask = ~np.all(x[2:] == 0, axis=0)
    val = (x[0] | (x[1] << np.uint64(32))).astype(np.int64)
    mag = (negx[0] | (negx[1] << np.uint64(32))).astype(np.int64)
    return np.where(neg_mask, -mag, val)


def softmax_witness(S: torch.Tensor, rows: int, cols: int, d_model: int) -> dict:
    """Every circuit value from the scores S ((rows*cols, 8) Montgomery,
    scale 2^16 signed): unsigned 64-bit numpy arrays, and P_mont on S's
    device."""
    Sv = _signed_values(S).reshape(rows, cols)
    smax = Sv.max(axis=1)
    am = Sv.argmax(axis=1)
    h = np.zeros((rows, cols), dtype=np.uint64)
    h[np.arange(rows), am] = 1
    t = (smax[:, None] - Sv).astype(np.uint64)
    rem8 = t & np.uint64((1 << BUCKET_SHIFT) - 1)
    d_full = t >> np.uint64(BUCKET_SHIFT)
    d = np.minimum(d_full, np.uint64(D_MAX))
    e = exp_table_vals(d_model)[d.astype(np.int64)]
    E = e.sum(axis=1)
    P_q = (e * np.uint64(quantize.SCALE)) // E[:, None]
    r = e * np.uint64(quantize.SCALE) - P_q * E[:, None]
    slack = np.uint64(quantize.SCALE) - P_q.sum(axis=1)
    wit = {
        "h": h.reshape(-1), "t": t.reshape(-1), "rem8": rem8.reshape(-1),
        "d_full": d_full.reshape(-1), "d": d.reshape(-1), "e": e.reshape(-1),
        "E": E, "P": P_q.reshape(-1), "r": r.reshape(-1), "slack": slack, "smax": smax,
    }
    wit["P_mont"] = fr_ops.mont_from_u64(wit["P"], S.device)
    return wit


# ---------------------------------------------------------------------------
# range, zero-product and row-sum proofs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RangeProof:
    """vals = sum_k 2^k bits_k, every bit binary: a binary sumcheck over the
    (n * 2^log_w) bit tensor and the recombination claims at u_rec."""

    width: int
    u: torch.Tensor
    v: torch.Tensor
    polys: torch.Tensor
    final: torch.Tensor
    u_rec: torch.Tensor
    bits_at_u: torch.Tensor  # (width, 8)

    def value_claim(self) -> int:
        """vals' MLE at u_rec = sum_k 2^k bits_k(u_rec)."""
        acc = 0
        for k, b in enumerate(sc.scalars_to_ints(self.bits_at_u)):
            acc = HF.add(acc, HF.mul(b, HF.mont(1 << k)))
        return acc

    def verify(self) -> tuple[bool, str]:
        ints = sc.scalars_to_ints
        res = sc.binary_verify(sc.polys_to_ints(self.polys), ints(self.u), ints(self.v), ints(self.final)[0])
        return res.ok, res.reason


def bits_tensor(vals, width: int, device) -> torch.Tensor:
    """(n * width, 8) Montgomery 0/1 tensor of vals' bits (_bits_tensor)."""
    return fr_ops.mont_bits(fr_ops.bits_of(vals, width, device))


def range_prove(vals, width: int, u_rec, challenges: ChallengeSource, device) -> RangeProof:
    """Range proof of the unsigned values `vals` (numpy) on `device`: the
    binary sumcheck runs on the packed bits (its round 0 mul-free), the
    recombination claims are masked sums of u_rec's eq table."""
    n = len(vals)
    log_n = fr_ops.ceil_log2(n)
    log_w = fr_ops.ceil_log2(width)
    W = 1 << log_w
    dev = device
    flat = fr_ops.bits_of(vals, W, dev)  # bit k of element j at j*W + k
    r = log_n + log_w
    u = challenges.random_vec(r)
    v = challenges.random_vec(r)
    packed = torch.nn.functional.pad(flat.view(torch.int32) != 0, (0, (1 << r) - flat.shape[0]))
    polys, final = pp.binary_prove_bits(packed[torch.from_numpy(pops.bitrev_indices(r)).to(dev)], u, v)
    eq = pops.eq_table(mp.host(u_rec), dev)[:, :n]
    bits_at_u = planar.masked_sum(flat.view(torch.int32).reshape(n, W).T != 0, eq).T[:width].contiguous()
    proof = RangeProof(width, u, v, polys, final, u_rec, bits_at_u)
    challenges.absorb_array(polys)
    challenges.absorb_array(bits_at_u)
    return proof


@dataclasses.dataclass
class ZeroProductProof:
    """a (.) b == 0 everywhere: a Hadamard sumcheck with initial claim 0."""

    u: torch.Tensor
    v: torch.Tensor
    polys: torch.Tensor
    finals: torch.Tensor

    def verify(self) -> tuple[bool, str]:
        ints = sc.scalars_to_ints
        fa, fb = ints(self.finals)
        res = sc.hadamard_verify(sc.polys_to_ints(self.polys), ints(self.u), ints(self.v), 0, fa, fb)
        return res.ok, res.reason


def zero_product_prove(a: torch.Tensor, b: torch.Tensor, challenges: ChallengeSource) -> ZeroProductProof:
    log_n = fr_ops.ceil_log2(a.shape[0])
    u = challenges.random_vec(log_n)
    v = challenges.random_vec(log_n)
    polys, finals = sc.hadamard_prove(a, b, u, v)
    proof = ZeroProductProof(u, v, polys, finals)
    challenges.absorb_array(polys)
    return proof


@dataclasses.dataclass
class RowSumProof:
    """Row-sum claims of M ((rows, cols) flattened): sums(u_row) =
    <M(u_row, .), ones> by one fold and an inner-product sumcheck."""

    u_row: torch.Tensor
    u_col: torch.Tensor
    polys: torch.Tensor
    finals: torch.Tensor
    claim: torch.Tensor  # (8,) <M(u_row, .), 1>

    def verify(self) -> tuple[bool, str]:
        ints = sc.scalars_to_ints
        res = sc.inner_product_verify(sc.polys_to_ints(self.polys), ints(self.u_col), ints(self.claim)[0])
        if not res.ok:
            return False, res.reason
        fa, fb = ints(self.finals)
        if fb != HF.one_mont:
            return False, "ones final != 1"
        if not sc.inner_product_check_final(res, fa, fb):
            return False, "final product mismatch"
        return True, ""


def rowsum_prove(M: torch.Tensor, rows: int, cols: int, challenges: ChallengeSource) -> RowSumProof:
    u_row = challenges.random_vec(fr_ops.ceil_log2(rows))
    u_col = challenges.random_vec(fr_ops.ceil_log2(cols))
    folded = fr_ops.partial_me(M, u_row, cols)
    polys, finals = sc.inner_product_prove(folded, fr_ops.ones_mont(cols, M.device), u_col)
    claim = fr_ops.fr_sum(folded)  # <folded, ones>
    proof = RowSumProof(u_row, u_col, polys, finals, claim)
    challenges.absorb_array(polys)
    challenges.absorb_array(claim)
    return proof


# ---------------------------------------------------------------------------
# committed-witness tier: the tensor inventory
# ---------------------------------------------------------------------------

def _hs_and_smax(h_m: torch.Tensor, S: torch.Tensor, rows: int, cols: int):
    hs = fr_ops.mul(h_m, S)
    smax_m = planar.from_planar(planar.lazy_sum(planar.to_planar(hs).reshape(8, rows, cols))).contiguous()
    return hs, smax_m


def _range_widths(cols: int) -> dict:
    """range-proof name -> (witness key or None for a derived one, width)."""
    return {
        "dfull_bits": ("d_full", D_FULL_BITS),
        "rem8_bits": ("rem8", REM_BITS),
        "d_bits": ("d", D_BITS),
        "dgap_bits": (None, D_FULL_BITS),  # d_full - d
        "r_bits": ("r", R_BITS),
        "er_bits": (None, R_BITS),  # E_bcast - 1 - r
        "slack_bits": ("slack", fr_ops.ceil_log2(cols) + 1),
    }


def _er_vals(wit: dict, cols: int) -> np.ndarray:
    return (wit["E"].repeat(cols) - np.uint64(1) - wit["r"]).astype(np.uint64)


def commit_witness(wc: wcommit.Committer, S: torch.Tensor, wit: dict, rows: int, cols: int,
                   prefix: str = "sm.", s_name: str | None = None) -> None:
    """Commit every softmax circuit tensor into wc (before wc.absorb). With
    s_name, S is committed already under that name."""
    dev = S.device
    if s_name is None:
        wc.commit(f"{prefix}S", S)
    h_m = fr_ops.mont_from_u64(wit["h"], dev)
    wc.commit(f"{prefix}h", h_m)
    hs, smax_m = _hs_and_smax(h_m, S, rows, cols)
    wc.commit(f"{prefix}hs", hs)
    wc.commit(f"{prefix}smax", smax_m)
    wc.commit(f"{prefix}e", fr_ops.mont_from_u64(wit["e"], dev))
    wc.commit(f"{prefix}E", fr_ops.mont_from_u64(wit["E"], dev))
    wc.commit(f"{prefix}P", wit["P_mont"])
    vals = {
        "dfull_bits": wit["d_full"], "rem8_bits": wit["rem8"], "d_bits": wit["d"],
        "dgap_bits": wit["d_full"] - wit["d"], "r_bits": wit["r"], "er_bits": _er_vals(wit, cols),
        "slack_bits": wit["slack"],
    }
    for nm, (_, width) in _range_widths(cols).items():
        wc.commit(f"{prefix}{nm}", bits_tensor(vals[nm], 1 << fr_ops.ceil_log2(width), dev))


# ---------------------------------------------------------------------------
# the full softmax proof
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ZkSoftmaxProof:
    rows: int
    cols: int
    d_model: int
    # 1. argmax one-hot h
    h_range: RangeProof
    h_rowsum: RowSumProof
    # 2/3. t decomposition and definition
    u_rec: torch.Tensor
    dfull_range: RangeProof
    rem8_range: RangeProof
    s_at_urec: torch.Tensor
    hs_u: torch.Tensor
    hs_v: torch.Tensor
    hs_polys: torch.Tensor
    hs_finals: torch.Tensor
    hs_claim: torch.Tensor
    smax_rowsum: RowSumProof
    smax_at_urec_row: torch.Tensor
    # 4. clip
    d_range: RangeProof
    dgap_range: RangeProof
    clip_zero: ZeroProductProof
    # 5. exp lookup
    lk: lookup.LookupProof
    d_at_lk: torch.Tensor
    e_at_lk: torch.Tensor
    # 6. division
    e_rowsum: RowSumProof
    div_zero_u: torch.Tensor
    div_zero_v: torch.Tensor
    div_polys: torch.Tensor
    div_finals: torch.Tensor
    e_at_div: torch.Tensor
    r_at_div: torch.Tensor
    pE_claim: torch.Tensor
    E_at_divrow: torch.Tensor
    r_range: RangeProof
    er_range: RangeProof
    # 7. P row sums and slack
    p_rowsum: RowSumProof
    slack_range: RangeProof
    slack_at_urow: torch.Tensor
    witness: wcommit.WitnessSet | None = None


def prove(S: torch.Tensor, wit: dict, rows: int, cols: int, d_model: int, challenges: ChallengeSource,
          witness: wcommit.Committer | None = None, prefix: str = "sm.",
          s_name: str | None = None) -> ZkSoftmaxProof:
    """Prove the circuit for `wit` (softmax_witness), in the JAX draw order.
    With `witness` (a Committer holding this circuit's tensors, absorbed),
    every forwarded claim also gets an opening; s_name names S's
    commitment when the caller made it."""
    dev = S.device
    n = rows * cols
    log_n = fr_ops.ceil_log2(n)
    log_cols = fr_ops.ceil_log2(cols)
    W, px = witness, prefix
    sn = s_name or f"{px}S"
    cat = lambda *us: np.concatenate([mp.host(u) for u in us])  # noqa: E731

    def rp_open(nm: str, rp: RangeProof) -> None:
        if W is None:
            return
        log_w = fr_ops.ceil_log2(rp.width)
        W.open(f"{px}{nm}@v", f"{px}{nm}", rp.v)
        W.open_recombined(f"{px}{nm}.rec", f"{px}{nm}", rp.u_rec, log_w)

    h_m = fr_ops.mont_from_u64(wit["h"], dev)
    e_m = fr_ops.mont_from_u64(wit["e"], dev)
    d_m = fr_ops.mont_from_u64(wit["d"], dev)
    dfull_m = fr_ops.mont_from_u64(wit["d_full"], dev)
    r_m = fr_ops.mont_from_u64(wit["r"], dev)
    E_m = fr_ops.mont_from_u64(wit["E"], dev)
    P_m = wit["P_mont"]

    # 1. h binary and its row sums
    h_range = range_prove(wit["h"], 1, challenges.random_vec(log_n), challenges, dev)
    rp_open("h", h_range)
    h_rowsum = rowsum_prove(h_m, rows, cols, challenges)
    if W is not None:
        W.open(f"{px}h@rowsum", f"{px}h", cat(h_rowsum.u_col, h_rowsum.u_row))

    # 2/3. t decomposition and definition at a shared point u_rec
    u_rec = challenges.random_vec(log_n)
    dfull_range = range_prove(wit["d_full"], D_FULL_BITS, u_rec, challenges, dev)
    rp_open("dfull_bits", dfull_range)
    rem8_range = range_prove(wit["rem8"], REM_BITS, u_rec, challenges, dev)
    rp_open("rem8_bits", rem8_range)
    s_at_urec = fr_ops.me_eval(S, u_rec)
    if W is not None:
        W.open(f"{px}S@u_rec", sn, u_rec)
    hs, smax_m = _hs_and_smax(h_m, S, rows, cols)
    hs_u = challenges.random_vec(log_n)
    hs_v = challenges.random_vec(log_n)
    hs_polys, hs_finals = sc.hadamard_prove(h_m, S, hs_u, hs_v)
    hs_claim = fr_ops.me_eval(hs, hs_u)
    challenges.absorb_array(hs_polys)
    if W is not None:
        W.open(f"{px}h@hs_v", f"{px}h", hs_v)
        W.open(f"{px}S@hs_v", sn, hs_v)
        W.open(f"{px}hs@hs_u", f"{px}hs", hs_u)
    smax_rowsum = rowsum_prove(hs, rows, cols, challenges)
    smax_at_urec_row = fr_ops.me_eval(smax_m, u_rec[log_cols:])
    if W is not None:
        W.open(f"{px}hs@rowsum", f"{px}hs", cat(smax_rowsum.u_col, smax_rowsum.u_row))
        W.open(f"{px}smax@rowsum", f"{px}smax", smax_rowsum.u_row)
        W.open(f"{px}smax@u_rec_row", f"{px}smax", u_rec[log_cols:])

    # 4. clip
    d_range = range_prove(wit["d"], D_BITS, u_rec, challenges, dev)
    rp_open("d_bits", d_range)
    dgap_range = range_prove(wit["d_full"] - wit["d"], D_FULL_BITS, u_rec, challenges, dev)
    rp_open("dgap_bits", dgap_range)
    dmax = fr_ops.mont_from_u64(np.full(n, D_MAX, dtype=np.uint64), dev)
    clip_zero = zero_product_prove(fr_ops.sub(dfull_m, d_m), fr_ops.sub(d_m, dmax), challenges)
    if W is not None:
        W.open_recombined(f"{px}dfull.clip", f"{px}dfull_bits", clip_zero.v, fr_ops.ceil_log2(D_FULL_BITS))
        W.open_recombined(f"{px}d.clip", f"{px}d_bits", clip_zero.v, fr_ops.ceil_log2(D_BITS))

    # 5. exp lookup on the pairs 2^17 d + e
    a_pairs = fr_ops.mont_from_u64((wit["d"] << np.uint64(E_PAIR)) | wit["e"], dev)
    tab = fr_ops.mont_from_u64(pair_table_vals(d_model), dev)
    lk = lookup.prove(a_pairs, tab, lookup.multiplicities(wit["d"], 1 << D_BITS, dev), challenges)
    d_at_lk = fr_ops.me_eval(d_m, lk.v_w)
    e_at_lk = fr_ops.me_eval(e_m, lk.v_w)
    if W is not None:
        W.open_recombined(f"{px}d.lk", f"{px}d_bits", lk.v_w, fr_ops.ceil_log2(D_BITS))
        W.open(f"{px}e@lk", f"{px}e", lk.v_w)

    # 6. division: e 2^16 - P (.) E_bcast - r == 0
    e_rowsum = rowsum_prove(e_m, rows, cols, challenges)
    if W is not None:
        W.open(f"{px}e@rowsum", f"{px}e", cat(e_rowsum.u_col, e_rowsum.u_row))
        W.open(f"{px}E@erowsum", f"{px}E", e_rowsum.u_row)
    E_bcast = fr_ops.mont_from_u64(np.repeat(wit["E"], cols), dev)
    div_u = challenges.random_vec(log_n)
    div_v = challenges.random_vec(log_n)
    div_polys, div_finals = sc.hadamard_prove(P_m, E_bcast, div_u, div_v)
    pE_claim = fr_ops.me_eval(fr_ops.mul(P_m, E_bcast), div_u)
    e_at_div = fr_ops.me_eval(e_m, div_u)
    r_at_div = fr_ops.me_eval(r_m, div_u)
    E_at_divrow = fr_ops.me_eval(E_m, div_u[log_cols:])
    challenges.absorb_array(div_polys)
    if W is not None:
        W.open(f"{px}P@div_v", f"{px}P", div_v)
        W.open(f"{px}E@div_v", f"{px}E", div_v[log_cols:])
        W.open(f"{px}e@div", f"{px}e", div_u)
        W.open(f"{px}E@div_row", f"{px}E", div_u[log_cols:])
    r_range = range_prove(wit["r"], R_BITS, div_u, challenges, dev)
    rp_open("r_bits", r_range)
    er_range = range_prove(_er_vals(wit, cols), R_BITS, div_u, challenges, dev)
    rp_open("er_bits", er_range)

    # 7. P row sums and slack
    p_rowsum = rowsum_prove(P_m, rows, cols, challenges)
    if W is not None:
        W.open(f"{px}P@rowsum", f"{px}P", cat(p_rowsum.u_col, p_rowsum.u_row))
    slack_range = range_prove(wit["slack"], fr_ops.ceil_log2(cols) + 1, p_rowsum.u_row, challenges, dev)
    rp_open("slack_bits", slack_range)
    slack_at_urow = fr_ops.me_eval(fr_ops.mont_from_u64(wit["slack"], dev), p_rowsum.u_row)

    return ZkSoftmaxProof(
        rows, cols, d_model,
        h_range, h_rowsum,
        u_rec, dfull_range, rem8_range, s_at_urec,
        hs_u, hs_v, hs_polys, hs_finals, hs_claim,
        smax_rowsum, smax_at_urec_row,
        d_range, dgap_range, clip_zero,
        lk, d_at_lk, e_at_lk,
        e_rowsum, div_u, div_v, div_polys, div_finals,
        e_at_div, r_at_div, pE_claim, E_at_divrow, r_range, er_range,
        p_rowsum, slack_range, slack_at_urow,
    )


def prove_committed(S: torch.Tensor, wit: dict, rows: int, cols: int, d_model: int,
                    challenges: ChallengeSource) -> ZkSoftmaxProof:
    """Standalone committed-witness prove: commit every circuit tensor,
    absorb, then prove with openings."""
    wc = wcommit.Committer()
    commit_witness(wc, S, wit, rows, cols)
    wc.absorb(challenges)
    proof = prove(S, wit, rows, cols, d_model, challenges, witness=wc)
    proof.witness = wc.witness_set()
    return proof


def _check_bound(proof: ZkSoftmaxProof, ck: wcommit.Checker, prefix: str = "sm.",
                 s_name: str | None = None) -> None:
    """Every forwarded claim must equal a verified opening of its committed
    tensor (raises BindingError)."""
    px = prefix
    sn = s_name or f"{px}S"
    ints = sc.scalars_to_ints
    one = HF.one_mont
    log_cols = fr_ops.ceil_log2(proof.cols)

    def rp_bind(nm: str, rp: RangeProof) -> None:
        tn = f"{px}{nm}"
        log_w = fr_ops.ceil_log2(rp.width)
        ck.require(f"{px}{nm}@v", tn, ints(rp.v), ints(rp.final)[0], f"{nm} binary final")
        if ck.recombined(f"{px}{nm}.rec", tn, ints(rp.u_rec), log_w) != rp.value_claim():
            raise wcommit.BindingError(f"{nm}: recombination claim unbound")

    rp_bind("h", proof.h_range)
    rp_bind("dfull_bits", proof.dfull_range)
    rp_bind("rem8_bits", proof.rem8_range)
    rp_bind("d_bits", proof.d_range)
    rp_bind("dgap_bits", proof.dgap_range)
    rp_bind("r_bits", proof.r_range)
    rp_bind("er_bits", proof.er_range)
    rp_bind("slack_bits", proof.slack_range)

    u_rec = ints(proof.u_rec)
    ck.require(f"{px}S@u_rec", sn, u_rec, ints(proof.s_at_urec)[0], "S@u_rec")
    hs_u, hs_v = ints(proof.hs_u), ints(proof.hs_v)
    hf = ints(proof.hs_finals)
    ck.require(f"{px}h@hs_v", f"{px}h", hs_v, hf[0], "hs hadamard h-final")
    ck.require(f"{px}S@hs_v", sn, hs_v, hf[1], "hs hadamard S-final")
    ck.require(f"{px}hs@hs_u", f"{px}hs", hs_u, ints(proof.hs_claim)[0], "hs claim")
    ck.require(f"{px}h@rowsum", f"{px}h", ints(proof.h_rowsum.u_col) + ints(proof.h_rowsum.u_row),
               ints(proof.h_rowsum.finals)[0], "h rowsum final")
    sr = proof.smax_rowsum
    ck.require(f"{px}hs@rowsum", f"{px}hs", ints(sr.u_col) + ints(sr.u_row), ints(sr.finals)[0],
               "smax rowsum final")
    ck.require(f"{px}smax@rowsum", f"{px}smax", ints(sr.u_row), ints(sr.claim)[0], "smax rowsum claim")
    ck.require(f"{px}smax@u_rec_row", f"{px}smax", u_rec[log_cols:], ints(proof.smax_at_urec_row)[0],
               "smax@u_rec_row")

    clip_v = ints(proof.clip_zero.v)
    dfull_clip = ck.recombined(f"{px}dfull.clip", f"{px}dfull_bits", clip_v, fr_ops.ceil_log2(D_FULL_BITS))
    d_clip = ck.recombined(f"{px}d.clip", f"{px}d_bits", clip_v, fr_ops.ceil_log2(D_BITS))
    cf = ints(proof.clip_zero.finals)
    if cf[0] != HF.sub(dfull_clip, d_clip):
        raise wcommit.BindingError("clip: (d_full - d) final unbound")
    if cf[1] != HF.sub(d_clip, HF.mont(D_MAX)):
        raise wcommit.BindingError("clip: (d - D_MAX) final unbound")

    v_w = ints(proof.lk.v_w)
    if ck.recombined(f"{px}d.lk", f"{px}d_bits", v_w, fr_ops.ceil_log2(D_BITS)) != ints(proof.d_at_lk)[0]:
        raise wcommit.BindingError("lookup: d claim unbound")
    ck.require(f"{px}e@lk", f"{px}e", v_w, ints(proof.e_at_lk)[0], "lookup e claim")

    er_ = proof.e_rowsum
    ck.require(f"{px}e@rowsum", f"{px}e", ints(er_.u_col) + ints(er_.u_row), ints(er_.finals)[0],
               "e rowsum final")
    ck.require(f"{px}E@erowsum", f"{px}E", ints(er_.u_row), ints(er_.claim)[0], "E != e row sums")

    div_u, div_v = ints(proof.div_zero_u), ints(proof.div_zero_v)
    df = ints(proof.div_finals)
    ck.require(f"{px}P@div_v", f"{px}P", div_v, df[0], "division P final")
    ck.require(f"{px}E@div_v", f"{px}E", div_v[log_cols:], df[1], "division E_bcast final")
    ck.require(f"{px}e@div", f"{px}e", div_u, ints(proof.e_at_div)[0], "e@div")
    r_div = ck.recombined(f"{px}r_bits.rec", f"{px}r_bits", div_u, fr_ops.ceil_log2(R_BITS))
    if r_div != ints(proof.r_at_div)[0]:
        raise wcommit.BindingError("r@div claim unbound")
    E_div_row = ck.value(f"{px}E@div_row", f"{px}E", div_u[log_cols:])
    if E_div_row != ints(proof.E_at_divrow)[0]:
        raise wcommit.BindingError("E@div_row claim unbound")
    er_rec = ck.recombined(f"{px}er_bits.rec", f"{px}er_bits", div_u, fr_ops.ceil_log2(R_BITS))
    if er_rec != HF.sub(HF.sub(E_div_row, one), r_div):
        raise wcommit.BindingError("er range tensor != E - 1 - r at div_u")

    pr = proof.p_rowsum
    ck.require(f"{px}P@rowsum", f"{px}P", ints(pr.u_col) + ints(pr.u_row), ints(pr.finals)[0], "P rowsum final")
    slack_rec = ck.recombined(f"{px}slack_bits.rec", f"{px}slack_bits", ints(pr.u_row),
                              fr_ops.ceil_log2(proof.slack_range.width))
    if slack_rec != ints(proof.slack_at_urow)[0]:
        raise wcommit.BindingError("slack@u_row claim unbound")


def witness_names(rows: int, cols: int, prefix: str = "sm.", s_name: str | None = None) -> list[str]:
    """The commitment order of commit_witness, which replay re-absorbs."""
    names = [] if s_name else [f"{prefix}S"]
    names += [f"{prefix}h", f"{prefix}hs", f"{prefix}smax", f"{prefix}e", f"{prefix}E", f"{prefix}P"]
    names += [f"{prefix}{nm}" for nm in _range_widths(cols)]
    return names


def absorb_witness_coms(transcript: ChallengeSource, ws: wcommit.WitnessSet, names: list[str]) -> str | None:
    """Absorb the witness commitments in that order; a missing one is a
    clean rejection."""
    for nm in names:
        com = ws.coms.get(nm)
        if com is None:
            return f"missing witness commitment {nm}"
        pts = com.points
        transcript.absorb_array(pts.x)
        transcript.absorb_array(pts.y)
        transcript.absorb_array(pts.z)
    return None


def draw_eq(transcript: ChallengeSource, tag: str, stored) -> str | None:
    """Draw as many challenges as `stored` holds and compare."""
    arr = mp.host(stored).reshape(-1, 8)
    got = mp.host(transcript.random_vec(arr.shape[0]))
    return None if np.array_equal(got, arr) else f"{tag} not transcript-derived"


def replay_transcript(proof: ZkSoftmaxProof, transcript: ChallengeSource) -> str | None:
    """Re-derive every softmax challenge from `transcript` (which holds the
    witness-commitment absorbs) and compare with the proof, in prove()'s
    draw and absorb order. Returns an error string or None."""

    def draw(tag, stored):
        return draw_eq(transcript, tag, stored)

    def point_eq(tag, stored, expect):
        return None if np.array_equal(mp.host(stored), mp.host(expect)) else f"{tag} anchor-point mismatch"

    def rp(tag, rpf, expect_urec):
        e = draw(f"{tag}.u_rec", rpf.u_rec) if expect_urec is None else point_eq(f"{tag}.u_rec", rpf.u_rec,
                                                                                 expect_urec)
        e = e or draw(f"{tag}.u", rpf.u) or draw(f"{tag}.v", rpf.v)
        if e:
            return e
        transcript.absorb_array(rpf.polys)
        transcript.absorb_array(rpf.bits_at_u)
        return None

    def rowsum(tag, rs):
        e = draw(f"{tag}.u_row", rs.u_row) or draw(f"{tag}.u_col", rs.u_col)
        if e:
            return e
        transcript.absorb_array(rs.polys)
        transcript.absorb_array(rs.claim)
        return None

    err = rp("h", proof.h_range, None) or rowsum("h_rowsum", proof.h_rowsum) \
        or draw("u_rec", proof.u_rec) \
        or rp("dfull_bits", proof.dfull_range, proof.u_rec) \
        or rp("rem8_bits", proof.rem8_range, proof.u_rec) \
        or draw("hs_u", proof.hs_u) or draw("hs_v", proof.hs_v)
    if err:
        return err
    transcript.absorb_array(proof.hs_polys)
    err = rowsum("smax_rowsum", proof.smax_rowsum) \
        or rp("d_bits", proof.d_range, proof.u_rec) \
        or rp("dgap_bits", proof.dgap_range, proof.u_rec) \
        or draw("clip.u", proof.clip_zero.u) or draw("clip.v", proof.clip_zero.v)
    if err:
        return err
    transcript.absorb_array(proof.clip_zero.polys)
    lk = proof.lk
    transcript.absorb_array(lk.m)
    err = draw("lk.z", lk.z) \
        or draw("lk.u_w_ip", lk.u_w_ip) or draw("lk.u_v_ip", lk.u_v_ip) \
        or draw("lk.u_w", lk.u_w) or draw("lk.v_w", lk.v_w) \
        or draw("lk.u_t", lk.u_t) or draw("lk.v_t", lk.v_t)
    if err:
        return err
    for arr in (lk.sum_w, lk.sum_v, lk.w_ip_polys, lk.v_ip_polys, lk.w_hp_polys, lk.t_hp_polys):
        transcript.absorb_array(arr)
    err = rowsum("e_rowsum", proof.e_rowsum) \
        or draw("div_u", proof.div_zero_u) or draw("div_v", proof.div_zero_v)
    if err:
        return err
    transcript.absorb_array(proof.div_polys)
    return rp("r_bits", proof.r_range, proof.div_zero_u) \
        or rp("er_bits", proof.er_range, proof.div_zero_u) \
        or rowsum("p_rowsum", proof.p_rowsum) \
        or rp("slack_bits", proof.slack_range, proof.p_rowsum.u_row)


def verify(proof: ZkSoftmaxProof, checker: wcommit.Checker | None = None, prefix: str = "sm.",
           s_name: str | None = None, transcript: ChallengeSource | None = None) -> tuple[bool, str]:
    """Verify the circuit's proofs and equations, and with a committed
    witness (or a checker) every binding (zksoftmax.py:verify)."""
    ints = sc.scalars_to_ints
    if transcript is not None:
        if proof.witness is None:
            return False, "transcript replay requires a committed-witness proof"
        err = absorb_witness_coms(transcript, proof.witness,
                                  witness_names(proof.rows, proof.cols, prefix, s_name)) \
            or replay_transcript(proof, transcript)
        if err:
            return False, f"transcript: {err}"
    checks: list[tuple[str, tuple[bool, str]]] = []
    checks.append(("h binary", proof.h_range.verify()))
    checks.append(("h rowsum", proof.h_rowsum.verify()))
    if ints(proof.h_rowsum.claim)[0] != HF.one_mont:
        return False, "h rowsum claim != 1"
    checks.append(("d_full range", proof.dfull_range.verify()))
    checks.append(("rem8 range", proof.rem8_range.verify()))
    t_claim = HF.add(HF.mul(HF.mont(1 << BUCKET_SHIFT), proof.dfull_range.value_claim()),
                     proof.rem8_range.value_claim())
    if t_claim != HF.sub(ints(proof.smax_at_urec_row)[0], ints(proof.s_at_urec)[0]):
        return False, "t != Smax - S at u_rec"
    res = sc.hadamard_verify(sc.polys_to_ints(proof.hs_polys), ints(proof.hs_u), ints(proof.hs_v),
                             ints(proof.hs_claim)[0], *ints(proof.hs_finals))
    if not res.ok:
        return False, "hs hadamard: " + res.reason
    checks.append(("smax rowsum", proof.smax_rowsum.verify()))
    checks.append(("d range", proof.d_range.verify()))
    checks.append(("dgap range", proof.dgap_range.verify()))
    if HF.add(proof.d_range.value_claim(), proof.dgap_range.value_claim()) != proof.dfull_range.value_claim():
        return False, "d + (d_full - d) != d_full at u_rec"
    checks.append(("clip zero-product", proof.clip_zero.verify()))
    checks.append(("exp lookup", lookup.verify(proof.lk, table_vals=[int(x) for x in pair_table_vals(proof.d_model)])))
    a_vw, d_lk, e_lk = ints(proof.lk.a_at_vw)[0], ints(proof.d_at_lk)[0], ints(proof.e_at_lk)[0]
    if a_vw != HF.add(HF.mul(HF.mont(1 << E_PAIR), d_lk), e_lk):
        return False, "lookup pair claim != 2^17 d + e"
    checks.append(("e rowsum", proof.e_rowsum.verify()))
    res = sc.hadamard_verify(sc.polys_to_ints(proof.div_polys), ints(proof.div_zero_u), ints(proof.div_zero_v),
                             ints(proof.pE_claim)[0], *ints(proof.div_finals))
    if not res.ok:
        return False, "division hadamard: " + res.reason
    lhs = HF.mul(HF.mont(quantize.SCALE), ints(proof.e_at_div)[0])
    if lhs != HF.add(ints(proof.pE_claim)[0], ints(proof.r_at_div)[0]):
        return False, "e*2^16 != P*E + r at div point"
    checks.append(("r range", proof.r_range.verify()))
    checks.append(("E-1-r range", proof.er_range.verify()))
    checks.append(("P rowsum", proof.p_rowsum.verify()))
    checks.append(("slack range", proof.slack_range.verify()))
    if ints(proof.p_rowsum.claim)[0] != HF.sub(HF.mont(quantize.SCALE), ints(proof.slack_at_urow)[0]):
        return False, "P rowsum != 2^16 - slack"
    for name, (ok, msg) in checks:
        if not ok:
            return False, f"{name}: {msg}"
    if checker is None and proof.witness is not None:
        checker = wcommit.Checker(proof.witness)
    if checker is not None:
        try:
            _check_bound(proof, checker, prefix=prefix, s_name=s_name)
        except wcommit.BindingError as e:
            return False, f"binding: {e}"
    return True, ""
