"""zkAttention: a verifiable quantized single-head attention block.

Counterpart of ``zkdl_tpu/models/zkattention.py``: ``MatmulProof``,
``matmul_prove``/``matmul_verify`` (:117-153), ``ZkAttention``
(``from_float``, ``forward``, ``prove`` in both tiers, ``verify``,
``_replay_transcript``, ``_verify_committed``, :240-590),
``ZkAttentionProof`` and ``_transpose``; and the cheap softmax variant,
on no entry point of either package (:49-231: ``P_RANGE_BITS``,
``softmax_aux``, ``p_range_bits``, ``SoftmaxProof``, ``softmax_prove``,
``softmax_verify``): a range proof of P's 17-bit entries and a proof that
every row of P sums to 2^16, on the natural-order provers (K1-K3).

    Q = rescale(X Wq)   K = rescale(X Wk)   V = rescale(X Wv)
    S = rescale(Q K^T)  P = softmax circuit of S (zksoftmax)
    O = rescale(P V)    Y = rescale(O Wo)

Four committed-weight matmul sumchecks with openings (zkfc.prove), two
witness-witness matmul sumchecks (matmul_prove), six rescale proofs and the
softmax circuit. With commit_witness=True every intermediate tensor and aux
is committed over NUMS generators before the first challenge and every
forwarded claim is a commitment opening (commit/witness.py); the verifier
can then replay the whole Fiat-Shamir transcript and anchor X and Y.
Matrices are row-major (rows*cols, 8) Montgomery tensors, dims powers of two.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..commit import witness as wcommit
from ..field import fr, host, mp, planar
from ..sumcheck import protocols as sc
from ..sumcheck.transcript import ChallengeSource
from ..tensor import fr_ops
from ..utils import prng
from . import quantize, zkfc, zkrelu, zkrescale, zksoftmax

HF = host.fr
P_RANGE_BITS = 17  # P entries lie in [0, 2^16]: 17 bits cover the closed range


@dataclasses.dataclass
class MatmulProof:
    u_rows: torch.Tensor
    u_k: torch.Tensor
    u_cols: torch.Tensor
    ip_polys: torch.Tensor  # (log k, 3, 8)
    ip_finals: torch.Tensor  # (2, 8): A'(u_k), B'(u_k)
    z_claim: torch.Tensor  # (8,) C(u_cols || u_rows)


def matmul_prove(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, rows: int, k: int, cols: int,
                 challenges: ChallengeSource) -> MatmulProof:
    """Prove C = A B for prover-known A (rows x k) and B (k x cols): zkFC's
    rounds without an opening."""
    u_rows = challenges.random_vec(fr_ops.ceil_log2(rows))
    u_k = challenges.random_vec(fr_ops.ceil_log2(k))
    u_cols = challenges.random_vec(fr_ops.ceil_log2(cols))
    ip_polys, ip_finals, z_claim = zkfc.fc_prove_core(A, B, C, u_rows, u_k, u_cols, k, cols)
    challenges.absorb_array(ip_polys)
    challenges.absorb_array(z_claim)
    return MatmulProof(u_rows, u_k, u_cols, ip_polys, ip_finals, z_claim)


def matmul_verify(proof: MatmulProof) -> tuple[bool, str]:
    ints = sc.scalars_to_ints
    res = sc.inner_product_verify(sc.polys_to_ints(proof.ip_polys), ints(proof.u_k), ints(proof.z_claim)[0])
    if not res.ok:
        return False, res.reason
    fa, fb = ints(proof.ip_finals)
    if not sc.inner_product_check_final(res, fa, fb):
        return False, "final product mismatch"
    return True, ""


# ---------------------------------------------------------------------------
# the cheap softmax: prover's P, its range bits, and its proof
# ---------------------------------------------------------------------------


def _softmax_aux_core(S: torch.Tensor, rows: int, cols: int, d_model: int) -> torch.Tensor:
    """S: (rows*cols, 8) Montgomery at scale 2^16 (signed) -> int64 (rows,
    cols) P values at scale 2^16, each row summing to exactly 2^16
    (zkattention.py:_softmax_aux_core): the float32 softmax of S / 2^16 /
    sqrt(d_model), floored at 2^16, the residue put on the row's first
    maximum. On S's device."""
    pos_max, _ = zkrelu._width_consts(zkrelu.Q, zkrelu.R)
    x = mp.i64(planar.from_mont(planar.to_planar(S)))  # (8, n) raw
    pos = mp.gte(mp.const(pos_max, x), x)
    neg_mag = mp.mod_sub(fr.SPEC.P_limbs, torch.zeros_like(x), x)
    lo = torch.where(pos, x[0], neg_mag[0]).to(torch.float32)
    hi = torch.where(pos, x[1], neg_mag[1]).to(torch.float32)
    mag = lo + hi * torch.tensor(2.0**32, dtype=torch.float32)
    val = torch.where(pos, mag, -mag) / torch.tensor(float(quantize.SCALE), dtype=torch.float32)
    logits = (val / torch.tensor(float(np.float32(np.sqrt(d_model))), dtype=torch.float32)).reshape(rows, cols)
    mx = logits.max(dim=1, keepdim=True).values
    e = torch.exp(logits - mx)
    p = e / e.sum(dim=1, keepdim=True)
    q = torch.floor(p * torch.tensor(float(quantize.SCALE), dtype=torch.float32)).to(torch.int64)
    resid = quantize.SCALE - q.sum(dim=1)
    am = q.argmax(dim=1)  # the first maximum
    q[torch.arange(rows, device=q.device), am] += resid
    return q


def softmax_aux(S: torch.Tensor, rows: int, cols: int, d_model: int, real_rows: int | None = None):
    """The prover's P: ((rows*cols, 8) Montgomery P on S's device, uint32
    numpy (rows, cols) values). Padding rows (>= real_rows) are replaced by
    2^16 e_0 so every row sums to 2^16 (zkattention.py:softmax_aux)."""
    q = _softmax_aux_core(S, rows, cols, d_model)
    if real_rows is not None and real_rows < rows:
        q[real_rows:] = 0
        q[real_rows:, 0] = quantize.SCALE
    P = fr_ops.to_mont(fr_ops.from_u32(q.reshape(-1)))
    return P, q.to(torch.uint32).cpu().numpy()


def p_range_bits(P: torch.Tensor) -> torch.Tensor:
    """17-bit LSB-first decomposition of P's values -> (n*17, 8) Montgomery
    bits, entry-major (zkattention.py:p_range_bits)."""
    vals = mp.i64(fr_ops.unmont(P)[:, 0])  # entries < 2^17 live in limb 0
    shifts = torch.arange(P_RANGE_BITS, device=P.device)
    return fr_ops.mont_bits(mp.u32((vals[:, None] >> shifts) & 1).reshape(-1))


@dataclasses.dataclass
class SoftmaxProof:
    # range: binary sumcheck over the 17-bit decomposition + recombination fold
    u_bin: torch.Tensor
    v_bin: torch.Tensor
    bin_polys: torch.Tensor
    bin_final: torch.Tensor
    u_rec: torch.Tensor
    bits_at_u: torch.Tensor  # (17, 8) recombination claims
    # normalization: <P(u_row, .), 1> == 2^16
    u_row: torch.Tensor
    u_col: torch.Tensor
    ip_polys: torch.Tensor
    ip_finals: torch.Tensor  # (2, 8): P'(u_col), 1


def softmax_prove(P: torch.Tensor, rows: int, cols: int, challenges: ChallengeSource) -> SoftmaxProof:
    """Range and normalization proof of the (rows*cols, 8) Montgomery P
    (zkattention.py:softmax_prove): the binary sumcheck of its bits over
    log n + 5 variables (17n bits padded to 32n), the bits' recombination
    claims, and the inner product of each row (folded at u_row) with ones."""
    n = rows * cols
    log_n = fr_ops.ceil_log2(n)
    bits = p_range_bits(P)
    u_bin = challenges.random_vec(log_n + 5)
    v_bin = challenges.random_vec(log_n + 5)
    u_rec = challenges.random_vec(log_n)
    u_row = challenges.random_vec(fr_ops.ceil_log2(rows))
    u_col = challenges.random_vec(fr_ops.ceil_log2(cols))
    bin_polys, bin_final = sc.binary_prove(bits, u_bin, v_bin)
    bits_at_u = fr_ops.partial_me(bits, u_rec, P_RANGE_BITS)
    P_row_folded = fr_ops.partial_me(P, u_row, cols)
    ip_polys, ip_finals = sc.inner_product_prove(P_row_folded, fr_ops.ones_mont(cols, P.device), u_col)
    proof = SoftmaxProof(u_bin, v_bin, bin_polys, bin_final, u_rec, bits_at_u, u_row, u_col, ip_polys, ip_finals)
    challenges.absorb_array(bin_polys)
    challenges.absorb_array(ip_polys)
    return proof


def softmax_verify(proof: SoftmaxProof) -> tuple[bool, str]:
    """Host verifier (zkattention.py:softmax_verify)."""
    ints = sc.scalars_to_ints
    res = sc.binary_verify(sc.polys_to_ints(proof.bin_polys), ints(proof.u_bin), ints(proof.v_bin),
                           ints(proof.bin_final)[0])
    if not res.ok:
        return False, "range: " + res.reason
    # normalization: the initial sum claim must be exactly mont(2^16)
    res = sc.inner_product_verify(sc.polys_to_ints(proof.ip_polys), ints(proof.u_col), HF.mont(quantize.SCALE))
    if not res.ok:
        return False, "norm: " + res.reason
    fa, fb = ints(proof.ip_finals)
    if fb != HF.one_mont:
        return False, "norm: ones-vector final != 1"
    if not sc.inner_product_check_final(res, fa, fb):
        return False, "norm: final product mismatch"
    return True, ""


_TRACE_NAMES = ("X", "Q_raw", "Q", "K_raw", "K", "V_raw", "V", "S_raw", "S", "O_raw", "O", "Y_raw", "Y")
_TAGS = ("q", "k", "v", "s", "o", "y")


def _cat(*us) -> np.ndarray:
    return np.concatenate([mp.host(u) for u in us], axis=0)


@dataclasses.dataclass
class ZkAttention:
    """Single-head attention with committed projection weights; seq and
    d_model powers of two."""

    seq: int
    d_model: int
    wq: zkfc.ZkFC
    wk: zkfc.ZkFC
    wv: zkfc.ZkFC
    wo: zkfc.ZkFC

    @classmethod
    def from_float(cls, seq: int, wq: np.ndarray, wk: np.ndarray, wv: np.ndarray, wo: np.ndarray,
                   key: np.ndarray, device) -> "ZkAttention":
        """The four projections from float (d, d) weights, their generators
        from split(key, 4) (a prng key, as jax.random.PRNGKey gives)."""
        keys = prng.split(key, 4)
        fcs = [zkfc.ZkFC.from_float(w, k, device) for w, k in zip((wq, wk, wv, wo), keys)]
        d = fcs[0].in_size
        if not all(f.in_size == d and f.out_size == d for f in fcs):
            raise ValueError("attention projections must all be d_model x d_model")
        return cls(seq, d, *fcs)

    def forward(self, X: torch.Tensor):
        """X: (seq*d_model, 8) Montgomery at scale 2^16 -> (Y, trace): every
        intermediate and aux, the witness of prove()."""
        s, d = self.seq, self.d_model
        tr: dict = {"X": X}
        for tag, fc, name in (("q", self.wq, "Q"), ("k", self.wk, "K"), ("v", self.wv, "V")):
            tr[f"{name}_raw"] = fc(X)
            tr[name], tr[f"{tag}_aux"] = zkrescale.forward(tr[f"{name}_raw"])
        tr["Kt"] = _transpose(tr["K"], s, d)
        tr["S_raw"] = zkfc.field_matmul(tr["Q"], tr["Kt"], d, s)
        tr["S"], tr["s_aux"] = zkrescale.forward(tr["S_raw"])
        wit = zksoftmax.softmax_witness(tr["S"], s, s, d)
        tr["P"], tr["P_raw_vals"], tr["sm_wit"] = wit["P_mont"], wit["P"].reshape(s, s), wit
        tr["O_raw"] = zkfc.field_matmul(tr["P"], tr["V"], s, d)
        tr["O"], tr["o_aux"] = zkrescale.forward(tr["O_raw"])
        tr["Y_raw"] = self.wo(tr["O"])
        tr["Y"], tr["y_aux"] = zkrescale.forward(tr["Y_raw"])
        return tr["Y"], tr

    def commit_witness(self, tr: dict) -> wcommit.Committer:
        """Commit every intermediate tensor and aux, in the JAX order."""
        s = self.seq
        wc = wcommit.Committer()
        for nm in _TRACE_NAMES:
            wc.commit(f"at.{nm}", tr[nm])
        for tag in _TAGS:
            zkrescale.commit_witness(wc, tr[f"{tag}_aux"], f"at.{tag}.")
        zksoftmax.commit_witness(wc, tr["S"], tr["sm_wit"], s, s, prefix="at.sm.", s_name="at.S")
        return wc

    def prove(self, tr: dict, challenges: ChallengeSource, commit_witness: bool = False,
              on_stage=None) -> "ZkAttentionProof":
        """Prove the block from forward()'s trace. on_stage(name), when
        given, is called after the witness commitments ("commit") and after
        each sub-proof, for per-stage timing."""
        s, d = self.seq, self.d_model
        mark = on_stage or (lambda name: None)
        if not commit_witness:
            fc_q = zkfc.prove(self.wq, tr["X"], tr["Q_raw"], challenges)
            rs_q = zkrescale.prove(tr["Q_raw"], tr["q_aux"], challenges)
            fc_k = zkfc.prove(self.wk, tr["X"], tr["K_raw"], challenges)
            rs_k = zkrescale.prove(tr["K_raw"], tr["k_aux"], challenges)
            fc_v = zkfc.prove(self.wv, tr["X"], tr["V_raw"], challenges)
            rs_v = zkrescale.prove(tr["V_raw"], tr["v_aux"], challenges)
            mm_s = matmul_prove(tr["Q"], tr["Kt"], tr["S_raw"], s, d, s, challenges)
            rs_s = zkrescale.prove(tr["S_raw"], tr["s_aux"], challenges)
            sm = zksoftmax.prove(tr["S"], tr["sm_wit"], s, s, d, challenges)
            mm_o = matmul_prove(tr["P"], tr["V"], tr["O_raw"], s, s, d, challenges)
            rs_o = zkrescale.prove(tr["O_raw"], tr["o_aux"], challenges)
            fc_y = zkfc.prove(self.wo, tr["O"], tr["Y_raw"], challenges)
            rs_y = zkrescale.prove(tr["Y_raw"], tr["y_aux"], challenges)
            mark("prove")
            return ZkAttentionProof(fc_q, rs_q, fc_k, rs_k, fc_v, rs_v, mm_s, rs_s, sm, mm_o, rs_o, fc_y, rs_y)

        wc = self.commit_witness(tr)
        wc.absorb(challenges)
        mark("commit")

        def fc_open(tag, p, x_name, z_name):
            wc.open(f"at.{tag}.fa", x_name, _cat(p.u_in, p.u_bs))
            wc.open(f"at.{tag}.z", z_name, _cat(p.u_out, p.u_bs))

        def mm_open(tag, p, a_name, b_name, c_name, b_transposed):
            # K^T entered the matmul transposed: Kt(u_cols || u_k) == K(u_k || u_cols)
            wc.open(f"at.{tag}.fa", a_name, _cat(p.u_k, p.u_rows))
            wc.open(f"at.{tag}.fb", b_name, _cat(p.u_k, p.u_cols) if b_transposed else _cat(p.u_cols, p.u_k))
            wc.open(f"at.{tag}.z", c_name, _cat(p.u_cols, p.u_rows))

        def rescale(tag, name):
            out = zkrescale.prove_committed(tr[f"{name}_raw"], tr[name], tr[f"{tag}_aux"], wc, f"at.{tag}.",
                                            challenges, f"at.{name}_raw", f"at.{name}")
            mark(f"rs_{tag}")
            return out

        def fc(tag, layer, x_name, z_name):
            p = zkfc.prove(layer, tr[x_name], tr[z_name], challenges)
            fc_open(tag, p, f"at.{x_name}", f"at.{z_name}")
            mark(tag)
            return p

        fc_q = fc("fc_q", self.wq, "X", "Q_raw")
        rs_q = rescale("q", "Q")
        fc_k = fc("fc_k", self.wk, "X", "K_raw")
        rs_k = rescale("k", "K")
        fc_v = fc("fc_v", self.wv, "X", "V_raw")
        rs_v = rescale("v", "V")
        mm_s = matmul_prove(tr["Q"], tr["Kt"], tr["S_raw"], s, d, s, challenges)
        mm_open("mm_s", mm_s, "at.Q", "at.K", "at.S_raw", b_transposed=True)
        mark("mm_s")
        rs_s = rescale("s", "S")
        sm = zksoftmax.prove(tr["S"], tr["sm_wit"], s, s, d, challenges, witness=wc, prefix="at.sm.", s_name="at.S")
        mark("softmax")
        mm_o = matmul_prove(tr["P"], tr["V"], tr["O_raw"], s, s, d, challenges)
        mm_open("mm_o", mm_o, "at.sm.P", "at.V", "at.O_raw", b_transposed=False)
        mark("mm_o")
        rs_o = rescale("o", "O")
        fc_y = fc("fc_y", self.wo, "O", "Y_raw")
        rs_y = rescale("y", "Y")

        # public anchors: X and Y opened at fresh points the verifier re-evaluates
        u_x = challenges.random_vec(fr_ops.ceil_log2(tr["X"].shape[0]))
        wc.open("at.X@anchor", "at.X", u_x)
        u_y = challenges.random_vec(fr_ops.ceil_log2(tr["Y"].shape[0]))
        wc.open("at.Y@anchor", "at.Y", u_y)
        mark("anchors")
        return ZkAttentionProof(fc_q, rs_q, fc_k, rs_k, fc_v, rs_v, mm_s, rs_s, sm, mm_o, rs_o, fc_y, rs_y,
                                witness=wc.witness_set(), u_x=u_x, u_y=u_y)

    def verify(self, proof: "ZkAttentionProof", X: torch.Tensor | None = None, Y: torch.Tensor | None = None,
               transcript: ChallengeSource | None = None) -> tuple[bool, str]:
        """Verify the block proof (zkattention.py:verify). A committed proof
        also binds every forwarded claim to the witness commitments and,
        given X/Y, anchors them; transcript (a fresh FiatShamir()) replays
        the whole challenge stream, committed proofs only."""
        if transcript is not None:
            if proof.witness is None:
                return False, "transcript replay requires a committed-witness proof"
            err = self._replay_transcript(proof, transcript)
            if err:
                return False, f"transcript: {err}"
        if proof.witness is not None:
            return self._verify_committed(proof, X, Y)
        if X is not None or Y is not None:
            return False, "public anchors require a committed-witness proof"
        checks = [
            ("fc_q", lambda: zkfc.verify(self.wq.com, proof.fc_q)),
            ("rs_q", lambda: zkrescale.verify(proof.rs_q)),
            ("fc_k", lambda: zkfc.verify(self.wk.com, proof.fc_k)),
            ("rs_k", lambda: zkrescale.verify(proof.rs_k)),
            ("fc_v", lambda: zkfc.verify(self.wv.com, proof.fc_v)),
            ("rs_v", lambda: zkrescale.verify(proof.rs_v)),
            ("mm_s", lambda: matmul_verify(proof.mm_s)),
            ("rs_s", lambda: zkrescale.verify(proof.rs_s)),
            ("softmax", lambda: zksoftmax.verify(proof.sm)),
            ("mm_o", lambda: matmul_verify(proof.mm_o)),
            ("rs_o", lambda: zkrescale.verify(proof.rs_o)),
            ("fc_y", lambda: zkfc.verify(self.wo.com, proof.fc_y)),
            ("rs_y", lambda: zkrescale.verify(proof.rs_y)),
        ]
        for name, check in checks:
            ok, msg = check()
            if not ok:
                return False, f"{name}: {msg}"
        return True, ""

    def _replay_transcript(self, proof: "ZkAttentionProof", transcript: ChallengeSource) -> str | None:
        """The committed prove()'s draw and absorb schedule: the commitments
        in insertion order, then each stage's draws and message absorbs,
        then the anchors u_x, u_y. Openings never touch the transcript."""
        s = self.seq
        names = [f"at.{nm}" for nm in _TRACE_NAMES]
        for tag in _TAGS:
            names += [f"at.{tag}.{x}" for x in ("sign", "mag", "rem", "abs")]
        names += zksoftmax.witness_names(s, s, prefix="at.sm.", s_name="at.S")
        err = zksoftmax.absorb_witness_coms(transcript, proof.witness, names)
        if err:
            return err

        def draw(tag, stored):
            return zksoftmax.draw_eq(transcript, tag, stored)

        def fc_rp(tag, p):
            e = draw(f"{tag}.u_bs", p.u_bs) or draw(f"{tag}.u_in", p.u_in) or draw(f"{tag}.u_out", p.u_out)
            if e:
                return e
            transcript.absorb_array(p.ip_polys)
            transcript.absorb_array(p.z_claim)
            return None

        def mm_rp(tag, p):
            e = draw(f"{tag}.u_rows", p.u_rows) or draw(f"{tag}.u_k", p.u_k) or draw(f"{tag}.u_cols", p.u_cols)
            if e:
                return e
            transcript.absorb_array(p.ip_polys)
            transcript.absorb_array(p.z_claim)
            return None

        def rs_rp(tag, p):
            b = p.base
            for nm, st in (("u_z", b.u_z_bin), ("v_z", b.v_z_bin), ("u_r", b.u_r_bin), ("v_r", b.v_r_bin),
                           ("u_rec", b.u_recover), ("u_hp", b.u_hp), ("v_hp", b.v_hp)):
                e = draw(f"{tag}.{nm}", st)
                if e:
                    return e
            transcript.absorb_array(b.mag_polys)
            transcript.absorb_array(b.rem_polys)
            transcript.absorb_array(b.hp_polys)
            e = draw(f"{tag}.u1", p.u1) or draw(f"{tag}.v1", p.v1)
            if e:
                return e
            transcript.absorb_array(p.sa_polys)
            e = draw(f"{tag}.u2", p.u2) or draw(f"{tag}.v2", p.v2)
            if e:
                return e
            transcript.absorb_array(p.sm_polys)
            return None

        err = fc_rp("fc_q", proof.fc_q) or rs_rp("rs_q", proof.rs_q) \
            or fc_rp("fc_k", proof.fc_k) or rs_rp("rs_k", proof.rs_k) \
            or fc_rp("fc_v", proof.fc_v) or rs_rp("rs_v", proof.rs_v) \
            or mm_rp("mm_s", proof.mm_s) or rs_rp("rs_s", proof.rs_s) \
            or zksoftmax.replay_transcript(proof.sm, transcript) \
            or mm_rp("mm_o", proof.mm_o) or rs_rp("rs_o", proof.rs_o) \
            or fc_rp("fc_y", proof.fc_y) or rs_rp("rs_y", proof.rs_y)
        if err:
            return err
        if proof.u_x is None or proof.u_y is None:
            return "missing public anchor points"
        return draw("u_x", proof.u_x) or draw("u_y", proof.u_y)

    def _verify_committed(self, proof: "ZkAttentionProof", X: torch.Tensor | None,
                          Y: torch.Tensor | None) -> tuple[bool, str]:
        ck = wcommit.Checker(proof.witness)
        ints = sc.scalars_to_ints

        def fc_bind(tag, p, com, x_name, z_name):
            ok, msg = zkfc.verify(com, p)
            if not ok:
                return f"{tag}: {msg}"
            try:
                ck.require(f"at.{tag}.fa", x_name, ints(p.u_in) + ints(p.u_bs), ints(p.ip_finals)[0],
                           f"{tag} input final")
                ck.require(f"at.{tag}.z", z_name, ints(p.u_out) + ints(p.u_bs), ints(p.z_claim)[0],
                           f"{tag} output claim")
            except wcommit.BindingError as e:
                return f"{tag}: {e}"
            return None

        def mm_bind(tag, p, a_name, b_name, c_name, b_transposed):
            ok, msg = matmul_verify(p)
            if not ok:
                return f"{tag}: {msg}"
            fa, fb = ints(p.ip_finals)
            b_pt = ints(p.u_k) + ints(p.u_cols) if b_transposed else ints(p.u_cols) + ints(p.u_k)
            try:
                ck.require(f"at.{tag}.fa", a_name, ints(p.u_k) + ints(p.u_rows), fa, f"{tag} left final")
                ck.require(f"at.{tag}.fb", b_name, b_pt, fb, f"{tag} right final")
                ck.require(f"at.{tag}.z", c_name, ints(p.u_cols) + ints(p.u_rows), ints(p.z_claim)[0],
                           f"{tag} output claim")
            except wcommit.BindingError as e:
                return f"{tag}: {e}"
            return None

        # each step runs only once the steps before it passed (the JAX list
        # evaluates every step first; its first failure is the same)
        steps = [
            ("fc_q", lambda: fc_bind("fc_q", proof.fc_q, self.wq.com, "at.X", "at.Q_raw")),
            ("rs_q", lambda: zkrescale.verify_committed(proof.rs_q, ck, "at.q.", "at.Q_raw", "at.Q")),
            ("fc_k", lambda: fc_bind("fc_k", proof.fc_k, self.wk.com, "at.X", "at.K_raw")),
            ("rs_k", lambda: zkrescale.verify_committed(proof.rs_k, ck, "at.k.", "at.K_raw", "at.K")),
            ("fc_v", lambda: fc_bind("fc_v", proof.fc_v, self.wv.com, "at.X", "at.V_raw")),
            ("rs_v", lambda: zkrescale.verify_committed(proof.rs_v, ck, "at.v.", "at.V_raw", "at.V")),
            ("mm_s", lambda: mm_bind("mm_s", proof.mm_s, "at.Q", "at.K", "at.S_raw", True)),
            ("rs_s", lambda: zkrescale.verify_committed(proof.rs_s, ck, "at.s.", "at.S_raw", "at.S")),
            ("softmax", lambda: zksoftmax.verify(proof.sm, checker=ck, prefix="at.sm.", s_name="at.S")),
            ("mm_o", lambda: mm_bind("mm_o", proof.mm_o, "at.sm.P", "at.V", "at.O_raw", False)),
            ("rs_o", lambda: zkrescale.verify_committed(proof.rs_o, ck, "at.o.", "at.O_raw", "at.O")),
            ("fc_y", lambda: fc_bind("fc_y", proof.fc_y, self.wo.com, "at.O", "at.Y_raw")),
            ("rs_y", lambda: zkrescale.verify_committed(proof.rs_y, ck, "at.y.", "at.Y_raw", "at.Y")),
        ]
        for name, step in steps:
            res = step()
            if res is None:
                continue
            if isinstance(res, tuple):
                ok, msg = res
                if not ok:
                    return False, f"{name}: {msg}"
            else:
                return False, str(res)

        try:
            if X is not None:
                want = ints(fr_ops.me_eval(X, proof.u_x))[0]
                if ck.value("at.X@anchor", "at.X", ints(proof.u_x)) != want:
                    return False, "public X anchor mismatch"
            else:
                ck.value("at.X@anchor", "at.X", ints(proof.u_x))
            if Y is not None:
                want = ints(fr_ops.me_eval(Y, proof.u_y))[0]
                if ck.value("at.Y@anchor", "at.Y", ints(proof.u_y)) != want:
                    return False, "public Y anchor mismatch"
        except wcommit.BindingError as e:
            return False, f"anchor: {e}"
        return True, ""


@dataclasses.dataclass
class ZkAttentionProof:
    fc_q: zkfc.ZkFCProof
    rs_q: zkrelu.ZkReluProof
    fc_k: zkfc.ZkFCProof
    rs_k: zkrelu.ZkReluProof
    fc_v: zkfc.ZkFCProof
    rs_v: zkrelu.ZkReluProof
    mm_s: MatmulProof
    rs_s: zkrelu.ZkReluProof
    sm: zksoftmax.ZkSoftmaxProof
    mm_o: MatmulProof
    rs_o: zkrelu.ZkReluProof
    fc_y: zkfc.ZkFCProof
    rs_y: zkrelu.ZkReluProof
    # committed-witness tier (None: claim forwarding); the rs_* fields then
    # hold zkrescale.RescaleBinding objects
    witness: wcommit.WitnessSet | None = None
    u_x: torch.Tensor | None = None  # public-input anchor point
    u_y: torch.Tensor | None = None  # public-output anchor point


def _transpose(M: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return M.reshape(rows, cols, 8).transpose(0, 1).reshape(rows * cols, 8).contiguous()
