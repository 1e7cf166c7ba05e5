"""Full-model SPMD prover: every sumcheck of MLP.prove dp-sharded over ranks.

Counterpart of ``zkdl_tpu/parallel/model.py``. Every protocol tensor (the
Z/A activations and the ReLU's aux) is block-sharded over its flat element
axis on the "dp" axis of a ``sharded.Mesh``: rank d holds block d, and its
local index bits are the low bits of the global index, the device bits the
highest (``sharded.py``). Per sumcheck:

- the rank reverses its own block and runs the planar rounds
  (``planar_protocols.py``) at the local challenges. For the point-anchored
  protocols (binary, Hadamard) each round's polynomial is the local
  coefficient MLE at the local tail; it is multiplied by eq(u_dev, rank)
  (``_dev_eq_weight``, the device bits' eq weight) before the sum over
  ranks (model.py:108-118);
- every local round's polynomial of one call goes in one all-reduce and one
  K9 launch (``collectives.psum_fr``): the challenges are drawn up front,
  so no round waits for another rank;
- the residues (one element a tensor a rank) are all-gathered and the last
  log2(n_dev) rounds run replicated.

MLE evaluations (``sharded_me_eval``) are local folds weighted the same way
and summed; partial folds (``sharded_partial_me``) gather the local folds
and finish replicated. The JAX scan tricks (``_fold_padded``,
``_me_eval_padded``, ``_local_tails``) fix shapes for ``lax.scan``; here
tensors shrink as they fold, with the same stream. Weights, challenges and
the transcript are replicated: every absorbed array is canonical and the
same on every rank, so every rank draws the same challenges and emits the
same proof, equal array for array to the single-device prover's
(``MLP.prove``) in every mode; unchained, that is the JAX (n, 8) path's.
"""

from __future__ import annotations

import torch

from ..commit import pedersen
from ..curve import g1
from ..field import fr, host, mp, planar
from ..models import zkfc, zkrelu
from ..sumcheck import planar_protocols as pp
from ..sumcheck import protocols as sc
from ..sumcheck.transcript import ChallengeSource, FiatShamir
from ..tensor import fr_ops
from . import collectives
from .sharded import Mesh, local_bits, shard

HF = host.fr


def _dev_eq_weight(u_dev, mesh: Mesh, axis: str) -> torch.Tensor:
    """eq(u_dev, this rank's index on the axis) -> host (8,) Montgomery
    limbs (model.py:_dev_eq_weight): bit t of the index picks u_dev[t] or
    1 - u_dev[t]. Round-independent: the device bits are the highest index
    bits of every protocol tensor."""
    d = mesh.index(axis)
    w = HF.one_mont
    for t, x in enumerate(fr.to_ints(mp.host(u_dev).reshape(-1, 8))):
        w = HF.mul(w, x if (d >> t) & 1 else HF.sub(HF.one_mont, x))
    return mp.limbs_from_int(w, 8)


def _weighted(vals: torch.Tensor, w) -> torch.Tensor:
    """(k, 8) values times the host scalar w (K2)."""
    return planar.from_planar(planar.mul_scalar(planar.to_planar(vals.reshape(-1, 8)), w)).contiguous()


def _bin_rounds(a, u, v):
    """Binary rounds of a (packed bits or planar) -> (polys, finals (1, 8))."""
    polys, final = pp._bin_rounds(a, mp.host(u), pp._given(v))
    return polys, final[None]


def _hp_rounds(a, b, u, v):
    """Hadamard rounds of a (.) b -> (polys, finals (2, 8))."""
    return pp._hp_rounds(a, b, mp.host(u), pp._given(v))


def _sharded_pa_prove(mesh: Mesh, operands, u, v, rounds, lr: int, axis: str):
    """The point-anchored sumchecks, sharded (model.py:_sharded_pa_prove): `operands`
    are this rank's bit-reversed local layouts of 2^lr entries, `rounds`
    the planar protocol (``_bin_rounds``/``_hp_rounds``). Local rounds at
    u[:lr], v[:lr], their polys weighted by eq(u[lr:], rank) and summed
    over the axis in one psum; the residues gathered; the device-bit rounds
    replicated. Returns (polys (r, 3, 8), finals (k, 8))."""
    u, v = mp.host(u), mp.host(v)
    polys, res = rounds(*operands, u[:lr], v[:lr])
    polys = collectives.psum_fr(_weighted(polys, _dev_eq_weight(u[lr:], mesh, axis)), mesh, axis)
    k = res.shape[0]
    g = collectives.all_gather(res, mesh, axis).reshape(-1, k, 8)
    ld = u.shape[0] - lr
    dev_polys, finals = rounds(*(sc._rev(g[:, j], ld) for j in range(k)), u[lr:], v[lr:])
    return torch.cat([polys.reshape(-1, 3, 8), dev_polys]), finals


def sharded_binary_prove(mesh: Mesh, a: torch.Tensor, u, v, axis: str = "dp"):
    """Distributed binary_prove (model.py:sharded_binary_prove): a is this
    rank's natural-order block (n_local, 8) Montgomery; u, v host (r, 8).
    Returns (polys (r, 3, 8), final (8,)), protocols.binary_prove's stream."""
    lr, _ = local_bits(a.shape[0], mesh.size(axis), u.shape[0])
    polys, finals = _sharded_pa_prove(mesh, (sc._rev(a, lr),), u, v, _bin_rounds, lr, axis)
    return polys, finals[0]


def sharded_hadamard_prove(mesh: Mesh, a: torch.Tensor, b: torch.Tensor, u, v, axis: str = "dp"):
    """Distributed hadamard_prove (model.py:sharded_hadamard_prove) of this
    rank's blocks a, b (n_local, 8). Returns (polys (r, 3, 8), finals (2, 8))."""
    lr, _ = local_bits(a.shape[0], mesh.size(axis), u.shape[0])
    return _sharded_pa_prove(mesh, (sc._rev(a, lr), sc._rev(b, lr)), u, v, _hp_rounds, lr, axis)


def sharded_partial_me(mesh: Mesh, t: torch.Tensor, u, window: int, axis: str = "dp") -> torch.Tensor:
    """Distributed fr_ops.partial_me (model.py:sharded_partial_me): this
    rank's block t (n_local * window, 8) of a window-minor tensor folded at
    u[:lr] locally, the n_dev folds gathered and folded at u[lr:].
    Returns the (window, 8) result on every rank."""
    u = mp.host(u)
    lr, ld = local_bits(t.shape[0] // window, mesh.size(axis), u.shape[0])
    t = fr_ops.partial_me(t, u[:lr], window) if lr else t
    g = collectives.all_gather(t, mesh, axis)
    return fr_ops.partial_me(g, u[lr:], window) if ld else g


def sharded_me_eval(mesh: Mesh, t: torch.Tensor, u, axis: str = "dp") -> torch.Tensor:
    """Distributed fr_ops.me_eval (model.py:sharded_me_eval) of this rank's
    block t (n_local, 8): the local MLE times eq(u_dev, rank), summed over
    the axis. Returns (8,) on every rank."""
    u = mp.host(u)
    lr, _ = local_bits(t.shape[0], mesh.size(axis), u.shape[0])
    local = fr_ops.me_eval(t, u[:lr]) if lr else t[0]
    return collectives.psum_fr(_weighted(local, _dev_eq_weight(u[lr:], mesh, axis)), mesh, axis)[0]


def sharded_commit_dlogs(mesh: Mesh, t: torch.Tensor, dlogs: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    """Row-sharded dlog commitment scalars (model.py:sharded_commit_dlogs):
    this rank's rows t (m_local * gen_size, 8), sigma_row = sum_i t[row, i]
    r_i by K3, gathered. Returns the (m, 8) Montgomery rows on every rank."""
    gen_size = dlogs.shape[0]
    local = pedersen._commit_rows_fast(t.reshape(-1, gen_size, 8), dlogs)
    return collectives.all_gather(local, mesh, axis)


# ---------------------------------------------------------------------------
# full-model sharded prover
# ---------------------------------------------------------------------------


def _fc_prove_sharded(mesh: Mesh, layer: zkfc.ZkFC, X, Z, challenges: ChallengeSource, z_point=None):
    """Sharded zkFC prover: unchained, the stream of zkfc.prove
    (model.py:_fc_prove_sharded); chained (z_point, the ReLU's u_recover,
    fixes u_out || u_bs; only u_in is drawn), that of
    zkfc.prove_planar(z_point=...) (model.py:_fc_prove_sharded_chained).
    X and Z are whole tensors; the batch fold of X and Z's claim are
    sharded, the in_size-scale inner product and the weight opening run
    replicated."""
    batch = X.shape[0] // layer.in_size
    lo = fr_ops.ceil_log2(layer.out_size)
    if z_point is None:
        u_bs = challenges.random_vec(fr_ops.ceil_log2(batch))
        u_in = challenges.random_vec(fr_ops.ceil_log2(layer.in_size))
        u_out = challenges.random_vec(lo)
    else:
        if z_point.shape[0] != lo + fr_ops.ceil_log2(batch):
            raise ValueError(f"z_point {tuple(z_point.shape)} vs out bits {lo}, batch {batch}")
        u_out, u_bs = z_point[:lo], z_point[lo:]
        u_in = challenges.random_vec(fr_ops.ceil_log2(layer.in_size))
    X_f = sharded_partial_me(mesh, shard(mesh, X), u_bs, layer.in_size) if u_bs.shape[0] else X
    W_f = fr_ops.partial_me(layer.weights, u_out, 1) if lo else layer.weights
    ip_polys, ip_finals = sc.inner_product_prove(X_f, W_f, u_in)
    z_claim = sharded_me_eval(mesh, shard(mesh, Z), torch.cat([u_out, u_bs]))
    opening = pedersen.open_planar(layer.gens, layer.weights, layer.com, torch.cat([u_out, u_in]))
    proof = zkfc.ZkFCProof(u_bs, u_in, u_out, ip_polys, ip_finals, z_claim, opening)
    challenges.absorb_array(ip_polys)
    challenges.absorb_array(z_claim)
    return proof


def _relu_prove_sharded(mesh: Mesh, X, aux: dict, challenges: ChallengeSource, chain_point=None,
                        aux_com: zkrelu.AuxCommitments | None = None) -> zkrelu.ZkReluProof:
    """Sharded zkReLU prover (model.py:_relu_prove_sharded and
    _relu_prove_sharded_chained): the
    draws and absorbs of zkrelu.prove_planar (unchained without chain_point,
    then the stream of zkrelu.prove; chained with it; committed with aux_com,
    whose six openings' row folds are sharded_partial_me). The rank lays
    out its element block as prove_planar lays out the whole (``_layout_body``);
    its recombination claims (mag, rem at u_rec, X (.) sign at u_hp, X at
    u_rec) are local eq-table sums, weighted and summed in one psum; the
    binary and Hadamard sumchecks run on _sharded_pa_prove."""
    Q, R, LOG_Q, LOG_R = zkrelu.Q, zkrelu.R, zkrelu.LOG_Q, zkrelu.LOG_R
    if Q != 1 << LOG_Q or R != 1 << LOG_R:
        raise ValueError("the sharded ReLU prover needs 2^k widths")
    n = X.shape[0]
    log_size = fr_ops.ceil_log2(n)
    zkrelu._begin_committed(challenges, aux_com, chain_point)
    u_z = challenges.random_vec(log_size + LOG_Q)
    v_z = challenges.random_vec(log_size + LOG_Q)
    u_r = challenges.random_vec(log_size + LOG_R)
    v_r = challenges.random_vec(log_size + LOG_R)
    u_rec = challenges.random_vec(log_size)  # == v_a in chained mode
    u_hp = challenges.random_vec(log_size)
    v_hp = challenges.random_vec(log_size)
    w_q = challenges.random_vec(LOG_Q) if aux_com is not None else None
    w_r = challenges.random_vec(LOG_R) if aux_com is not None else None

    blk = {k: shard(mesh, v) for k, v in aux.items()}  # this rank's element block of the compact aux
    X_l = shard(mesh, X)
    lr, _ = local_bits(X_l.shape[0], mesh.size("dp"), log_size)
    (mag_rev, rem_rev, X_rev, sign_rev, mag_mont_rev,
     mag_bits, rem_bits, Xp, sign) = zkrelu._layout_body(
        X_l, blk["mag"], blk["rem_bits16"], blk["sign_bits"], lr, Q, R)
    u_rec_h, u_hp_h = mp.host(u_rec), mp.host(u_hp)
    mag_at_u, rem_at_u, hp_claim, x_at_u = zkrelu._claims_body(
        mag_bits, rem_bits, Xp, sign, u_rec_h[:lr], u_hp_h[:lr])
    w_rec = _dev_eq_weight(u_rec_h[lr:], mesh, "dp")
    claims = collectives.psum_fr(torch.cat([
        _weighted(torch.cat([mag_at_u, rem_at_u, x_at_u[None]]), w_rec),
        _weighted(hp_claim, _dev_eq_weight(u_hp_h[lr:], mesh, "dp"))]), mesh, "dp")
    mag_at_u, rem_at_u, x_at_u, hp_claim = claims[:Q], claims[Q : Q + R], claims[Q + R], claims[Q + R + 1]

    mag_polys, mag_final = _sharded_pa_prove(mesh, (mag_rev,), u_z, v_z, _bin_rounds, lr + LOG_Q, "dp")
    rem_polys, rem_final = _sharded_pa_prove(mesh, (rem_rev,), u_r, v_r, _bin_rounds, lr + LOG_R, "dp")
    hp_polys, hp_finals = _sharded_pa_prove(mesh, (X_rev, sign_rev), u_hp, v_hp, _hp_rounds, lr, "dp")

    a_polys = a_finals = x_at_va = a_point = None
    if chain_point is not None:
        zkrelu._check_chain_point(chain_point, n, log_size)
        a_point = chain_point
        a_polys, a_finals = _sharded_pa_prove(mesh, (mag_mont_rev, sign_rev), chain_point, u_rec,
                                              _hp_rounds, lr, "dp")
        x_at_va = x_at_u
    proof = zkrelu.ZkReluProof(
        u_z, v_z, u_r, v_r, u_rec, u_hp, v_hp,
        mag_polys, mag_final[0], rem_polys, rem_final[0], hp_polys, hp_finals,
        mag_at_u.contiguous(), rem_at_u.contiguous(), hp_claim.contiguous(),
        a_point, a_polys, a_finals, x_at_va,
    )
    if aux_com is not None:
        _open_aux_sharded(mesh, proof, n, blk, aux_com, w_q, w_r)
    challenges.absorb_array(mag_polys)
    challenges.absorb_array(rem_polys)
    challenges.absorb_array(hp_polys)
    if a_polys is not None:
        challenges.absorb_array(a_polys)
    return proof


def _open_aux_sharded(mesh: Mesh, proof: zkrelu.ZkReluProof, n: int, blk: dict,
                      aux_com: zkrelu.AuxCommitments, w_q, w_r) -> None:
    """The committed tier's six revealed-fold openings (model.py:420-432),
    each row fold sharded over this rank's rows of the expanded bit tensor."""
    sign_m, mag_bin, rem_bin = zkrelu._expand_aux(blk["sign_bits"], blk["mag"], blk["rem_bits16"],
                                                  zkrelu.Q, zkrelu.R)

    def fold_open(t, size, point):
        gen_size = zkrelu._aux_gens(size, t.device).size
        point = mp.host(point)
        log_m = point.shape[0] - fr_ops.ceil_log2(gen_size)
        u_row = point[point.shape[0] - log_m :]
        folded = sharded_partial_me(mesh, t, u_row, gen_size) if log_m else collectives.all_gather(t, mesh, "dp")
        return pedersen.FoldOpening(t_folded=folded)

    u_rec = mp.host(proof.u_recover)
    proof.aux_coms = aux_com
    proof.w_q, proof.w_r = w_q, w_r
    Q, R = zkrelu.Q, zkrelu.R
    proof.open_mag_bin = fold_open(mag_bin, n * Q, proof.v_z_bin)
    proof.open_mag_rec = fold_open(mag_bin, n * Q, torch.cat([w_q, torch.from_numpy(u_rec)]))
    proof.open_rem_bin = fold_open(rem_bin, n * R, proof.v_r_bin)
    proof.open_rem_rec = fold_open(rem_bin, n * R, torch.cat([w_r, torch.from_numpy(u_rec)]))
    proof.open_sign_hp = fold_open(sign_m, n, proof.v_hp)
    proof.open_sign_rec = fold_open(sign_m, n, u_rec)


def commit_aux_sharded(mesh: Mesh, aux: dict, axis: str = "dp") -> zkrelu.AuxCommitments:
    """Row-sharded NUMS aux commitments (model.py:commit_aux_sharded): each
    bit tensor's rows split over the axis, each rank's row sums by K6's
    tree (pedersen.commit_bits' masked sums) and the points gathered; the
    rows' sums are independent, so the points equal the single-device
    zkrelu.commit_aux's limb for limb. A row count that does not split over
    the axis is committed whole on every rank (the JAX fallback to a
    replicated layout, model.py:336-364). aux: a ReLU's whole compact aux
    (zkrelu.forward_compact's)."""
    if zkrelu.Q != 1 << zkrelu.LOG_Q or zkrelu.R != 1 << zkrelu.LOG_R:
        raise ValueError("committed aux needs 2^k widths")
    n_dev = mesh.size(axis)

    def commit_one(bits):
        gens = zkrelu._aux_gens(bits.shape[0], bits.device)
        m = bits.shape[0] // gens.size
        if m % n_dev:
            return pedersen.commit_bits(gens, bits)
        local = shard(mesh, bits.reshape(m, gens.size), axis)
        pts = pedersen.commit_bits(gens, local.reshape(-1)).points
        whole = collectives.all_gather(torch.stack(list(pts), dim=1), mesh, axis)  # (m, 3, 12)
        return pedersen.RowCommitments(points=g1.G1Jac(*(whole[:, k].contiguous() for k in range(3))))

    bits = zkrelu._expand_aux_bits(aux["sign_bits"], aux["mag"], aux["rem_bits16"], zkrelu.Q, zkrelu.R)
    return zkrelu.AuxCommitments(*(commit_one(b) for b in bits))


def prove_sharded(model, X, Y_hat, Z_list, A_list, aux_list, mesh: Mesh,
                  challenges: ChallengeSource | None = None, chain: bool = False,
                  commit_aux: bool = False):
    """Distributed MLP.prove (model.py:prove_sharded): every layer's
    sumchecks dp-sharded over `mesh`, on every rank of it. X, Y_hat and the
    lists (MLP.infer's, aux compact) are whole tensors on every rank, which
    proves its own block. chain=False emits the unchained stream (equal to
    MLP.prove(chain=False), the JAX (n, 8) path's); chain=True
    the chained stream of the planar prover; commit_aux=True adds the
    committed-aux tier (row-sharded NUMS commitments, sharded revealed-fold
    openings). Every rank returns the same proof."""
    from ..models import mlp as mlp_mod

    if commit_aux and not chain:
        raise ValueError("committed aux requires chained mode")
    if challenges is None:
        challenges = FiatShamir()
    mlp_mod.absorb_statement(challenges, model.layers, X, Y_hat)
    n_layers = len(model.layers)
    fc_proofs: list = [None] * n_layers
    relu_proofs: list = [None] * (n_layers - 1)
    fc_proofs[n_layers - 1] = _fc_prove_sharded(
        mesh, model.layers[n_layers - 1], A_list[n_layers - 2] if n_layers >= 2 else X, Y_hat, challenges)
    for i in range(n_layers - 2, -1, -1):
        A_prev = A_list[i - 1] if i > 0 else X
        if chain:
            w = torch.cat([fc_proofs[i + 1].u_in, fc_proofs[i + 1].u_bs], dim=0)
            aux_com = commit_aux_sharded(mesh, aux_list[i]) if commit_aux else None
            relu_proofs[i] = _relu_prove_sharded(mesh, Z_list[i], aux_list[i], challenges, w, aux_com=aux_com)
            fc_proofs[i] = _fc_prove_sharded(mesh, model.layers[i], A_prev, Z_list[i], challenges,
                                             z_point=relu_proofs[i].u_recover)
        else:
            relu_proofs[i] = _relu_prove_sharded(mesh, Z_list[i], aux_list[i], challenges)
            fc_proofs[i] = _fc_prove_sharded(mesh, model.layers[i], A_prev, Z_list[i], challenges)
    return mlp_mod.MLPProof(fc_proofs, relu_proofs)
