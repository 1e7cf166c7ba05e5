"""logUp lookup argument over Fr.

Counterpart of ``zkdl_tpu/sumcheck/lookup.py``: ``batch_inverse`` (:55),
``LookupProof``, ``_lookup_core`` (:112), ``multiplicities`` (:138),
``prove`` (:148), ``verify`` (:186), ``_host_me_eval`` (:256) and
``range_table`` (:271). To show every witness element a_i lies in a table
{t_j}, the prover proves sum_i 1/(a_i + z) == sum_j m_j/(t_j + z) at a
challenge z drawn after m is absorbed: two inner-product sumchecks reduce
the sums, two Hadamard sumchecks bind the inverse vectors to a + z and
t + z.

The inverse vectors come from ``kernels.batch_inverse_many``, both sides in
one call: kernel K7 (``csrc/fr_inverse.cu``) on CUDA tensors, its plain
version on CPU ones.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..field import host, kernels, mp
from ..tensor import fr_ops
from . import protocols as sc
from .transcript import ChallengeSource

HF = host.fr

batch_inverse = kernels.batch_inverse


@dataclasses.dataclass
class LookupProof:
    z: torch.Tensor  # (8,) challenge
    m: torch.Tensor  # (T, 8) multiplicities (Montgomery)
    sum_w: torch.Tensor  # (8,) sum of 1/(a+z)
    sum_v: torch.Tensor  # (8,) sum of m/(t+z)
    u_w_ip: torch.Tensor
    w_ip_polys: torch.Tensor
    w_ip_finals: torch.Tensor  # (2, 8): w(u), ones(u) = 1
    u_v_ip: torch.Tensor
    v_ip_polys: torch.Tensor
    v_ip_finals: torch.Tensor
    u_w: torch.Tensor
    v_w: torch.Tensor
    w_hp_polys: torch.Tensor
    w_hp_finals: torch.Tensor  # (2, 8): w(v_w), (a+z)(v_w)
    u_t: torch.Tensor
    v_t: torch.Tensor
    t_hp_polys: torch.Tensor
    t_hp_finals: torch.Tensor
    m_at_ut: torch.Tensor  # (8,) claimed m MLE at u_t (the verifier recomputes it)
    a_at_vw: torch.Tensor  # (8,) claimed a MLE at v_w (bound by the caller)
    t_at_vt: torch.Tensor  # (8,) claimed t MLE at v_t


def _lookup_core(a, t, m, z, u_w_ip, u_v_ip, u_w, v_w, u_t, v_t):
    dev = a.device
    az = fr_ops.add(a, fr_ops.const(z, 1, dev))
    tz = fr_ops.add(t, fr_ops.const(z, 1, dev))
    w, tz_inv = kernels.batch_inverse_many([az, tz])  # one K7 call, each side its own zero rule
    v = fr_ops.mul(m, tz_inv)
    sum_w, sum_v = fr_ops.fr_sum(w), fr_ops.fr_sum(v)
    w_ip_polys, w_ip_finals = sc.inner_product_prove(w, fr_ops.ones_mont(a.shape[0], dev), u_w_ip)
    v_ip_polys, v_ip_finals = sc.inner_product_prove(v, fr_ops.ones_mont(t.shape[0], dev), u_v_ip)
    w_hp_polys, w_hp_finals = sc.hadamard_prove(w, az, u_w, v_w)
    t_hp_polys, t_hp_finals = sc.hadamard_prove(v, tz, u_t, v_t)
    return (sum_w, sum_v, w_ip_polys, w_ip_finals, v_ip_polys, v_ip_finals,
            w_hp_polys, w_hp_finals, t_hp_polys, t_hp_finals,
            fr_ops.me_eval(m, u_t), fr_ops.me_eval(a, v_w), fr_ops.me_eval(t, v_t))


def multiplicities(a_vals: np.ndarray, table_size: int, device) -> torch.Tensor:
    """Multiplicity tensor ((T, 8) Montgomery) for a range table t_j = j,
    from unsigned witness values (numpy)."""
    counts = np.bincount(np.asarray(a_vals).reshape(-1).astype(np.int64), minlength=table_size)
    raw = np.zeros((table_size, 8), dtype=np.uint32)
    raw[:, 0] = (counts & 0xFFFFFFFF).astype(np.uint32)
    raw[:, 1] = (counts >> 32).astype(np.uint32)
    return fr_ops.to_mont(torch.from_numpy(raw).to(device))


def prove(a: torch.Tensor, t: torch.Tensor, m: torch.Tensor, challenges: ChallengeSource) -> LookupProof:
    """a: (n, 8) witness, t: (T, 8) table, m: (T, 8) multiplicities, all
    Montgomery, n and T powers of two. Draw order: z, u_w_ip, u_v_ip, u_w,
    v_w, u_t, v_t (after absorbing m)."""
    challenges.absorb_array(m)
    z = challenges.random_vec(1)[0]
    n_log = fr_ops.ceil_log2(a.shape[0])
    t_log = fr_ops.ceil_log2(t.shape[0])
    u_w_ip = challenges.random_vec(n_log)
    u_v_ip = challenges.random_vec(t_log)
    u_w = challenges.random_vec(n_log)
    v_w = challenges.random_vec(n_log)
    u_t = challenges.random_vec(t_log)
    v_t = challenges.random_vec(t_log)
    (sum_w, sum_v, w_ip_polys, w_ip_finals, v_ip_polys, v_ip_finals,
     w_hp_polys, w_hp_finals, t_hp_polys, t_hp_finals,
     m_at_ut, a_at_vw, t_at_vt) = _lookup_core(a, t, m, mp.host(z), u_w_ip, u_v_ip, u_w, v_w, u_t, v_t)
    proof = LookupProof(
        z, m, sum_w, sum_v,
        u_w_ip, w_ip_polys, w_ip_finals,
        u_v_ip, v_ip_polys, v_ip_finals,
        u_w, v_w, w_hp_polys, w_hp_finals,
        u_t, v_t, t_hp_polys, t_hp_finals,
        m_at_ut, a_at_vw, t_at_vt,
    )
    for arr in (sum_w, sum_v, w_ip_polys, v_ip_polys, w_hp_polys, t_hp_polys):
        challenges.absorb_array(arr)
    return proof


def verify(proof: LookupProof, table_vals: list[int] | None = None) -> tuple[bool, str]:
    """Verify the lookup proof (lookup.py:verify), with its reasons.
    table_vals: the raw table values, when given t's claim at v_t is
    recomputed from them; binding a_at_vw is the caller's."""
    ints = sc.scalars_to_ints
    sum_w = ints(proof.sum_w)[0]
    sum_v = ints(proof.sum_v)[0]
    if sum_w != sum_v:
        return False, "grand sums differ"
    res = sc.inner_product_verify(sc.polys_to_ints(proof.w_ip_polys), ints(proof.u_w_ip), sum_w)
    if not res.ok:
        return False, "w ip: " + res.reason
    fa, fb = ints(proof.w_ip_finals)
    if fb != HF.one_mont or not sc.inner_product_check_final(res, fa, fb):
        return False, "w ip: final mismatch"
    res = sc.inner_product_verify(sc.polys_to_ints(proof.v_ip_polys), ints(proof.u_v_ip), sum_v)
    if not res.ok:
        return False, "v ip: " + res.reason
    fa, fb = ints(proof.v_ip_finals)
    if fb != HF.one_mont or not sc.inner_product_check_final(res, fa, fb):
        return False, "v ip: final mismatch"

    z = ints(proof.z)[0]
    res = sc.hadamard_verify(sc.polys_to_ints(proof.w_hp_polys), ints(proof.u_w), ints(proof.v_w),
                             HF.one_mont, *ints(proof.w_hp_finals))
    if not res.ok:
        return False, "w hp: " + res.reason
    _, faz = ints(proof.w_hp_finals)
    if faz != HF.add(ints(proof.a_at_vw)[0], z):
        return False, "w hp: (a+z) final != a(v_w)+z"

    u_t = ints(proof.u_t)
    m_at = _host_me_eval(ints(proof.m), u_t)
    if m_at != ints(proof.m_at_ut)[0]:
        return False, "m MLE claim mismatch"
    res = sc.hadamard_verify(sc.polys_to_ints(proof.t_hp_polys), u_t, ints(proof.v_t), m_at,
                             *ints(proof.t_hp_finals))
    if not res.ok:
        return False, "t hp: " + res.reason
    _, ftz = ints(proof.t_hp_finals)
    t_vt = ints(proof.t_at_vt)[0]
    if ftz != HF.add(t_vt, z):
        return False, "t hp: (t+z) final != t(v_t)+z"
    if table_vals is not None:
        if _host_me_eval([HF.mont(int(x)) for x in table_vals], ints(proof.v_t)) != t_vt:
            return False, "t MLE != public table"
    return True, ""


def _host_me_eval(vals_mont: list[int], u_mont: list[int]) -> int:
    """Host MLE evaluation (Montgomery ints), lowest variable first."""
    cur = list(vals_mont)
    for uk in u_mont:
        if len(cur) % 2:
            cur.append(0)
        cur = [HF.add(cur[2 * i], HF.mul(uk, HF.sub(cur[2 * i + 1], cur[2 * i]))) for i in range(len(cur) // 2)]
    return cur[0]


def range_table(bits: int, device) -> torch.Tensor:
    """The table [0, 2^bits) as (2^bits, 8) Montgomery Fr."""
    return fr_ops.mont_from_u64(np.arange(1 << bits, dtype=np.uint64), device)
