"""Quantized MLP: build, inference, the backwards proving loop, verification.

Counterpart of ``zkdl_tpu/models/mlp.py``: ``absorb_statement`` (:38-49),
``MLP.from_float_weights``/``infer``/``prove`` (:57-163, planar path,
chained by default, grouped or round-interleaved Fiat-Shamir, optionally
the committed-aux tier), ``MLP.verify`` with its Fiat-Shamir replay of
either schedule (:165-355), ``MLPProof`` and ``prove_timed`` (:378-388).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from .. import config
from ..field import mp
from ..sumcheck import protocols as sc
from ..sumcheck.transcript import ChallengeSource, FiatShamir
from ..tensor import fr_ops
from ..utils import prng
from ..utils.runtime import resolve_device
from . import zkfc, zkrelu


def absorb_statement(challenges: ChallengeSource, layers, X, Y_hat) -> None:
    """Bind the Fiat-Shamir transcript to the public statement before any
    challenge is drawn: every layer's row commitments (x, y, z), the public
    input X and the claimed output Y_hat, in the JAX package's byte layout."""
    for layer in layers:
        challenges.absorb_array(layer.com.points.x)
        challenges.absorb_array(layer.com.points.y)
        challenges.absorb_array(layer.com.points.z)
    challenges.absorb_array(X)
    challenges.absorb_array(Y_hat)


def _cat_host(*vecs) -> np.ndarray:
    """Host concatenation of challenge vectors (CPU or card tensors)."""
    return np.concatenate([mp.host(v).reshape(-1, 8) for v in vecs], axis=0)


def _same(a, b) -> bool:
    """Host equality of two stored challenge vectors (None never matches)."""
    return a is not None and b is not None and np.array_equal(mp.host(a), mp.host(b))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class MLP:
    layers: list[zkfc.ZkFC]

    @classmethod
    def from_float_weights(cls, weights: Sequence[np.ndarray], key: np.ndarray,
                           device="cuda") -> "MLP":
        """weights: float (in, out) matrices; key: a prng key (as
        ``prng.PRNGKey`` gives), split into one key per layer for its
        generators, as the JAX package splits a jax.random key. Sizes must
        chain."""
        dev = resolve_device(device)
        layers = []
        keys = prng.split(key, len(weights))
        for i, w in enumerate(weights):
            layers.append(zkfc.ZkFC.from_float(w, keys[i], dev))
            if i > 0 and layers[i - 1].out_size != layers[i].in_size:
                raise ValueError("Incompatible layer sizes")
        return cls(layers)

    @property
    def n_params(self) -> int:
        return sum(l.weights.shape[0] for l in self.layers)

    def infer(self, X: torch.Tensor):
        """X: (batch*in, 8) Montgomery. Returns (Y_hat, Z_list, A_list, aux_list)."""
        Z_list, A_list, aux_list = [], [], []
        A = X
        for layer in self.layers[:-1]:
            Z = layer(A)
            A, aux = zkrelu.forward_compact(Z)
            Z_list.append(Z)
            A_list.append(A)
            aux_list.append(aux)
        return self.layers[-1](A), Z_list, A_list, aux_list

    def prove(self, X, Y_hat, Z_list, A_list, aux_list, challenges: ChallengeSource | None = None,
              chain: bool = True, on_layer: Callable[[str, int], None] | None = None,
              interleave: bool = False, commit_aux: bool | None = None) -> "MLPProof":
        """Backwards proving loop: output FC first, then (relu_i, fc_i) down to
        layer 0. chain=True links every FC's output claim to the adjacent
        ReLU's sumchecks (GKR-style); chain=False gives independent per-layer
        proofs. on_layer(kind, i) is called after each layer proof (kind
        "fc" or "relu"), e.g. to time the layers.

        interleave=True uses the round-interleaved Fiat-Shamir schedule: each
        sumcheck round polynomial is absorbed before its fold challenge is
        drawn (one host round trip per round). Verify with
        MLP.verify(transcript=..., interleaved=True).

        commit_aux=True (default: config's commit_aux, ZKDL_COMMIT_AUX) also
        commits every ReLU's auxiliary bit tensors (sign, mag_bin, rem_bin)
        over NUMS generators before that layer's draws, and opens them at
        every point where the proof claims their evaluations (the committed-
        aux tier; chained proofs only)."""
        if commit_aux is None:
            commit_aux = config.get().commit_aux
        if commit_aux and not chain:
            raise ValueError("committed aux requires chained mode")
        if challenges is None:
            challenges = FiatShamir()
        absorb_statement(challenges, self.layers, X, Y_hat)
        n = len(self.layers)
        fc_proofs: list = [None] * n
        relu_proofs: list = [None] * (n - 1)
        fc_proofs[n - 1] = zkfc.prove_planar(self.layers[n - 1], A_list[n - 2] if n >= 2 else X,
                                             Y_hat, challenges, interleave=interleave)
        if on_layer:
            on_layer("fc", n - 1)
        for i in range(n - 2, -1, -1):
            A_prev = A_list[i - 1] if i > 0 else X
            if chain:
                w = torch.cat([fc_proofs[i + 1].u_in, fc_proofs[i + 1].u_bs], dim=0)
                aux_com = zkrelu.commit_aux(aux_list[i]) if commit_aux else None
                relu_proofs[i] = zkrelu.prove_planar(Z_list[i], aux_list[i], challenges, chain_point=w,
                                                     aux_com=aux_com, interleave=interleave)
                if on_layer:
                    on_layer("relu", i)
                fc_proofs[i] = zkfc.prove_planar(self.layers[i], A_prev, Z_list[i], challenges,
                                                 z_point=relu_proofs[i].u_recover, interleave=interleave)
            else:
                relu_proofs[i] = zkrelu.prove_planar(Z_list[i], aux_list[i], challenges, interleave=interleave)
                if on_layer:
                    on_layer("relu", i)
                fc_proofs[i] = zkfc.prove_planar(self.layers[i], A_prev, Z_list[i], challenges,
                                                 interleave=interleave)
            if on_layer:
                on_layer("fc", i)
        return MLPProof(fc_proofs, relu_proofs)

    def verify(self, proof: "MLPProof", X=None, Y_hat=None, transcript: ChallengeSource | None = None,
               interleaved: bool = False) -> tuple[bool, str]:
        """Verify every layer proof and, for chained proofs, the cross-layer
        claim chain; returns (ok, reason) with the JAX verifier's reasons.

        Y_hat's MLE anchors fc[n-1]'s z-claim (public output); each
        fc[i+1]'s X-side final is the initial claim of relu[i]'s
        A = sign (.) mag sumcheck; relu[i]'s X(v_a) is fc[i]'s z-claim at
        the shared point; fc[0]'s X-side final is checked against the public
        input X's MLE. The two anchors evaluate MLEs on X's and Y_hat's
        device (K2 on the card).

        transcript: a FRESH ChallengeSource of the prover's mode (e.g.
        FiatShamir()). The verifier then re-derives every challenge
        (statement absorption, every draw, every absorbed message) and
        rejects a proof whose stored challenges differ. Without it the
        evaluation points are taken from the proof on trust. interleaved=True
        replays the round-interleaved schedule (MLP.prove(interleave=True)).

        The checks are the JAX package's, with committed-aux ReLU proofs
        (aux_coms set) checked by zkrelu.verify_committed where the JAX
        verifier checks them, after the layer's sumchecks; the binding of
        each FC opening to its layer's row commitments (a G1 fold over every
        row) runs after every other check, so a tampered proof is rejected
        before it. A proof with one fault gets the JAX verifier's reason."""
        n = len(self.layers)
        if transcript is not None:
            if X is None or Y_hat is None:
                return False, "transcript replay requires the public X and Y_hat"
            ok, msg = self._verify_transcript(proof, X, Y_hat, transcript, interleaved)
            if not ok:
                return False, f"transcript: {msg}"
        for i in range(n):
            ok, msg = zkfc.verify_claims(proof.fc_proofs[i])
            if not ok:
                return False, f"fc[{i}]: {msg}"
        for i in range(n - 1):
            ok, msg = zkrelu.verify(proof.relu_proofs[i])
            if not ok:
                return False, f"relu[{i}]: {msg}"
            if proof.relu_proofs[i].aux_coms is not None:
                ok, msg = zkrelu.verify_committed(proof.relu_proofs[i])
                if not ok:
                    return False, f"relu[{i}] committed-aux: {msg}"
        chained = n >= 2 and proof.relu_proofs[0].a_polys is not None
        # The output anchor needs only the top FC's z-claim (chained or not);
        # the input anchor rides the claim chain, so an unchained proof with
        # X is rejected rather than left unanchored.
        if Y_hat is not None:
            top = proof.fc_proofs[n - 1]
            pt = _cat_host(top.u_out, top.u_bs)
            y_eval = fr_ops.me_eval(fr_ops.pad_to(Y_hat, 1 << pt.shape[0]), pt)
            if sc.scalars_to_ints(y_eval) != sc.scalars_to_ints(top.z_claim):
                return False, "fc[-1]: output claim != Y_hat MLE (public anchor)"
        if X is not None and n >= 2 and not chained:
            return False, "input anchor requires a chained proof"
        if chained:
            for i in range(n - 2, -1, -1):
                rp, nxt, fcp = proof.relu_proofs[i], proof.fc_proofs[i + 1], proof.fc_proofs[i]
                if not _same(rp.a_point, _cat_host(nxt.u_in, nxt.u_bs)):
                    return False, f"relu[{i}]: chain point != fc[{i+1}]'s X point"
                ok, msg = zkrelu.verify_chained(rp, sc.scalars_to_ints(nxt.ip_finals)[0])
                if not ok:
                    return False, f"relu[{i}]: {msg}"
                if not _same(_cat_host(fcp.u_out, fcp.u_bs), rp.u_recover):
                    return False, f"fc[{i}]: z point not chained to relu[{i}].v_a"
                if sc.scalars_to_ints(fcp.z_claim) != sc.scalars_to_ints(rp.x_at_va):
                    return False, f"fc[{i}]: z claim != relu[{i}].X(v_a)"
            if X is not None:
                bot = proof.fc_proofs[0]
                pt = _cat_host(bot.u_in, bot.u_bs)
                x_eval = fr_ops.me_eval(fr_ops.pad_to(X, 1 << pt.shape[0]), pt)
                if sc.scalars_to_ints(x_eval) != [sc.scalars_to_ints(bot.ip_finals)[0]]:
                    return False, "fc[0]: input claim != X MLE (public anchor)"
        for i in range(n):
            ok, msg = zkfc.verify_binding(self.layers[i].com, proof.fc_proofs[i])
            if not ok:
                return False, f"fc[{i}]: {msg}"
        return True, ""

    def _verify_transcript(self, proof: "MLPProof", X, Y_hat, transcript: ChallengeSource,
                           interleaved: bool = False) -> tuple[bool, str]:
        """Re-derive the challenge stream of prove() and compare it with the
        proof's stored vectors: the statement, then the output layer's
        draws, then per layer (backwards) the ReLU's and the FC's, absorbing
        each proof's messages where the prover did. In chained mode
        fc[i<n-1] draws only u_in (its z-point is relu[i]'s u_recover;
        verify checks that equality).

        interleaved=True replays the round-interleaved schedule: every fold
        challenge is re-derived after absorbing its round's polynomial, so a
        prover that chose a round polynomial after seeing its fold challenge
        is caught. A committed-aux layer's commitments are absorbed first and
        its w_q, w_r re-derived after v_hp, in both schedules."""

        def draw_eq(stored) -> bool:
            got = transcript.random_vec(stored.shape[0])
            return np.array_equal(got.numpy(), mp.host(stored))

        def rounds_eq(polys, stored) -> bool:
            """Interleaved replay: absorb poly i, re-derive fold challenge i."""
            sp = mp.host(stored)
            for i in range(sp.shape[0]):
                transcript.absorb_array(polys[i])
                if not np.array_equal(transcript.random_vec(1).numpy()[0], sp[i]):
                    return False
            return True

        absorb_statement(transcript, self.layers, X, Y_hat)
        n = len(self.layers)
        chained = n >= 2 and proof.relu_proofs[0].a_polys is not None

        def fc_replay_interleaved(i: int, draw_all: bool) -> str | None:
            p = proof.fc_proofs[i]
            if draw_all:
                for name, stored in (("u_bs", p.u_bs), ("u_out", p.u_out)):
                    if not draw_eq(stored):
                        return f"fc[{i}].{name} not derived from the transcript"
            transcript.absorb_array(p.z_claim)
            if not rounds_eq(p.ip_polys, p.u_in):
                return f"fc[{i}].u_in not derived round-interleaved"
            return None

        def relu_replay_interleaved(i: int) -> str | None:
            p = proof.relu_proofs[i]
            steps = [("u_z_bin", None), ("v_z_bin", p.mag_polys), ("u_r_bin", None), ("v_r_bin", p.rem_polys),
                     ("u_recover", p.a_polys), ("u_hp", None)]
            for name, polys in steps:
                stored = getattr(p, name)
                if polys is None and not draw_eq(stored):
                    return f"relu[{i}].{name} not derived from the transcript"
                if polys is not None and not rounds_eq(polys, stored):
                    return f"relu[{i}].{name} not derived round-interleaved"
            transcript.absorb_array(p.mag_bits_at_u)
            transcript.absorb_array(p.rem_bits_at_u)
            transcript.absorb_array(p.hp_claim)
            if p.x_at_va is None:
                return f"relu[{i}]: interleaved proof missing x_at_va"
            transcript.absorb_array(p.x_at_va)
            if not rounds_eq(p.hp_polys, p.v_hp):
                return f"relu[{i}].v_hp not derived round-interleaved"
            return committed_draws(p, i)

        def fc_replay(i: int, draw_all: bool) -> str | None:
            p = proof.fc_proofs[i]
            vecs = [("u_bs", p.u_bs), ("u_in", p.u_in), ("u_out", p.u_out)] if draw_all else [("u_in", p.u_in)]
            for name, stored in vecs:
                if not draw_eq(stored):
                    return f"fc[{i}].{name} not derived from the transcript"
            transcript.absorb_array(p.ip_polys)
            transcript.absorb_array(p.z_claim)
            return None

        def committed_draws(p, i: int) -> str | None:
            if p.aux_coms is not None:
                for name, stored in (("w_q", p.w_q), ("w_r", p.w_r)):
                    if not draw_eq(stored):
                        return f"relu[{i}].{name} not derived from the transcript"
            return None

        def relu_replay(i: int) -> str | None:
            p = proof.relu_proofs[i]
            vecs = [("u_z_bin", p.u_z_bin), ("v_z_bin", p.v_z_bin), ("u_r_bin", p.u_r_bin),
                    ("v_r_bin", p.v_r_bin), ("u_recover", p.u_recover), ("u_hp", p.u_hp), ("v_hp", p.v_hp)]
            for name, stored in vecs:
                if not draw_eq(stored):
                    return f"relu[{i}].{name} not derived from the transcript"
            err = committed_draws(p, i)
            if err:
                return err
            transcript.absorb_array(p.mag_polys)
            transcript.absorb_array(p.rem_polys)
            transcript.absorb_array(p.hp_polys)
            if p.a_polys is not None:
                transcript.absorb_array(p.a_polys)
            return None

        if interleaved:
            fc_replay, relu_replay = fc_replay_interleaved, relu_replay_interleaved
        err = fc_replay(n - 1, draw_all=True)
        if err:
            return False, err
        for i in range(n - 2, -1, -1):
            if proof.relu_proofs[i].aux_coms is not None:
                zkrelu._absorb_aux_coms(transcript, proof.relu_proofs[i].aux_coms)
            err = relu_replay(i) or fc_replay(i, draw_all=not chained)
            if err:
                return False, err
        return True, ""


@dataclasses.dataclass
class MLPProof:
    fc_proofs: list
    relu_proofs: list


def prove_timed(model: MLP, X, batch_size: int, challenges=None, **prove_kwargs):
    """Inference (untimed), then the timed proving loop, ended by a device
    synchronize. Returns (proof, seconds_per_data_point)."""
    dev = X.device
    Y_hat, Z_list, A_list, aux_list = model.infer(X)
    _sync(dev)
    t0 = time.perf_counter()
    proof = model.prove(X, Y_hat, Z_list, A_list, aux_list, challenges, **prove_kwargs)
    _sync(dev)
    return proof, (time.perf_counter() - t0) / batch_size
