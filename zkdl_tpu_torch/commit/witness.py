"""Committed-witness binding for the attention and softmax circuits.

Counterpart of ``zkdl_tpu/commit/witness.py``: ``pow2_point``/``top_point``
(:56-79), ``Opening``, ``WitnessSet``, ``_gens_for`` (:110), ``Committer``
(:118-198), ``Checker`` and ``BindingError`` (:205-253). The prover commits
every witness tensor over NUMS generators (no dlogs: the commitments bind)
and absorbs the commitments before the first challenge; each forwarded
claim becomes a revealed-fold opening, which the verifier checks against the
commitment before the circuit equations read its value.

A bit tensor B (bit index on the low log_w variables) opened at
(w || u) with w_j = 2^(2^j) / (1 + 2^(2^j)) gives C * sum_k 2^k B_k(u),
C = prod_j 1/(1 + 2^(2^j)) (``pow2_point``); the all-ones point selects the
top bit row (``top_point``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..field import fr, host, mp
from ..tensor import fr_ops
from . import pedersen

HF = host.fr


@functools.lru_cache(maxsize=None)
def pow2_point(log_w: int) -> tuple[tuple[int, ...], int]:
    """((w_0..w_{log_w-1}) Montgomery ints, C Montgomery int): the eq
    weights at w over k in [0, 2^log_w) are exactly C * 2^k."""
    pts = []
    c = HF.one_mont
    for j in range(log_w):
        two_pow = HF.mont(1 << (1 << j))
        denom_inv = HF.inv(HF.add(HF.one_mont, two_pow))
        pts.append(HF.mul(two_pow, denom_inv))
        c = HF.mul(c, denom_inv)
    return tuple(pts), c


@functools.lru_cache(maxsize=None)
def top_point(log_w: int) -> tuple[int, ...]:
    """All-ones point: the eq weights select the top bit row."""
    return tuple(HF.one_mont for _ in range(log_w))


def _point_limbs(pts: tuple[int, ...]) -> np.ndarray:
    """Montgomery-representation ints -> their (r, 8) limbs, verbatim."""
    if not pts:
        return np.zeros((0, 8), dtype=np.uint32)
    return fr.from_ints(list(pts))


@dataclasses.dataclass
class Opening:
    name: str  # the committed tensor this opening is against
    point: torch.Tensor  # (r, 8) Montgomery, r == log2(padded size)
    proof: pedersen.FoldOpening


@dataclasses.dataclass
class WitnessSet:
    """The committed-witness payload carried inside a proof object."""

    coms: dict  # name -> pedersen.RowCommitments
    log_sizes: dict  # name -> log2 of the padded tensor size
    openings: dict  # label -> Opening


def _gens_for(log_n: int, device) -> pedersen.Generators:
    """The NUMS vector of a 2^log_n tensor: 2^ceil(log_n / 2) points."""
    return pedersen.nums_generators(1 << ((log_n + 1) // 2), device)


class Committer:
    """Prover-side builder: commit every witness tensor, absorb, then open
    one label per forwarded claim; ``witness_set()`` goes into the proof.
    The commitments of the tensors committed before ``absorb`` are computed
    there, all at once (pedersen.commit_many): each is the one
    pedersen.commit gives, and they are absorbed in insertion order."""

    def __init__(self):
        self._tensors: dict[str, torch.Tensor] = {}
        self._gens: dict[str, pedersen.Generators] = {}
        self.coms: dict[str, pedersen.RowCommitments] = {}
        self.log_sizes: dict[str, int] = {}
        self.openings: dict[str, Opening] = {}
        self._absorbed = False

    def commit(self, name: str, t: torch.Tensor) -> None:
        """Commit (n, 8) Montgomery t, zero-padded to a power of two."""
        if name in self.log_sizes:
            raise ValueError(f"duplicate witness {name}")
        if self._absorbed:
            raise ValueError("commit after absorb breaks the transcript")
        log_n = fr_ops.ceil_log2(t.shape[0])
        self._tensors[name] = fr_ops.pad_to(t, 1 << log_n)
        self.log_sizes[name] = log_n

    def absorb(self, challenges) -> None:
        """Compute every commitment, then absorb them (insertion order)
        before the first draw."""
        self._absorbed = True
        names = list(self.log_sizes)
        # the longest generator vector first: the others are its prefixes
        for name in sorted(names, key=lambda nm: -self.log_sizes[nm]):
            self._gens[name] = _gens_for(self.log_sizes[name], self._tensors[name].device)
        self.coms = dict(zip(names, pedersen.commit_many([(self._gens[n], self._tensors[n]) for n in names])))
        for name in names:
            pts = self.coms[name].points
            challenges.absorb_array(pts.x)
            challenges.absorb_array(pts.y)
            challenges.absorb_array(pts.z)

    def open(self, label: str, name: str, point) -> None:
        """Open `name` at `point` (host (log_n, 8) Montgomery), after absorb."""
        if label in self.openings:
            raise ValueError(f"duplicate opening {label}")
        if not self._absorbed:
            raise ValueError("open before absorb")
        point = torch.from_numpy(np.ascontiguousarray(mp.host(point)))
        if point.shape[0] != self.log_sizes[name]:
            raise ValueError(f"{label}: point {tuple(point.shape)} for a 2^{self.log_sizes[name]} tensor")
        proof = pedersen.open_reveal(self._gens[name], self._tensors[name], self.coms[name], point)
        self.openings[label] = Opening(name, point, proof)

    def open_recombined(self, label: str, name: str, u, log_w: int) -> None:
        """Open a bit tensor at (pow2_point || u)."""
        self.open(label, name, np.concatenate([_point_limbs(pow2_point(log_w)[0]), mp.host(u)]))

    def open_top_bit(self, label: str, name: str, u, log_w: int) -> None:
        """Open a bit tensor at (top_point || u)."""
        self.open(label, name, np.concatenate([_point_limbs(top_point(log_w)), mp.host(u)]))

    def witness_set(self) -> WitnessSet:
        return WitnessSet(dict(self.coms), dict(self.log_sizes), dict(self.openings))


class Checker:
    """Validates openings and exposes bound values. Every accessor raises
    BindingError on a bad opening, a label/tensor mismatch or a point
    mismatch, at the access where the JAX Checker raises. The group math of
    every opening runs once, batched (pedersen.verify_reveals), at the
    first access; each access then reads its opening's verdict."""

    def __init__(self, ws: WitnessSet):
        self.ws = ws
        self._verdicts: dict | None = None

    def _verify_all(self) -> dict:
        labels, checks = [], []
        for label, op in self.ws.openings.items():
            com = self.ws.coms.get(op.name)
            if com is None:
                continue
            log_gen = (op.point.shape[0] + 1) // 2
            gens = pedersen.nums_generators(1 << log_gen, com.points.x.device)
            labels.append(label)
            checks.append((op.proof, gens, com, fr.to_ints(mp.host(op.point).reshape(-1, 8)), None))
        return dict(zip(labels, pedersen.verify_reveals(checks) if checks else []))

    def value(self, label: str, name: str, point_ints: list[int]) -> int:
        """Bound MLE value of committed tensor `name` at `point_ints`
        (Montgomery ints, low variables first), proven by opening `label`.
        The generators come from the point's length alone."""
        op = self.ws.openings.get(label)
        if op is None:
            raise BindingError(f"missing opening {label}")
        if op.name != name:
            raise BindingError(f"{label}: opens {op.name}, expected {name}")
        if fr.to_ints(mp.host(op.point).reshape(-1, 8)) != list(point_ints):
            raise BindingError(f"{label}: opened at a different point")
        if self.ws.coms.get(name) is None:
            raise BindingError(f"{label}: no commitment for {name}")
        if self._verdicts is None:
            self._verdicts = self._verify_all()
        ok, msg = self._verdicts[label]
        if not ok:
            raise BindingError(f"{label}: binding: {msg}")
        log_gen = (len(point_ints) + 1) // 2
        u_in = torch.from_numpy(np.ascontiguousarray(mp.host(op.point)[:log_gen]))
        return fr.to_ints(mp.host(fr_ops.me_eval(op.proof.t_folded, u_in))[None])[0]

    def recombined(self, label: str, name: str, u_ints: list[int], log_w: int) -> int:
        """Bound recombined value sum_k 2^k B_k(u) of bit tensor `name`."""
        pts, c = pow2_point(log_w)
        raw = self.value(label, name, list(pts) + list(u_ints))
        return HF.mul(raw, HF.inv(c))

    def top_bit(self, label: str, name: str, u_ints: list[int], log_w: int) -> int:
        """Bound MLE value of the top bit row at u."""
        return self.value(label, name, list(top_point(log_w)) + list(u_ints))

    def require(self, label: str, name: str, point_ints: list[int], expected: int, what: str) -> None:
        """Check a forwarded claim equals the bound opening value."""
        if self.value(label, name, point_ints) != expected:
            raise BindingError(f"{what}: claim != committed opening")


class BindingError(Exception):
    pass
