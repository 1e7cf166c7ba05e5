"""Proof serialization: the npz schema of ``zkdl_tpu/io/proof_io.py`` (:30-125),
for the MLP's proofs and the attention block's (with the softmax, lookup,
rescale and committed-witness classes inside it); and the MLP's
layer-by-layer checkpointed proving (:124-259: ``ProofCheckpoint``,
``prove_mlp_checkpointed``, ``_replay_fc``, ``_replay_relu``).

``dump_proof`` writes a proof tree (dataclasses, NamedTuples, lists,
tensors) to one ``.npz``: every array under a key ``a{i}`` (the paths in
sorted order, e.g. ``p.fc_proofs[0].ip_polys``), the structure as a JSON
skeleton with the key map. Files written by either package load in the
other. ``load_proof`` resolves each class tag by its qualified name against
the port's own proof classes and never imports the tag's module, so a file
written by the JAX package imports nothing of it.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Any

import numpy as np
import torch

from .. import config
from ..commit.pedersen import FoldOpening, OpeningProof, RowCommitments
from ..commit.witness import Opening, WitnessSet
from ..curve.g1 import G1Jac
from ..models import mlp as mlp_mod, zkfc, zkrelu
from ..models.mlp import MLPProof
from ..models.zkattention import MatmulProof, ZkAttentionProof
from ..models.zkfc import ZkFCProof
from ..models.zkrelu import AuxCommitments, ZkReluProof
from ..models.zkrescale import RescaleBinding
from ..models.zksoftmax import RangeProof, RowSumProof, ZeroProductProof, ZkSoftmaxProof
from ..sumcheck.lookup import LookupProof
from ..utils.runtime import resolve_device

_CLASSES = {c.__qualname__: c for c in (
    MLPProof, ZkFCProof, ZkReluProof, OpeningProof, G1Jac, AuxCommitments, RowCommitments, FoldOpening,
    ZkAttentionProof, MatmulProof, RescaleBinding, ZkSoftmaxProof, RangeProof, RowSumProof, ZeroProductProof,
    LookupProof, WitnessSet, Opening)}
_PACKAGES = ("zkdl_tpu", "zkdl_tpu_torch")


def flatten(obj: Any, path: str, arrays: dict):
    """Proof tree (dataclasses, NamedTuples, lists, tensors) -> {path: numpy
    array} in `arrays`, with the JAX package's paths, e.g.
    ``p.fc_proofs[0].ip_polys``; returns the tree's skeleton node."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = {f.name: flatten(getattr(obj, f.name), f"{path}.{f.name}", arrays)
                  for f in dataclasses.fields(obj)}
        return {"__dc__": type(obj).__module__ + ":" + type(obj).__qualname__, "fields": fields}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        fields = {name: flatten(getattr(obj, name), f"{path}.{name}", arrays) for name in obj._fields}
        return {"__nt__": type(obj).__module__ + ":" + type(obj).__qualname__, "fields": fields}
    if isinstance(obj, (list, tuple)):
        items = [flatten(x, f"{path}[{i}]", arrays) for i, x in enumerate(obj)]
        return {"__seq__": "tuple" if isinstance(obj, tuple) else "list", "items": items}
    if isinstance(obj, dict):
        return {"__map__": {k: flatten(v, f"{path}.{k}", arrays) for k, v in obj.items()}}
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return {"__lit__": obj}
    arr = obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor) else np.asarray(obj)
    arrays[path] = arr
    return {"__arr__": path, "dtype": str(arr.dtype), "shape": list(arr.shape)}


def _resolve(tag: str) -> type:
    """A class tag 'module:Qualname' of either package -> the port's class."""
    module, _, qual = tag.partition(":")
    cls = _CLASSES.get(qual)
    if cls is None or module.split(".")[0] not in _PACKAGES:
        raise ValueError(f"unknown proof class {tag!r}")
    return cls


def _unflatten(node: Any, arrays: dict, device: torch.device):
    if "__dc__" in node or "__nt__" in node:
        cls = _resolve(node.get("__dc__") or node["__nt__"])
        kwargs = {k: _unflatten(v, arrays, device) for k, v in node["fields"].items()}
        return cls(**kwargs)  # fields a stale skeleton lacks take their defaults
    if "__seq__" in node:
        items = [_unflatten(x, arrays, device) for x in node["items"]]
        return tuple(items) if node["__seq__"] == "tuple" else items
    if "__map__" in node:
        return {k: _unflatten(v, arrays, device) for k, v in node["__map__"].items()}
    if "__lit__" in node:
        return node["__lit__"]
    return torch.from_numpy(arrays[node["__arr__"]]).to(device)


def serialize(proof: Any) -> bytes:
    """The npz bytes of a proof tree (what dump_proof writes)."""
    arrays: dict[str, np.ndarray] = {}
    skeleton = flatten(proof, "p", arrays)
    paths = sorted(arrays)
    keymap = {k: f"a{i}" for i, k in enumerate(paths)}
    buf = io.BytesIO()
    np.savez_compressed(buf, __skeleton__=np.frombuffer(
        json.dumps({"tree": skeleton, "keys": keymap}).encode(), dtype=np.uint8
    ), **{keymap[k]: arrays[k] for k in paths})
    return buf.getvalue()


def dump_proof(proof: Any, path: str) -> None:
    """Serialize a proof tree to `path` (.npz), atomically."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(serialize(proof))
    os.replace(tmp, path)


def load_proof(path, device="cuda") -> Any:
    """Load a proof tree written by either package's dump_proof (a path or
    a binary file object), its arrays on `device`."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__skeleton__"]).decode())
        arrays = {k: z[v] for k, v in meta["keys"].items()}
    return _unflatten(meta["tree"], arrays, dev)


# ---------------------------------------------------------------------------
# layer-granular checkpoint and resume of the MLP's proving loop
# ---------------------------------------------------------------------------


class ProofCheckpoint:
    """The backwards proving loop persisted layer by layer: one proof file
    a layer, ``{kind}_{idx:03d}.npz`` (kind "fc" or "relu") in the JAX
    package's format, so either package resumes from the other's files."""

    def __init__(self, directory):
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, kind: str, idx: int) -> str:
        return os.path.join(self.dir, f"{kind}_{idx:03d}.npz")

    def has(self, kind: str, idx: int) -> bool:
        return os.path.exists(self._path(kind, idx))

    def save(self, kind: str, idx: int, proof: Any) -> None:
        dump_proof(proof, self._path(kind, idx))

    def load(self, kind: str, idx: int, device="cuda") -> Any:
        return load_proof(self._path(kind, idx), device=device)


def prove_mlp_checkpointed(model, X, Y_hat, Z_list, A_list, aux_list, challenges, ckpt: ProofCheckpoint,
                           chain: bool = True, commit_aux: bool | None = None) -> MLPProof:
    """MLP.prove (grouped schedule) with a checkpoint file per layer proof:
    the same proof order and transcript, output layer first, then (relu_i,
    fc_i) backwards. A layer whose file exists is loaded instead of proved,
    and the transcript is brought to the state its proving left (the same
    draws, counted from the loaded proof's vectors, and absorbs), so the
    layers proved after it get an uninterrupted run's challenges; the chain
    points come from the loaded proofs. Works with any ChallengeSource whose
    draws follow from what it absorbed (FiatShamir, SeededRng).
    commit_aux defaults to the configuration's (ZKDL_COMMIT_AUX)."""
    if commit_aux is None:
        commit_aux = config.get().commit_aux
    if commit_aux and not chain:
        raise ValueError("committed aux requires chained mode")
    mlp_mod.absorb_statement(challenges, model.layers, X, Y_hat)
    dev = X.device
    n = len(model.layers)
    fc_proofs: list = [None] * n
    relu_proofs: list = [None] * (n - 1)

    def fc_step(i, Xi, Zi, z_point=None):
        if ckpt.has("fc", i):
            p = ckpt.load("fc", i, dev)
            _replay_fc(challenges, p, draw_all=z_point is None)
            return p
        p = zkfc.prove_planar(model.layers[i], Xi, Zi, challenges, z_point=z_point)
        ckpt.save("fc", i, p)
        return p

    def relu_step(i, chain_point=None):
        if ckpt.has("relu", i):
            p = ckpt.load("relu", i, dev)
            _replay_relu(challenges, p)
            return p
        aux_com = zkrelu.commit_aux(aux_list[i]) if commit_aux else None
        p = zkrelu.prove_planar(Z_list[i], aux_list[i], challenges, chain_point=chain_point, aux_com=aux_com)
        ckpt.save("relu", i, p)
        return p

    fc_proofs[n - 1] = fc_step(n - 1, A_list[n - 2] if n >= 2 else X, Y_hat)
    for i in range(n - 2, -1, -1):
        A_prev = A_list[i - 1] if i > 0 else X
        if chain:
            w = torch.cat([fc_proofs[i + 1].u_in.cpu(), fc_proofs[i + 1].u_bs.cpu()], dim=0)
            relu_proofs[i] = relu_step(i, chain_point=w)
            fc_proofs[i] = fc_step(i, A_prev, Z_list[i], z_point=relu_proofs[i].u_recover.cpu())
        else:
            relu_proofs[i] = relu_step(i)
            fc_proofs[i] = fc_step(i, A_prev, Z_list[i])
    return MLPProof(fc_proofs, relu_proofs)


def _replay_fc(challenges, p: ZkFCProof, draw_all: bool = True) -> None:
    """The transcript steps of proving this fc layer: its draws (a chained
    layer drew only u_in; its z point came from the ReLU below it) and its
    absorbs."""
    if draw_all:
        challenges.random_vec(p.u_bs.shape[0])
    challenges.random_vec(p.u_in.shape[0])
    if draw_all:
        challenges.random_vec(p.u_out.shape[0])
    challenges.absorb_array(p.ip_polys)
    challenges.absorb_array(p.z_claim)


def _replay_relu(challenges, p: ZkReluProof) -> None:
    """The transcript steps of proving this ReLU layer: the aux commitments
    (committed tier), the seven challenge vectors and w_q, w_r (committed),
    then the sumcheck messages."""
    if p.aux_coms is not None:
        zkrelu._absorb_aux_coms(challenges, p.aux_coms)
    for u in (p.u_z_bin, p.v_z_bin, p.u_r_bin, p.v_r_bin, p.u_recover, p.u_hp, p.v_hp):
        challenges.random_vec(u.shape[0])
    if p.aux_coms is not None:
        challenges.random_vec(p.w_q.shape[0])
        challenges.random_vec(p.w_r.shape[0])
    challenges.absorb_array(p.mag_polys)
    challenges.absorb_array(p.rem_polys)
    challenges.absorb_array(p.hp_polys)
    if p.a_polys is not None:
        challenges.absorb_array(p.a_polys)
