"""Proof serialization: the npz schema of ``zkdl_tpu/io/proof_io.py`` (:30-125),
for the MLP's proofs and the attention block's (with the softmax, lookup,
rescale and committed-witness classes inside it).

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

from ..commit.pedersen import FoldOpening, OpeningProof, RowCommitments
from ..commit.witness import Opening, WitnessSet
from ..curve.g1 import G1Jac
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
