"""Proof trees as flat arrays (counterpart of zkdl_tpu/io/proof_io.py's
``_flatten``; the dump/load of whole proofs is a later slice)."""

from __future__ import annotations

import dataclasses

import torch


def flatten(obj, path: str, out: dict) -> None:
    """Proof tree (dataclasses, NamedTuples, lists, tensors) -> {path: numpy
    array} in ``out``, with the JAX package's paths, e.g.
    ``p.fc_proofs[0].ip_polys``."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            flatten(getattr(obj, f.name), f"{path}.{f.name}", out)
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for name in obj._fields:
            flatten(getattr(obj, name), f"{path}.{name}", out)
    elif isinstance(obj, (list, tuple)):
        for i, x in enumerate(obj):
            flatten(x, f"{path}[{i}]", out)
    elif isinstance(obj, torch.Tensor):
        out[path] = obj.detach().cpu().numpy()
