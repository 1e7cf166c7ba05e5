"""Typed runtime configuration (the port's copy of ``zkdl_tpu/config.py``).

One frozen dataclass, set per process through environment variables
(``ZKDL_<FIELD>``, parsed as the JAX package parses them) and read once:
each consumer reads ``get()`` where it is used, so a variable set before
the process starts reaches every entry point (demo, bench, profile_prove,
chip_smoke). The JAX package's ``configure(...)`` has no counterpart: the
values are fixed for the life of the process. The port keeps the knobs that
mean something in it:

- ``scale_bits``: the fixed-point scale 2^scale_bits, read when
  ``models/quantize.py`` is imported;
- ``relu_mag_bits``, ``relu_rem_bits``: the ReLU widths Q and R, read when
  ``models/zkrelu.py`` is imported;
- ``commit_aux``: the committed-aux tier, the default of ``MLP.prove``'s
  ``commit_aux`` (the demo's ``--commit-aux`` sets it for one run);
- ``fiat_shamir_label``: the label of every ``FiatShamir()`` transcript made
  without one (``sumcheck/transcript.py``).

The JAX package's other knobs have no counterpart here:
``use_planar_prover`` (the port has only the planar prover; its unchained
stream is the (n, 8) reference path's, which ``parallel/model.py`` is held
against), ``planar_tail_n`` (the JAX scan tails are XLA compile
workarounds; the port's rounds run down to size 1), ``pallas_block_rows``
(the Pallas block shape; the CUDA kernels size their own grids),
``dot_chunk`` (the JAX lazy dot reduces every 2^13 terms; K3 accumulates up
to 2^32 terms in one launch) and ``mesh_dp``/``mesh_tp``
(``parallel/multihost.py:global_mesh`` takes the mesh as its arguments, dp
0 meaning the world size over tp).
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Config:
    # quantization (zkfc.cu:65; zkrelu.cu:74-77)
    scale_bits: int = 16  # fixed-point scale 2^16
    relu_mag_bits: int = 32  # Q: rescaled-magnitude width
    relu_rem_bits: int = 16  # R: remainder width (15 magnitude + sign)

    # committed-aux soundness tier (aux bit commitments and their openings)
    commit_aux: bool = False

    # transcript
    fiat_shamir_label: bytes = b"zkdl-tpu-v1"

    @classmethod
    def from_env(cls) -> "Config":
        kwargs = {}
        for f in dataclasses.fields(cls):
            env = os.environ.get("ZKDL_" + f.name.upper())
            if env is None:
                continue
            if f.type in ("int", int):
                kwargs[f.name] = int(env)
            elif f.type in ("bool", bool):
                kwargs[f.name] = env.lower() not in ("0", "false", "")
            elif f.type in ("bytes", bytes):
                kwargs[f.name] = env.encode()
            else:
                kwargs[f.name] = env
        return cls(**kwargs)


_CONFIG: Config | None = None


def get() -> Config:
    """The process's config, read from the environment at the first call."""
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = Config.from_env()
    return _CONFIG
