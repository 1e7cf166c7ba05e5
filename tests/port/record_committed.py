"""Record SHA-256 digests of the JAX package's NUMS generators, for the port's
check on the GPU (``chip_smoke.py``'s committed phase), where JAX is not
installed.

    JAX_PLATFORMS=cpu python tests/port/record_committed.py

Runs ``zkdl_tpu.commit.pedersen.nums_generators(4096)`` on the CPU (the
largest vector the committed-aux tier draws at zkdl256: mag_bin and rem_bin
of a 2^19-element ReLU) and writes
``tests/port/fixtures/nums_generators_jax.json``: the digests of its x, y
and z limbs, and those of every power-of-two prefix from 1 to 4096 (the
stream is prefix-stable: point i depends on i alone, so a smaller vector is
a prefix of this one). A digest is SHA-256 of the C-order uint32 bytes of
the array. Not a test: pytest does not collect it.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from zkdl_tpu.commit import pedersen  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent / "fixtures" / "nums_generators_jax.json"
SIZE = 4096
COMMAND = "JAX_PLATFORMS=cpu python tests/port/record_committed.py"


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a), dtype=np.uint32).tobytes()).hexdigest()


def main() -> None:
    t0 = time.perf_counter()
    pts = pedersen.nums_generators(SIZE).points
    coords = {c: np.asarray(getattr(pts, c)) for c in ("x", "y", "z")}
    prefixes = {}
    size = 1
    while size <= SIZE:
        prefixes[str(size)] = {c: digest(a[:size]) for c, a in coords.items()}
        size *= 2
    out = {
        "command": COMMAND,
        "jax_version": jax.__version__,
        "digest": "sha256 of the C-order uint32 bytes of each (size, 12) Montgomery Fp limb array",
        "size": SIZE,
        "points": prefixes[str(SIZE)],
        "prefixes": prefixes,
        "seconds": round(time.perf_counter() - t0, 1),
    }
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT} in {out['seconds']}s", file=sys.stderr)


if __name__ == "__main__":
    main()
