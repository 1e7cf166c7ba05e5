"""Record SHA-256 digests of the JAX package's zkdl256 build, for the port's
check on the GPU (``chip_smoke.py`` phase 4), where JAX is not installed.

    JAX_PLATFORMS=cpu python tests/port/record_zkdl256_build.py

Builds bench.py's zkdl256 model on the CPU as bench.py does: its weights
(``np.random.default_rng(0)``, nn.Linear's init range),
``MLP.from_float_weights(weights, PRNGKey(0))`` and the input X drawn next
from the same generator; then ``Y_hat = model.infer(X)[0]``. Writes
``tests/port/fixtures/zkdl256_jax_build.json``: for each layer the digests
of the generator dlogs, the generator points, the row commitments' dlogs
(sigma) and their points (x, y, z limbs), and the digest of Y_hat. A digest
is SHA-256 of the C-order uint32 bytes of the array. Not a test: pytest
does not collect it.
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

from zkdl_tpu.field import fr  # noqa: E402
from zkdl_tpu.models import mlp, quantize, zkfc  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent / "fixtures" / "zkdl256_jax_build.json"
DIMS = [784, 1000, 1773, 1773, 1773, 1773, 1773, 1124, 1000]  # bench.py:42
BATCH = 256
COMMAND = "JAX_PLATFORMS=cpu python tests/port/record_zkdl256_build.py"


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a), dtype=np.uint32).tobytes()).hexdigest()


def point_digests(p) -> dict:
    return {c: digest(getattr(p, c)) for c in ("x", "y", "z")}


def main() -> None:
    t_start = time.perf_counter()
    rng = np.random.default_rng(0)  # bench.py:91, then the weights of bench.py:100-104
    weights = [
        rng.uniform(-1.0, 1.0, (DIMS[i], DIMS[i + 1])).astype(np.float32)
        / np.sqrt(DIMS[i]).astype(np.float32)
        for i in range(len(DIMS) - 1)
    ]
    keys = jax.random.split(jax.random.PRNGKey(0), len(weights))  # mlp.py:61
    layers, records = [], []
    for i, w in enumerate(weights):
        t0 = time.perf_counter()
        layer = zkfc.ZkFC.from_float(w, keys[i])
        layers.append(layer)
        records.append({
            "in_size": layer.in_size, "out_size": layer.out_size, "gen_size": layer.gens.size,
            "rows": int(layer.com.points.x.shape[0]),
            "gen_dlogs": digest(layer.gens.dlogs), "gen_points": point_digests(layer.gens.points),
            "sigma": digest(layer.com.dlogs), "com_points": point_digests(layer.com.points),
        })
        print(f"layer {i}: {time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
    model = mlp.MLP(layers)
    X_np = rng.standard_normal((BATCH, DIMS[0])).astype(np.float32)  # bench.py:113
    X = fr.mont(quantize.load_input(X_np))  # bench.py:114
    Y_hat = model.infer(X)[0]
    out = {
        "command": COMMAND,
        "jax_version": jax.__version__,
        "jax_threefry_partitionable": bool(jax.config.jax_threefry_partitionable),
        "prng_impl": str(jax.config.jax_default_prng_impl),
        "digest": "sha256 of the C-order uint32 bytes",
        "dims": DIMS, "batch": BATCH, "key": "PRNGKey(0), split into one key per layer",
        "seconds": round(time.perf_counter() - t_start, 1),
        "layers": records,
        "X": digest(X),
        "Y_hat": digest(Y_hat), "Y_hat_rows": int(Y_hat.shape[0]),
    }
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT} in {out['seconds']}s", file=sys.stderr)


if __name__ == "__main__":
    main()
