"""Record the JAX package's side of the port's GLV, blinded-tier and conv tests
(``tests/port/test_torch_glv.py``, ``test_torch_blinded.py``,
``test_torch_conv.py``), which run no JAX compile.

    JAX_PLATFORMS=cpu python tests/port/record_slice11.py

Runs on the CPU and writes ``tests/port/fixtures/slice11_jax.npz`` and
``slice11_jax.json``:

- ``glv/*``: ``g1.glv_decompose``, ``endomorphism``, ``_window_digits`` and
  ``scalar_mul_glv`` on ``slice11_inputs.glv_inputs()`` (edge scalars on
  edge points, random scalars below r, and the blinded tests' H^b rows);
- ``blind/*``: ``tests/test_blinded.py``'s setup (gens from PRNGKey(3) of
  size 4, 16 Montgomery values from PRNGKey(4)): the blinding point, the
  blinded commitments under keys 10 and 11 (the CPU branch: H^b by
  double-and-add), the plain commitment, the opening at u from PRNGKey(5)
  and its blinder fold;
- ``conv_fwd_<pad>_<stride>/Z``: ``tests/test_conv.py``'s three forwards;
  ``conv_prove/*``: its prove case's commitments, Z and proof (flattened as
  ``proof_io.dump_proof`` flattens it);

The JAX package's ``pedersen.blinding_point`` (:483-501) never returns: its
try-and-increment loop never increments its counter, and the counter-0
candidate is not on the curve. This script runs the JAX blinded tier with
that one function replaced by ``terminating_blinding_point``, the same code
with the counter incremented (the port's ``blinding_point``); nothing of
the JAX package is edited. It records the counter of the accepted
candidate.

and in the JSON the JAX verifier's verdicts (the blinded opening, a wrong
blinder fold, a tampered value; the conv proof and its tampered-Z proof),
the command, the JAX version and the SHA-256 of the JAX sources it read.
Each phase runs in a process of its own (GLV's window walk compiles for
minutes on XLA:CPU), side by side; ``--parts DIR`` reruns the phases DIR
lacks. Not a test: pytest does not collect it.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import slice11_inputs  # noqa: E402
from slice11_inputs import CONV_FORWARD, CONV_PROVE, CONV_TAMPER  # noqa: E402

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
COMMAND = "JAX_PLATFORMS=cpu python tests/port/record_slice11.py"
SOURCES = ["zkdl_tpu/curve/g1.py", "zkdl_tpu/commit/pedersen.py", "zkdl_tpu/models/zkconv.py",
           "zkdl_tpu/models/zkfc.py", "zkdl_tpu/models/quantize.py", "zkdl_tpu/io/proof_io.py"]


def conv_case(seed: int, pad: int, stride: int, small: bool):
    """slice11_inputs.conv_case with the JAX package's ConvShape."""
    from zkdl_tpu.models import zkconv

    shape, batch, x, k = slice11_inputs.conv_case(seed, pad, stride, small)
    return zkconv.ConvShape(**shape), batch, x, k


def conv_input(x):
    from zkdl_tpu.field import fr
    from zkdl_tpu.models import quantize

    return fr.mont(quantize.float_to_fr(jnp.asarray(x.reshape(-1))).reshape(-1, 8))


def put_proof(out: dict, prefix: str, proof) -> None:
    from zkdl_tpu.io import proof_io

    arrays: dict = {}
    skel = proof_io._flatten(proof, "p", arrays, None)
    for k, a in arrays.items():
        out[f"{prefix}:{k}"] = np.asarray(a)
    out[f"{prefix}:__skeleton__"] = np.frombuffer(json.dumps(skel).encode(), np.uint8)


def put_points(out: dict, prefix: str, p) -> None:
    for c in ("x", "y", "z"):
        out[f"{prefix}.{c}"] = np.asarray(getattr(p, c))


def phase_glv(out: dict, verdicts: dict) -> None:
    from zkdl_tpu.curve import g1 as jg1

    pts, scal = slice11_inputs.glv_inputs()
    P = jg1.G1Jac(*(jnp.asarray(c.numpy()) for c in pts))
    s = jnp.asarray(scal.numpy())
    out["glv/points.x"], out["glv/points.y"], out["glv/points.z"] = (c.numpy() for c in pts)
    out["glv/scalars"] = scal.numpy()
    s1, s2 = jax.jit(jg1.glv_decompose)(s)
    out["glv/s1"], out["glv/s2"] = np.asarray(s1), np.asarray(s2)
    out["glv/d1"] = np.asarray(jg1._window_digits(s1))
    out["glv/d2"] = np.asarray(jg1._window_digits(s2))
    put_points(out, "glv/endo", jax.jit(jg1.endomorphism)(P))
    t0 = time.perf_counter()
    put_points(out, "glv/out", jg1.scalar_mul_glv_jit(P, s))
    print(f"scalar_mul_glv at {pts.x.shape[0]} points: {time.perf_counter() - t0:.0f}s", file=sys.stderr, flush=True)


def blinded_setup():
    """tests/test_blinded.py:_setup and its opening point."""
    from zkdl_tpu.commit import pedersen
    from zkdl_tpu.field import fr
    from zkdl_tpu.tensor import fr_ops

    gens = pedersen.setup(jax.random.PRNGKey(3), 4)
    t = fr.mont(fr_ops.random_fr(jax.random.PRNGKey(4), 16))
    u = fr.mont(fr_ops.random_fr(jax.random.PRNGKey(5), 4))
    return gens, t, u


def terminating_blinding_point():
    """pedersen.blinding_point's code (:483-501) with its counter
    incremented: the first candidate of the domain-separated stream that is
    on the curve, cofactor-cleared by the host double-and-add. Returns
    (point, counter)."""
    import hashlib

    from zkdl_tpu.commit import pedersen
    from zkdl_tpu.curve import convert, host_g1
    from zkdl_tpu.field import fp

    p = fp.P_INT
    ctr = 0
    while True:
        h1 = hashlib.sha256(f"zkdl-tpu/nums-blind/v1/{ctr}".encode()).digest()
        h2 = hashlib.sha256(f"zkdl-tpu/nums-blind/v1/{ctr}/b".encode()).digest()
        x = int.from_bytes(h1 + h2, "big") % p
        rhs = (x * x % p * x + 4) % p
        y = pow(rhs, (p + 1) // 4, p)
        if y * y % p == rhs:
            pt = host_g1.scalar_mul(host_g1.JacPoint(x, min(y, p - y), 1), pedersen._G1_COFACTOR)
            assert not pt.is_identity()
            return convert.jac_to_device([pt]), ctr
        ctr += 1


def phase_blinded(out: dict, verdicts: dict) -> None:
    import functools

    from zkdl_tpu.commit import pedersen
    from zkdl_tpu.field import fr
    from zkdl_tpu.sumcheck import protocols as sc
    from zkdl_tpu.tensor import fr_ops

    H, ctr = terminating_blinding_point()
    pedersen.blinding_point = functools.lru_cache(maxsize=None)(lambda: H)
    out["blind/H_counter"] = np.array([ctr], np.int64)
    gens, t, u = blinded_setup()
    put_points(out, "blind/H", pedersen.blinding_point())
    put_points(out, "blind/gens", gens.points)
    out["blind/gens.dlogs"], out["blind/t"], out["blind/u"] = np.asarray(gens.dlogs), np.asarray(t), np.asarray(u)
    coms = {}
    for key in slice11_inputs.BLIND_KEYS:
        coms[key] = pedersen.commit_blinded(gens, t, jax.random.PRNGKey(key))
        put_points(out, f"blind/com{key}", coms[key].points)
        out[f"blind/com{key}.blinders"] = np.asarray(coms[key].blinders)
    put_points(out, "blind/plain", pedersen.commit(gens, t).points)
    com = coms[slice11_inputs.BLIND_KEYS[0]]
    proof, b_fold = pedersen.open_blinded(gens, t, com, u)
    put_proof(out, "blind/opening", proof)
    out["blind/b_fold"] = np.asarray(b_fold)
    u_ints = sc.scalars_to_ints(u)
    want = sc.scalars_to_ints(fr_ops.me_eval(t, u)[None])[0]
    b = sc.scalars_to_ints(b_fold[None])[0]
    verdicts["blind_ok"] = pedersen.verify_open_blinded(proof, com.public, u_ints, b, expected_value=want)
    verdicts["blind_wrong_b_fold"] = pedersen.verify_open_blinded(proof, com.public, u_ints, (b + 1) % fr.P_INT)
    verdicts["blind_tampered_value"] = pedersen.verify_open_blinded(
        proof, com.public, u_ints, b, expected_value=(want + 1) % fr.P_INT)


def phase_conv(out: dict, verdicts: dict) -> None:
    from zkdl_tpu.field import fr
    from zkdl_tpu.models import zkconv
    from zkdl_tpu.sumcheck.transcript import FiatShamir

    for seed, pad, stride in CONV_FORWARD:
        shape, batch, x, k = conv_case(seed, pad, stride, small=False)
        layer = zkconv.ZkConv2D.from_float(k, shape, jax.random.PRNGKey(0))
        out[f"conv_fwd_{pad}_{stride}/Z"] = np.asarray(layer(conv_input(x), batch))
    for name, (seed, pad, stride, key) in (("conv_prove", CONV_PROVE), ("conv_tamper", CONV_TAMPER)):
        shape, batch, x, k = conv_case(seed, pad, stride, small=True)
        layer = zkconv.ZkConv2D.from_float(k, shape, jax.random.PRNGKey(key))
        X = conv_input(x)
        Z = layer(X, batch)
        if name == "conv_tamper":
            Z = fr.add(Z, fr.ones_mont((Z.shape[0],)))
        proof = layer.prove(X, Z, FiatShamir(), batch)
        verdicts[name] = layer.verify(proof)
        out[f"{name}/Z"] = np.asarray(Z)
        put_points(out, f"{name}/com", layer.fc.com.points)
        put_proof(out, f"{name}/proof", proof)


PHASES = {"glv": phase_glv, "blinded": phase_blinded, "conv": phase_conv}


def save(path: pathlib.Path, out: dict) -> None:
    keys = sorted(out)
    np.savez_compressed(
        path,
        __keys__=np.frombuffer(json.dumps({k: f"a{i}" for i, k in enumerate(keys)}).encode(), np.uint8),
        **{f"a{i}": out[k] for i, k in enumerate(keys)},
    )


def load(path: pathlib.Path) -> dict:
    with np.load(path) as z:
        keys = json.loads(bytes(z["__keys__"]).decode())
        return {k: z[v] for k, v in keys.items()}


def run_phase(name: str, parts: pathlib.Path) -> None:
    t0 = time.perf_counter()
    out: dict = {}
    verdicts: dict = {}
    PHASES[name](out, verdicts)
    save(parts / f"{name}.npz", out)
    (parts / f"{name}.json").write_text(json.dumps({k: list(v) for k, v in verdicts.items()}))
    print(f"phase {name}: {time.perf_counter() - t0:.0f}s", file=sys.stderr, flush=True)


def main() -> None:
    """With no argument, every phase in a new temporary directory; with
    --parts DIR, the phases whose parts DIR lacks; with PHASE DIR, that
    phase alone."""
    import subprocess
    import tempfile

    if len(sys.argv) == 3 and sys.argv[1] in PHASES:
        run_phase(sys.argv[1], pathlib.Path(sys.argv[2]))
        return
    t0 = time.perf_counter()
    parts = pathlib.Path(sys.argv[2] if sys.argv[1:2] == ["--parts"] else tempfile.mkdtemp(prefix="record_slice11_"))
    me = [sys.executable, str(pathlib.Path(__file__).resolve())]
    procs = {nm: subprocess.Popen([*me, nm, str(parts)]) for nm in PHASES if not (parts / f"{nm}.json").exists()}
    failed = [nm for nm, p in procs.items() if p.wait()]
    if failed:
        raise SystemExit(f"phases {failed} failed; rerun with --parts {parts}")
    out: dict = {}
    verdicts: dict = {}
    for nm in PHASES:
        out.update(load(parts / f"{nm}.npz"))
        verdicts.update(json.loads((parts / f"{nm}.json").read_text()))
    FIXTURES.mkdir(exist_ok=True)
    save(FIXTURES / "slice11_jax.npz", out)
    meta = {
        "command": COMMAND,
        "jax_version": jax.__version__,
        "verdicts": verdicts,
        "sources_sha256": {s: hashlib.sha256((ROOT / s).read_bytes()).hexdigest() for s in SOURCES},
    }
    (FIXTURES / "slice11_jax.json").write_text(json.dumps(meta, indent=1) + "\n")
    print(f"wrote slice11_jax.npz/json ({time.perf_counter() - t0:.0f}s)", file=sys.stderr)


if __name__ == "__main__":
    main()
