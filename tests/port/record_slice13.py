"""Record the JAX package's side of the port's multi-device tests
(``tests/port/test_torch_collectives.py``, ``test_torch_nat_path.py``,
``test_torch_sharded.py``, ``test_torch_sharded_model.py``), which run no
JAX compile.

    JAX_PLATFORMS=cpu python tests/port/record_slice13.py

Runs on the CPU over eight virtual devices (each phase process is started
with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``) and writes
``tests/port/fixtures/slice13_jax.npz`` and ``slice13_jax.json``:

- ``model/*``: the 8-wide, 2-layer model of ``tests/test_sharded_model.py``
  (``default_rng(11)``, dims [8, 8, 8], batch 8, ``PRNGKey(0)``) with the
  (n, 8) prover (``USE_PLANAR_PROVER = False``): X, its commitments, the
  forward's Y, Z, A and expanded aux (``zkrelu.forward``), and
  ``model.prove(chain=False)`` under ``SeededRng(7)``; ``prove_sharded`` at
  2, 4 and 8 devices is asserted equal to it here;
- ``chained/*`` and ``committed/*``: the planar single-device proof under
  ``FiatShamir`` (chained; chained with the committed-aux tier) and
  ``prove_sharded`` of the same mode at 4 devices, the latter kept only where
  the two differ (the JSON says which);
- ``kern/*``: ``tests/test_sharded_model.py``'s protocol checks (binary and
  Hadamard sumchecks at n = 64, the row-sharded commitment sums) and the
  other sharded functions (inner product, partial and full MLE folds, the
  dp x tp matmul) at 4 devices, each asserted equal to its single-device
  function, with their inputs;
- ``collect/*``: ``psum_fr`` over 1, 2, 4 and 8 devices of per-device values
  (p - 1, zeros, random), and ``reduce_mod_p`` of 9-limb edge sums
  (n (p - 1) for n up to 255, zero, random sums);
- ``open/*``: ``me_open``, ``me_open_fast`` and ``open`` on transparent
  (``setup``, dlogs known) and opaque (``nums_generators``) vectors of 8 and
  16 generators, four rows each (the JAX CPU branch: double-and-add);

and in the JSON the JAX verifier's verdicts, which modes' sharded proofs
equal the single-device proofs, the command, the JAX version and the
SHA-256 of the JAX sources it read. Each phase runs in a process of its own,
side by side; ``--parts DIR`` reruns the phases DIR lacks. Not a test: pytest
does not collect it.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
COMMAND = "JAX_PLATFORMS=cpu python tests/port/record_slice13.py"
SOURCES = ["zkdl_tpu/parallel/collectives.py", "zkdl_tpu/parallel/sharded.py", "zkdl_tpu/parallel/model.py",
           "zkdl_tpu/models/mlp.py", "zkdl_tpu/models/zkrelu.py", "zkdl_tpu/models/zkfc.py",
           "zkdl_tpu/commit/pedersen.py", "zkdl_tpu/sumcheck/protocols.py", "zkdl_tpu/curve/g1.py"]
N_DEVICES = 8
OPEN_SIZES = (8, 16)
OPEN_ROWS = 4
COLLECT_DEVICES = (1, 2, 4, 8)
EDGE_COPIES = (1, 2, 4, 8, 128, 255)


def put_proof(out: dict, prefix: str, proof) -> dict:
    from zkdl_tpu.io import proof_io

    arrays: dict = {}
    skel = proof_io._flatten(proof, "p", arrays, None)
    for k, a in arrays.items():
        out[f"{prefix}:{k}"] = np.asarray(a)
    out[f"{prefix}:__skeleton__"] = np.frombuffer(json.dumps(skel).encode(), np.uint8)
    return {k: np.asarray(a) for k, a in arrays.items()}


def put_points(out: dict, prefix: str, p) -> None:
    for c in ("x", "y", "z"):
        out[f"{prefix}.{c}"] = np.asarray(getattr(p, c))


def put_split_fold(out: dict, prefix: str, res) -> None:
    """me_open's (round_points, final_gen, final_scalar)."""
    rounds, final_gen, final_scalar = res
    for i, pts in enumerate(rounds):
        put_points(out, f"{prefix}/round{i}", pts)
    put_points(out, f"{prefix}/final_gen", final_gen)
    out[f"{prefix}/final_scalar"] = np.asarray(final_scalar)


def same_arrays(a: dict, b: dict) -> list:
    """The keys where two flattened proofs differ (or exist in one only)."""
    return sorted(k for k in set(a) | set(b) if k not in a or k not in b or not np.array_equal(a[k], b[k]))


def dp_mesh(n: int):
    from zkdl_tpu.parallel import sharded

    return sharded.make_mesh(n, (n,), names=("dp",))


def tiny_model():
    """tests/test_sharded_model.py:tiny."""
    from zkdl_tpu.field import fr
    from zkdl_tpu.models import mlp, quantize

    rng = np.random.default_rng(11)
    dims = [8, 8, 8]
    weights = [(rng.standard_normal((dims[i], dims[i + 1])) * 0.4).astype(np.float32)
               for i in range(len(dims) - 1)]
    model = mlp.MLP.from_float_weights(weights, jax.random.PRNGKey(0))
    X = fr.mont(quantize.load_input(rng.standard_normal((8, dims[0])).astype(np.float32)))
    return model, X


def phase_model(out: dict, meta: dict) -> None:
    from zkdl_tpu.models import mlp
    from zkdl_tpu.parallel import model as pmodel
    from zkdl_tpu.sumcheck.transcript import FiatShamir, SeededRng

    model, X = tiny_model()
    out["model/X"] = np.asarray(X)
    for i, layer in enumerate(model.layers):
        put_points(out, f"model/com{i}", layer.com.points)
    prev = mlp.USE_PLANAR_PROVER
    try:
        mlp.USE_PLANAR_PROVER = False
        Y, Z, A, aux = model.infer(X)
        out["model/Y"] = np.asarray(Y)
        for i in range(len(Z)):
            out[f"model/Z{i}"], out[f"model/A{i}"] = np.asarray(Z[i]), np.asarray(A[i])
            for k, v in aux[i].items():
                out[f"model/aux{i}.{k}"] = np.asarray(v)
        t0 = time.perf_counter()
        ref = model.prove(X, Y, Z, A, aux, SeededRng(7), chain=False)
        ref_arrays = put_proof(out, "model/nat", ref)
        meta["verdicts"]["nat"] = list(model.verify(ref))
        print(f"(n, 8) prove: {time.perf_counter() - t0:.0f}s", file=sys.stderr, flush=True)
        for n in (2, 4, 8):
            t0 = time.perf_counter()
            sh = pmodel.prove_sharded(model, X, Y, Z, A, aux, dp_mesh(n), SeededRng(7))
            bad = same_arrays(ref_arrays, put_proof({}, "x", sh))
            assert not bad, f"prove_sharded at {n} devices differs from the (n, 8) proof at {bad[:5]}"
            print(f"prove_sharded at {n}: {time.perf_counter() - t0:.0f}s", file=sys.stderr, flush=True)

        mlp.USE_PLANAR_PROVER = True
        Yp, Zp, Ap, auxp = model.infer(X)
        mlp.USE_PLANAR_PROVER = False
        for mode, kw in (("chained", {}), ("committed", {"commit_aux": True})):
            mlp.USE_PLANAR_PROVER = True
            single = model.prove(X, Yp, Zp, Ap, auxp, FiatShamir(), chain=True, **kw)
            mlp.USE_PLANAR_PROVER = False
            t0 = time.perf_counter()
            sh = pmodel.prove_sharded(model, X, Y, Z, A, aux, dp_mesh(4), FiatShamir(), chain=True, **kw)
            print(f"prove_sharded {mode} at 4: {time.perf_counter() - t0:.0f}s", file=sys.stderr, flush=True)
            single_arrays = put_proof(out, f"{mode}/single", single)
            bad = same_arrays(single_arrays, put_proof({}, "x", sh))
            meta["sharded_equals_single"][mode] = {"equal": not bad, "first_keys_that_differ": bad[:10]}
            if bad:
                put_proof(out, f"{mode}/sharded4", sh)
                meta["verdicts"][f"{mode}_sharded4"] = list(
                    model.verify(sh, X=X, Y_hat=Y, transcript=FiatShamir()))
            meta["verdicts"][f"{mode}_single"] = list(model.verify(single, X=X, Y_hat=Y, transcript=FiatShamir()))
    finally:
        mlp.USE_PLANAR_PROVER = prev


def phase_kernels(out: dict, meta: dict) -> None:
    from zkdl_tpu.commit import pedersen
    from zkdl_tpu.field import fr
    from zkdl_tpu.models import quantize, zkfc
    from zkdl_tpu.parallel import model as pmodel
    from zkdl_tpu.parallel import sharded
    from zkdl_tpu.sumcheck import protocols as sc
    from zkdl_tpu.tensor import fr_ops

    def rec(name, got, want):
        got, want = [np.asarray(x) for x in got], [np.asarray(x) for x in want]
        for k, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(g, w), f"{name}[{k}]: sharded != single device"
            out[f"kern/{name}.{k}"] = g

    mesh = dp_mesh(4)
    # tests/test_sharded_model.py:64-93
    n = 64
    bits = fr.select(jax.random.bernoulli(jax.random.PRNGKey(3), shape=(n,)), fr.ones_mont((n,)), fr.zeros((n,)))
    r = fr_ops.ceil_log2(n)
    u = fr.mont(fr_ops.random_fr(jax.random.PRNGKey(4), r))
    v = fr.mont(fr_ops.random_fr(jax.random.PRNGKey(5), r))
    a = fr.mont(fr_ops.random_fr(jax.random.PRNGKey(6), n))
    b = fr.mont(fr_ops.random_fr(jax.random.PRNGKey(7), n))
    for k, x in {"bits": bits, "u": u, "v": v, "a": a, "b": b}.items():
        out[f"kern/in.{k}"] = np.asarray(x)
    rec("binary", pmodel.sharded_binary_prove(mesh, pmodel._shard(mesh, bits), u, v),
        jax.jit(sc.binary_prove)(bits, u, v))
    rec("hadamard", pmodel.sharded_hadamard_prove(mesh, pmodel._shard(mesh, a), pmodel._shard(mesh, b), u, v),
        jax.jit(sc.hadamard_prove)(a, b, u, v))
    rec("inner_product", sharded.sharded_inner_product_prove(mesh, pmodel._shard(mesh, a), pmodel._shard(mesh, b), u),
        jax.jit(sc.inner_product_prove)(a, b, u))
    rec("me_eval", [pmodel.sharded_me_eval(mesh, pmodel._shard(mesh, a), u)], [fr_ops.me_eval(a, u)])
    rec("partial_me", [pmodel.sharded_partial_me(mesh, pmodel._shard(mesh, a), u[:4], 4)],
        [fr_ops.partial_me(a, u[:4], 4)])
    gens = pedersen.setup(jax.random.PRNGKey(8), 8)
    t = fr.mont(fr_ops.random_fr(jax.random.PRNGKey(9), 8 * 8))  # m=8 rows
    out["kern/in.dlogs"], out["kern/in.t"] = np.asarray(gens.dlogs), np.asarray(t)
    rec("commit_dlogs", [pmodel.sharded_commit_dlogs(mesh, pmodel._shard(mesh, t), gens.dlogs)],
        [pedersen._commit_rows_fast(t.reshape(8, 8, 8), gens.dlogs)])
    # the dp x tp forward of parallel/dryrun.py at 8 devices (dp 4, tp 2)
    rng = np.random.default_rng(0)
    in_s, out_s, batch = 16, 16, 16
    W = quantize.load_weights((rng.standard_normal((in_s, out_s)) * 0.3).astype(np.float32))
    X = fr.mont(quantize.load_input(rng.standard_normal((batch, in_s)).astype(np.float32)))
    out["kern/in.W"], out["kern/in.X"] = np.asarray(W), np.asarray(X)
    mesh2 = sharded.make_mesh(8, (4, 2))
    rec("matmul", [sharded.sharded_field_matmul(mesh2, X, W, in_s, out_s)],
        [zkfc.field_matmul_jit(X, W, in_s, out_s)])


def phase_collect(out: dict, meta: dict) -> None:
    from jax.sharding import Mesh, PartitionSpec as P

    from zkdl_tpu.field import fr, mp
    from zkdl_tpu.parallel import collectives

    rng = np.random.default_rng(13)
    P_INT = fr.P_INT
    for n in COLLECT_DEVICES:
        vals = [[P_INT - 1] * n, [0] * n] + [[int(x) for x in rng.integers(0, 1 << 62, 8)] for _ in range(6)]
        rows = np.zeros((n, len(vals), 8), np.uint32)
        for j, per in enumerate(vals):
            for d in range(n):
                x = (per[d] * pow(3, d + 7 * j, P_INT) if j >= 2 else per[d]) % P_INT
                rows[d, j] = mp.limbs_from_int(x, 8)
        mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
        f = jax.shard_map(lambda x: collectives.psum_fr(x[0], "dp"), mesh=mesh, in_specs=P("dp"),
                          out_specs=P(), check_vma=False)
        got = np.asarray(jax.jit(f)(jnp.asarray(rows)))
        want = np.stack([mp.limbs_from_int(sum(mp.int_from_limbs(rows[d, j]) for d in range(n)) % P_INT, 8)
                         for j in range(len(vals))])
        assert np.array_equal(got, want), f"psum_fr over {n} devices"
        out[f"collect/values{n}"], out[f"collect/psum{n}"] = rows, got
    sums = [c * (P_INT - 1) for c in EDGE_COPIES] + [0, P_INT, 2 * P_INT - 1, (1 << 256) - 1, 255 * P_INT]
    sums += [int(sum(int(x) << (32 * i) for i, x in enumerate(rng.integers(0, 1 << 32, 8)))) % P_INT * c
             for c in (3, 17, 200)]
    limbs9 = np.stack([mp.limbs_from_int(s, 9) for s in sums])
    got = np.asarray(jax.jit(collectives.reduce_mod_p)(jnp.asarray(limbs9)))
    assert all(mp.int_from_limbs(g) == s % P_INT for g, s in zip(got, sums)), "reduce_mod_p"
    out["collect/limbs9"], out["collect/reduced"] = limbs9, got


def phase_open(out: dict, meta: dict) -> None:
    from zkdl_tpu.commit import pedersen
    from zkdl_tpu.field import fr
    from zkdl_tpu.sumcheck import protocols as sc
    from zkdl_tpu.tensor import fr_ops

    for size in OPEN_SIZES:
        log_g = fr_ops.ceil_log2(size)
        t = fr.mont(fr_ops.random_fr(jax.random.PRNGKey(30 + size), OPEN_ROWS * size))
        u = fr.mont(fr_ops.random_fr(jax.random.PRNGKey(40 + size), log_g + fr_ops.ceil_log2(OPEN_ROWS)))
        out[f"open/{size}/t"], out[f"open/{size}/u"] = np.asarray(t), np.asarray(u)
        dl = pedersen.setup(jax.random.PRNGKey(20 + size), size)
        nums = pedersen.nums_generators(size)
        for kind, gens in (("dlog", dl), ("nums", nums)):
            p = f"open/{size}/{kind}"
            put_points(out, f"{p}/gens", gens.points)
            t_row = t[:size]
            put_split_fold(out, f"{p}/me_open", pedersen.me_open(t_row, gens.points, u[:log_g], glv_safe=True))
            com = pedersen.commit(gens, t)
            put_points(out, f"{p}/com", com.points)
            proof = pedersen.open(gens, t, com, u)
            put_proof(out, f"{p}/open", proof)
            want = sc.scalars_to_ints(fr_ops.me_eval(t, u)[None])[0]
            meta["verdicts"][f"{p}/open"] = list(pedersen.verify_open(proof, sc.scalars_to_ints(u), want))
            if kind == "dlog":
                out[f"{p}/dlogs"], out[f"{p}/com.dlogs"] = np.asarray(gens.dlogs), np.asarray(com.dlogs)
                put_split_fold(out, f"{p}/me_open_fast", pedersen.me_open_fast(t_row, gens.dlogs, u[:log_g]))
                opaque = pedersen.open(pedersen.Generators(points=gens.points, glv_safe=True), t,
                                       pedersen.RowCommitments(points=com.points), u)
                put_proof(out, f"{p}/open_opaque", opaque)
                meta["verdicts"][f"{p}/open_opaque"] = list(
                    pedersen.verify_open(opaque, sc.scalars_to_ints(u), want))


PHASES = {"model": phase_model, "kernels": phase_kernels, "collect": phase_collect, "open": phase_open}


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
    if len(jax.devices()) < N_DEVICES:
        raise SystemExit(f"{len(jax.devices())} devices; start with "
                         f"XLA_FLAGS=--xla_force_host_platform_device_count={N_DEVICES}")
    t0 = time.perf_counter()
    out: dict = {}
    meta: dict = {"verdicts": {}, "sharded_equals_single": {}}
    PHASES[name](out, meta)
    save(parts / f"{name}.npz", out)
    (parts / f"{name}.json").write_text(json.dumps(meta))
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
    parts = pathlib.Path(sys.argv[2] if sys.argv[1:2] == ["--parts"] else tempfile.mkdtemp(prefix="record_slice13_"))
    me = [sys.executable, str(pathlib.Path(__file__).resolve())]
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={N_DEVICES}"}
    procs = {nm: subprocess.Popen([*me, nm, str(parts)], env=env)
             for nm in PHASES if not (parts / f"{nm}.json").exists()}
    failed = [nm for nm, p in procs.items() if p.wait()]
    if failed:
        raise SystemExit(f"phases {failed} failed; rerun with --parts {parts}")
    out: dict = {}
    meta: dict = {"verdicts": {}, "sharded_equals_single": {}}
    for nm in PHASES:
        out.update(load(parts / f"{nm}.npz"))
        part = json.loads((parts / f"{nm}.json").read_text())
        for k in meta:
            meta[k].update(part[k])
    FIXTURES.mkdir(exist_ok=True)
    save(FIXTURES / "slice13_jax.npz", out)
    meta.update({
        "command": COMMAND,
        "jax_version": jax.__version__,
        "sources_sha256": {s: hashlib.sha256((ROOT / s).read_bytes()).hexdigest() for s in SOURCES},
    })
    (FIXTURES / "slice13_jax.json").write_text(json.dumps(meta, indent=1) + "\n")
    print(f"wrote slice13_jax.npz/json ({time.perf_counter() - t0:.0f}s)", file=sys.stderr)


if __name__ == "__main__":
    main()
