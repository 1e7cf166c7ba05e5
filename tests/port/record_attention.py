"""Record the JAX package's attention block at a tiny size, for the port's CPU
tests (``tests/port/test_torch_attention.py``, ``test_torch_lookup.py``) and
``chip_smoke.py``'s attention phase, which run no JAX.

    JAX_PLATFORMS=cpu python tests/port/record_attention.py

Runs on the CPU, at ``tests/test_attention.py``'s tiny attention (seq 4,
d_model 8, weights and input from ``np.random.default_rng(0)``, generators
from ``PRNGKey(0)``), and writes ``tests/port/fixtures/attention_jax.npz``
and ``attention_jax.json``:

- ``inputs/*``: the float weights and input; ``model/*``: each projection's
  weights, generators, dlogs and row commitments;
- ``trace/*``: every tensor of ``ZkAttention.forward``, the rescale aux and
  the softmax witness;
- ``plain:*`` and ``committed:*``: the proofs of both tiers
  (``prove(..., commit_witness=False/True)`` with ``FiatShamir()``),
  flattened as ``proof_io.dump_proof`` flattens them, each with its
  skeleton under ``<tier>:__skeleton__``;
- ``lookup*``, ``binv/*``, ``scan/*``, ``fm/*``, ``rescale*``: a lookup
  proof, ``batch_inverse``, the scan provers, ``field_matmul`` and a
  rescale forward and proof, each on seeded inputs;

and in the JSON, the JAX verifier's verdict and reason on each tamper case
(``TAMPERS``: one fault each, a limb of the named proof array plus one), the
command, the JAX version and the SHA-256 of every JAX source the run read.
The npz stores each array as ``a<i>`` with the key map in ``__keys__``.
Not a test: pytest does not collect it. Its XLA:CPU compiles take over
an hour and more executables than one process can map (XLA:CPU maps
each executable's code; at the kernel's 65,530 mappings a compile fails
with "LLVM compilation error: Cannot allocate memory"). So the script runs
its phases (``STAGES``) in processes of their own, side by side, each
writing a part that the last step merges, and a process drops JAX's
compiled executables when it holds MAPS_LIMIT mappings. A phase that
failed is run again, alone or with the others missing, by
``record_attention.py --parts DIR`` (DIR is printed on failure).
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import sys
import time

# one object file per executable: the default parallel codegen maps many
# sections per compile, and a process runs out of mappings
os.environ.setdefault("XLA_FLAGS", "--xla_cpu_parallel_codegen_split_count=1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from zkdl_tpu.field import fr  # noqa: E402
from zkdl_tpu.io import proof_io  # noqa: E402
from zkdl_tpu.models import quantize, zkattention, zkfc, zkrescale, zksoftmax  # noqa: E402
from zkdl_tpu.sumcheck import lookup  # noqa: E402
from zkdl_tpu.sumcheck import protocols as sc  # noqa: E402
from zkdl_tpu.sumcheck.transcript import FiatShamir  # noqa: E402

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
COMMAND = "JAX_PLATFORMS=cpu python tests/port/record_attention.py"
SEQ, D = 4, 8
SOURCES = [
    "zkdl_tpu/models/zkattention.py", "zkdl_tpu/models/zksoftmax.py", "zkdl_tpu/models/zkrescale.py",
    "zkdl_tpu/models/zkrelu.py", "zkdl_tpu/models/zkfc.py", "zkdl_tpu/models/quantize.py",
    "zkdl_tpu/sumcheck/lookup.py", "zkdl_tpu/sumcheck/protocols.py", "zkdl_tpu/sumcheck/transcript.py",
    "zkdl_tpu/commit/witness.py", "zkdl_tpu/commit/pedersen.py", "zkdl_tpu/curve/g1.py",
    "zkdl_tpu/tensor/fr_ops.py", "zkdl_tpu/field/fr.py", "zkdl_tpu/io/proof_io.py",
]

# (name, tier, array path or None, index, verify arguments): the array's
# limb at index gets + 1 (uint32, wrapping); "X"/"Y" pass the public tensors,
# "Y_bad" Y with its first entry replaced by mont(7 << 16), "transcript" a
# fresh FiatShamir() for replay.
TAMPERS = [
    ("plain_ok", "plain", None, None, ()),
    ("plain_replay_refused", "plain", None, None, ("transcript",)),
    ("plain_anchor_refused", "plain", None, None, ("X",)),
    ("plain_h_rowsum_claim", "plain", "p.sm.h_rowsum.claim", (0,), ()),
    ("plain_rs_k_hp_polys", "plain", "p.rs_k.hp_polys", (0, 0, 0), ()),
    ("plain_mm_s_ip_finals", "plain", "p.mm_s.ip_finals", (1, 0), ()),
    ("plain_lk_m", "plain", "p.sm.lk.m", (0, 0), ()),
    ("plain_fc_v_opening", "plain", "p.fc_v.opening.final_scalar", (0,), ()),
    ("committed_ok", "committed", None, None, ("X", "Y")),
    ("committed_replay_ok", "committed", None, None, ("X", "Y", "transcript")),
    ("committed_wrong_Y", "committed", None, None, ("X", "Y_bad")),
    ("committed_opening_t_folded", "committed", "p.witness.openings.at.mm_s.fa.proof.t_folded", (0, 0), ()),
    ("committed_replay_swapped_u_x", "committed", "p.u_x", (0, 0), ("X", "Y", "transcript")),
    ("committed_com_S_x", "committed", "p.witness.coms.at.S.points.x", (0, 0), ()),
    ("committed_lk_sum_w", "committed", "p.sm.lk.sum_w", (0,), ()),
    ("committed_rs_s_mag_polys", "committed", "p.rs_s.base.mag_polys", (0, 0, 0), ()),
    ("committed_mm_o_z_claim", "committed", "p.mm_o.z_claim", (0,), ()),
    ("committed_replay_fc_y_ip_polys", "committed", "p.fc_y.ip_polys", (0, 0, 0), ("transcript",)),
    ("committed_rs_q_sa_claim", "committed", "p.rs_q.sa_claim", (0,), ()),
    ("committed_div_polys", "committed", "p.sm.div_polys", (1, 2, 0), ()),
    ("committed_smax_at_urec_row", "committed", "p.sm.smax_at_urec_row", (0,), ()),
    ("committed_er_bits_opening", "committed", "p.witness.openings.at.sm.er_bits.rec.proof.t_folded", (1, 0), ()),
]


MAPS_LIMIT = 40000  # of the kernel's 65530 mappings a process may hold


def _maps() -> int:
    with open("/proc/self/maps") as f:
        return sum(1 for _ in f)


def _guarded(fn):
    """fn, first dropping JAX's compiled executables when the process holds
    MAPS_LIMIT mappings: XLA:CPU maps each executable's code, and the
    committed tier's prove and verify compile more executables than one
    process can map (they are compiled again when next needed)."""

    def wrapped(*args, **kwargs):
        if _maps() > MAPS_LIMIT:
            import gc

            before = _maps()
            jax.clear_caches()
            gc.collect()
            print(f"cleared JAX's caches: {before} -> {_maps()} mappings", file=sys.stderr, flush=True)
        return fn(*args, **kwargs)

    return wrapped


def guard_compiles() -> None:
    """Wrap the committed tier's stage entry points in _guarded."""
    from zkdl_tpu.commit import pedersen, witness

    for cls, name in ((witness.Committer, "open"), (witness.Committer, "commit"), (witness.Checker, "value")):
        setattr(cls, name, _guarded(getattr(cls, name)))
    for mod, name in ((zkrescale, "prove_committed"), (zkrescale, "verify_committed"), (zkfc, "prove"),
                      (zksoftmax, "range_prove"), (zksoftmax, "rowsum_prove"), (pedersen, "commit")):
        setattr(mod, name, _guarded(getattr(mod, name)))


def tiny():
    """tests/test_attention.py:_tiny_attention."""
    rng = np.random.default_rng(0)
    ws = [(rng.standard_normal((D, D)) * 0.3).astype(np.float32) for _ in range(4)]
    attn = zkattention.ZkAttention.from_float(SEQ, *ws, jax.random.PRNGKey(0))
    X_np = rng.standard_normal((SEQ, D)).astype(np.float32)
    return attn, fr.mont(quantize.load_input(X_np)), ws, X_np


def rand_fr(seed: int, n: int) -> np.ndarray:
    a = np.random.default_rng(seed).integers(0, 1 << 32, size=(n, 8), dtype=np.uint32)
    a[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    return a


def mont_bits(seed: int, n: int):
    bits = np.random.default_rng(seed).integers(0, 2, size=n)
    return jnp.where(jnp.asarray(bits == 1)[:, None], fr.ones_mont((n,)), fr.zeros((n,)))


def put_proof(out: dict, prefix: str, proof) -> tuple[dict, dict]:
    arrays: dict = {}
    skel = proof_io._flatten(proof, "p", arrays, None)
    for k, a in arrays.items():
        out[f"{prefix}:{k}"] = np.asarray(a)
    out[f"{prefix}:__skeleton__"] = np.frombuffer(json.dumps(skel).encode(), np.uint8)
    return skel, arrays


def tampered(skel: dict, arrays: dict, path: str | None, index):
    arrs = {k: np.array(v) for k, v in arrays.items()}
    if path is not None:
        arrs[path][index] += np.uint32(1)
    return proof_io._unflatten(skel, arrs, True)


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


def proof_from(parts: dict, prefix: str):
    skel = json.loads(bytes(parts[f"{prefix}:__skeleton__"]).decode())
    arrays = {k[len(prefix) + 1 :]: v for k, v in parts.items()
              if k.startswith(prefix + ":") and not k.endswith("__skeleton__")}
    return skel, arrays


def verdict(attn, proof, args, X, Y, Y_bad):
    kw = {}
    if "X" in args:
        kw["X"] = X
    if "Y" in args:
        kw["Y"] = Y
    if "Y_bad" in args:
        kw["Y"] = Y_bad
    if "transcript" in args:
        kw["transcript"] = FiatShamir()
    ok, msg = attn.verify(proof, **kw)
    return [bool(ok), msg]


def phase_plain(out: dict, verdicts: dict, parts: pathlib.Path) -> None:
    """The model, the trace and the plain tier's proof."""
    attn, X, ws, X_np = tiny()
    for i, w in enumerate(ws):
        out[f"inputs/w{i}"] = w
    out["inputs/X_np"] = X_np
    for nm in ("wq", "wk", "wv", "wo"):
        fc = getattr(attn, nm)
        out[f"model/{nm}/weights"] = np.asarray(fc.weights)
        out[f"model/{nm}/gens_dlogs"] = np.asarray(fc.gens.dlogs)
        out[f"model/{nm}/com_dlogs"] = np.asarray(fc.com.dlogs)
        for c in "xyz":
            out[f"model/{nm}/gens_{c}"] = np.asarray(getattr(fc.gens.points, c))
            out[f"model/{nm}/com_{c}"] = np.asarray(getattr(fc.com.points, c))
    Y, tr = attn.forward(X)
    for k, v in tr.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                out[f"trace/{k}/{kk}"] = np.asarray(vv)
        else:
            out[f"trace/{k}"] = np.asarray(v)
    put_proof(out, "plain", attn.prove(tr, FiatShamir()))


def phase_plain_verify(out: dict, verdicts: dict, parts: pathlib.Path) -> None:
    """The JAX verifier's verdicts on the plain tier's proof and its tampers
    (host-side checks)."""
    attn, X, _, _ = tiny()
    saved = load(parts / "plain.npz")
    Y = jnp.asarray(saved["trace/Y"])
    Y_bad = Y.at[0].set(fr.mont(jnp.asarray(fr.from_ints([7 << 16])))[0])
    plain = proof_from(saved, "plain")
    for name, tier, path, index, args in TAMPERS:
        if tier == "plain":
            verdicts[name] = verdict(attn, tampered(*plain, path, index), args, X, Y, Y_bad)
            print(f"{name}: {verdicts[name]}", file=sys.stderr, flush=True)


def phase_plain_p(out: dict, verdicts: dict, parts: pathlib.Path) -> None:
    """The plain tier on a trace whose P has one wrong entry
    (test_attention.py:test_attention_rejects_tampered_softmax)."""
    attn, X, _, _ = tiny()
    _, tr = attn.forward(X)
    tr["P"] = tr["P"].at[0].set(fr.mont(jnp.asarray(fr.from_ints([3 << 16])))[0])
    ok, msg = attn.verify(attn.prove(tr, FiatShamir()))
    verdicts["trace_softmax_P"] = [bool(ok), msg]


def phase_extras(out: dict, verdicts: dict, parts: pathlib.Path) -> None:
    """The smaller functions on seeded inputs."""
    # a lookup into the 16-entry range table
    a_vals = np.random.default_rng(7).integers(0, 16, size=32).astype(np.uint64)
    m = lookup.multiplicities(a_vals, 16)
    lk = lookup.prove(zksoftmax._mont_from_u64(jnp.asarray(a_vals)), lookup.range_table(4), m, FiatShamir())
    out["lookup/a_vals"] = a_vals
    out["lookup/m"] = np.asarray(m)
    put_proof(out, "lookup", lk)
    verdicts["lookup_ok"] = list(lookup.verify(lk, table_vals=list(range(16))))

    # batch_inverse (Montgomery in and out); the last case holds a zero
    for n in (1, 2, 5, 64):
        x = rand_fr(100 + n, n)
        x[x.sum(axis=1) == 0, 0] = 1
        out[f"binv/in{n}"] = x
        out[f"binv/out{n}"] = np.asarray(lookup.batch_inverse(jnp.asarray(x)))
    xz = rand_fr(99, 5)
    xz[2] = 0
    out["binv/in_zero"] = xz
    out["binv/out_zero"] = np.asarray(lookup.batch_inverse(jnp.asarray(xz)))

    # the scan provers on seeded general and bit operands
    for n, r in ((5, 3), (8, 3), (1, 0)):
        a, b, u = rand_fr(10 + n, n), rand_fr(20 + n, n), rand_fr(30 + n, r)
        polys, finals = sc.inner_product_prove_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(u))
        out.update({f"scan/ip{n}/a": a, f"scan/ip{n}/b": b, f"scan/ip{n}/u": u,
                    f"scan/ip{n}/polys": np.asarray(polys), f"scan/ip{n}/finals": np.asarray(finals)})
    for n, r, bit_b in ((6, 3, False), (8, 3, False), (8, 3, True), (1, 0, False)):
        tag = f"hp{n}{'b' if bit_b else ''}"
        a = rand_fr(40 + n, n)
        b = np.asarray(mont_bits(50 + n, n)) if bit_b else rand_fr(50 + n, n)
        u, v = rand_fr(60 + n, r), rand_fr(70 + n, r)
        polys, finals = sc.hadamard_prove_scan(*(jnp.asarray(t) for t in (a, b, u, v)))
        out.update({f"scan/{tag}/a": a, f"scan/{tag}/b": b, f"scan/{tag}/u": u, f"scan/{tag}/v": v,
                    f"scan/{tag}/polys": np.asarray(polys), f"scan/{tag}/finals": np.asarray(finals)})
    for n, r, bits in ((16, 4, True), (7, 3, False), (1, 0, True)):
        tag = f"bin{n}"
        a = np.asarray(mont_bits(80 + n, n)) if bits else rand_fr(80 + n, n)
        u, v = rand_fr(90 + n, r), rand_fr(95 + n, r)
        polys, final = sc.binary_prove_scan(*(jnp.asarray(t) for t in (a, u, v)))
        out.update({f"scan/{tag}/a": a, f"scan/{tag}/u": u, f"scan/{tag}/v": v,
                    f"scan/{tag}/polys": np.asarray(polys), f"scan/{tag}/final": np.asarray(final)})

    # the general field matmul on full-width operands
    Xf, Wf = rand_fr(5, 4 * 8), rand_fr(6, 8 * 4)
    out.update({"fm/X": Xf, "fm/W": Wf,
                "fm/Z": np.asarray(zkfc.field_matmul(jnp.asarray(Xf), jnp.asarray(Wf), 8, 4))})

    # tests/test_attention.py:test_rescale_prove_verify's input
    floats = np.random.default_rng(0).standard_normal(16) * 5
    ints = []
    for f in floats:
        v = int(round(abs(f) * 2**32))
        ints.append(v if f >= 0 else (fr.P_INT - v) % fr.P_INT)
    Xr = fr.mont(jnp.asarray(fr.from_ints(ints)))
    Zr, aux = zkrescale.forward(Xr)
    out.update({"rescale/X": np.asarray(Xr), "rescale/Z": np.asarray(Zr),
                **{f"rescale/{k}": np.asarray(v) for k, v in aux.items()}})
    put_proof(out, "rescale", zkrescale.prove(Xr, aux, FiatShamir()))


def phase_committed(out: dict, verdicts: dict, parts: pathlib.Path) -> None:
    """The committed tier's proof of the honest trace."""
    attn, X, _, _ = tiny()
    _, tr = attn.forward(X)
    put_proof(out, "committed", attn.prove(tr, FiatShamir(), commit_witness=True))


def phase_committed_q(out: dict, verdicts: dict, parts: pathlib.Path) -> None:
    """The committed proof of a trace whose Q has one wrong entry
    (test_attention.py:test_attention_committed_rejects_inconsistent_rescale)."""
    attn, X, _, _ = tiny()
    _, tr = attn.forward(X)
    tr["Q"] = tr["Q"].at[1].set(fr.mont(jnp.asarray(fr.from_ints([5 << 16])))[0])
    put_proof(out, "committed_q", attn.prove(tr, FiatShamir(), commit_witness=True))


def _phase_verify(out: dict, verdicts: dict, parts: pathlib.Path, half: int) -> None:
    """The JAX verifier's verdicts on the committed proof's tampers, every
    other one (half 0 or 1), and with half 1 on the wrong-Q trace's proof."""
    attn, X, _, _ = tiny()
    Y = jnp.asarray(load(parts / "plain.npz")["trace/Y"])
    Y_bad = Y.at[0].set(fr.mont(jnp.asarray(fr.from_ints([7 << 16])))[0])
    committed = proof_from(load(parts / "committed.npz"), "committed")
    cases = [t for t in TAMPERS if t[1] == "committed"][half::2]
    for name, _, path, index, args in cases:
        verdicts[name] = verdict(attn, tampered(*committed, path, index), args, X, Y, Y_bad)
        print(f"{name}: {verdicts[name]}", file=sys.stderr, flush=True)
    if half:
        q = proof_from(load(parts / "committed_q.npz"), "committed_q")
        verdicts["trace_rescale_Q"] = verdict(attn, tampered(*q, None, None), (), X, Y, Y_bad)


def phase_verify_a(out: dict, verdicts: dict, parts: pathlib.Path) -> None:
    _phase_verify(out, verdicts, parts, 0)


def phase_verify_b(out: dict, verdicts: dict, parts: pathlib.Path) -> None:
    _phase_verify(out, verdicts, parts, 1)


# phases in the stages they run in: each stage's phases side by side, each
# in a process of its own; a phase whose part exists is not run again
STAGES = (("plain", "plain_p", "extras", "committed", "committed_q"), ("plain_verify", "verify_a", "verify_b"))
PHASES = {"plain": phase_plain, "plain_p": phase_plain_p, "extras": phase_extras, "committed": phase_committed,
          "committed_q": phase_committed_q, "plain_verify": phase_plain_verify, "verify_a": phase_verify_a,
          "verify_b": phase_verify_b}


def run_phase(name: str, parts: pathlib.Path) -> None:
    guard_compiles()
    t0 = time.perf_counter()
    out: dict = {}
    verdicts: dict = {}
    PHASES[name](out, verdicts, parts)
    save(parts / f"{name}.npz", out)
    (parts / f"{name}.json").write_text(json.dumps(verdicts))
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
    parts = pathlib.Path(sys.argv[2] if sys.argv[1:2] == ["--parts"] else tempfile.mkdtemp(prefix="record_attention_"))
    me = [sys.executable, str(pathlib.Path(__file__).resolve())]
    for stage in STAGES:
        procs = {nm: subprocess.Popen([*me, nm, str(parts)]) for nm in stage if not (parts / f"{nm}.json").exists()}
        failed = [nm for nm, p in procs.items() if p.wait()]
        if failed:
            raise SystemExit(f"phases {failed} failed; rerun with --parts {parts}")
    out: dict = {}
    verdicts: dict = {}
    for nm in PHASES:
        out.update(load(parts / f"{nm}.npz"))
        verdicts.update(json.loads((parts / f"{nm}.json").read_text()))
    for k in [k for k in out if k.startswith("committed_q:")]:
        del out[k]
    FIXTURES.mkdir(exist_ok=True)
    save(FIXTURES / "attention_jax.npz", out)
    meta = {
        "command": COMMAND,
        "jax_version": jax.__version__,
        "seq": SEQ,
        "d_model": D,
        "tampers": [[n, t, p, list(i) if i else None, list(a)] for n, t, p, i, a in TAMPERS],
        "verdicts": verdicts,
        "sources_sha256": {s: hashlib.sha256((ROOT / s).read_bytes()).hexdigest() for s in SOURCES},
    }
    (FIXTURES / "attention_jax.json").write_text(json.dumps(meta, indent=1) + "\n")
    print(f"wrote attention_jax.npz/json ({time.perf_counter() - t0:.0f}s)", file=sys.stderr)


if __name__ == "__main__":
    main()
