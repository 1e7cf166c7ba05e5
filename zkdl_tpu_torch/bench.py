"""Benchmark of the port: prints ONE JSON line with the headline metric.

    python -m zkdl_tpu_torch.bench            # BENCH_CONFIG=zkdl256 (default)

Same configurations, weight init, generator key (PRNGKey(0)) and metric as
the JAX package's bench.py (prover seconds per data point, the reference's
unit): the model is built (quantize, setup, commit), inference runs once
untimed, then the proving loop (chained Fiat-Shamir) runs twice, warm-up
then timed; the timed proof is then serialized (proof_bytes) and checked by
the port's verifier with Fiat-Shamir replay (verify_s, verify_ok). Progress
and these secondary numbers go to stderr. BENCH_CONFIG:
  zkdl256             - 8-layer 18M-parameter MLP, batch 256 (the headline)
  zkdl256_interleaved - the same, round-interleaved Fiat-Shamir
  zkdl1               - the same model, batch 1
  mid     - 4 layers, batch 32
  micro   - 2 layers of width 64, batch 4
  attention - the single-head attention block (seq 128, d_model 128) of
              bench.py:bench_attention, proved with every witness committed
              (prover seconds per row, the JAX bench's unit for it) and
              verified with Fiat-Shamir replay and the X/Y anchors
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from . import native
from .commit.pedersen import to_mont_rows
from .curve import g1
from .field import kernels
from .io import proof_io
from .models import mlp, quantize, zkattention
from .sumcheck.transcript import FiatShamir
from .utils import prng, profiling
from .utils.runtime import resolve_device

ZKDL_DIMS = [784, 1000, 1773, 1773, 1773, 1773, 1773, 1124, 1000]

# (dims, batch, baseline s/point of the CUDA reference (proxies for
# mid/micro), round-interleaved Fiat-Shamir schedule, committed-aux tier)
CONFIGS = {
    "zkdl256": (ZKDL_DIMS, 256, 0.1, False, False),
    "zkdl256_interleaved": (ZKDL_DIMS, 256, 0.1, True, False),
    "zkdl256_committed": (ZKDL_DIMS, 256, 0.1, False, True),
    "zkdl1": (ZKDL_DIMS, 1, 7.21, False, False),
    "mid": ([128, 256, 256, 128], 32, 0.1, False, False),
    "micro": ([64, 64, 64], 4, 0.1, False, False),
}


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def make_weights(dims, rng: np.random.Generator) -> list[np.ndarray]:
    """torch nn.Linear's default init range (bound 1/sqrt(fan_in)): keeps every
    pre-activation inside the protocol's 2^47 magnitude bound."""
    return [
        rng.uniform(-1.0, 1.0, (dims[i], dims[i + 1])).astype(np.float32)
        / np.sqrt(dims[i]).astype(np.float32)
        for i in range(len(dims) - 1)
    ]


def launch_counts() -> dict[str, int]:
    """Launch count of every hand-written kernel (K1-K7) so far."""
    return {k.name: k.launches for k in (*kernels.KERNELS, *g1.KERNELS)}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


ATTENTION_SEQ = ATTENTION_D = 128


def run_attention(device="cuda", split: bool = True, verify: bool = True) -> dict:
    """bench.py:bench_attention: four (d, d) weights from default_rng(0) as
    standard_normal * 0.2, ZkAttention.from_float with PRNGKey(0), the input
    from the same rng; forward, then a warm-up and a timed committed-witness
    prove (FiatShamir); the proof's size and the verify with Fiat-Shamir
    replay and the X/Y anchors. With split=True one more prove is made with
    a device synchronize after each stage (the witness commitments, then
    each sub-proof with its openings), for the stage seconds."""
    dev = resolve_device(device)
    seq, d_model = ATTENTION_SEQ, ATTENTION_D
    timer = profiling.PhaseTimer(dev)
    rng = np.random.default_rng(0)
    ws = [(rng.standard_normal((d_model, d_model)) * 0.2).astype(np.float32) for _ in range(4)]
    with timer.phase("build"):
        attn = zkattention.ZkAttention.from_float(seq, *ws, prng.PRNGKey(0), dev)
        X = to_mont_rows(quantize.load_input(rng.standard_normal((seq, d_model)).astype(np.float32), dev))
    log(f"attention block built (seq={seq}, d={d_model}): {timer.totals['build']:.3f}s")

    def prove(on_stage=None, marks=None):
        with timer.phase("forward"):
            Y, tr = attn.forward(X)
        _sync(dev)
        t0 = time.perf_counter()
        if marks is not None:
            marks.append(t0)
        proof = attn.prove(tr, FiatShamir(), commit_witness=True, on_stage=on_stage)
        _sync(dev)
        return Y, tr, proof, time.perf_counter() - t0

    _, _, _, warm_s = prove()
    log(f"warm-up prove: {warm_s:.3f}s")
    before = launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    Y, tr, proof, prove_s = prove()
    per_prove = {k: v - before[k] for k, v in launch_counts().items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    log(f"steady prove {prove_s:.3f}s ({prove_s / seq:.6f} s/row); kernel launches per prove "
        f"{json.dumps(per_prove)}; peak device memory {peak_gib} GiB")
    stages = None
    if split:
        stages, marks = {}, []

        def on_stage(name: str) -> None:
            _sync(dev)
            marks.append(time.perf_counter())
            stages[name] = marks[-1] - marks[-2]

        _, _, _, split_s = prove(on_stage, marks)
        log(f"prove with a synchronize a stage {split_s:.3f}s; stage seconds {json.dumps(stages)}")
    res = {"config": "attention", "seq": seq, "d_model": d_model, "weights": ws, "model": attn, "X": X, "Y": Y,
           "trace": tr, "proof": proof, "build_s": timer.totals["build"],
           "forward_s": timer.totals["forward"] / (3 if split else 2), "warm_prove_s": warm_s, "prove_s": prove_s,
           "prover_s_total": prove_s, "prover_s_per_row": prove_s / seq, "stage_s": stages,
           "launches_per_prove": per_prove, "prove_peak_gib": peak_gib}
    if verify:
        native.lib()  # built at its first use: outside the timed verify
        res["proof_bytes"] = len(proof_io.serialize(proof))
        before = launch_counts()
        with timer.phase("verify"):
            ok, msg = attn.verify(proof, X=X, Y=Y, transcript=FiatShamir())
        res.update(verify_s=timer.totals["verify"], verify_ok=ok, verify_msg=msg,
                   verify_launches={k: v - before[k] for k, v in launch_counts().items()})
        log(f"proof {res['proof_bytes']} bytes; verify with replay {res['verify_s']:.3f}s ok={ok} {msg}; kernel "
            f"launches in the verify: {json.dumps(res['verify_launches'])}")
    log("phases:\n" + timer.report())
    return res


def run(config: str = "zkdl256", device="cuda", split: bool = True, verify: bool = True) -> dict:
    """Build, infer and prove one configuration. Returns the model, inputs,
    outputs, proof and timings (seconds), and the configuration's
    Fiat-Shamir schedule (interleave) and tier (commit_aux), which it proves
    and verifies. With
    verify=True the steady proof is serialized and verified (host seconds,
    verdict, kernel launches of the verify); an exception of the verifier
    propagates. With split=True one more proving run is made with a device
    synchronize after every layer, for the per-layer fc/relu seconds."""
    if config == "attention":
        return run_attention(device, split, verify)
    dev = resolve_device(device)
    dims, batch, baseline, interleave, commit_aux = CONFIGS[config]
    timer = profiling.PhaseTimer(dev)
    rng = np.random.default_rng(0)
    weights = make_weights(dims, rng)
    with timer.phase("build"):
        model = mlp.MLP.from_float_weights(weights, prng.PRNGKey(0), dev)
    build_s = timer.totals["build"]
    log(f"model built ({model.n_params} params): {build_s:.3f}s")
    X_np = rng.standard_normal((batch, dims[0])).astype(np.float32)
    X = to_mont_rows(quantize.load_input(X_np, dev))

    with timer.phase("infer"):
        Y_hat, Z_list, A_list, aux_list = model.infer(X)
    infer_s = timer.totals["infer"]
    log(f"infer: {infer_s:.3f}s")

    with timer.phase("warm-up infer + prove"):
        proof, warm_spp = mlp.prove_timed(model, X, batch, interleave=interleave, commit_aux=commit_aux)
    log(f"warmup done: {timer.totals['warm-up infer + prove']:.3f}s, spp={warm_spp:.6f}")
    before = launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    proof, spp = mlp.prove_timed(model, X, batch, interleave=interleave, commit_aux=commit_aux)
    per_prove = {k: v - before[k] for k, v in launch_counts().items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    log(f"steady-state spp={spp:.6f}; kernel launches per prove: {json.dumps(per_prove)}; "
        f"peak device memory {peak_gib} GiB")

    checked = {}
    if verify:
        native.lib()  # built at its first use: outside the timed verify
        checked["proof_bytes"] = len(proof_io.serialize(proof))
        before = launch_counts()
        with timer.phase("verify"):
            ok, msg = model.verify(proof, X=X, Y_hat=Y_hat, transcript=FiatShamir(), interleaved=interleave)
        checked.update(verify_s=timer.totals["verify"], verify_ok=ok, verify_msg=msg,
                       verify_launches={k: v - before[k] for k, v in launch_counts().items()})
        log(f"proof {checked['proof_bytes']} bytes; host verify {checked['verify_s']:.3f}s ok={ok} {msg}; "
            f"kernel launches in the verify: {json.dumps(checked['verify_launches'])}")

    layer_s = {}
    if split:
        marks = [time.perf_counter()]

        def on_layer(kind: str, i: int) -> None:
            _sync(dev)
            now = time.perf_counter()
            layer_s[f"{kind}[{i}]"] = now - marks[-1]
            marks.append(now)

        Y2, Z2, A2, aux2 = model.infer(X)
        _sync(dev)
        marks[0] = time.perf_counter()
        model.prove(X, Y2, Z2, A2, aux2, on_layer=on_layer, interleave=interleave, commit_aux=commit_aux)
        log("per-layer prove seconds: " + json.dumps(layer_s))
    log("phases:\n" + timer.report())
    return {
        "config": config, "dims": dims, "batch": batch, "baseline_spp": baseline, "interleave": interleave,
        "commit_aux": commit_aux,
        "weights": weights, "X_np": X_np, "model": model, "X": X, "Y_hat": Y_hat,
        "proof": proof, "build_s": build_s, "infer_s": infer_s,
        "warm_prove_s": warm_spp * batch, "prove_s": spp * batch, "spp": spp,
        "layer_s": layer_s, "launches_per_prove": per_prove, "prove_peak_gib": peak_gib, **checked,
    }


def main() -> None:
    config = os.environ.get("BENCH_CONFIG", "zkdl256")
    if config == "attention":
        res = run_attention(split=False)
        log(f"device: {torch.cuda.get_device_name(0)}")
        print(json.dumps({
            "metric": "prover_seconds_per_row[attention]",
            "value": res["prover_s_per_row"],
            "unit": "s/row",
            **{k: res[k] for k in ("prover_s_total", "prover_s_per_row", "proof_bytes", "verify_s", "verify_ok",
                                   "launches_per_prove", "verify_launches", "prove_peak_gib")},
        }))
        return
    if config not in CONFIGS:
        raise SystemExit(f"unknown BENCH_CONFIG {config!r}; one of {sorted(CONFIGS) + ['attention']}")
    res = run(config, split=False)
    log(f"device: {torch.cuda.get_device_name(0)}")
    print(json.dumps({
        "metric": f"prover_seconds_per_data_point[{config}]",
        "value": res["spp"],
        "unit": "s/point",
        "vs_baseline": res["baseline_spp"] / res["spp"] if res["spp"] > 0 else None,
        "verify_s": res["verify_s"],
        "proof_bytes": res["proof_bytes"],
    }))


if __name__ == "__main__":
    main()
