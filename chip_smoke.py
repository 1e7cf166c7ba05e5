#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: the quickest proof that it
builds and runs.

    python3 chip_smoke.py           # every phase
    python3 chip_smoke.py --comb    # phase 1 and K4's times only
    python3 chip_smoke.py --var     # phase 1, K5/K6 against plain, and their times
    python3 chip_smoke.py --var-times   # K4, K5 and K6 times only, at the verify's and the
                                        # commitments' shapes on seeded data
    python3 chip_smoke.py --attention   # phase 1, K7 against plain, and phase 7 alone
    python3 chip_smoke.py --k7-times    # K7 times only, on seeded inputs
    python3 chip_smoke.py --glv         # phase 1, K8 against plain on its edges, and K8 (beside K5)
                                        # timed at the verify's MSM shape and the blinded tier's H^b
    python3 chip_smoke.py --glv-times [FILE]   # K8 times only, in each of its forms, at those two
                                               # shapes (and FILE's launches replayed)
    python3 chip_smoke.py --save-k8-launches FILE  # every phase; phase 6 writes one committed
                                                   # verify's K8 launches to FILE
    python3 chip_smoke.py --sharded --ranks N --backend nccl|gloo
                                        # phase 1 and phase 9 on N ranks: one card a rank with
                                        # NCCL (N cards), or every rank on card 0 with gloo
    python3 chip_smoke.py --tower       # phase 1, K10-K13 against plain with their times,
                                        # phase 10 alone (its attention block built for its scores)
                                        # and K11's and K13's forms swept over launch sizes
    python3 chip_smoke.py --tower-times # K11 at 256, 4096 and 18,432 points, a K12 tree level and
                                        # K13 (beside K8, K5) at 18,432, in each form, on seeded data

`--comb`, `--var-times`, `--k7-times`, `--glv-times` and `--tower-times` time
K4 (and K5, K6; K7; K8; K11-K13) on the same seeded inputs in any checkout of
the port they are copied into, so that two versions can be compared in one
call.

Phases (each prints its own lines; any failure exits nonzero):
  1. the card's name and power limit, the host CPU's model; build of every
     CUDA kernel from csrc/ and of the verifier's host library (native/),
     all compilers started together; the registers and spill bytes of each
     K8, K11 and K13 instantiation (ptxas; a spill fails the run)
  2. each kernel against its plain PyTorch version on the card, bit for bit,
     with its time at a main-path shape beside its bound; K3 also at the
     shapes where its design can break (one warp, the last-block reduction,
     odd tails, every operand p - 1, dot_many of strided halves) and timed at
     each main-path regime (flat, batched rows, dot_many of a round); K4 on
     the edge scalars (0, 1, r - 1, 2^256 - 1, r, 2^256 - r) and at 1 to 2049
     scalars, and timed at 35 (an opening) and 2048 (a commitment) on random
     scalars below r, drawn as setup draws them; K5 (variable-base scalar
     multiplication) and K6 (point addition) on the edge points and scalars
     (O + O, p + p, p + (-p) and its (r^2, -r^3, 0), the scalars 0, 1, r - 1,
     the cofactor, 2^256 - 1, r and 2^256 - r) at 1 to 4097 points, K5 in
     each of its layouts, K6 also on strided halves, with q negated and in
     bit mode; K5 timed at a NUMS clearing (4096 points x the cofactor, one
     scalar for all), at the verify's MSM and first fold level (18,432 and
     6,656 seeded points, random scalars below r), K6 at a mag_bin
     commitment's first two levels (2^23 and 2^22 pairs, bits drawn at a
     real commitment's set-bit share); K8 (GLV scalar multiplication) in
     each form on the decomposition's edge scalars (0, 1, lambda - 1,
     lambda, lambda + 1, r - 1) on G, a random point, O and (r^2, -r^3, 0)
     at 1 to 257 points and on points of order 3 (off the subgroup: K8
     builds their second table by adds), and against K5 in affine form
  3. a small model proved on the card and on the CPU (plain versions): every
     proof array identical, unchained SeededRng and chained Fiat-Shamir; the
     card's proof accepted by the port's verifier on the card and, moved to
     the CPU through the proof file format, by the same verifier there
  4. zkdl256 (8 layers at full width, batch 256) through the port's bench
     path: build from PRNGKey(0), its generators, row commitments, X and
     Y_hat against the SHA-256 digests of the JAX package's build
     (tests/port/fixtures/zkdl256_jax_build.json), infer, warm and steady
     prove, the proof's size, the port's
     verifier with Fiat-Shamir replay (every sumcheck, every opening and its
     binding to the row commitments, the chain, the ReLU recombination, the
     public anchors on X and Y_hat), per-layer split, launch count of every
     kernel (all > 0, K2 also within the verify), tampered copies of the
     proof and of Y_hat each rejected with its expected reason, Y_hat
     against a float64 forward
  5. the demo at full width: gen_benchmark's 8-layer model and batch-256
     input, then `demo --interleave --verify` (round-interleaved
     Fiat-Shamir), its output against the float model's, kernel launches of
     the run (all > 0), two tampered copies of the interleaved proof
     rejected with the JAX verifier's reasons; the demo again with
     `--commit-aux --verify`; then phase 4's model proved grouped and
     interleaved in turn (one pair), for the two schedules' spp
  6. (run after phase 4) the committed-aux tier at zkdl256, full width and
     depth (BENCH_CONFIG=zkdl256_committed): warm and steady grouped proves,
     proof bytes, the verify with Fiat-Shamir replay, the launches of every
     kernel (all > 0); nums_generators(4096) against the JAX package's
     digests (tests/port/fixtures/nums_generators_jax.json), a 2^19-element
     layer's sign commitment and 64 rows of its mag_bin commitment against
     plain; K8 held against plain and K5 and timed at the verify's
     generator MSM (relu[1]'s, 18,432 points) and K5 at the first level of
     its row commitments' MLE fold (6,656 points), a scalar per point; K8's
     launches in one committed verify (one per batch of opening checks,
     each formerly a K5 launch); K6 timed
     at a mag_bin commitment's first (bit mode) and second levels, with the
     set-bit share of its bits and the lane use of one thread a pair against
     K6's per-block list; K5's device time in one committed verify and K6's
     in one committed prove (torch.profiler) beside the sums of their
     bounds; a committed and an ordinary prove in turn; an interleaved
     committed proof verified; four tampered copies rejected with the JAX
     verifier's reasons
  7. the attention block (BENCH_CONFIG=attention: seq 128, d_model 128,
     every witness committed) through bench.run: build, forward, warm and
     steady proves, one more prove for the stage seconds, the proof's size, the verify
     with Fiat-Shamir replay and the X/Y anchors, the launches of every
     kernel in the run (all > 0, K7 among them, one K7 call a prove); K7
     (batch inversion) bit for bit against plain at n = 1, 2, 5, 4096 (also
     with a zero input) and 16,384, on the GCD's edge inputs (each alone and
     together), and in the lookup's one call over both sides (16,384 +
     4,096, also with a zero in one side only), timed at 1, 4096, 16,384
     and the two sides in one call beside its bound; three
     tampered copies rejected with the reasons of the JAX verifier on the
     recorded tiny proof (tests/port/fixtures/attention_jax.json); K5 and
     K6 held against plain and timed at the witness commitments' launches;
     the tiny block (seq 4, d 8) proved in both tiers on the card and on
     the CPU, every proof array equal, and equal to the recorded JAX
     proofs (tests/port/fixtures/attention_jax.npz); the K8 launches of
     its verify
  8. (phase 4's model, after phase 6) the blinded tier on a 2048 x 2048
     layer: commit_blinded (one K8 launch of 2048 H^b points, held against
     plain and timed), open_blinded, verify_open_blinded accepting, and
     rejecting a wrong blinder fold and a tampered value with the JAX
     verifier's reasons (tests/port/fixtures/slice11_jax.json); checkpointed
     proving of zkdl256, byte-identical to phase 4's proof, and again after
     resuming with the last four layer files removed; (after phase 5)
     zkConv2D at 28 x 28 x 32 -> 64, 3 x 3, pad 1, batch 64: the forward
     against a float64 convolution within the quantization bound, prove,
     verify, a tampered output rejected with the JAX reason, and the small
     case of tests/test_conv.py on the card equal to the CPU's proof and the
     JAX recorder's (slice11_jax.npz)
  9. (after phase 4) the multi-device prover: two ranks on the one card
     (torch.distributed, gloo, each rank's tensors on cuda:0, staged
     through host memory for the collectives), each building zkdl256 from
     PRNGKey(0), inferring it whole and proving it chained under FiatShamir
     with parallel.model.prove_sharded (dp 2), warm and steady: every rank's
     serialized proof must have the SHA-256 of phase 4's proof, the port's
     verifier must accept it with replay, K1-K4 and K9 must launch on each
     rank (launches, all-reduces and their bytes a prove printed, the
     steady prove's seconds beside phase 4's); phase 3's small model proved
     unchained (SeededRng) and committed-aux by the two ranks, equal to its
     single-device proofs; the dry run (parallel/dryrun.py) on a (1, 2)
     mesh; and pedersen.open on one zkdl256 layer's 2048 generators taken
     as opaque (K5, K6, K8), equal to open_planar's proof in affine form and
     accepted by pedersen.verify_open. Phase 2 also holds K9 (fr_collect,
     the canonical cross-rank Fr sum) bit for bit against its plain version
     on sums of n copies of p - 1, zeros and random values, n = 1 to 255,
     at 1 to 4097 values, and times it at a sharded sumcheck's width
 10. (after phase 7) the path of the last kernels, every count set to 0
     first: a forward and an inverse NTT of 2^20 values and poly_mul of two
     2^19-coefficient polynomials (K10, its product held at a random point
     on the host); g2.msm at 4096 and 18,432 points (K11, K12), each sum
     equal to the host's in affine form; the windowed G1 scalar
     multiplication at the verify's MSM shape (K13), bit-equal to phase 2's
     plain run on the same inputs; the cheap softmax (models/zkattention.py:
     softmax_aux, softmax_prove, softmax_verify) on phase 7's scores at seq
     128, d 128: card proof = CPU proof, verified, three tampered copies
     rejected with the JAX verifier's reasons. Phase 2 also holds K10
     (fr_ntt) bit for bit against plain at n = 1 ... 4096 and 2^20, forward
     and inverse, on zeros, p - 1 and random values, K11 (g2_scalar_mul, in
     each form) and K12 (g2_add, g2_sum's levels) on G2's edge points (P, Q,
     R, O, P + (-P), 2P, P + Q, 2Q, off the r-torsion subgroup) and scalars
     (0, 1, 2, 5, r - 1, r, 2^256 - 1) at 1 to 18,432 points, K12 also on
     the first tree level of g2.msm at 4096 and 18,432 points, K13
     (g1_scalar_mul_windowed, in each form) on K5's edges at 1 to 4097
     points and at the verify's MSM shape (18,432 points); and times K10 at
     2^20, K11 (each form) and K12 through g2.msm at 4096 and 18,432 points
     and on the 256-point check set, K13 (each form) at the verify's MSM
     shape beside K8 and K5
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# 32-bit integer multiply-adds per second: Hopper runs IMAD on 64 of an
# SM's 128 FP32 lanes, i.e. half the FMA rate behind the 67 TFLOP/s float32
# peak (132 SMs at 1.98 GHz): 64 * 132 * 1.98e9.
IMAD_PER_S = 16.7e12
FR_MUL_IMAD = 2 * 2 * 8 * 8 + 8  # CIOS: 128 wide products (lo + hi) + 8 m's
FR_DOT_IMAD = 2 * 8 * 8  # K3's lazy product: 64 wide products (lo + hi), no reduction
FP_MUL_IMAD = 2 * 2 * 12 * 12 + 12  # CIOS: a b and m p, 144 wide products each (lo + hi), + 12 m's
FP_SQR_IMAD = 2 * 78 + 2 * 12 * 12 + 12  # a^2 needs the 78 wide products a_i a_j, i <= j
FP_MULS_PER_WINDOW, FP_SQRS_PER_WINDOW = 7, 4  # add_mixed, generic case; squarings z1z1, hh, rr, zh2
FP_LEVELS_PER_WINDOW = 5  # add_mixed's levels of dependent products (K4 runs each level's products side by side)
G1_ADD_IMAD = 11 * FP_MUL_IMAD + 5 * FP_SQR_IMAD  # add-2007-bl, generic case (K5, K6)
G1_DBL_IMAD = 2 * FP_MUL_IMAD + 5 * FP_SQR_IMAD  # dbl-2009-l (K5)
G1_COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB  # the NUMS generators' cofactor clearing (K5)
FR_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# K5's and K13's edge scalars: r runs the generic formula to z = 0 at G's
# bit 254 (out = -acc there), 2^256 - r adds equal points at G's bit 255
G1_EDGE_SCALARS = (0, 1, FR_R - 1, G1_COFACTOR, (1 << 256) - 1, FR_R, (1 << 256) - FR_R)
# K5/K6 launch sizes held against plain: one block or warp, partial warps
# (K5's layouts hold 1, 4 or 16 points a warp), tails, a NUMS vector, K6's
# largest tile (4096 pairs) and one more
VAR_SIZES = (1, 2, 3, 5, 255, 256, 257, 4096, 4097)
NUMS_SIZE = 4096  # the largest NUMS vector of zkdl256's committed tier (mag_bin and rem_bin of a 2^19 ReLU)
# --var's seeded shapes: relu[1]'s verify launches K5 at its six openings'
# generator MSM (18,432 points) and then at its row commitments' first fold
# level (6,656 points); a 2^19-element layer's mag_bin commitment is 2^24
# bits over 4096 generators, whose tree starts with 2^23 pairs in bit mode
VAR_MSM_POINTS, VAR_FOLD_POINTS = 18432, 6656
MAG_BITS, MAG_GEN = 1 << 24, 4096
# the share of set bits of relu[1]'s mag_bin bits in the zkdl256 committed
# proof (phase 6 prints it: "mag_bin bits set")
MAG_SET_SHARE = 0.41775
Y_HAT_TOL = 1e-4  # zkdl256 Y_hat vs the float64 forward (see phase_zkdl256)
JAX_BUILD = os.path.join("tests", "port", "fixtures", "zkdl256_jax_build.json")
# Two faults of an interleaved proof (the low bit of one word flipped) and
# the JAX verifier's reason for each, which tests/port/test_torch_interleaved.py
# holds on the CPU (phase 5): (proof list, layer, field, word, reason)
INTERLEAVED_FAULTS = [
    ("fc_proofs", 0, "ip_polys", (1, 0, 2), "transcript: fc[0].u_in not derived round-interleaved"),
    ("relu_proofs", 0, "x_at_va", (0,), "transcript: relu[0].v_hp not derived round-interleaved"),
]
NUMS_JAX = os.path.join("tests", "port", "fixtures", "nums_generators_jax.json")
# The four faults of tests/test_committed_aux.py in relu[0] of a committed
# zkdl256 proof, verified as that file verifies them (X and Y_hat anchors,
# no replay), and the JAX verifier's reason for each, which
# tests/port/test_torch_committed.py holds on the 8-wide proof
COMMITTED_FAULTS = [
    ("open_mag_bin.t_folded[0, 0]",
     "relu[0] committed-aux: mag_bin@v_z: generator MSM != row-commitment MLE at u_row"),
    ("aux_coms mag and rem swapped",
     "relu[0] committed-aux: mag_bin@v_z: generator MSM != row-commitment MLE at u_row"),
    ("open_sign_rec.t_folded[0, 0]",
     "relu[0] committed-aux: sign@v_a: generator MSM != row-commitment MLE at u_row"),
    ("mag_bits_at_u rows 0 and 1 swapped",
     "relu[0] committed-aux: mag_bin@w||u_rec: folded MLE value != expected"),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(n_bytes: float, imads: float) -> tuple[float, str]:
    tb, to = n_bytes / HBM_BYTES_PER_S, imads / IMAD_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def cuda_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def same(label: str, got, want) -> None:
    import torch

    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: kernel != plain")


def max_abs_err(a, b) -> int:
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


# the instantiations that must not spill: (kernel, csrc source, entry prefix)
SPILL_FREE = (("K8", "g1_glv", "g1_glv_kernel"), ("K11", "g2", "g2_team_kernel"),
              ("K13", "g1_win", "g1_windowed_kernel"))


def phase_build(host_library: bool = True, check_spills: bool = True) -> None:
    """host_library=False builds the CUDA kernels only (--comb, which also
    runs in checkouts that predate the host library); check_spills: fail if
    ptxas spilled in any instantiation of K8, K11 or K13 (SPILL_FREE; False
    where a times-only mode builds another checkout's kernels)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    try:
        lscpu = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    except FileNotFoundError:
        lscpu = ""
    fields = {k.strip(): v.strip() for k, v in (l.split(":", 1) for l in lscpu.splitlines() if ":" in l)}
    cpu = ", ".join(f"{k} {fields[k]}" for k in ("Vendor ID", "CPU family", "Model", "Model name")
                    if k in fields) or "not read (no lscpu)"
    log(f"[host] CPU {cpu}; {len(os.sched_getaffinity(0))} usable cores (the verifier's native threads)")
    from zkdl_tpu_torch.utils import build

    secs = build.build_all(build.SOURCES + (build.HOST_SOURCES if host_library else ()))
    log(f"[build] kernels and the verifier's host library built in {secs:.2f}s (0 = already built)")
    for name in build.SOURCES:
        log(f"[build] {name}: " + build.ptxas_report(name).replace("\n", " | "))
    for kernel, name, prefix in SPILL_FREE:
        entries = {e: info for e, info in ptxas_entries(name).items() if prefix in e}
        for entry, info in entries.items():
            log(f"[build] {kernel} {entry}: {info.get('registers')} registers, {info.get('spill_stores')} bytes spill "
                f"stores, {info.get('spill_loads')} bytes spill loads, {info.get('stack')} bytes stack frame")
        spilled = [e for e, info in entries.items() if info.get("spill_stores", 0) or info.get("spill_loads", 0)]
        if check_spills and (spilled or not entries):
            raise AssertionError(f"{kernel} spills in {spilled}" if entries else f"no ptxas report of {kernel}")


def ptxas_entries(name: str) -> dict:
    """Each kernel of csrc/<name>.cu's last build as ptxas reported it:
    {"g1_glv_kernel<Pair, 1>": {"registers", "spill_stores",
    "spill_loads", "stack"}}, template arguments read from the mangled
    name."""
    import re

    from zkdl_tpu_torch.utils import build

    path = build.library_path(name).with_suffix(".log")
    out, entry, props = {}, None, None
    for line in path.read_text().splitlines() if path.exists() else []:
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = props = m.group(1)
            out[entry] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and props in out:
            out[props].update(zip(("stack", "spill_stores", "spill_loads"), map(int, m.groups())))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in out:
            out[entry]["registers"] = int(m.group(1))

    def label(mangled: str) -> str:
        # the kernel's name is the length-prefixed identifier ending in _kernel
        # that its template arguments (I...E) follow
        for m in re.finditer(r"(?=(\d+))", mangled):  # a digit run from every position
            end = m.start() + len(m.group(1))
            name = mangled[end: end + int(m.group(1))]
            if name.endswith("_kernel") and mangled[end + len(name):].startswith("I"):
                rest = mangled[end + len(name) + 1:]
                args = [a or b for a, b in re.findall(r"NS_\d+(\w+?)E|Li(\d+)E", rest.split("EEv")[0])]
                return f"{name}<{', '.join(args)}>"
        return mangled

    return {label(k): v for k, v in out.items()}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _rand_fr(rng, n: int, device):
    import torch
    from zkdl_tpu_torch.field import fr

    a = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint32)
    a[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    edges = np.stack([fr.ZERO, fr.from_int(1), fr.from_int(fr.P_INT - 1), fr.ONE_MONT])
    a[:4] = edges  # 0, 1, p - 1, R mod p at both ends
    a[-4:] = edges
    return torch.from_numpy(np.ascontiguousarray(a.T)).to(device)


def _rand_cols(rng, n: int, device):
    """(8, n) random Fr for any n >= 1 (edge values where n allows)."""
    return _rand_fr(rng, max(n, 8), device)[:, :n].contiguous()


def _halves(rng, n: int, device):
    """The four (8, n) halves of two (8, 2n) tensors, strided views as a
    sumcheck round passes them, and their round's dot_many pairs."""
    x, y = _rand_fr(rng, 2 * n, device), _rand_fr(rng, 2 * n, device)
    x0, x1, y0, y1 = x[:, :n], x[:, n:], y[:, :n], y[:, n:]
    return [(x0, y0), (x0, y1), (y0, x1), (x1, y1)]


def phase_dot_shapes(rng, dev) -> None:
    """K3 where its design can break, each bit-equal to plain: n <= 512 runs
    one warp; 4096 spreads a slot over blocks and finishes in the last
    block; odd n ends in the one-element tail; operands of p - 1 make every
    product (p - 1)^2, the accumulator's worst case; dot_many reads strided
    halves."""
    import torch
    from zkdl_tpu_torch.field import fr, kernels

    for n in (1, 2, 3, 255, 256, 257, 4096):
        a, b = _rand_cols(rng, n, dev), _rand_cols(rng, n, dev)
        same(f"fr_dot n={n}", kernels.dot(a, b), kernels.dot_plain(a, b))
    pm1 = torch.from_numpy(np.ascontiguousarray(np.repeat(fr.from_int(fr.P_INT - 1)[:, None], 1 << 22, 1))).to(dev)
    same("fr_dot all p-1 (8, 2^22)", kernels.dot(pm1, pm1), kernels.dot_plain(pm1, pm1))
    A, T = pm1.reshape(8, 2048, 2048), pm1[:, :2048].reshape(8, 1, 2048)
    same("fr_dot all p-1 (8,2048,2048).(8,1,2048)", kernels.dot(A, T), kernels.dot_plain(A, T))
    for n in (1 << 21, 1 << 10):
        pairs = _halves(rng, n, dev)
        for k in (3, 4):
            same(f"fr_dot dot_many of {k} at n={n}", kernels.dot_many(pairs[:k]), kernels.dot_many_plain(pairs[:k]))
    log("[kernels] fr_dot bit-equal to plain at n = 1, 2, 3, 255, 256, 257, 4096; all operands p-1 at (8, 2^22) "
        "and (8,2048,2048).(8,1,2048); dot_many of 3 and 4 strided halves at n = 2^21 and 2^10")


def comb_generic_windows(scal) -> int:
    """The windows of these scalars that run add_mixed's generic formula. On
    a scalar k below r, window w adds d 16^w to a prefix below 16^w, and the
    sum is at most k < r: the two never agree or cancel mod r, so no window
    adds equal points or ends at the identity. Every nonzero window runs the
    generic formula but a scalar's first, which lifts its entry with no
    product."""
    from zkdl_tpu_torch.curve import g1

    nonzero = g1._digits(scal) != 0
    return int(nonzero.sum().item()) - int(nonzero.any(dim=1).sum().item())


def comb_bound(scal) -> tuple[float, str]:
    """K4's least time on scalars below r: scalars, the two (64, 16, 12)
    tables and the (n, 12) x, y, z read or written once, against the
    multiply-adds of 7 Fp products and 4 squarings per generic window."""
    n = scal.shape[0]
    ops = comb_generic_windows(scal) * (FP_MULS_PER_WINDOW * FP_MUL_IMAD + FP_SQRS_PER_WINDOW * FP_SQR_IMAD)
    return bound_ms(n * 32 + 2 * 64 * 16 * 48 + n * 3 * 48, ops)


def comb_timing_sets(dev) -> dict:
    """K4's timed inputs: 2048 random scalars below r, with setup's
    distribution (8 uniform words, the top one reduced mod P_TOP_LIMB) from
    numpy seed 7, the set every earlier K4 time was taken on (a
    commitment's shape), and the first 35 of them (an opening)."""
    import torch
    from zkdl_tpu_torch.field import fr

    raw = np.random.default_rng(7).integers(0, 1 << 32, size=(2048, 8), dtype=np.uint32)
    raw[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    sc = torch.from_numpy(raw).to(dev)
    return {"35 scalars (one opening)": sc[:35].contiguous(), "2048 scalars (setup, one layer's commitment)": sc}


def phase_comb_times(dev, with_plain: bool = True) -> dict:
    """K4's time at an opening's and a commitment's shape beside its bound
    (and its plain version's time)."""
    from zkdl_tpu_torch.curve import g1

    out = {}
    for label, scal in comb_timing_sets(dev).items():
        ms, (bms, by) = cuda_ms(lambda: g1.generator_pow(scal), 10), comb_bound(scal)
        out[label] = {"ms": ms, "bound_ms": bms, "bound_by": by}
        plain = ""
        if with_plain:
            out[label]["plain_ms"] = pms = cuda_ms(lambda: g1.generator_pow_plain(scal), iters=2)
            plain = f"plain {pms:.2f} ms, "
        log(f"[kernels] g1_comb at {label}: {ms:.4f} ms ({plain}bound {bms:.6f} ms by {by}, {100 * bms / ms:.1f}% of "
            f"it: {comb_generic_windows(scal)} generic windows x ({FP_MULS_PER_WINDOW} Fp products + "
            f"{FP_SQRS_PER_WINDOW} squarings); the chain of one scalar is up to 64 windows x "
            f"{FP_LEVELS_PER_WINDOW} = {64 * FP_LEVELS_PER_WINDOW} dependent Fp-product levels)")
    return out


def phase_comb_shapes(rng, dev) -> None:
    """K4 bit-equal to plain at counts that fill its last block of 4 scalars
    (one a warp) partly or wholly (1, 2, 3, 7, 8, 9, 35, 256, 2048, 2049)
    and on the edge scalars, at the head of every count's set: 0, 1, r - 1,
    2^256 - 1 (top limb reduced, as setup draws it), r (the generic formula
    ends in z = 0 at window 63: p = -q there) and 2^256 - r (window 63 adds
    equal points: double)."""
    import torch
    from zkdl_tpu_torch.curve import g1
    from zkdl_tpu_torch.field import fr

    def limbs(x: int) -> np.ndarray:
        return np.array([(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)], dtype=np.uint32)

    top = np.full(8, 0xFFFFFFFF, dtype=np.uint32)
    top[7] %= np.uint32(fr.P_TOP_LIMB)
    edges = np.stack([limbs(0), limbs(1), limbs(fr.P_INT - 1), top, limbs(fr.P_INT), limbs((1 << 256) - fr.P_INT)])
    sc = rng.integers(0, 1 << 32, size=(2049, 8), dtype=np.uint32)
    sc[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    sc[: len(edges)] = edges
    for n in (1, 2, 3, 7, 8, 9, 35, 256, 2048, 2049):
        st = torch.from_numpy(sc[:n]).to(dev)
        same(f"g1_comb n={n}", torch.cat(list(g1.generator_pow(st))), torch.cat(list(g1.generator_pow_plain(st))))
    for i in range(len(edges)):  # each edge scalar alone in its group
        st = torch.from_numpy(edges[i:i + 1]).to(dev)
        same(f"g1_comb edge scalar {i}", torch.cat(list(g1.generator_pow(st))), torch.cat(list(g1.generator_pow_plain(st))))
    log("[kernels] g1_comb bit-equal to plain at n = 1, 2, 3, 7, 8, 9, 35, 256, 2048, 2049, each set headed by the "
        "edge scalars 0, 1, r-1, 2^256-1 (reduced), r (ends in z = 0 through the generic formula) and 2^256-r "
        "(window 63 adds equal points: double), and each edge scalar alone")


def _points(p, idx):
    """The points of p at the integer index tensor idx."""
    from zkdl_tpu_torch.curve import g1
    from zkdl_tpu_torch.field import mp

    return g1.G1Jac(*(mp.take(c, idx, 0) for c in p))


def _cat_points(*ps):
    import torch
    from zkdl_tpu_torch.curve import g1

    return g1.G1Jac(*(torch.cat([getattr(p, c) for p in ps]) for c in "xyz"))


def same_points(label: str, got, want) -> None:
    import torch

    same(label, torch.cat(list(got)), torch.cat(list(want)))


def point_err(got, want) -> int:
    import torch

    return max_abs_err(torch.cat(list(got)), torch.cat(list(want)))


def scalar_words(x: int):
    import torch

    return torch.tensor([(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)], dtype=torch.int64).to(torch.uint32)


def var_bound(pts, scal) -> tuple[float, str]:
    """K5's least time: points and scalars read and the products written
    once, against the multiply-adds of this data's double-and-add walk:
    top(k) doubles and popcount(k) - 1 generic adds per scalar k (the first
    add takes acc as it is; past the top bit nothing is computed)."""
    import torch
    from zkdl_tpu_torch.curve import g1

    n = pts.x.shape[0]
    bits = g1._scalar_bits(scal.reshape(-1, 8).expand(n, 8) if scal.dim() == 1 else scal)
    pop = bits.sum(1)
    idx = torch.arange(256, device=bits.device)
    top = torch.where(bits, idx, -1).max(1).values
    dbl = int(top.clamp(min=0).sum().item())
    adds = int((pop - 1).clamp(min=0).sum().item())
    n_bytes = n * 3 * 48 * 2 + (32 if scal.dim() == 1 else n * 32)
    return bound_ms(n_bytes, dbl * G1_DBL_IMAD + adds * G1_ADD_IMAD)


def add_bound(p, q) -> tuple[float, str]:
    """K6's least time on these pairs: both points read and the sum written
    once; a generic add where neither is the identity (equal points would
    double, which costs less)."""
    from zkdl_tpu_torch.curve import g1

    n = p.x.shape[0]
    generic = int((~g1.is_identity(p) & ~g1.is_identity(q)).sum().item())
    return bound_ms(n * 3 * 48 * 3, generic * G1_ADD_IMAD)


def add_bits_bound(bits, gen: int) -> tuple[float, str]:
    """K6's bit mode: the bits, the generator vector and the sums once;
    a generic add where both leaves of a pair are set (two distinct
    generators)."""
    import torch

    pairs = bits.view(torch.int32).reshape(-1, 2) != 0
    both = int((pairs[:, 0] & pairs[:, 1]).sum().item())
    return bound_ms(bits.shape[0] * 4 + gen * 3 * 48 + pairs.shape[0] * 3 * 48, both * G1_ADD_IMAD)


def g1_edge_points(dev, R):
    """K5's and K13's edge points: G, a NUMS candidate, the identity and
    (r^2, -r^3, 0), the generic formula's p + (-p) for p = R[0]."""
    import torch
    from zkdl_tpu_torch.commit import pedersen
    from zkdl_tpu_torch.curve import convert, g1, host_g1

    G = convert.jac_to_device([host_g1.GENERATOR], dev)
    cand = convert.jac_to_device([host_g1.JacPoint(x, y, 1) for _, x, y in pedersen._nums_affine(1)], dev)
    r0 = _points(R, torch.tensor([0], device=dev))
    C = g1.add_plain(r0, g1.neg(r0))
    if not (bool(g1.is_identity(C)[0]) and int(C.x.to(torch.int64).sum()) > 0):
        raise AssertionError("p + (-p) did not give (r^2, -r^3, 0)")
    return G, cand, g1.identity((1,), dev), C


def g1_scalar_edge_set(dev, R, raw, n: int):
    """n points and scalars: every one of G1_EDGE_SCALARS on every edge
    point at the head, then R's points under raw's scalars (below r)."""
    import torch

    edge_points = g1_edge_points(dev, R)
    pe = _cat_points(*[pt for pt in edge_points for _ in G1_EDGE_SCALARS])
    se = torch.stack([scalar_words(x) for _ in edge_points for x in G1_EDGE_SCALARS]).to(dev)
    k = pe.x.shape[0]
    pts = _cat_points(pe, _points(R, torch.arange(n - k, device=dev)))
    return pts, torch.cat([se, torch.from_numpy(raw[n: 2 * n - k]).to(dev)])


def phase_var(dev, records: dict) -> None:
    """K5 and K6 against their plain versions on the card, bit for bit: the
    edge inputs (K6: O + O, O + q, p + O, p + p, p + (-p) and the resulting
    (r^2, -r^3, 0) as either operand, random pairs; K5: the scalars 0, 1,
    r - 1, the cofactor, 2^256 - 1, r and 2^256 - r on the generator, a
    NUMS candidate, the identity and (r^2, -r^3, 0)) at the head of every
    size of VAR_SIZES; K6 also on strided halves, with q negated (me_step)
    and in bit mode; K5 in each layout, also with one scalar for all
    points. Then K5 timed beside
    its bound at 4096 NUMS candidates x the cofactor (the clearing of
    nums_generators(4096), the one launch with one scalar for all points);
    phase 6 times it at the verify's launches."""
    import torch
    from zkdl_tpu_torch.commit import pedersen
    from zkdl_tpu_torch.curve import convert, g1, host_g1
    from zkdl_tpu_torch.field import fr

    n = max(VAR_SIZES)
    raw = np.random.default_rng(9).integers(0, 1 << 32, size=(2 * n, 8), dtype=np.uint32)
    raw[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    R = g1.generator_pow(torch.from_numpy(raw).to(dev))  # random points (K4, held against plain in phase 2)
    G, cand, O, C = g1_edge_points(dev, R)  # C = R[0] + (-R[0]): z = 0, x = r^2, y = -r^3
    r0, r1 = _points(R, torch.tensor([0], device=dev)), _points(R, torch.tensor([1], device=dev))

    # K6: edge pairs at the head, random pairs after
    ep = _cat_points(O, O, r0, r0, r0, C, r1, C, G)
    eq = _cat_points(O, r0, O, r0, g1.neg(r0), r1, C, C, cand)
    k = ep.x.shape[0]
    p = _cat_points(ep, _points(R, torch.arange(2, 2 + n - k, device=dev)))
    q = _cat_points(eq, _points(R, torch.arange(n + 2, 2 * n - k + 2, device=dev)))
    want = g1.add_plain(p, q)
    for m in VAR_SIZES:
        same_points(f"g1_add n={m}", g1.add(_points(p, torch.arange(m, device=dev)),
                                             _points(q, torch.arange(m, device=dev))), _points(want, torch.arange(m, device=dev)))
    if int(g1.add(ep, eq).x[4].to(torch.int64).sum()) == 0:
        raise AssertionError("g1_add: p + (-p) lost its (r^2, -r^3, 0) limbs")
    flat = _cat_points(p, q)
    halves = (g1.G1Jac(*(c[0::2] for c in flat)), g1.G1Jac(*(c[1::2] for c in flat)))
    same_points("g1_add on strided halves", g1.add(*halves), g1.add_plain(*halves))
    same_points("g1_add with q negated", g1._add(p, q, neg_q=True), g1.add_plain(p, q, neg_q=True))
    bits = torch.from_numpy(np.random.default_rng(10).integers(0, 2, 2 * n).astype(np.uint32)).to(dev)
    bits[:8] = torch.tensor([0, 0, 0, 1, 1, 0, 1, 1], dtype=torch.uint32)
    for gen in (2, 64, n):
        gens = _points(R, torch.arange(gen, device=dev))
        want_b = g1.add_bits_plain(bits, gens)
        for m in VAR_SIZES:
            same_points(f"g1_add bit mode gen={gen} n={m}", g1.add_bits(bits[: 2 * m], gens),
                        _points(want_b, torch.arange(m, device=dev)))
    log(f"[kernels] g1_add bit-equal to plain at n = {', '.join(map(str, VAR_SIZES))}, each set headed by O + O, "
        "O + q, p + O, p + p (double), p + (-p) (gives (r^2, -r^3, 0)), that point as either operand and "
        f"alone, G + a NUMS candidate; on strided halves, with q negated, and in bit mode (gen 2, 64, {n})")

    # K5: every edge scalar on every edge point at the head, random after;
    # r runs the generic formula to z = 0 at G's bit 254 (out = -acc there)
    # and 2^256 - r adds equal points at G's bit 255 (double)
    pts, sc = g1_scalar_edge_set(dev, R, raw, n)
    want = g1.scalar_mul_plain(pts, sc)
    part = _points(pts, torch.arange(VAR_SIZES[-2], device=dev))
    one = {x: g1.scalar_mul_plain(part, scalar_words(x).to(dev)) for x in G1_EDGE_SCALARS}
    for form in g1.SCALAR_MUL_FORMS:
        for m in VAR_SIZES:
            idx = torch.arange(m, device=dev)
            same_points(f"g1_scalar_mul ({form}) n={m}", g1.scalar_mul(_points(pts, idx), sc[:m], form),
                        _points(want, idx))
        for x, want_one in one.items():
            same_points(f"g1_scalar_mul ({form}) one scalar {x:#x} n={VAR_SIZES[-2]}",
                        g1.scalar_mul(part, scalar_words(x).to(dev), form), want_one)
    log(f"[kernels] g1_scalar_mul bit-equal to plain in each layout ({', '.join(g1.SCALAR_MUL_FORMS)}) at n = "
        f"{', '.join(map(str, VAR_SIZES))}, each set headed by the scalars 0, 1, r-1, the cofactor, 2^256-1, r and "
        f"2^256-r on G, a NUMS candidate, O and (r^2, -r^3, 0); one scalar for all {VAR_SIZES[-2]} points, each of "
        "those scalars")

    # K5 at the NUMS clearing of nums_generators(NUMS_SIZE)
    cands = convert.jac_to_device([host_g1.JacPoint(x, y, 1) for _, x, y in pedersen._nums_affine(NUMS_SIZE)], dev)
    time_scalar_mul(records, f"{NUMS_SIZE} NUMS candidates x the cofactor", cands, scalar_words(G1_COFACTOR).to(dev))


def var_time_sets(dev) -> dict:
    """--var-times' seeded inputs: K5 at a NUMS clearing (NUMS_SIZE
    candidates x the cofactor), at the verify's MSM and first fold level
    (VAR_MSM_POINTS and VAR_FOLD_POINTS points from K4 on seeded scalars,
    each by a random scalar below r) and at the fold's levels as the verify
    runs them (VAR_FOLD_POINTS points down to 6, six challenges each on a
    sixth of the points); K6 at a mag_bin commitment's first level
    (MAG_BITS bits at MAG_SET_SHARE over MAG_GEN seeded generators, bit
    mode) and second (the strided halves of the first's sums). Only APIs
    that every version of the port since K6 has."""
    import torch
    from zkdl_tpu_torch.commit import pedersen
    from zkdl_tpu_torch.curve import convert, g1, host_g1
    from zkdl_tpu_torch.field import fr

    rng = np.random.default_rng(12)

    def below_r(m):
        raw = rng.integers(0, 1 << 32, size=(m, 8), dtype=np.uint32)
        raw[:, 7] %= np.uint32(fr.P_TOP_LIMB)
        return torch.from_numpy(raw).to(dev)

    pts = g1.generator_pow(below_r(VAR_MSM_POINTS))
    cands = convert.jac_to_device([host_g1.JacPoint(x, y, 1) for _, x, y in pedersen._nums_affine(NUMS_SIZE)], dev)
    k5 = {
        f"{NUMS_SIZE} NUMS candidates x the cofactor": (cands, scalar_words(G1_COFACTOR).to(dev)),
        f"the verify's generator MSM shape ({VAR_MSM_POINTS} points, random scalars below r)":
            (pts, below_r(VAR_MSM_POINTS)),
        f"the verify's first fold level shape ({VAR_FOLD_POINTS} points, random scalars below r)":
            (_points(pts, torch.arange(VAR_FOLD_POINTS, device=dev)), below_r(VAR_FOLD_POINTS)),
    }
    # the fold's levels as the verify runs them: six vectors side by side,
    # each point by its vector's challenge (me_step)
    m = VAR_FOLD_POINTS
    while m >= 6:
        idx = torch.arange(m, device=dev)
        k5[f"a fold level of {m} points (six challenges, each on a sixth)"] = (
            _points(pts, idx), below_r(6).repeat_interleave(-(-m // 6), 0)[:m].contiguous())
        m //= 4
    gens = g1.generator_pow(below_r(MAG_GEN))
    bits = torch.from_numpy((rng.random(MAG_BITS) < MAG_SET_SHARE).astype(np.uint32)).to(dev)
    first = g1.add_bits(bits, gens)
    halves = (g1.G1Jac(*(c[0::2] for c in first)), g1.G1Jac(*(c[1::2] for c in first)))
    k6 = {
        f"mag_bin level 1 shape, bit mode ({MAG_BITS // 2} pairs over {MAG_GEN} generators, "
        f"{MAG_SET_SHARE:g} of the bits set)": ("bits", bits, gens),
        f"mag_bin level 2 shape ({MAG_BITS // 4} pairs, strided halves)": ("add", *halves),
    }
    return {"g1_scalar_mul": k5, "g1_add": k6}


def phase_var_times(dev, sets: dict | None = None) -> dict:
    """K5 and K6 timed (CUDA events, 10 launches) on var_time_sets beside
    their bounds; K5 also in each layout where the port has them."""
    from zkdl_tpu_torch.curve import g1

    sets = sets or var_time_sets(dev)
    out = {"g1_scalar_mul": {}, "g1_add": {}}
    forms = list(getattr(g1, "SCALAR_MUL_FORMS", {"auto": 0}))
    for label, (pts, scal) in sets["g1_scalar_mul"].items():
        bms, by = var_bound(pts, scal)
        rec = out["g1_scalar_mul"][label] = {"bound_ms": bms, "bound_by": by}
        for form in forms:
            fn = (lambda: g1.scalar_mul(pts, scal)) if form == "auto" else (lambda: g1.scalar_mul(pts, scal, form))
            rec["ms" if form == "auto" else f"ms_{form}"] = ms = cuda_ms(fn, 10)
            log(f"[var] g1_scalar_mul ({form}) at {label}: {ms:.4f} ms (bound {bms:.6f} ms by {by}, "
                f"{100 * bms / ms:.2f}% of it)")
    for label, (kind, a, b) in sets["g1_add"].items():
        fn = (lambda: g1.add_bits(a, b)) if kind == "bits" else (lambda: g1.add(a, b))
        bms, by = add_bits_bound(a, b.x.shape[0]) if kind == "bits" else add_bound(a, b)
        ms = cuda_ms(fn, 10)
        out["g1_add"][label] = {"ms": ms, "bound_ms": bms, "bound_by": by}
        log(f"[var] g1_add at {label}: {ms:.4f} ms (bound {bms:.6f} ms by {by}, {100 * bms / ms:.2f}% of it)")
    return out


# ---------------------------------------------------------------------------
# K8: GLV scalar multiplication
# ---------------------------------------------------------------------------

# K8 launch sizes held against plain: one point, partial warps of each
# layout (1, 4 or 16 points a warp), a block and one more
GLV_SIZES = (1, 2, 3, 5, 17, 33, 255, 257)
BLIND_ROWS = 2048  # zkdl256's 2048 x 2048 layers: 2048 rows over 2048 generators, an H^b a row


def glv_derives(pts):
    """Per point (a CPU bool tensor), whether K8 derives phi(P)'s table from
    P's by one product an entry: P is not the identity and no jP, j = 2..14,
    is the identity (then the JAX adds t[j] = add(t[j - 1], P) of t1 from
    t[3] on all run the generic formula; by add_plain, not a kernel)."""
    from zkdl_tpu_torch.curve import g1

    pts = g1.G1Jac(*(c.reshape(-1, 12) for c in pts))
    ok, t = ~g1.is_identity(pts), pts
    for _ in range(13):
        t = g1.add_plain(t, pts)
        ok &= ~g1.is_identity(t)
    return ok.cpu()


def glv_work(pts, scal) -> tuple[int, int, int]:
    """(doubles, generic adds, Fp products) of GLV on this data, as the JAX
    formulas count them, with the second table as K8 builds it: per point
    that is not the identity, t1's double (t[2] = add(p, p)) and 13 generic
    adds and phi's product, then t2 by 14 products where K8 derives it
    (glv_derives) and by a double and 13 adds where it does not; 4 doubles
    a window below the point's highest nonzero window, and a generic add
    for each nonzero digit after its first (the first adds to the
    identity)."""
    import torch
    from zkdl_tpu_torch.curve import g1

    s1, s2 = g1.glv_decompose(scal.cpu())
    d1, d2 = g1._window_digits(s1), g1._window_digits(s2)
    nz = (d1 != 0) | (d2 != 0)
    top = torch.where(nz, torch.arange(nz.shape[1]), -1).max(1).values
    live = ~g1.is_identity(pts).cpu()
    derived = int(glv_derives(pts).sum().item())
    built = int(live.sum().item()) - derived
    digits = (d1 != 0).sum(1) + (d2 != 0).sum(1)
    dbl = int((4 * top.clamp(min=0))[live].sum().item()) + int(live.sum().item()) + built
    adds = int((digits - 1).clamp(min=0)[live].sum().item()) + 13 * int(live.sum().item()) + 13 * built
    return dbl, adds, int(live.sum().item()) + 14 * derived


def glv_bound(pts, scal) -> tuple[float, str]:
    """K8's least time: points and scalars read and the products written
    once, against the multiply-adds of this data's GLV (glv_work; the
    tables are scratch, not counted as traffic)."""
    dbl, adds, muls = glv_work(pts, scal)
    return bound_ms(pts.x.shape[0] * (3 * 48 * 2 + 32), dbl * G1_DBL_IMAD + adds * G1_ADD_IMAD + muls * FP_MUL_IMAD)


def windowed_bound(pts, scal) -> tuple[float, str]:
    """K13's least time (g1.py:scalar_mul_windowed, :187-214, 4-bit
    windows, 64 of them from the top) on this data: per
    point that is not the identity its table's double (t[2]) and 13
    generic adds, 4 doubles a window below the scalar's highest nonzero
    window, a generic add per nonzero digit after the first; the same
    bytes as K5."""
    import torch
    from zkdl_tpu_torch.curve import g1

    n = pts.x.shape[0]
    s = (scal.reshape(-1, 8).expand(n, 8) if scal.dim() == 1 else scal).cpu()
    d = g1._digits(s)  # (n, 64) 4-bit windows, LSB first
    top = torch.where(d != 0, torch.arange(64), -1).max(1).values
    live = ~g1.is_identity(pts).cpu()
    dbl = int((4 * top.clamp(min=0))[live].sum().item()) + int(live.sum().item())
    adds = int(((d != 0).sum(1) - 1).clamp(min=0)[live].sum().item()) + 13 * int(live.sum().item())
    return bound_ms(n * 3 * 48 * 2 + (32 if scal.dim() == 1 else n * 32), dbl * G1_DBL_IMAD + adds * G1_ADD_IMAD)


def ntt_bound(log_n: int, inverse: bool = False) -> tuple[float, str]:
    """K10's least time (tensor/fft.py:_ntt_core, :71-85) for a radix-2 NTT
    of 2^log_n Fr values: log_n stages of n/2 butterflies, one Fr product
    each but for the n - 1 whose twiddle is w^0 = 1 (j = 0 in every block;
    the adds are not counted); the inverse's n^-1 folded into the last
    stage (lo n^-1 +- hi (w n^-1)), n/2 products more. The input, the
    output and a table of n/2 twiddles (every stage's are in it) moved
    once."""
    n = 1 << log_n
    products = log_n * (n // 2) - (n - 1) + (n // 2 if inverse else 0)
    return bound_ms(32 * (2 * n + n // 2), products * FR_MUL_IMAD)


NTT_LOG_N = 20  # K10's main size: a transform of 2^20 values


def glv_forms() -> dict:
    """K8's forms in this checkout (GLV_FORMS; before it K8 took K5's
    SCALAR_MUL_FORMS)."""
    from zkdl_tpu_torch.curve import g1

    return getattr(g1, "GLV_FORMS", g1.SCALAR_MUL_FORMS)


def glv_edges(dev):
    """K8's edge inputs: the decomposition's edge scalars 0, 1, lambda - 1,
    lambda, lambda + 1 and r - 1 on G, a random point (z != 1), the identity
    and (r^2, -r^3, 0) (p + (-p) by the generic formula), then random points
    from K4 by random scalars below r, max(GLV_SIZES) in all."""
    import torch
    from zkdl_tpu_torch.curve import convert, g1, host_g1
    from zkdl_tpu_torch.field import fr

    n = max(GLV_SIZES)
    raw = np.random.default_rng(13).integers(0, 1 << 32, size=(2 * n, 8), dtype=np.uint32)
    raw[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    R = g1.generator_pow(torch.from_numpy(raw).to(dev))
    G = convert.jac_to_device([host_g1.GENERATOR], dev)
    O = g1.identity((1,), dev)
    r0 = _points(R, torch.tensor([0], device=dev))
    C = g1.add_plain(r0, g1.neg(r0))
    lam = g1._LAMBDA_INT
    scalars = [0, 1, lam - 1, lam, lam + 1, fr.P_INT - 1]
    head = [G, r0, O, C]
    pe = _cat_points(*[pt for pt in head for _ in scalars])
    se = torch.stack([scalar_words(x) for _ in head for x in scalars]).to(dev)
    k = pe.x.shape[0]
    pts = _cat_points(pe, _points(R, torch.arange(1, 1 + n - k, device=dev)))
    sc = torch.cat([se, torch.from_numpy(raw[n: 2 * n - k]).to(dev)])
    return pts, sc


def phase_glv(dev, records: dict) -> None:
    """K8 against its plain version on the card, bit for bit, in each form
    at every size of GLV_SIZES (each set headed by glv_edges' edge points and
    scalars) and on points of order 3; K8 against K5 in affine form on the
    largest set."""
    import torch
    from zkdl_tpu_torch.curve import convert, g1, host_g1
    from zkdl_tpu_torch.field import fp

    pts, sc = glv_edges(dev)
    want = g1.scalar_mul_glv_plain(pts, sc)
    for form in glv_forms():
        for m in GLV_SIZES:
            idx = torch.arange(m, device=dev)
            same_points(f"g1_scalar_mul_glv ({form}) n={m}", g1.scalar_mul_glv(_points(pts, idx), sc[:m], form),
                        _points(want, idx))
    if convert.affine_from_device(g1.scalar_mul_glv(pts, sc)) != convert.affine_from_device(g1.scalar_mul(pts, sc)):
        raise AssertionError("g1_scalar_mul_glv and g1_scalar_mul disagree in affine form")
    # points off the order-r subgroup, where K8 builds phi(P)'s table by adds
    # rather than from P's: (0, +-2) has order 3 (its table reaches O at t[3])
    off = convert.jac_to_device([host_g1.JacPoint(0, y, 1) for y in (2, fp.P_INT - 2) for _ in range(8)], dev)
    osc = sc[:16].contiguous()
    owant = g1.scalar_mul_glv_plain(off, osc)
    for form in glv_forms():
        same_points(f"g1_scalar_mul_glv ({form}) on points of order 3", g1.scalar_mul_glv(off, osc, form), owant)
    log(f"[kernels] g1_scalar_mul_glv bit-equal to plain in each form ({', '.join(glv_forms())}) at n = "
        f"{', '.join(map(str, GLV_SIZES))}, each set headed by the scalars 0, 1, lambda-1, lambda, lambda+1 and "
        "r-1 on G, a random point, O and (r^2, -r^3, 0), and on points of order 3 (0, +-2); equal to "
        "g1_scalar_mul in affine form")
    records.setdefault("_g1_scalar_mul_glv_shapes", {})


def time_glv(records: dict, label: str, pts, scal) -> dict:
    """K8 on (pts, scal) held bit for bit against scalar_mul_glv_plain on the
    card in every form and against K5 in affine form, then timed beside
    K5 on the same inputs and beside its bound; kept in records' K8 shapes."""
    from zkdl_tpu_torch.curve import convert, g1

    want, pms = plain_once(lambda: g1.scalar_mul_glv_plain(pts, scal))
    err = max(point_err(g1.scalar_mul_glv(pts, scal, form), want) for form in glv_forms())
    if err:
        raise AssertionError(f"g1_scalar_mul_glv differs from plain at {label}: {err}")
    if convert.affine_from_device(want) != convert.affine_from_device(g1.scalar_mul(pts, scal)):
        raise AssertionError(f"g1_scalar_mul_glv and g1_scalar_mul disagree in affine form at {label}")
    ms = {form: cuda_ms(lambda f=form: g1.scalar_mul_glv(pts, scal, f), 10) for form in glv_forms()}
    k5 = cuda_ms(lambda: g1.scalar_mul(pts, scal), 10)
    bms, by = glv_bound(pts, scal)
    k5_bms, _ = var_bound(pts, scal)
    dbl, adds, muls = glv_work(pts, scal)
    rec = records.setdefault("_g1_scalar_mul_glv_shapes", {})[label] = {
        "points": pts.x.shape[0], "ms": ms["auto"], **{f"ms_{f}": t for f, t in ms.items() if f != "auto"},
        "plain_ms": pms, "bound_ms": bms, "bound_by": by, "max_abs_err": err, "k5_ms": k5, "k5_bound_ms": k5_bms,
        "doubles": dbl, "adds": adds, "fp_products": muls}
    log(f"[kernels] g1_scalar_mul_glv at {label}: bit-equal to plain in every form, equal to g1_scalar_mul in "
        f"affine form; {ms['auto']:.4f} ms (forms: {', '.join(f'{f} {t:.4f}' for f, t in ms.items() if f != 'auto')};"
        f" plain {pms:.1f} ms, bound {bms:.6f} ms by {by} from {dbl} doubles, {adds} adds and {muls} Fp products, "
        f"{100 * bms / ms['auto']:.2f}% of it); g1_scalar_mul on the same {k5:.4f} ms (bound {k5_bms:.6f})")
    return rec


GLV_SWEEP = (256, 1024, 2048, 4096, 5120, 6144, 8192, 12288, 18432)  # --glv's launch sizes for K8's crossover


def glv_form_sweep(dev) -> dict:
    """K8 in each form at each size of GLV_SWEEP (points from K4, random
    scalars below r), every form's output equal to the others', timed over
    5 launches: where each form is fastest (auto's thresholds in
    csrc/g1_glv.cu)."""
    import torch
    from zkdl_tpu_torch.curve import g1
    from zkdl_tpu_torch.field import fr

    rng = np.random.default_rng(16)
    raw = rng.integers(0, 1 << 32, size=(2 * max(GLV_SWEEP), 8), dtype=np.uint32)
    raw[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    allp = g1.generator_pow(torch.from_numpy(raw[: max(GLV_SWEEP)]).to(dev))
    alls = torch.from_numpy(raw[max(GLV_SWEEP):]).to(dev)
    out = {}
    for n in GLV_SWEEP:
        pts, sc = g1.G1Jac(*(c[:n] for c in allp)), alls[:n].contiguous()
        ref = torch.cat(list(g1.scalar_mul_glv(pts, sc)))
        for form in glv_forms():
            if not torch.equal(torch.cat(list(g1.scalar_mul_glv(pts, sc, form))), ref):
                raise AssertionError(f"g1_scalar_mul_glv's forms disagree at {n} points")
        out[n] = {form: cuda_ms(lambda f=form: g1.scalar_mul_glv(pts, sc, f), 5) for form in glv_forms()}
        log(f"[glv] {n} points: " + ", ".join(f"{f} {t:.4f} ms" for f, t in out[n].items()))
    return out


def glv_time_sets(dev) -> dict:
    """--glv's seeded inputs: the verify's generator MSM shape (VAR_MSM_POINTS
    points from K4, random scalars below r) and the blinded tier's H^b at
    BLIND_ROWS rows (the blinding point by random_fr blinders)."""
    import torch
    from zkdl_tpu_torch.commit import pedersen
    from zkdl_tpu_torch.curve import g1
    from zkdl_tpu_torch.field import fr
    from zkdl_tpu_torch.tensor import fr_ops
    from zkdl_tpu_torch.utils import prng

    rng = np.random.default_rng(12)

    def below_r(m):
        raw = rng.integers(0, 1 << 32, size=(m, 8), dtype=np.uint32)
        raw[:, 7] %= np.uint32(fr.P_TOP_LIMB)
        return torch.from_numpy(raw).to(dev)

    H = pedersen.blinding_point(dev)
    return {
        f"the verify's generator MSM shape ({VAR_MSM_POINTS} points, random scalars below r)":
            (g1.generator_pow(below_r(VAR_MSM_POINTS)), below_r(VAR_MSM_POINTS)),
        f"the blinded tier's H^b shape ({BLIND_ROWS} rows, random blinders)":
            (g1.G1Jac(*(c.expand(BLIND_ROWS, 12) for c in H)), fr_ops.random_fr(prng.PRNGKey(7), BLIND_ROWS, dev)),
    }


def phase_glv_times(dev, launches_file: str | None = None) -> dict:
    """K8 alone on glv_time_sets' inputs, in each form of this checkout
    (CUDA events, 10 launches each), every form's output equal to auto's,
    with the SHA-256 of auto's output limbs (equal across checkouts where
    K8's bits are); and, given the file of one committed verify's K8
    launches that the full run's --save-k8-launches writes, those launches
    replayed back to back (auto, 10 times). Only APIs that every version of
    the port since K8 has, so that two checkouts can be timed in one call."""
    import hashlib

    import torch
    from zkdl_tpu_torch.curve import g1

    out = {}
    if launches_file:
        launches = [(g1.G1Jac(*(c.to(dev) for c in p)), s.to(dev)) for p, s in torch.load(launches_file)]
        outs = [torch.cat(list(g1.scalar_mul_glv(p, s))) for p, s in launches]
        ms = cuda_ms(lambda: [g1.scalar_mul_glv(p, s) for p, s in launches], 10)
        digest = hashlib.sha256(b"".join(o.cpu().numpy().tobytes() for o in outs)).hexdigest()
        out["the committed verify's K8 launches"] = {
            "auto": ms, "points": [p.x.shape[0] for p, _ in launches], "sha256": digest}
        log(f"[glv-times] one committed verify's {len(launches)} K8 launches "
            f"({', '.join(str(p.x.shape[0]) for p, _ in launches)} points): {ms:.4f} ms; output sha256 {digest[:16]}")
    for label, (pts, scal) in glv_time_sets(dev).items():
        ref = torch.cat(list(g1.scalar_mul_glv(pts, scal)))
        for form in glv_forms():
            if not torch.equal(torch.cat(list(g1.scalar_mul_glv(pts, scal, form))), ref):
                raise AssertionError(f"g1_scalar_mul_glv's forms disagree at {label}")
        rec = out[label] = {form: cuda_ms(lambda f=form: g1.scalar_mul_glv(pts, scal, f), 10)
                            for form in glv_forms()}
        rec["sha256"] = hashlib.sha256(ref.cpu().numpy().tobytes()).hexdigest()
        log(f"[glv-times] {label}: " + ", ".join(f"{f} {t:.4f} ms" for f, t in rec.items() if f != "sha256") +
            f"; output sha256 {rec['sha256'][:16]}")
    return out


def plain_once(fn):
    """fn()'s result and its device time in ms, one run (the plain versions
    take seconds a call)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_scalar_mul(records: dict, label: str, pts, scal) -> None:
    """K5 on (pts, scal) held bit for bit against scalar_mul_plain on the
    card, then timed beside its bound; kept in records' K5 shapes."""
    from zkdl_tpu_torch.curve import g1

    want, pms = plain_once(lambda: g1.scalar_mul_plain(pts, scal))
    err = max(point_err(g1.scalar_mul(pts, scal, form), want) for form in g1.SCALAR_MUL_FORMS)
    if err:
        raise AssertionError(f"g1_scalar_mul differs from plain at {label}: {err}")
    ms = {form: cuda_ms(lambda f=form: g1.scalar_mul(pts, scal, f), 10) for form in g1.SCALAR_MUL_FORMS}
    bms, by = var_bound(pts, scal)
    records.setdefault("_g1_scalar_mul_shapes", {})[label] = {
        "ms": ms["auto"], **{f"ms_{f}": t for f, t in ms.items() if f != "auto"}, "plain_ms": pms,
        "bound_ms": bms, "bound_by": by, "max_abs_err": err}
    log(f"[kernels] g1_scalar_mul at {label}: bit-equal to plain in every layout; {ms['auto']:.4f} ms (layouts: "
        f"{', '.join(f'{f} {t:.4f}' for f, t in ms.items() if f != 'auto')}; plain {pms:.1f} ms, bound "
        f"{bms:.6f} ms by {by}, {100 * bms / ms['auto']:.2f}% of it)")


def phase_kernels(records: dict) -> None:
    import torch
    from zkdl_tpu_torch.curve import g1
    from zkdl_tpu_torch.field import fr, kernels

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    random_scalar = rng.integers(0, 1 << 32, 8, dtype=np.uint32) % np.uint32(fr.P_TOP_LIMB)
    scalars = [fr.ZERO, fr.from_int(1), fr.from_int(fr.P_INT - 1), fr.ONE_MONT, random_scalar]
    for n in (1 << 20, (1 << 20) + 37):
        a, b = _rand_fr(rng, n, dev), _rand_fr(rng, n, dev)
        got, want = kernels.mul(a, b), kernels.mul_plain(a, b)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fr_mul != plain at n={n}")
        for s in scalars:
            if not torch.equal(kernels.mul_scalar(a, s), kernels.mul_scalar_plain(a, s)):
                raise AssertionError(f"fr_mul_scalar != plain at n={n}, s={s}")
        if not torch.equal(kernels.dot(a, b), kernels.dot_plain(a, b)):
            raise AssertionError(f"fr_dot != plain at n={n}")
        log(f"[kernels] n={n}: fr_mul, fr_mul_scalar (5 scalars), fr_dot bit-equal to plain")
    A = _rand_fr(rng, 64 * 4096, dev).reshape(8, 64, 4096)
    T = _rand_fr(rng, 4096, dev).reshape(8, 1, 4096)
    if not torch.equal(kernels.dot(A, T), kernels.dot_plain(A, T)):
        raise AssertionError("batched fr_dot != plain")
    log("[kernels] fr_dot (8,64,4096).(8,1,4096) bit-equal to plain")
    phase_dot_shapes(rng, dev)

    phase_comb_shapes(rng, dev)

    # the main path's largest shapes (zkdl256): 2^22-element round halves for
    # K1-K3; the batched (8,2048,2048).(8,1,2048) dot of commit rows and the
    # W fold (B=2048 rows, one block each); the 35 opening points and the
    # 2048 commitment rows of a 2048-wide layer for K4
    n = 1 << 22
    a, b = _rand_fr(rng, n, dev), _rand_fr(rng, n, dev)
    s = scalars[-1]
    A = _rand_fr(rng, 2048 * 2048, dev).reshape(8, 2048, 2048)
    T = _rand_fr(rng, 2048, dev).reshape(8, 1, 2048)

    def comb_err(scal) -> int:
        return max_abs_err(torch.cat(list(g1.generator_pow(scal))), torch.cat(list(g1.generator_pow_plain(scal))))

    errs = {
        "fr_mul": max_abs_err(kernels.mul(a, b), kernels.mul_plain(a, b)),
        "fr_mul_scalar": max_abs_err(kernels.mul_scalar(a, s), kernels.mul_scalar_plain(a, s)),
        "fr_dot": max(max_abs_err(kernels.dot(a, b), kernels.dot_plain(a, b)),
                      max_abs_err(kernels.dot(A, T), kernels.dot_plain(A, T))),
        "g1_comb": max(comb_err(scal) for scal in comb_timing_sets(dev).values()),
    }
    if any(errs.values()):
        raise AssertionError(f"kernels differ from their plain versions at main-path shapes: {errs}")
    log("[kernels] at main-path shapes, bit-equal to plain: fr_mul, fr_mul_scalar, fr_dot at (8, 2^22); "
        "fr_dot at (8,2048,2048).(8,1,2048); g1_comb on 35 and on 2048 scalars")

    fr_b = 32 * n
    rows = {
        "fr_mul": ("(8, 2^22)", lambda: kernels.mul(a, b), lambda: kernels.mul_plain(a, b),
                   bound_ms(3 * fr_b, FR_MUL_IMAD * n)),
        "fr_mul_scalar": ("(8, 2^22)", lambda: kernels.mul_scalar(a, s), lambda: kernels.mul_scalar_plain(a, s),
                          bound_ms(2 * fr_b, FR_MUL_IMAD * n)),
    }
    for name, (shape, kfn, pfn, (bms, by)) in rows.items():
        ms = cuda_ms(kfn)
        pms = cuda_ms(pfn, iters=2)
        records[name] = {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                         "max_abs_err": errs[name], "library_ms": None}
        log(f"[kernels] {name} at {shape}: {ms:.4f} ms (plain {pms:.2f} ms, bound {bms:.4f} ms by {by}; "
            "no single PyTorch call computes this)")
    comb = records["_g1_comb_shapes"] = phase_comb_times(dev)
    records["g1_comb"] = {**comb["35 scalars (one opening)"], "max_abs_err": errs["g1_comb"], "library_ms": None}

    # K3 in each regime of the main path. Bounds count each distinct input
    # once: a round's dot_many reads four halves, each in two of its pairs.
    dot_rows = {"(8, 2^22)": (lambda: kernels.dot(a, b), lambda: kernels.dot_plain(a, b), 2 * fr_b + 32, n),
                "(8,2048,2048).(8,1,2048)": (lambda: kernels.dot(A, T), lambda: kernels.dot_plain(A, T),
                                             fr_b + 2 * 32 * 2048, n)}
    for m in (1 << 21, 1 << 10):
        pairs = _halves(rng, m, dev)
        dot_rows[f"dot_many 4 x 2^{m.bit_length() - 1}"] = (
            lambda p=pairs: kernels.dot_many(p), lambda p=pairs: kernels.dot_many_plain(p), 4 * 32 * m + 4 * 32, 4 * m)
    shapes = records["_fr_dot_shapes"] = {}
    for label, (kfn, pfn, n_bytes, n_prod) in dot_rows.items():
        ms, pms = cuda_ms(kfn, 20), cuda_ms(pfn, iters=2)
        bms, by = bound_ms(n_bytes, FR_DOT_IMAD * n_prod)
        shapes[label] = {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by}
        log(f"[kernels] fr_dot {label}: {ms:.4f} ms (plain {pms:.2f} ms, bound {bms:.4f} ms by {by}: "
            f"{n_bytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s vs {FR_DOT_IMAD * n_prod / 1e6:.0f}M IMAD "
            f"at {IMAD_PER_S / 1e12:.1f}e12/s; {100 * bms / ms:.0f}% of the bound)")
    records["fr_dot"] = {**shapes["(8, 2^22)"], "max_abs_err": errs["fr_dot"], "library_ms": None}


# K9's edge set: sums of n copies of p - 1 over n ranks (128 the largest the
# JAX reduce_mod_p names, 255 K9's limit), zeros, random canonical values
# summed over n ranks; at each width of COLLECT_WIDTHS values
COLLECT_RANKS = (1, 2, 4, 8, 128, 255)
COLLECT_WIDTHS = (1, 2, 3, 69, 255, 256, 257, 4096, 4097)
# a zkdl256 chained sharded prove's widest K9 launch: one sumcheck's local
# rounds' polys, mag_bin's 23 rounds x 3 at 2 ranks (2^19 elements x 32 bits)
COLLECT_MAIN_WIDTH = 69


def collect_sums(rng, n_ranks: int, width: int, kind: str, device):
    """(width, 8) int64 limb sums of n_ranks canonical values each: every
    value p - 1 ("max"), 0 ("zero") or random below p ("random")."""
    import torch
    from zkdl_tpu_torch.field import fr

    if kind == "zero":
        return torch.zeros((width, 8), dtype=torch.int64, device=device)
    if kind == "max":
        row = torch.from_numpy(fr.from_int(fr.P_INT - 1).astype(np.int64))
        return (row * n_ranks).expand(width, 8).contiguous().to(device)
    vals = rng.integers(0, 1 << 32, size=(n_ranks, width, 8), dtype=np.uint64)
    vals[..., 7] %= np.uint64(fr.P_TOP_LIMB)
    return torch.from_numpy(vals.astype(np.int64).sum(0)).to(device)


def collect_bound(width: int) -> tuple[float, str]:
    """K9's bound: 64 bytes of limb sums in and 32 of value out a value; its
    ~200 integer operations a value (a carry pass, eight 9-word
    subtractions) are no multiply-adds."""
    return bound_ms(96 * width, 0)


def phase_collect(records: dict) -> None:
    """K9 (csrc/fr_collect.cu) against its plain version on the card, bit for
    bit, at every width of COLLECT_WIDTHS on the sums of n copies of p - 1,
    zeros and random values for n in COLLECT_RANKS, each also against the
    integer sum; timed at COLLECT_MAIN_WIDTH."""
    import torch
    from zkdl_tpu_torch.field import fr, kernels, mp

    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    checked = 0
    for n in COLLECT_RANKS:
        for kind in ("max", "zero", "random"):
            for w in COLLECT_WIDTHS:
                sums = collect_sums(rng, n, w, kind, dev)
                got = kernels.collect(sums)
                same(f"fr_collect {kind} n={n} width={w}", got, kernels.collect_plain(sums))
                rows = sums[:: max(1, w // 3)].cpu().numpy()
                for row, g in zip(rows, got[:: max(1, w // 3)].cpu().numpy()):
                    if mp.int_from_limbs(g) != sum(int(x) << (32 * k) for k, x in enumerate(row)) % fr.P_INT:
                        raise AssertionError(f"fr_collect {kind} n={n} width={w}: not the sum mod p")
                checked += 1
    sums = collect_sums(rng, 2, COLLECT_MAIN_WIDTH, "random", dev)
    err = max_abs_err(kernels.collect(sums), kernels.collect_plain(sums))
    ms, pms = cuda_ms(lambda: kernels.collect(sums), 50), cuda_ms(lambda: kernels.collect_plain(sums), 5)
    bms, by = collect_bound(COLLECT_MAIN_WIDTH)
    records["fr_collect"] = {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by, "max_abs_err": err,
                             "library_ms": None}
    log(f"[kernels] fr_collect (K9) bit-equal to plain on {checked} sets (n copies of p - 1, zeros, random values "
        f"over n = {', '.join(map(str, COLLECT_RANKS))} ranks at widths {', '.join(map(str, COLLECT_WIDTHS))}), "
        f"each the integer sum mod p; at {COLLECT_MAIN_WIDTH} values (a zkdl256 sharded sumcheck's local rounds) "
        f"{ms:.4f} ms (plain {pms:.3f} ms, bound {bms:.7f} ms by {by}; no PyTorch call computes it)")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def phase_small() -> None:
    from zkdl_tpu_torch.bench import make_weights
    from zkdl_tpu_torch.commit.pedersen import to_mont_rows
    from zkdl_tpu_torch.io import proof_io
    from zkdl_tpu_torch.models import mlp, quantize
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir, SeededRng
    from zkdl_tpu_torch.utils import prng

    dims, batch = [64, 64, 64], 4
    weights = make_weights(dims, np.random.default_rng(3))
    X_np = np.random.default_rng(4).standard_normal((batch, dims[0])).astype(np.float32)
    for label, mk, chain in (("SeededRng(12345), chain=False", lambda: SeededRng(12345), False),
                             ("FiatShamir, chained", FiatShamir, True)):
        flat, runs = {}, {}
        for device in ("cuda", "cpu"):
            model = mlp.MLP.from_float_weights(weights, prng.PRNGKey(5), device)
            X = to_mont_rows(quantize.load_input(X_np, device))
            Y, Z, A, aux = model.infer(X)
            proof = model.prove(X, Y, Z, A, aux, mk(), chain=chain)
            runs[device] = (model, X, Y, proof)
            flat[device] = {}
            proof_io.flatten(proof, "p", flat[device])
            proof_io.flatten([l.com for l in model.layers], "com", flat[device])
        if flat["cuda"].keys() != flat["cpu"].keys():
            raise AssertionError(f"{label}: proof trees differ")
        bad = [k for k in flat["cuda"] if not np.array_equal(flat["cuda"][k], flat["cpu"][k])]
        if bad:
            raise AssertionError(f"{label}: CUDA and CPU proofs differ at {bad[:5]}")

        def verify(model, X, Y, proof):
            if chain:
                return model.verify(proof, X=X, Y_hat=Y, transcript=FiatShamir())
            return model.verify(proof, Y_hat=Y)

        model, X, Y, proof = runs["cuda"]
        on_card = verify(model, X, Y, proof)
        moved = proof_io.load_proof(io.BytesIO(proof_io.serialize(proof)), device="cpu")
        on_cpu = verify(*runs["cpu"][:3], moved)
        if on_card != (True, "") or on_cpu != on_card:
            raise AssertionError(f"{label}: verifier on the card {on_card}, on the CPU {on_cpu}")
        log(f"[small] dims {dims} batch {batch}, {label}: {len(flat['cuda'])} arrays identical on cuda and cpu; "
            f"the card's proof accepted by the port's verifier on the card and on the CPU")


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def flipped(t, idx):
    """A copy of the uint32 tensor t (any device) with the low bit of t[idx]
    flipped."""
    import torch
    from zkdl_tpu_torch.field import mp

    a = mp.host(t).copy()
    a[idx] ^= 1
    return torch.from_numpy(a).to(t.device)


def check_tampered(res: dict) -> None:
    """Tampered copies of zkdl256's proof and of Y_hat, each rejected by the
    port's verifier with its expected reason. Each fails early in the
    verifier's order: at the transcript replay or at the cheap opening
    checks, before the row-commitment folds."""
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir

    model, proof, X, Y = res["model"], res["proof"], res["X"], res["Y_hat"]

    def relu_a_polys(p):
        p.relu_proofs[0].a_polys = flipped(p.relu_proofs[0].a_polys, (1, 2, 3))

    def final_scalar(p):
        p.fc_proofs[-1].opening.final_scalar = flipped(p.fc_proofs[-1].opening.final_scalar, (0,))

    def com_at_u_row(p):
        c = p.fc_proofs[0].opening.com_at_u_row
        p.fc_proofs[0].opening.com_at_u_row = c._replace(x=flipped(c.x, (5,)))

    n = len(model.layers)
    cases = [
        ("relu_proofs[0].a_polys", relu_a_polys, Y, "transcript: fc[0].u_in not derived from the transcript"),
        ("fc_proofs[-1].opening.final_scalar", final_scalar, Y,
         f"fc[{n - 1}]: open: final: final_gen^final_scalar != D"),
        ("fc_proofs[0].opening.com_at_u_row.x", com_at_u_row, Y, "fc[0]: open: round 0: temp != D_k"),
        ("Y_hat", None, flipped(Y, (1, 0)), f"transcript: fc[{n - 1}].u_bs not derived from the transcript"),
    ]
    for label, edit, Y_used, want in cases:
        bad = proof
        if edit is not None:
            bad = copy.deepcopy(proof)
            edit(bad)
        t0 = time.perf_counter()
        got = model.verify(bad, X=X, Y_hat=Y_used, transcript=FiatShamir())
        if got != (False, want):
            raise AssertionError(f"tampered {label}: verifier returned {got}, expected (False, {want!r})")
        log(f"[zkdl256] tampered {label}: rejected in {time.perf_counter() - t0:.3f}s: {want}")


def float_forward(weights, X_np) -> np.ndarray:
    a = X_np.astype(np.float64)
    for i, w in enumerate(weights):
        a = a @ w.astype(np.float64)
        if i + 1 < len(weights):
            a = np.maximum(a, 0.0)
    return a


def sha256(t) -> str:
    from zkdl_tpu_torch.field import mp

    return hashlib.sha256(np.ascontiguousarray(mp.host(t)).tobytes()).hexdigest()


def check_jax_build(res: dict) -> None:
    """zkdl256's generators (dlogs and points), row commitments (sigma and
    points), X and Y_hat on the card against the digests of the JAX
    package's build from the same weights and PRNGKey(0)."""
    with open(JAX_BUILD) as f:
        want = json.load(f)
    got = {"layers": [], "X": sha256(res["X"]), "Y_hat": sha256(res["Y_hat"])}
    for layer in res["model"].layers:
        got["layers"].append({
            "gen_dlogs": sha256(layer.gens.dlogs), "sigma": sha256(layer.com.dlogs),
            "gen_points": {c: sha256(getattr(layer.gens.points, c)) for c in "xyz"},
            "com_points": {c: sha256(getattr(layer.com.points, c)) for c in "xyz"},
        })
    bad = [k for k in ("X", "Y_hat") if got[k] != want[k]]
    for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        bad += [f"layer {i} {k}" for k in g if g[k] != w[k]]
    if len(got["layers"]) != len(want["layers"]) or bad:
        raise AssertionError(f"zkdl256 build differs from the JAX package's ({JAX_BUILD}): {bad}")
    log(f"[zkdl256] build equal to the JAX package's (jax {want['jax_version']}, PRNGKey(0)): generator dlogs "
        f"and points, row-commitment sigma and points of all {len(want['layers'])} layers, X and Y_hat "
        f"(SHA-256 digests in {JAX_BUILD})")


def phase_zkdl256(records: dict) -> dict:
    import torch
    from zkdl_tpu_torch import bench
    from zkdl_tpu_torch.curve import g1
    from zkdl_tpu_torch.field import kernels, planar

    for k in (*kernels.KERNELS, *g1.KERNELS):
        k.launches = 0
    res = bench.run("zkdl256", device="cuda", split=True)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in (*kernels.FR_KERNELS, g1.COMB)}  # the ordinary tier runs K1-K4
    log(f"[zkdl256] build {res['build_s']:.3f}s, infer {res['infer_s']:.3f}s, "
        f"prove warm {res['warm_prove_s']:.3f}s, steady {res['prove_s']:.3f}s, "
        f"{res['spp']:.6f} s/point, peak device memory of the prove {res['prove_peak_gib']:.2f} GiB")
    log(f"[zkdl256] per-layer prove seconds: {json.dumps(res['layer_s'])}")
    log(f"[zkdl256] launches in this run (build, infer, 3 proves): {json.dumps(launches)}")
    log(f"[zkdl256] launches per prove: {json.dumps(res['launches_per_prove'])}")
    check_jax_build(res)
    for name, count in launches.items():
        records.setdefault(name, {})["launches"] = count
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    if (res["verify_ok"], res["verify_msg"]) != (True, ""):
        raise AssertionError(f"the port's verifier rejected zkdl256's proof: {res['verify_msg']}")
    log(f"[zkdl256] proof {res['proof_bytes']} bytes; accepted by MLP.verify(X, Y_hat, FiatShamir()) in "
        f"{res['verify_s']:.3f}s host time; kernel launches in the verify: {json.dumps(res['verify_launches'])}")
    if res["verify_launches"]["fr_mul_scalar"] <= 0:
        raise AssertionError("the verify's MLE anchors launched no fr_mul_scalar (K2)")
    check_tampered(res)

    # Y_hat is at scale 2^32 (input and weights at 2^16 each); each ReLU
    # rescales by 2^16 with rounding. The weights and input come from fixed
    # seeds, so the quantization error is the same every run: 9.9e-6 against
    # |y| <= 4.6e-3. The tolerance is 10x that, 1e-4, about 2% of max |y|.
    y = planar.from_planar(planar.from_mont(planar.to_planar(res["Y_hat"])))
    from zkdl_tpu_torch.models import quantize

    got = quantize.dequantize(y, 32).reshape(res["batch"], -1)[:, : res["dims"][-1]]
    want = float_forward(res["weights"], res["X_np"])
    err, y_max = float(np.abs(got - want).max()), float(np.abs(want).max())
    log(f"[zkdl256] Y_hat vs float64 forward: max abs err {err:.3e} ({err / y_max:.2e} of |y| max "
        f"{y_max:.3e}), tolerance {Y_HAT_TOL:g}")
    if got.shape != want.shape or not np.isfinite(got).all() or err > Y_HAT_TOL:
        raise AssertionError(f"Y_hat disagrees with the float64 forward: {err}")
    records["_zkdl256"] = {k: res[k] for k in ("build_s", "infer_s", "warm_prove_s", "prove_s", "spp",
                                               "prove_peak_gib", "launches_per_prove", "layer_s",
                                               "proof_bytes", "verify_s", "verify_launches")}
    return res


# ---------------------------------------------------------------------------
# phase 6: the committed-aux tier at zkdl256
# ---------------------------------------------------------------------------


def committed_fault(proof, label: str):
    """A copy of the committed proof with one fault of COMMITTED_FAULTS."""
    import dataclasses

    import torch
    from zkdl_tpu_torch.field import mp
    from zkdl_tpu_torch.models import zkrelu

    bad = copy.deepcopy(proof)
    rp = bad.relu_proofs[0]
    if label.startswith("open_mag_bin"):
        rp.open_mag_bin = dataclasses.replace(rp.open_mag_bin, t_folded=flipped(rp.open_mag_bin.t_folded, (0, 0)))
    elif label.startswith("aux_coms"):
        rp.aux_coms = zkrelu.AuxCommitments(sign=rp.aux_coms.sign, mag=rp.aux_coms.rem, rem=rp.aux_coms.mag)
    elif label.startswith("open_sign_rec"):
        rp.open_sign_rec = dataclasses.replace(rp.open_sign_rec, t_folded=flipped(rp.open_sign_rec.t_folded, (0, 0)))
    else:
        order = torch.tensor([1, 0, *range(2, rp.mag_bits_at_u.shape[0])], device=rp.mag_bits_at_u.device)
        rp.mag_bits_at_u = mp.take(rp.mag_bits_at_u, order, 0)
    return bad


def check_committed_build(res: dict) -> None:
    """nums_generators(4096) on the card against the JAX package's digests;
    relu[1]'s (2^19 elements) sign commitment and the first 64 rows of its
    mag_bin commitment, as the proof carries them (K6), against the plain
    version on the card."""
    import torch
    from zkdl_tpu_torch.commit import pedersen
    from zkdl_tpu_torch.curve import g1
    from zkdl_tpu_torch.models import zkrelu

    dev = res["X"].device
    with open(NUMS_JAX) as f:
        want = json.load(f)
    gens = pedersen.nums_generators(want["size"], dev).points
    got = {c: sha256(getattr(gens, c)) for c in "xyz"}
    if got != want["points"]:
        raise AssertionError(f"nums_generators({want['size']}) differs from the JAX package's ({NUMS_JAX})")
    log(f"[committed] nums_generators({want['size']}) on the card equal to the JAX package's (jax "
        f"{want['jax_version']}; SHA-256 of the x, y, z limbs in {NUMS_JAX})")

    _, _, _, aux = res["model"].infer(res["X"])
    sign_b, mag_b, _ = zkrelu._expand_aux_bits(aux[1]["sign_bits"], aux[1]["mag"], aux[1]["rem_bits16"],
                                               zkrelu.Q, zkrelu.R)
    coms = res["proof"].relu_proofs[1].aux_coms
    g_s = zkrelu._aux_gens(sign_b.shape[0], dev).points
    plain_sign = g1.sum_bit_rows(sign_b.reshape(-1, g_s.x.shape[0]), g_s, plain=True)
    same_points("relu[1] sign commitment", coms.sign.points, plain_sign)
    g_m = zkrelu._aux_gens(mag_b.shape[0], dev).points
    gen = g_m.x.shape[0]
    plain_mag = g1.sum_bit_rows(mag_b[: 64 * gen].reshape(64, gen), g_m, plain=True)
    same_points("relu[1] mag_bin commitment rows 0-63", _points(coms.mag.points, torch.arange(64, device=dev)),
                plain_mag)
    log(f"[committed] relu[1] (n = {sign_b.shape[0]}): the proof's sign commitment ({coms.sign.points.x.shape[0]} "
        f"rows x {g_s.x.shape[0]} generators) and the first 64 of its {coms.mag.points.x.shape[0]} mag_bin rows "
        f"(x {gen} generators) equal to the plain version on the card")


def time_commit_levels(res: dict, records: dict) -> None:
    """K6 at a zkdl256 mag_bin commitment's shapes (relu[1], 2^24 bits over
    4096 generators): its first level in bit mode (2^12 rows x 2^11 pairs)
    and its second level (strided halves of the first's sums), each beside
    its bound and the plain version, on this run's bits."""
    import torch
    from zkdl_tpu_torch.curve import g1
    from zkdl_tpu_torch.models import zkrelu

    _, _, _, aux = res["model"].infer(res["X"])
    _, mag_b, _ = zkrelu._expand_aux_bits(aux[1]["sign_bits"], aux[1]["mag"], aux[1]["rem_bits16"],
                                          zkrelu.Q, zkrelu.R)
    g_m = zkrelu._aux_gens(mag_b.shape[0], res["X"].device).points
    gen = g_m.x.shape[0]
    set_bits = mag_b.view(torch.int32) != 0
    share = float(set_bits.to(torch.float64).mean().item())
    both = set_bits.reshape(-1, 2).all(1)  # a generic pair: two NUMS generators (never the identity)
    log(f"[committed] relu[1] mag_bin bits set: {share:.6f} of {mag_b.shape[0]}; generic pairs at level 1: "
        f"{float(both.to(torch.float64).mean().item()):.6f}")
    first = g1.add_bits(mag_b, g_m)
    first_plain = g1.add_bits_plain(mag_b, g_m)
    halves = (g1.G1Jac(*(c[0::2] for c in first)), g1.G1Jac(*(c[1::2] for c in first)))
    err = max(point_err(first, first_plain), point_err(g1.add(*halves), g1.add_plain(*halves)))
    shapes = records["_g1_add_shapes"] = {}
    levels = {
        f"mag_bin level 1, bit mode ({mag_b.shape[0] // gen} rows x {gen // 2} pairs)":
            (lambda: g1.add_bits(mag_b, g_m), lambda: g1.add_bits_plain(mag_b, g_m), add_bits_bound(mag_b, gen)),
        f"mag_bin level 2 ({mag_b.shape[0] // gen} rows x {gen // 4} pairs, strided halves)":
            (lambda: g1.add(*halves), lambda: g1.add_plain(*halves), add_bound(*halves)),
    }
    generic = {next(iter(levels)): both, list(levels)[1]: ~g1.is_identity(halves[0]) & ~g1.is_identity(halves[1])}
    for label, (kfn, pfn, (bms, by)) in levels.items():
        ms, pms = cuda_ms(kfn, 10), cuda_ms(pfn, 1)
        per_thread, per_list = lane_use(generic[label])
        shapes[label] = {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                         "lane_use_thread_a_pair": per_thread, "lane_use_block_list": per_list}
        log(f"[kernels] g1_add at {label}: {ms:.4f} ms (plain {pms:.1f} ms, bound {bms:.6f} ms by {by}, "
            f"{100 * bms / ms:.2f}% of it); generic-add lanes over the lanes of the warps that run a generic add: "
            f"{per_thread:.4f} with one thread a pair, {per_list:.4f} with K6's per-block list")
    if err:
        raise AssertionError(f"g1_add differs from plain at a zkdl256 commitment's shapes: {err}")
    log("[kernels] g1_add bit-equal to plain at both levels")
    first_label = next(iter(levels))
    records["g1_add"] = {**shapes[first_label], "max_abs_err": err, "library_ms": None}


def lane_use(generic) -> tuple[float, float]:
    """Of the lanes of the warps that run a generic add, the share that run
    one, for the (n,) bool pairs: with one thread a pair (warps of 32
    consecutive pairs, the one-thread K6) and with K6's per-block list
    (tiles of 4096 pairs, as K6 takes them at a commitment's first levels,
    each tile's generic pairs in passes of 128 threads; a pass's last warp
    runs only its listed lanes)."""
    import torch

    g = generic.to(torch.int64)
    total = int(g.sum().item())
    if total == 0:
        return 1.0, 1.0
    by_warp = torch.nn.functional.pad(g, (0, (-g.shape[0]) % 32)).reshape(-1, 32).sum(1)
    thread_lanes = 32 * int((by_warp > 0).sum().item())
    by_tile = torch.nn.functional.pad(g, (0, (-g.shape[0]) % 4096)).reshape(-1, 4096).sum(1)
    list_lanes = 32 * int((4 * (by_tile // 128) + (by_tile % 128 + 31) // 32).sum().item())
    return total / thread_lanes, total / list_lanes


def profile_committed(res: dict, records: dict, save_k8: str | None = None) -> None:
    """K5's and K8's device time in one committed verify and K6's in one
    committed prove (torch.profiler, summed over the kernels' launches),
    beside the sums of the launches' bounds (var_bound, add_bound,
    add_bits_bound on each launch's own inputs, recorded while it runs;
    glv_bound on K8's, after the trace, as it runs plain adds on the card).
    save_k8: a file for the verify's K8 launches (--glv-times replays it)."""
    import torch
    from zkdl_tpu_torch.curve import g1
    from zkdl_tpu_torch.models import mlp
    from zkdl_tpu_torch.profile_prove import device_time
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir
    from zkdl_tpu_torch.utils import profiling

    bounds = {"K5 g1_scalar_mul": 0.0, "K6 g1_add": 0.0, "K8 g1_scalar_mul_glv": 0.0}
    smul, add_, bits_, glv = g1.scalar_mul, g1._add, g1.add_bits, g1.scalar_mul_glv
    k8_inputs = []  # the run's K8 launches, for glv_bound and --glv-times

    def scalar_mul(p, scal, form="auto"):
        flat = g1.G1Jac(*(c.reshape(-1, 12) for c in p))
        bounds["K5 g1_scalar_mul"] += var_bound(flat, scal if scal.dim() == 1 else scal.reshape(-1, 8))[0]
        return smul(p, scal, form)

    def scalar_mul_glv(p, scal, form="auto"):
        flat = g1.G1Jac(*(c.reshape(-1, 12) for c in p))
        k8_inputs.append(([c.clone() for c in flat], scal.reshape(-1, 8).clone()))
        return glv(p, scal, form)

    def _add(p, q, neg_q):
        bounds["K6 g1_add"] += add_bound(*(g1.G1Jac(*(c.reshape(-1, 12) for c in x)) for x in (p, q)))[0]
        return add_(p, q, neg_q)

    def add_bits(bits, gens):
        bounds["K6 g1_add"] += add_bits_bound(bits, gens.x.reshape(-1, 12).shape[0])[0]
        return bits_(bits, gens)

    model, X, Y = res["model"], res["X"], res["Y_hat"]
    out = {}
    g1.scalar_mul, g1._add, g1.add_bits, g1.scalar_mul_glv = scalar_mul, _add, add_bits, scalar_mul_glv
    try:
        for what, fn in (("verify", lambda: model.verify(res["proof"], X=X, Y_hat=Y, transcript=FiatShamir())),
                         ("prove", lambda: mlp.prove_timed(model, X, res["batch"], commit_aux=True))):
            for k in bounds:
                bounds[k] = 0.0
            k8_inputs.clear()
            torch.cuda.synchronize()
            with profiling.trace() as prof:
                fn()
                torch.cuda.synchronize()
            groups, _, _ = device_time(prof)
            bounds["K8 g1_scalar_mul_glv"] = sum(glv_bound(g1.G1Jac(*p), sc)[0] for p, sc in k8_inputs)
            out[what] = {k: {"device_ms": 1e3 * groups.get(k, [0.0, 0])[0], "launches": groups.get(k, [0.0, 0])[1],
                             "bound_ms": bounds[k]} for k in bounds}
            if what == "verify" and save_k8:
                torch.save([([c.cpu() for c in p], sc.cpu()) for p, sc in k8_inputs], save_k8)
                log(f"[committed] the verify's {len(k8_inputs)} K8 launches' inputs saved to {save_k8}")
    finally:
        g1.scalar_mul, g1._add, g1.add_bits, g1.scalar_mul_glv = smul, add_, bits_, glv
    for what, ks in out.items():
        log(f"[committed] device time of K5, K6 and K8 in one committed {what} (torch.profiler): " + "; ".join(
            f"{k} {v['device_ms']:.3f} ms over {v['launches']} launches, bound sum {v['bound_ms']:.3f} ms"
            for k, v in ks.items()))
    records["_committed_device"] = out


OPENINGS = ("open_mag_bin", "open_rem_bin", "open_mag_rec", "open_rem_rec", "open_sign_hp", "open_sign_rec")


def time_verify_scalar_muls(res: dict, records: dict) -> None:
    """K8 and K5 at the verify's own launches: relu[1]'s committed-aux checks
    (zkrelu.verify_committed, a 2^19-element layer) run once with
    g1.scalar_mul_glv and g1.scalar_mul recorded. K8's one launch is the six
    openings' generator MSM (each generator by its opening's unmonted
    t_folded entry); K5's first is the first level of the row commitments'
    MLE fold (each difference point by its vector's challenge); both a
    scalar per point, held against plain and timed (K8 also beside K5 on
    the MSM's inputs). They are K8's and K5's records in the kernels' line."""
    import torch
    from zkdl_tpu_torch.curve import g1
    from zkdl_tpu_torch.models import zkrelu
    from zkdl_tpu_torch.tensor import fr_ops

    rp = res["proof"].relu_proofs[1]
    calls, glv_calls = [], []
    smul, glv = g1.scalar_mul, g1.scalar_mul_glv

    def recorded(p, scal):
        calls.append((g1.G1Jac(*(c.clone() for c in p)), scal.clone()))
        return smul(p, scal)

    def recorded_glv(p, scal):
        glv_calls.append((g1.G1Jac(*(c.clone() for c in p)), scal.clone()))
        return glv(p, scal)

    g1.scalar_mul, g1.scalar_mul_glv = recorded, recorded_glv
    try:
        got = zkrelu.verify_committed(rp)
    finally:
        g1.scalar_mul, g1.scalar_mul_glv = smul, glv
    if got != (True, ""):
        raise AssertionError(f"relu[1]'s committed-aux checks failed: {got}")
    coms = rp.aux_coms
    msm_n = sum(getattr(rp, f).t_folded.shape[0] for f in OPENINGS)
    fold_n = sum((1 << fr_ops.ceil_log2(c.points.x.shape[0])) // 2 for c in (coms.mag, coms.rem) * 2 + (coms.sign,) * 2)
    sizes, glv_sizes = [p.x.shape[0] for p, _ in calls], [p.x.shape[0] for p, _ in glv_calls]
    if glv_sizes != [msm_n] or sizes[:1] != [fold_n] or any(s.dim() != 2 for _, s in calls + glv_calls):
        raise AssertionError(f"relu[1]'s verify launched K8 at {glv_sizes} and K5 at {sizes}, expected K8 once at the "
                             f"MSM ({msm_n}) and K5 first at the first fold level ({fold_n}), a scalar per point")
    log(f"[committed] relu[1]'s checks launch K8 once, at {msm_n} points (the generator MSM), and K5 {len(calls)} "
        f"times, at {sizes} points (the row commitments' MLE fold)")
    msm = f"the verify's generator MSM of relu[1] ({msm_n} points, a scalar per point)"
    shape = time_glv(records, msm, *glv_calls[0])
    records["g1_scalar_mul_glv"] = {**{k: shape[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                                    "max_abs_err": max(v["max_abs_err"] for v in
                                                       records["_g1_scalar_mul_glv_shapes"].values()),
                                    "library_ms": None}
    fold = f"the first MLE fold level of relu[1]'s verify ({fold_n} points, a scalar per point)"
    time_scalar_mul(records, fold, *calls[0])
    shapes = records["_g1_scalar_mul_shapes"]
    records["g1_scalar_mul"] = {**{k: v for k, v in shapes[fold].items() if k != "max_abs_err"},
                                "max_abs_err": max(v["max_abs_err"] for v in shapes.values()), "library_ms": None}
    # every K5 launch of the verify in every layout, each layout bit-equal to
    # the first (the largest is held against plain above)
    sweep = records["_g1_scalar_mul_verify_launches"] = {}
    for p, scal in calls:
        outs = {form: torch.cat(list(g1.scalar_mul(p, scal, form))) for form in g1.SCALAR_MUL_FORMS}
        ref = next(iter(outs.values()))
        if any(not torch.equal(o, ref) for o in outs.values()):
            raise AssertionError(f"g1_scalar_mul's layouts disagree at {p.x.shape[0]} points")
        sweep[p.x.shape[0]] = {form: cuda_ms(lambda f=form: g1.scalar_mul(p, scal, f), 5) for form in outs}
        log(f"[committed] relu[1]'s verify, K5 at {p.x.shape[0]} points: " +
            ", ".join(f"{f} {t:.4f} ms" for f, t in sweep[p.x.shape[0]].items()))


def count_verify_reveals(model, proof, X, Y) -> tuple[dict, int]:
    """One committed verify with Fiat-Shamir replay: its kernel launches
    and the number of device batches of opening checks it made (each one
    K8 launch, formerly one K5 launch)."""
    from zkdl_tpu_torch import bench
    from zkdl_tpu_torch.commit import pedersen
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir

    batches = [0]
    group_math = pedersen._reveal_group_math

    def counted(checks, live):
        batches[0] += 1
        return group_math(checks, live)

    before = bench.launch_counts()
    pedersen._reveal_group_math = counted
    try:
        got = model.verify(proof, X=X, Y_hat=Y, transcript=FiatShamir())
    finally:
        pedersen._reveal_group_math = group_math
    if got != (True, ""):
        raise AssertionError(f"the committed verify failed: {got}")
    return {k: v - before[k] for k, v in bench.launch_counts().items()}, batches[0]


def phase_committed(records: dict, ordinary: dict, pairs: int = 1, save_k8: str | None = None) -> dict:
    """The committed-aux tier at zkdl256 (BENCH_CONFIG=zkdl256_committed
    through bench.run: phase 4's model, built again from PRNGKey(0), full
    width and depth): warm and steady grouped proves, the proof's size, the
    verify with Fiat-Shamir replay, per-layer seconds and the launches of
    every kernel in this run (all > 0); the NUMS generators against the JAX
    digests and the commitments against plain; K6 timed at a commitment's
    levels; `pairs` committed and ordinary grouped proves in turn; one
    interleaved committed prove verified; the four faults of
    COMMITTED_FAULTS each rejected with the JAX verifier's reason."""
    import torch
    from zkdl_tpu_torch import bench
    from zkdl_tpu_torch.curve import g1
    from zkdl_tpu_torch.field import kernels
    from zkdl_tpu_torch.models import mlp
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir

    for k in (*kernels.KERNELS, *g1.KERNELS):
        k.launches = 0
    res = bench.run("zkdl256_committed", device="cuda", split=True)
    torch.cuda.synchronize()
    launches = {k: v for k, v in bench.launch_counts().items()
                if k not in (kernels.INVERSE.name, kernels.COLLECT.name)}  # K1-K6, K8
    log(f"[committed] zkdl256_committed: build {res['build_s']:.3f}s, infer {res['infer_s']:.3f}s, prove warm "
        f"{res['warm_prove_s']:.3f}s, steady {res['prove_s']:.3f}s, {res['spp']:.6f} s/point, peak device memory "
        f"of the prove {res['prove_peak_gib']:.2f} GiB")
    log(f"[committed] per-layer prove seconds: {json.dumps(res['layer_s'])}")
    log(f"[committed] launches in this run (build, infer, 3 proves, verify): {json.dumps(launches)}")
    log(f"[committed] launches per prove: {json.dumps(res['launches_per_prove'])}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the committed path")
    if (res["verify_ok"], res["verify_msg"]) != (True, ""):
        raise AssertionError(f"the port's verifier rejected the committed zkdl256 proof: {res['verify_msg']}")
    log(f"[committed] proof {res['proof_bytes']} bytes; accepted by MLP.verify(X, Y_hat, FiatShamir()) in "
        f"{res['verify_s']:.3f}s; kernel launches in the verify: {json.dumps(res['verify_launches'])}")
    check_committed_build(res)
    per_verify, batches = count_verify_reveals(res["model"], res["proof"], res["X"], res["Y_hat"])
    k5, k8 = per_verify["g1_scalar_mul"], per_verify["g1_scalar_mul_glv"]
    log(f"[committed] one committed verify: {k8} K8 launches (one per batch of opening checks: {batches}) and {k5} "
        f"K5 launches, {k5 + k8} in all (before K8 every one of them was a K5 launch)")
    if k8 != batches or k8 <= 0:
        raise AssertionError(f"the committed verify made {k8} K8 launches for {batches} batches of opening checks")
    records["_committed_verify_k8"] = {"k8": k8, "k5": k5, "batches": batches}
    time_verify_scalar_muls(res, records)
    time_commit_levels(res, records)
    profile_committed(res, records, save_k8)
    for k in g1.KERNELS[1:]:
        records[k.name]["launches"] = launches[k.name]

    model, X, Y, batch = res["model"], res["X"], res["Y_hat"], res["batch"]
    spp = {"committed": [], "ordinary": []}
    for _ in range(pairs):
        for name in ("committed", "ordinary"):
            spp[name].append(mlp.prove_timed(model, X, batch, commit_aux=name == "committed")[1])
    log(f"[committed] zkdl256 steady spp, grouped, alternating in this call: committed {spp['committed']}, "
        f"ordinary {spp['ordinary']} s/point (phase 4's ordinary steady: {ordinary['spp']})")

    before = bench.launch_counts()
    proof_i, spp_i = mlp.prove_timed(model, X, batch, interleave=True, commit_aux=True)
    launches_i = {k: v - before[k] for k, v in bench.launch_counts().items()}
    t0 = time.perf_counter()
    got = model.verify(proof_i, X=X, Y_hat=Y, transcript=FiatShamir(), interleaved=True)
    verify_i = time.perf_counter() - t0
    if got != (True, ""):
        raise AssertionError(f"the port's verifier rejected the interleaved committed proof: {got}")
    log(f"[committed] interleaved committed prove {spp_i:.6f} s/point, launches {json.dumps(launches_i)}; accepted "
        f"by MLP.verify(..., interleaved=True) in {verify_i:.3f}s")

    for label, want in COMMITTED_FAULTS:
        bad = committed_fault(res["proof"], label)
        t0 = time.perf_counter()
        got = model.verify(bad, X=X, Y_hat=Y)
        if got != (False, want):
            raise AssertionError(f"tampered {label}: verifier returned {got}, expected (False, {want!r})")
        log(f"[committed] tampered {label}: rejected in {time.perf_counter() - t0:.3f}s: {want}")
    records["_committed"] = {
        **{k: res[k] for k in ("build_s", "infer_s", "warm_prove_s", "prove_s", "spp", "prove_peak_gib",
                               "launches_per_prove", "layer_s", "proof_bytes", "verify_s", "verify_launches")},
        "launches": launches, "alternating_spp": spp, "interleaved_spp": spp_i,
        "interleaved_launches_per_prove": launches_i, "interleaved_verify_s": verify_i,
        "device_time": records["_committed_device"], "verify_k8": records["_committed_verify_k8"],
    }
    return res


# ---------------------------------------------------------------------------
# phase 8: the blinded tier, checkpointed proving (on phase 4's model), zkConv2D
# ---------------------------------------------------------------------------

SLICE11_JAX = os.path.join("tests", "port", "fixtures", "slice11_jax")  # record_slice11.py's .npz and .json
CONV_SHAPE = dict(h=28, w=28, c_in=32, c_out=64, kh=3, kw=3, stride=1, pad=1)  # MNIST's size, a second layer's widths
CONV_BATCH = 64


def slice11_jax() -> tuple[dict, dict]:
    """The JAX package's arrays and verdicts of record_slice11.py."""
    with np.load(SLICE11_JAX + ".npz") as z:
        keys = json.loads(bytes(z["__keys__"]).decode())
        arrays = {k: z[v] for k, v in keys.items()}
    with open(SLICE11_JAX + ".json") as f:
        return arrays, json.load(f)["verdicts"]


def phase_blinded(res: dict, records: dict) -> None:
    """The blinded tier on a 2048 x 2048 layer of phase 4's zkdl256 model
    (2048 generators, 2048 rows): commit_blinded (one K8 launch of 2048 H^b
    points, held bit for bit against plain and timed beside K5 and the
    bound), open_blinded at a random point, verify_open_blinded accepting
    it, and rejecting a wrong blinder fold and a tampered value with the
    JAX verifier's reasons (recorded on tests/test_blinded.py's setup)."""
    import torch
    from zkdl_tpu_torch.commit import pedersen
    from zkdl_tpu_torch.curve import convert, g1
    from zkdl_tpu_torch.field import fr
    from zkdl_tpu_torch.sumcheck import protocols as sc
    from zkdl_tpu_torch.tensor import fr_ops
    from zkdl_tpu_torch.utils import prng

    layer = res["model"].layers[2]
    m, gen = layer.com.points.x.shape[0], layer.gens.size
    if (m, gen) != (BLIND_ROWS, BLIND_ROWS):
        raise AssertionError(f"layer 2 has {m} rows over {gen} generators, expected {BLIND_ROWS} x {BLIND_ROWS}")
    before = g1.GLV.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    com = pedersen.commit_blinded(layer.gens, layer.weights, prng.PRNGKey(11))
    torch.cuda.synchronize()
    commit_s = time.perf_counter() - t0
    if g1.GLV.launches - before != 1:
        raise AssertionError(f"commit_blinded made {g1.GLV.launches - before} K8 launches, expected 1")
    H = pedersen.blinding_point(layer.weights.device)
    hb = (g1.G1Jac(*(c.expand(m, 12) for c in H)), pedersen.from_mont_rows(com.blinders))
    shape = time_glv(records, f"the blinded tier's H^b ({m} rows of a 2048 x 2048 layer)", *hb)
    blind = convert.affine_from_device(com.points)
    if blind == convert.affine_from_device(layer.com.points) or len(set(blind)) != m:
        raise AssertionError("the blinded commitments do not hide the rows")
    rng = np.random.default_rng(14)
    u_raw = rng.integers(0, 1 << 32, size=(fr_ops.ceil_log2(m * gen), 8), dtype=np.uint32)
    u_raw[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    u = pedersen.to_mont_rows(torch.from_numpy(u_raw)).numpy()
    t0 = time.perf_counter()
    proof, b_fold = pedersen.open_blinded(layer.gens, layer.weights, com, u)
    torch.cuda.synchronize()
    open_s = time.perf_counter() - t0
    u_ints = sc.scalars_to_ints(u)
    want = sc.scalars_to_ints(fr_ops.me_eval(layer.weights, u)[None])[0]
    b = sc.scalars_to_ints(b_fold[None])[0]
    _, verdicts = slice11_jax()
    cases = {"blind_ok": dict(b_fold=b, expected_value=want), "blind_wrong_b_fold": dict(b_fold=(b + 1) % fr.P_INT),
             "blind_tampered_value": dict(b_fold=b, expected_value=(want + 1) % fr.P_INT)}
    verify_s = {}
    for name, kw in cases.items():
        t0 = time.perf_counter()
        got = pedersen.verify_open_blinded(proof, com.public, u_ints, **kw)
        verify_s[name] = time.perf_counter() - t0
        if list(got) != verdicts[name]:
            raise AssertionError(f"blinded {name}: verifier returned {got}, the JAX verifier {verdicts[name]}")
        log(f"[blinded] {name}: {got} in {verify_s[name]:.3f}s (the JAX verifier's verdict)")
    records["_blinded"] = {"rows": m, "gen": gen, "commit_s": commit_s, "open_s": open_s, "verify_s": verify_s,
                           "k8_h_b": shape}
    log(f"[blinded] 2048 x 2048 layer: commit_blinded {commit_s:.3f}s (K8 once, {m} H^b points), open_blinded "
        f"{open_s:.3f}s, commitments distinct from the unblinded rows and from each other")


def phase_checkpoint(res: dict, records: dict) -> None:
    """Checkpointed proving of phase 4's zkdl256 model (grouped,
    FiatShamir): the proof from prove_mlp_checkpointed serializes to the
    bytes of phase 4's uninterrupted steady proof; with the files of the
    four layer proofs made last removed, the resumed proof again."""
    import torch
    from zkdl_tpu_torch.io import proof_io
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir

    model, X = res["model"], res["X"]
    Y, Z, A, aux = model.infer(X)
    want = proof_io.serialize(res["proof"])
    out = {}
    with tempfile.TemporaryDirectory() as d:
        ckpt = proof_io.ProofCheckpoint(d)
        for step in ("prove", "resume"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = proof_io.prove_mlp_checkpointed(model, X, Y, Z, A, aux, FiatShamir(), ckpt, commit_aux=False)
            torch.cuda.synchronize()
            out[f"{step}_s"] = time.perf_counter() - t0
            if proof_io.serialize(p) != want:
                raise AssertionError(f"checkpointed {step}: not byte-identical to the uninterrupted proof")
            if step == "prove":
                files = sorted(os.listdir(d))
                for name in ("relu_000.npz", "fc_000.npz", "relu_001.npz", "fc_001.npz"):
                    os.remove(os.path.join(d, name))
    records["_checkpoint"] = {**out, "files": len(files), "proof_bytes": len(want)}
    log(f"[checkpoint] zkdl256: checkpointed prove {out['prove_s']:.3f}s ({len(files)} layer files), resumed after "
        f"removing relu[0], fc[0], relu[1], fc[1] in {out['resume_s']:.3f}s; both byte-identical to phase 4's "
        f"proof ({len(want)} bytes)")


def float_conv(x, k, stride: int, pad: int) -> np.ndarray:
    """A direct float64 convolution, NHWC input, (kh, kw, C_in, C_out) kernel."""
    b, h, w, _ = x.shape
    kh, kw, _, cout = k.shape
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    oh, ow = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1
    out = np.zeros((b, oh, ow, cout))
    for i in range(oh):
        for j in range(ow):
            out[:, i, j, :] = np.tensordot(xp[:, i * stride: i * stride + kh, j * stride: j * stride + kw, :], k,
                                           axes=([1, 2, 3], [0, 1, 2]))
    return out


def signed_values(Z, scale_bits: int):
    """(n, 8) Montgomery Fr holding signed values below 2^62 -> float64, on
    the card."""
    import torch
    from zkdl_tpu_torch.field import mp, planar

    raw = planar.from_mont(planar.to_planar(Z))
    neg = planar.neg(raw)
    r, n = mp.i64(raw), mp.i64(neg)
    pos = (r[2:] == 0).all(0)
    if not bool((pos | (n[2:] == 0).all(0)).all()):
        raise AssertionError("a conv output is not a small signed value")
    v = torch.where(pos, r[0] + (r[1] << 32), -(n[0] + (n[1] << 32)))
    return v.to(torch.float64) / 2.0**scale_bits


def phase_conv(records: dict, device: str = "cuda") -> None:
    """zkConv2D at CONV_SHAPE, batch CONV_BATCH (MNIST's 28 x 28 with a
    second conv layer's 32 -> 64 channels; the repo defines no conv model,
    so this is a layer check): the forward against a float64 convolution
    within the quantization bound, prove and verify (Fiat-Shamir), a
    tampered output rejected with the JAX verifier's reason; and
    tests/test_conv.py's small prove case on the card equal to the CPU
    proof and to the JAX recorder's, array for array."""
    import torch
    from zkdl_tpu_torch.commit import pedersen
    from zkdl_tpu_torch.field import planar
    from zkdl_tpu_torch.io import proof_io
    from zkdl_tpu_torch.models import quantize, zkconv
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir
    from zkdl_tpu_torch.tensor import fr_ops
    from zkdl_tpu_torch.utils import prng

    shape = zkconv.ConvShape(**CONV_SHAPE)
    rng = np.random.default_rng(15)
    x = rng.random((CONV_BATCH, shape.h, shape.w, shape.c_in)).astype(np.float32)  # post-ReLU activations in [0, 1)
    bound_w = 1.0 / np.sqrt(shape.patch_size)  # nn.Conv2d's initial range
    k = rng.uniform(-bound_w, bound_w, (shape.kh, shape.kw, shape.c_in, shape.c_out)).astype(np.float32)

    def mont_input(x_np, dev):
        raw = planar.from_planar(quantize.float_to_fr(torch.from_numpy(x_np.reshape(-1)).to(dev))).contiguous()
        return pedersen.to_mont_rows(raw)

    dev = torch.device(device)
    t0 = time.perf_counter()
    layer = zkconv.ZkConv2D.from_float(k, shape, prng.PRNGKey(5), dev)
    X = mont_input(x, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Z = layer(X, CONV_BATCH)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    got = signed_values(Z, 32).reshape(-1, layer.fc.out_size)[:, : shape.c_out].cpu().numpy()
    got = got.reshape(CONV_BATCH, shape.oh, shape.ow, shape.c_out)
    want = float_conv(x.astype(np.float64), k.astype(np.float64), shape.stride, shape.pad)
    # the input and the kernel are rounded to 2^-16 (each error <= 2^-17), the
    # products and sums are exact: an output's error is at most
    # 2^-17 sum(|x| + |w|) + n 2^-34 over its n = patch_size taps
    tol = shape.patch_size * (2.0**-17 * (float(np.abs(x).max()) + float(np.abs(k).max())) + 2.0**-34)
    err = float(np.abs(got - want).max())
    log(f"[conv] {shape}, batch {CONV_BATCH}: build {build_s:.3f}s, forward {forward_s:.3f}s; against a float64 "
        f"convolution max abs err {err:.3e} (|z| max {float(np.abs(want).max()):.3f}), quantization bound {tol:.3e}")
    if got.shape != want.shape or not np.isfinite(got).all() or err > tol:
        raise AssertionError(f"the conv forward disagrees with the float64 convolution: {err} > {tol}")
    t0 = time.perf_counter()
    proof = layer.prove(X, Z, FiatShamir(), CONV_BATCH)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = layer.verify(proof)
    verify_s = time.perf_counter() - t0
    if ok != (True, ""):
        raise AssertionError(f"the conv proof was rejected: {ok}")
    _, verdicts = slice11_jax()
    bad = layer.verify(layer.prove(X, fr_ops.add(Z, fr_ops.ones_mont(Z.shape[0], dev)), FiatShamir(), CONV_BATCH))
    if list(bad) != verdicts["conv_tamper"]:
        raise AssertionError(f"the tampered conv output got {bad}, the JAX verifier {verdicts['conv_tamper']}")
    log(f"[conv] prove {prove_s:.3f}s, proof {len(proof_io.serialize(proof))} bytes, verify {verify_s:.3f}s: "
        f"accepted; Z + 1 rejected: {bad[1]} (the JAX verifier's reason)")

    # tests/test_conv.py's prove case: card == CPU == the JAX recorder
    arrays, _ = slice11_jax()
    rng = np.random.default_rng(4)
    small = zkconv.ConvShape(h=4, w=4, c_in=1, c_out=2, kh=3, kw=3, stride=1, pad=1)
    xs = (rng.standard_normal((1, 4, 4, 1)) * 0.5).astype(np.float32)
    ks = (rng.standard_normal((3, 3, 1, 2)) * 0.5).astype(np.float32)
    flat = {}
    for d in (device, "cpu"):
        lay = zkconv.ZkConv2D.from_float(ks, small, prng.PRNGKey(1), d)
        Xs = mont_input(xs, torch.device(d))
        out = {}
        proof_io.flatten(lay.prove(Xs, lay(Xs, 1), FiatShamir(), 1), "p", out)
        flat[d] = out
    jax = {k[len("conv_prove/proof:"):]: v for k, v in arrays.items()
           if k.startswith("conv_prove/proof:") and not k.endswith("__skeleton__")}
    for other in ("cpu", "jax"):
        b = flat["cpu"] if other == "cpu" else jax
        diff = sorted(set(flat[device]) ^ set(b)) + [k for k in b if k in flat[device] and
                                                      not np.array_equal(flat[device][k], b[k])]
        if diff:
            raise AssertionError(f"the small conv proof on the card differs from the {other} one at {diff[:5]}")
    log(f"[conv] tests/test_conv.py's prove case: the card's proof equals the CPU's and the JAX recorder's "
        f"({len(jax)} arrays)")
    records["_conv"] = {"shape": CONV_SHAPE, "batch": CONV_BATCH, "build_s": build_s, "forward_s": forward_s,
                        "max_abs_err": err, "tolerance": tol, "prove_s": prove_s, "verify_s": verify_s,
                        "proof_bytes": len(proof_io.serialize(proof))}


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------


def dequantized_lines(path: str, scale_bits: int) -> np.ndarray:
    """demo.out's raw Fr values (one a line, 64 hex digits) as signed fixed
    point."""
    from zkdl_tpu_torch.field import fr

    vals = [int(line, 16) for line in open(path).read().split()]
    return np.array([(v if v <= fr.P_INT // 2 else v - fr.P_INT) / (1 << scale_bits) for v in vals])


def phase_demo(records: dict) -> None:
    """The demo at full width, twice: with --interleave --verify and with
    --commit-aux --verify. Each: exit code 0, "Verification: OK", every
    kernel of its tier launched (K1-K4; K1-K6 with the committed tier),
    demo.out against the float model's output."""
    import torch
    from zkdl_tpu_torch import bench, demo
    from zkdl_tpu_torch.curve import g1
    from zkdl_tpu_torch.field import kernels
    from zkdl_tpu_torch.io import pt_loader
    from zkdl_tpu_torch.models import gen_benchmark

    runs = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        model_path = gen_benchmark.generate(d)
        log(f"[demo] gen_benchmark: dims {gen_benchmark.FULL_DIMS}, batch 256, in {time.perf_counter() - t0:.1f}s")
        out_path = os.path.join(d, "demo.out")
        for flag, tier in (("--interleave", (*kernels.FR_KERNELS, g1.COMB)),
                           ("--commit-aux", (*kernels.FR_KERNELS, *g1.KERNELS))):
            argv = [model_path, os.path.join(d, "sample_input.pt"), flag, "--verify", "--out", out_path]
            for k in (*kernels.KERNELS, *g1.KERNELS):
                k.launches = 0
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                rc = demo.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.name: k.launches for k in tier}
            for line in printed.getvalue().splitlines():
                log(f"[demo] {line}")
            log(f"[demo] demo.main(model, input, {flag}, --verify): exit {rc} in {wall:.1f}s; kernel launches "
                f"(build, infer, prove, verify): {json.dumps(launches)}")
            if rc != 0 or "Verification: OK" not in printed.getvalue():
                raise AssertionError(f"demo {flag} --verify failed (exit {rc})")
            for name, count in launches.items():
                if count <= 0:
                    raise AssertionError(f"kernel {name} was not launched by demo {flag}")

            # demo.out (scale 2^32) against the float32 model's own output: the
            # same architecture and nn.Linear init range as phase 4, whose
            # seeded quantization error is 9.9e-6; the float32 reference adds
            # rounding of about 1e-7 of |y|. So the tolerance is phase 4's.
            want = pt_loader.load_tensor(os.path.join(d, "sample_output.pt")).numpy().astype(np.float64)
            got = dequantized_lines(out_path, 32).reshape(want.shape[0], -1)[:, : want.shape[1]]
            err, y_max = float(np.abs(got - want).max()), float(np.abs(want).max())
            log(f"[demo] demo.out dequantized vs sample_output.pt: max abs err {err:.3e} ({err / y_max:.2e} of "
                f"|y| max {y_max:.3e}), tolerance {Y_HAT_TOL:g}")
            if not np.isfinite(got).all() or err > Y_HAT_TOL:
                raise AssertionError(f"demo.out disagrees with sample_output.pt: {err}")
            runs[flag] = {"wall_s": wall, "launches": launches, "out_max_abs_err": err}
    records["_demo"] = runs


def phase_schedules(records: dict, res: dict, pairs: int = 1) -> None:
    """Phase 4's zkdl256 model proved with the grouped and the
    round-interleaved schedule in turn, `pairs` times (steady spp of each, launches
    of one interleaved prove); the last interleaved proof is verified and
    two tampered copies are rejected with the JAX verifier's reasons."""
    from zkdl_tpu_torch import bench
    from zkdl_tpu_torch.models import mlp
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir

    model, X, Y = res["model"], res["X"], res["Y_hat"]
    spp = {"grouped": [], "interleaved": []}
    launches = proof = None
    for _ in range(pairs):
        for name in ("grouped", "interleaved"):
            before = bench.launch_counts()
            p, t = mlp.prove_timed(model, X, res["batch"], interleave=name == "interleaved")
            spp[name].append(t)
            if name == "interleaved":
                launches = {k: v - before[k] for k, v in bench.launch_counts().items()}
                proof = p
    log(f"[schedules] zkdl256 steady spp, alternating in this call: grouped {spp['grouped']}, "
        f"interleaved {spp['interleaved']} s/point; kernel launches of one interleaved prove: "
        f"{json.dumps(launches)} (grouped: {json.dumps(res['launches_per_prove'])})")
    t0 = time.perf_counter()
    got = model.verify(proof, X=X, Y_hat=Y, transcript=FiatShamir(), interleaved=True)
    verify_s = time.perf_counter() - t0
    if got != (True, ""):
        raise AssertionError(f"the port's verifier rejected the interleaved zkdl256 proof: {got}")
    log(f"[schedules] interleaved proof accepted by MLP.verify(..., interleaved=True) in {verify_s:.3f}s")
    for kind, i, field, idx, want in INTERLEAVED_FAULTS:
        bad = copy.deepcopy(proof)
        p = getattr(bad, kind)[i]
        setattr(p, field, flipped(getattr(p, field), idx))
        path = f"{kind}[{i}].{field}"
        t0 = time.perf_counter()
        got = model.verify(bad, X=X, Y_hat=Y, transcript=FiatShamir(), interleaved=True)
        if got != (False, want):
            raise AssertionError(f"tampered {path}: verifier returned {got}, expected (False, {want!r})")
        log(f"[schedules] tampered {path}: rejected in {time.perf_counter() - t0:.3f}s: {want}")
    records["_schedules"] = {"spp": spp, "interleaved_launches_per_prove": launches,
                             "interleaved_verify_s": verify_s}
# ---------------------------------------------------------------------------
# phase 9: the multi-device prover (torch.distributed ranks)
# ---------------------------------------------------------------------------

SMALL_DIMS, SMALL_BATCH = [64, 64, 64], 4  # phase 3's model
SHARDED_DEADLINE_S = 600  # a launch's ranks are killed past it


def small_model(device):
    """Phase 3's small model and input: (model, X)."""
    from zkdl_tpu_torch.bench import make_weights
    from zkdl_tpu_torch.commit.pedersen import to_mont_rows
    from zkdl_tpu_torch.models import mlp, quantize
    from zkdl_tpu_torch.utils import prng

    weights = make_weights(SMALL_DIMS, np.random.default_rng(3))
    X_np = np.random.default_rng(4).standard_normal((SMALL_BATCH, SMALL_DIMS[0])).astype(np.float32)
    return mlp.MLP.from_float_weights(weights, prng.PRNGKey(5), device), \
        to_mont_rows(quantize.load_input(X_np, device))


def proof_sha(proof) -> str:
    from zkdl_tpu_torch.io import proof_io

    return hashlib.sha256(proof_io.serialize(proof)).hexdigest()


def sharded_rank(argv) -> None:
    """One rank of phase 9 (multihost.launch target; argv: out_dir, then
    "single" where rank 0 also makes the single-device zkdl256 proof):
    zkdl256 built from PRNGKey(0) and inferred whole, then proved chained
    under FiatShamir by prove_sharded on a dp mesh of every rank, warm and
    steady (launches of every kernel and the collectives of the steady
    prove counted alone); rank 0 verifies it with replay. Then phase 3's
    small model proved unchained (SeededRng) and committed-aux, and the dry
    run on a (n/2, 2) mesh. Writes rank<r>.json (and rank 0 zkdl256.bin)."""
    import torch
    import torch.distributed as dist
    from zkdl_tpu_torch import bench
    from zkdl_tpu_torch.commit.pedersen import to_mont_rows
    from zkdl_tpu_torch.models import mlp, quantize
    from zkdl_tpu_torch.parallel import collectives, dryrun, multihost, sharded
    from zkdl_tpu_torch.parallel import model as pmodel
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir, SeededRng
    from zkdl_tpu_torch.utils import prng

    out, single = argv[0], argv[1:] == ["single"]
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = multihost.global_mesh(tp=1)
    dev = mesh.device
    rec: dict = {"rank": rank, "device": str(dev)}
    t0 = time.perf_counter()
    say = lambda msg: log(f"[rank {rank}] {time.perf_counter() - t0:.1f}s {msg}")  # noqa: E731
    say(f"joined the group of {world} on {dev}")
    rng = np.random.default_rng(0)
    dims, batch = bench.ZKDL_DIMS, 256
    model = mlp.MLP.from_float_weights(bench.make_weights(dims, rng), prng.PRNGKey(0), dev)
    X = to_mont_rows(quantize.load_input(rng.standard_normal((batch, dims[0])).astype(np.float32), dev))
    Y, Z, A, aux = model.infer(X)
    torch.cuda.synchronize(dev)
    rec["build_infer_s"] = time.perf_counter() - t0
    say("zkdl256 built and inferred")

    def prove():
        dist.barrier()
        t = time.perf_counter()
        p = pmodel.prove_sharded(model, X, Y, Z, A, aux, mesh, FiatShamir(), chain=True)
        torch.cuda.synchronize(dev)
        return p, time.perf_counter() - t

    _, rec["warm_prove_s"] = prove()
    say("warm sharded prove done")
    before = bench.launch_counts()
    collectives.reset_stats()
    proof, rec["prove_s"] = prove()
    rec["launches"] = {k: v - before[k] for k, v in bench.launch_counts().items()}
    rec["collectives"] = dict(collectives.STATS)
    rec["sha256"] = proof_sha(proof)
    say("steady sharded prove done")
    if rank == 0:
        from zkdl_tpu_torch.io import proof_io

        with open(os.path.join(out, "zkdl256.bin"), "wb") as f:
            f.write(proof_io.serialize(proof))
        t = time.perf_counter()
        rec["verify"] = list(model.verify(proof, X=X, Y_hat=Y, transcript=FiatShamir()))
        rec["verify_s"] = time.perf_counter() - t
    if single:
        dist.barrier()
        if rank == 0:
            mlp.prove_timed(model, X, batch)
            p, spp = mlp.prove_timed(model, X, batch)
            rec["single_sha256"], rec["single_prove_s"] = proof_sha(p), spp * batch
        dist.barrier()
    del model, X, Y, Z, A, aux, proof

    say("zkdl256 done")
    small, Xs = small_model(dev)
    Ys, Zs, As, auxs = small.infer(Xs)
    rec["small"] = {
        "unchained": proof_sha(pmodel.prove_sharded(small, Xs, Ys, Zs, As, auxs, mesh, SeededRng(12345))),
        "committed": proof_sha(pmodel.prove_sharded(small, Xs, Ys, Zs, As, auxs, mesh, FiatShamir(), chain=True,
                                                    commit_aux=True)),
    }
    if rank == 0:
        rec["small_single"] = {
            "unchained": proof_sha(small.prove(Xs, Ys, Zs, As, auxs, SeededRng(12345), chain=False)),
            "committed": proof_sha(small.prove(Xs, Ys, Zs, As, auxs, FiatShamir(), commit_aux=True)),
        }
    say("small model done")
    rec["dryrun"] = dryrun.run(sharded.make_mesh(shape=(world // 2, 2) if world % 2 == 0 else (world, 1)))
    say("dry run done")
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def phase_sharded(records: dict, n_ranks: int, backend: str, device: str, single_sha: str | None = None,
                  single_prove_s: float | None = None) -> None:
    """Phase 9: sharded_rank on n_ranks ranks of this host. Every rank's
    zkdl256 proof must have the SHA-256 of the single-device chained proof
    (phase 4's, or rank 0's own where single_sha is None), the port's
    verifier must accept it, K1-K4 and K9 must launch on every rank; the
    small model's sharded proofs must equal its single-device proofs; the
    dry run must pass. Prints the all-reduces and their bytes a prove and
    the steady prove's seconds beside the single-device prove's."""
    import shutil

    from zkdl_tpu_torch.field import kernels
    from zkdl_tpu_torch.parallel import multihost

    work = tempfile.mkdtemp(prefix="zkdl_sharded_")
    t0 = time.perf_counter()
    try:
        multihost.launch(f"{os.path.abspath(__file__)}:sharded_rank", n_ranks, backend, device,
                         args=[work] + ([] if single_sha else ["single"]), timeout_s=SHARDED_DEADLINE_S,
                         workdir=work)
        ranks = []
        for r in range(n_ranks):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t0
    if single_sha is None:
        single_sha, single_prove_s = ranks[0]["single_sha256"], ranks[0]["single_prove_s"]
    for rec in ranks:
        r = rec["rank"]
        if rec["sha256"] != single_sha:
            raise AssertionError(f"rank {r}'s sharded zkdl256 proof {rec['sha256']} != the single-device "
                                 f"proof {single_sha}")
        for mode, sha in rec["small"].items():
            if sha != ranks[0]["small_single"][mode]:
                raise AssertionError(f"rank {r}'s sharded {mode} proof of the small model != its single-device proof")
        launched = {k: rec["launches"][k] for k in (*(k.name for k in kernels.FR_KERNELS), "g1_comb", "fr_collect")}
        if min(launched.values()) <= 0:
            raise AssertionError(f"rank {r}: a kernel of the sharded path was not launched: {launched}")
        log(f"[sharded] rank {r} on {rec['device']}: build + infer {rec['build_infer_s']:.3f}s, sharded prove warm "
            f"{rec['warm_prove_s']:.3f}s, steady {rec['prove_s']:.3f}s; launches of the steady prove "
            f"{json.dumps(rec['launches'])}; collectives {json.dumps(rec['collectives'])}")
        log(f"[sharded] rank {r}: {rec['dryrun']}")
    if ranks[0]["verify"] != [True, ""]:
        raise AssertionError(f"the port's verifier rejected the sharded zkdl256 proof: {ranks[0]['verify']}")
    stats = ranks[0]["collectives"]
    log(f"[sharded] zkdl256 chained (FiatShamir) on {n_ranks} ranks ({backend}, {device}): every rank's proof has "
        f"the single-device proof's SHA-256 {single_sha}; accepted by MLP.verify(X, Y_hat, FiatShamir()) in "
        f"{ranks[0]['verify_s']:.3f}s; a prove makes {stats['all_reduce']} all-reduces of "
        f"{stats['all_reduce_bytes']} bytes and {stats['all_gather']} all-gathers of {stats['all_gather_bytes']} "
        f"bytes on each rank; steady sharded prove {ranks[0]['prove_s']:.3f}s beside the single-device prove's "
        f"{single_prove_s:.3f}s in this call (a record, not a claim); the small model's unchained (SeededRng) and "
        f"committed-aux sharded proofs equal its single-device proofs; {wall:.1f}s with the ranks' start")
    records.setdefault("fr_collect", {})["launches"] = ranks[0]["launches"]["fr_collect"]
    records["_sharded"] = {"ranks": n_ranks, "backend": backend, "device": device, "single_sha256": single_sha,
                           "single_prove_s": single_prove_s, "wall_s": wall,
                           **{k: [rec[k] for rec in ranks] for k in ("build_infer_s", "warm_prove_s", "prove_s",
                                                                     "launches", "collectives")},
                           "verify_s": ranks[0]["verify_s"]}


def phase_me_open(res: dict, records: dict) -> None:
    """me_open on the opaque generators of one zkdl256 layer (relu[1]'s FC,
    1024 rows over 2048 generators, treated as opaque: no dlogs): open()'s
    G1 MLE of the row commitments (K5, K6) and me_open's rounds (K8 on
    these subgroup generators, K6), against open_planar's proof in affine
    form (the final scalar exactly), accepted by pedersen.verify_open."""
    import torch
    from zkdl_tpu_torch import bench
    from zkdl_tpu_torch.commit import pedersen
    from zkdl_tpu_torch.curve import convert, g1
    from zkdl_tpu_torch.sumcheck import protocols as sc
    from zkdl_tpu_torch.tensor import fr_ops
    from zkdl_tpu_torch.utils import prng

    layer = res["model"].layers[1]
    n_vars = fr_ops.ceil_log2(layer.weights.shape[0])
    u = pedersen.to_mont_rows(fr_ops.random_fr(prng.PRNGKey(77), n_vars, "cpu"))
    want = pedersen.open_planar(layer.gens, layer.weights, layer.com, u)
    before = bench.launch_counts()
    t0 = time.perf_counter()
    got = pedersen.open(pedersen.Generators(points=layer.gens.points, glv_safe=True), layer.weights,
                        pedersen.RowCommitments(points=layer.com.points), u)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in bench.launch_counts().items() if v - before[k]}
    aff = lambda p: convert.affine_from_device(g1.G1Jac(*(c.reshape(-1, 12) for c in p)))  # noqa: E731
    for name, g, w in [("com_at_u_row", got.com_at_u_row, want.com_at_u_row), ("final_gen", got.final_gen,
                                                                                 want.final_gen)] + [
            (f"round {i}", g, w) for i, (g, w) in enumerate(zip(got.round_points, want.round_points))]:
        if aff(g) != aff(w):
            raise AssertionError(f"me_open at {layer.gens.size} generators: {name} != open_planar's in affine form")
    if not torch.equal(got.final_scalar, want.final_scalar) or len(got.round_points) != len(want.round_points):
        raise AssertionError("me_open's final scalar or round count != open_planar's")
    value = sc.scalars_to_ints(fr_ops.me_eval(layer.weights, u)[None])[0]
    ok = pedersen.verify_open(got, sc.scalars_to_ints(u), value)
    if ok != (True, ""):
        raise AssertionError(f"pedersen.verify_open rejected me_open's opening: {ok}")
    log(f"[me_open] open() on layer 1's {layer.gens.size} opaque generators ({layer.com.points.x.shape[0]} rows): "
        f"{secs:.3f}s, launches {json.dumps(launches)}; every point equal to open_planar's in affine form, the "
        f"final scalar exactly; accepted by pedersen.verify_open")
    records["_me_open"] = {"generators": layer.gens.size, "s": secs, "launches": launches}


# ---------------------------------------------------------------------------
# phase 7: the attention block and K7
# ---------------------------------------------------------------------------

ATTENTION_JAX = os.path.join("tests", "port", "fixtures", "attention_jax.npz")  # the JAX recorder's arrays
# three tampers of the JAX recorder (TAMPERS there: name, array path, index
# of the word + 1, verify arguments) run on the seq-128 proof, each with the
# JAX verifier's reason on the tiny proof (recorded in attention_jax.json,
# which tests/port/test_torch_zkattention.py holds these against): no reason
# names a size
ATTENTION_FAULTS = [
    ("committed_replay_swapped_u_x", "p.u_x", (0, 0), ("X", "Y", "transcript"),
     "transcript: u_x not transcript-derived"),
    ("committed_opening_t_folded", "p.witness.openings.at.mm_s.fa.proof.t_folded", (0, 0), (),
     "mm_s: at.mm_s.fa: binding: generator MSM != row-commitment MLE at u_row"),
    ("committed_wrong_Y", None, None, ("X", "Y_bad"), "public Y anchor mismatch"),
]
K7_SIZES = (1, 2, 5, 4096, 16384)  # one element (the inverse alone), odd, the table and the witness side
K7_SEGMENTS = (16384, 4096)  # the lookup's one call at seq 128: the witness side, then the table side
# The multiply-adds of K7's GCD (csrc/fr_inverse.cu): a batch's update_de
# (its d and e rows: 6 wide products a limb, + 2 at limb 0 for md, me and
# their two 32-bit products) and update_fg (4 wide products a limb), a wide
# product counted as 2 (lo + hi); each trip of divsteps30's inner loop makes
# 8 32-bit products (two Newton steps, w, and g, q, r += w times f, u, v)
K7_BATCH_IMAD = (2 * 2 * 2 + 2 + 2 * 2 + 8 * 6 * 2) + (2 * 2 * 2 + 8 * 4 * 2)
K7_TRIP_IMAD = 8
K7_MAX_BATCHES = 25
# the input of the most divstep batches in the seeded search of
# tests/port/test_torch_lookup.py (GCD_SLOWEST there): 19 batches of 30
K7_GCD_SLOWEST = 0x73227B5DE2E79A360ED5B065AE09D832F5A9EBD42DED0059A2833BC4183570D


def k7_gcd_imads(a: int) -> int:
    """The multiply-adds of K7's GCD of a (canonical words): the batches of
    30 divsteps and the inner trips that this input takes, as divsteps30
    runs them on the low 30-bit limbs of f and g (0 for a = 0)."""
    from zkdl_tpu_torch.field import fr

    m30, u32 = (1 << 30) - 1, (1 << 32) - 1
    f, g, eta, imads = fr.P_INT, a, -1, 0
    for _ in range(K7_MAX_BATCHES if a else 0):
        u, v, q, r, i, lf, lg = 1, 0, 0, 1, 30, f & m30, g & m30
        while True:
            low = lg | ((u32 << i) & u32)
            z = (low & -low).bit_length() - 1
            lg, u, v, eta, i = lg >> z, (u << z) & u32, (v << z) & u32, eta - z, i - z
            if i == 0:
                break
            imads += K7_TRIP_IMAD
            if eta < 0:
                eta, lf, lg, u, q, v, r = -eta, lg, -lf & u32, q, -u & u32, r, -v & u32
            mask = (u32 >> (32 - min(eta + 1, i))) & 255
            finv = lf * (2 - lf * lf) & u32
            finv = finv * (2 - lf * finv) & u32
            w = lg * (-finv & u32) & mask
            lg, q, r = (lg + lf * w) & u32, (q + u * w) & u32, (r + v * w) & u32
        u, v, q, r = (c - (1 << 32) if c >> 31 else c for c in (u, v, q, r))
        f, g, imads = (u * f + v * g) >> 30, (q * f + r * g) >> 30, imads + K7_BATCH_IMAD
        if g == 0:
            break
    return imads


def k7_bound(xs) -> tuple[float, str]:
    """K7 over the segments xs: each input read and output written once (64
    B an element); a segment of n elements needs 3 (n - 1) products
    (Montgomery's trick: a prefix, and two on the way back), one GCD of its
    product, counted for this run's data, and the product by C."""
    from zkdl_tpu_torch.field import fr

    p, r_inv = fr.P_INT, pow(1 << 256, -1, fr.P_INT)
    n_bytes, imads = 0, 0
    for x in xs:
        n, root = x.shape[0], 1
        for v in fr.to_ints(x.cpu().numpy()):
            root = root * v % p
        root = root * pow(r_inv, n - 1, p) % p  # the Montgomery product of the segment
        n_bytes += 64 * n
        imads += FR_MUL_IMAD * (3 * (n - 1) + 1) + k7_gcd_imads(root)
    return bound_ms(n_bytes, imads)


def k7_edges() -> list[int]:
    """The GCD's edge inputs (canonical words, read by K7 as Montgomery
    forms): 1, 2, p - 1, p - 2, R mod p, R^-1 mod p, (p + 1) / 2, powers of
    two, the seeded search's slowest input."""
    from zkdl_tpu_torch.field import fr

    p, R = fr.P_INT, 1 << 256
    return [1, 2, p - 1, p - 2, R % p, pow(R, -1, p), (p + 1) // 2, K7_GCD_SLOWEST] + [1 << k for k in range(0, 255, 9)]


def _nonzero_fr(rng, n: int, device):
    import torch
    from zkdl_tpu_torch.field import fr

    a = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint32)
    a[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    a[a.sum(axis=1) == 0, 0] = 1
    return torch.from_numpy(a).to(device)


def k7_time_sets(dev) -> dict:
    """Seeded inputs of K7's timed shapes: one element, the table and the
    witness side alone, and both in one call."""
    rng = np.random.default_rng(10)
    xs = {n: _nonzero_fr(rng, n, dev) for n in (1, 4096, 16384)}
    return {"1": [xs[1]], "4096": [xs[4096]], "16384": [xs[16384]],
            "16384 + 4096": [xs[16384], xs[4096]]}


def k7_call(xs):
    """K7 over the segments xs as the lookup calls it: one segmented call,
    or, in a checkout that predates it, a call a segment."""
    from zkdl_tpu_torch.field import kernels

    many = getattr(kernels, "batch_inverse_many", None)
    if many is not None:
        return lambda: many(xs)
    return lambda: [kernels.batch_inverse(x) for x in xs]


def queued_ms(fn, iters: int = 50) -> float | None:
    """Device ms a call of fn, the calls queued behind a sleeping kernel so
    that the host's time to enqueue them (the Python wrapper) does not show;
    None where torch has no torch.cuda._sleep."""
    import torch

    if not hasattr(torch.cuda, "_sleep"):
        return None
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at the card's clock: longer than enqueueing the calls
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_k7_times(dev, sets: dict | None = None) -> dict:
    """K7 timed on k7_time_sets beside its bound: `ms` over 50 calls back to
    back (CUDA events, the wrapper's host time included where it is the
    longer), `queued_ms` with the calls queued ahead."""
    sets = sets or k7_time_sets(dev)
    out = {}
    for label, xs in sets.items():
        fn = k7_call(xs)
        bms, by = k7_bound(xs)
        ms, qms = cuda_ms(fn, 50), queued_ms(fn, 50)
        out[label] = {"ms": ms, "queued_ms": qms, "bound_ms": bms, "bound_by": by}
        log(f"[k7] fr_batch_inverse at {label}: {ms:.4f} ms ({'not measured' if qms is None else f'{qms:.4f}'} ms "
            f"queued; bound {bms:.6f} ms by {by}, {100 * bms / ms:.3f}% of it)")
    return out


def phase_k7(records: dict) -> None:
    """K7 bit-equal to plain at K7_SIZES, with a zero input (every output
    zero), on the GCD's edge inputs (each alone, the inverse without a tree,
    and all in one call), and in the lookup's segmented call (16,384 +
    4,096), also with a zero in one segment only (that segment zero, the
    other right); timed at 1, 4096, 16,384 and the segmented call beside
    its bound."""
    import torch
    from zkdl_tpu_torch.field import fr, kernels

    rng = np.random.default_rng(9)
    dev = torch.device("cuda")
    inputs = {n: _nonzero_fr(rng, n, dev) for n in K7_SIZES}
    zero = _nonzero_fr(rng, 4096, dev)
    zero[1234] = 0
    inputs["4096 with a zero"] = zero
    edges = torch.from_numpy(fr.from_ints(k7_edges())).to(dev)
    inputs[f"{edges.shape[0]} edge inputs"] = edges
    err, plain, plain_ms = 0, {}, {}
    for n, x in inputs.items():
        want, plain_ms[n] = plain_once(lambda: kernels.batch_inverse_plain(x))
        got = kernels.batch_inverse(x)
        same(f"fr_batch_inverse at {n}", got, want)
        err, plain[n] = max(err, max_abs_err(got, want)), want
    if bool((plain["4096 with a zero"].view(torch.int32) != 0).any()):
        raise AssertionError("fr_batch_inverse: a zero input must make every output zero")
    want_edges = plain[f"{edges.shape[0]} edge inputs"]
    for i in range(edges.shape[0]):
        same(f"fr_batch_inverse of edge input {i} alone", kernels.batch_inverse(edges[i : i + 1]), want_edges[i : i + 1])
    a, t = inputs[K7_SEGMENTS[0]], inputs[K7_SEGMENTS[1]]
    a_zero, t_zero = a.clone(), t.clone()
    a_zero[777] = 0
    t_zero[4095] = 0
    cases = {"both": (a, t), "a zero in the first only": (a_zero, t), "a zero in the second only": (a, t_zero)}
    for label, segs in cases.items():
        got = kernels.batch_inverse_many(list(segs))
        want = [plain[K7_SEGMENTS[0]] if segs[0] is a else kernels.batch_inverse_plain(a_zero),
                plain[K7_SEGMENTS[1]] if segs[1] is t else kernels.batch_inverse_plain(t_zero)]
        for k, (g, w) in enumerate(zip(got, want)):
            same(f"fr_batch_inverse_many ({label}), segment {k}", g, w)
            err = max(err, max_abs_err(g, w))
    if bool((kernels.batch_inverse_many([a_zero, t])[0].view(torch.int32) != 0).any()):
        raise AssertionError("fr_batch_inverse_many: a zero must zero its own segment")
    small = [inputs[5], inputs[1], inputs[2], edges]  # segments of one block, one and two elements among them
    for k, (g, x) in enumerate(zip(kernels.batch_inverse_many(small), small)):
        same(f"fr_batch_inverse_many of 5, 1, 2 and {edges.shape[0]} elements, segment {k}", g, plain[x.shape[0]]
             if x is not edges else want_edges)
    log(f"[attention] fr_batch_inverse bit-equal to plain at n = {', '.join(map(str, inputs))} (a zero input "
        f"gives all zeros, as the JAX function does), on each edge input alone, and in one call of segments "
        f"{' + '.join(map(str, K7_SEGMENTS))}, also with a zero in one segment (that segment zero, the other "
        f"right), and of 5, 1, 2 and {edges.shape[0]} elements")
    shapes = phase_k7_times(dev, {"1": [inputs[1]], "4096": [t], "16384": [a], "16384 + 4096": [a, t]})
    for label, n in (("1", 1), ("4096", 4096), ("16384", 16384)):
        shapes[label]["plain_ms"] = plain_ms[n]
    shapes["16384 + 4096"]["plain_ms"] = plain_ms[16384] + plain_ms[4096]
    records["fr_batch_inverse"] = {**shapes["16384 + 4096"], "max_abs_err": err, "library_ms": None}
    records["_fr_batch_inverse_shapes"] = shapes


def tampered_copy(proof, path: str, index, device):
    """The proof with the word at `index` of its array `path` (proof_io's
    flattened names) plus one, wrapping, as the JAX recorder tampers."""
    from zkdl_tpu_torch.io import proof_io

    arrays: dict = {}
    skel = proof_io.flatten(proof, "p", arrays)
    arrays = {k: np.array(v) for k, v in arrays.items()}
    if path is not None:
        arrays[path][tuple(index)] += np.uint32(1)
    return proof_io._unflatten(skel, arrays, device)


def attention_arrays(proof) -> dict:
    from zkdl_tpu_torch.io import proof_io

    arrays: dict = {}
    proof_io.flatten(proof, "p", arrays)
    return arrays


def tiny_attention(device):
    """tests/test_attention.py's block: seq 4, d 8, weights and input from
    default_rng(0), generators from PRNGKey(0)."""
    from zkdl_tpu_torch.commit.pedersen import to_mont_rows
    from zkdl_tpu_torch.models import quantize, zkattention
    from zkdl_tpu_torch.utils import prng

    rng = np.random.default_rng(0)
    ws = [(rng.standard_normal((8, 8)) * 0.3).astype(np.float32) for _ in range(4)]
    attn = zkattention.ZkAttention.from_float(4, *ws, prng.PRNGKey(0), device)
    X = to_mont_rows(quantize.load_input(rng.standard_normal((4, 8)).astype(np.float32), device))
    return attn, X


def check_tiny_attention() -> None:
    """Both tiers of the tiny block on the card and on the CPU: every proof
    array equal, and equal to the JAX recorder's arrays."""
    import torch
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir

    proofs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        attn, X = tiny_attention(dev)
        _, tr = attn.forward(X)
        for tier in ("plain", "committed"):
            proofs[dev, tier] = attention_arrays(attn.prove(tr, FiatShamir(), commit_witness=tier == "committed"))
        torch.cuda.synchronize()
        log(f"[attention] tiny block (seq 4, d 8) proved in both tiers on {dev} in {time.perf_counter() - t0:.1f}s")
    recorded = None
    if os.path.exists(ATTENTION_JAX):
        with np.load(ATTENTION_JAX) as z:
            keys = json.loads(bytes(z["__keys__"]).decode())
            recorded = {k: z[v] for k, v in keys.items()}
    for tier in ("plain", "committed"):
        card, cpu = proofs["cuda", tier], proofs["cpu", tier]
        bad = sorted(set(card) ^ set(cpu)) + [k for k in card if k in cpu and not np.array_equal(card[k], cpu[k])]
        if bad:
            raise AssertionError(f"tiny {tier} proof: card != CPU at {bad[:5]}")
        msg = f"{len(card)} arrays of the card's proof equal the CPU port's"
        if recorded is not None:
            jax = {k[len(tier) + 1 :]: v for k, v in recorded.items() if k.startswith(tier + ":")}
            jax.pop("__skeleton__", None)
            bad = sorted(set(card) ^ set(jax)) + [k for k in card if k in jax and not np.array_equal(card[k], jax[k])]
            if bad:
                raise AssertionError(f"tiny {tier} proof: card != the JAX recorder's at {bad[:5]}")
            msg += " and the JAX recorder's"
        log(f"[attention] tiny {tier} tier: {msg}")
    if recorded is None:
        raise AssertionError(f"{ATTENTION_JAX} missing: the card's tiny proof has no JAX arrays to meet")


def g1_var_const(name: str) -> int:
    """A launch constant of zkdl_tpu_torch/csrc/g1_var.cu, read from the
    source (K5 picks its layout by them, K6 its tile)."""
    import re

    src = open(os.path.join("zkdl_tpu_torch", "csrc", "g1_var.cu")).read()
    m = re.search(rf"constexpr \w+ {name} = ([0-9 *]+);", src)
    if m is None:
        raise AssertionError(f"{name} not found in g1_var.cu")
    return int(np.prod([int(v) for v in m.group(1).split("*")]))


def k5_layout(n: int) -> str:
    """The layout zk_g1_scalar_mul_form's auto picks for n points with a
    scalar each."""
    return "Team" if n < g1_var_const("QUAD_FROM") else "Solo" if n >= g1_var_const("SOLO_FROM") else "Quad"


def k6_tile(n: int) -> int:
    """zk_g1_add's tile (pairs a block) at a launch of n pairs."""
    blocks, threads = g1_var_const("ADD_BLOCKS"), g1_var_const("ADD_THREADS")
    return min(g1_var_const("ADD_TILE"), -(-(-(-n // blocks)) // threads) * threads)


def time_commit_launches(res: dict, records: dict) -> None:
    """One more commitment of the seq-128 witness with K5's and K6's
    launches recorded and the openings' seconds summed. K5 is held against
    plain on the first SOLO_FROM points of its first launch and the last
    SOLO_FROM of its last (one launch that takes the layout every launch of
    the MSM takes) and timed at its largest launch; K6's largest bit-mode
    level is held against plain whole (so at its own tile) and timed."""
    import torch
    from zkdl_tpu_torch.commit import pedersen
    from zkdl_tpu_torch.curve import g1
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir

    calls = {"scalar_mul": [], "add_bits": []}
    smul, bits_, reveal = g1.scalar_mul, g1.add_bits, pedersen.open_reveal
    opening_s = [0.0, 0]

    def scalar_mul(p, scal, form="auto"):
        calls["scalar_mul"].append((g1.G1Jac(*(c.clone() for c in p)), scal.clone()))
        return smul(p, scal, form)

    def add_bits(bits, gens):
        calls["add_bits"].append((bits.clone(), g1.G1Jac(*(c.clone() for c in gens))))
        return bits_(bits, gens)

    def open_reveal(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reveal(*a)
        torch.cuda.synchronize()
        opening_s[0] += time.perf_counter() - t0
        opening_s[1] += 1
        return out

    attn, tr = res["model"], res["trace"]
    g1.scalar_mul, g1.add_bits, pedersen.open_reveal = scalar_mul, add_bits, open_reveal
    try:
        attn.prove(tr, FiatShamir(), commit_witness=True)
        torch.cuda.synchronize()
    finally:
        g1.scalar_mul, g1.add_bits, pedersen.open_reveal = smul, bits_, reveal
    log(f"[attention] one committed prove: K5 launched at {[p.x.shape[0] for p, _ in calls['scalar_mul']]} points, "
        f"K6 in bit mode at {[b.shape[0] // 2 for b, _ in calls['add_bits']]} pairs; {opening_s[1]} openings took "
        f"{opening_s[0]:.3f}s (a sync around each)")
    shapes = records.setdefault("_attention_commit_launches", {"openings_s": opening_s[0], "openings": opening_s[1]})
    msm = [c for c in calls["scalar_mul"] if c[1].dim() == 2]
    layouts = sorted({k5_layout(p.x.shape[0]) for p, _ in msm})
    half = g1_var_const("SOLO_FROM")
    (first, s_first), (last, s_last) = msm[0], msm[-1]
    check = (g1.G1Jac(*(torch.cat([a[:half], b[-half:]]) for a, b in zip(first, last))),
             torch.cat([s_first[:half], s_last[-half:]]))
    if layouts != [k5_layout(2 * half)]:
        raise AssertionError(f"the witness MSM's launches take {layouts}, the check {k5_layout(2 * half)}")
    t0 = time.perf_counter()
    err = point_err(g1.scalar_mul(*check), g1.scalar_mul_plain(*check))
    if err:
        raise AssertionError(f"g1_scalar_mul differs from plain on the witness MSM's points: {err}")
    plain_s = time.perf_counter() - t0
    pts, scal = max(msm, key=lambda c: c[0].x.shape[0])
    n = pts.x.shape[0]
    ms = cuda_ms(lambda: g1.scalar_mul(pts, scal), 3)
    bms, by = var_bound(pts, scal)
    shapes["K5 witness MSM"] = {"points": n, "ms": ms, "bound_ms": bms, "bound_by": by}
    log(f"[attention] g1_scalar_mul at the witness commitments' MSM ({n} points, a scalar each): {ms:.4f} ms, bound "
        f"{bms:.4f} ms by {by} ({100 * bms / ms:.2f}%); {2 * half} of its points (the first {half} of the first "
        f"launch, the last {half} of the last) bit-equal to plain in one launch of the {layouts[0]} layout, which "
        f"every launch of the MSM takes (plain {plain_s:.1f}s)")
    bits, gens = max(calls["add_bits"], key=lambda c: c[0].shape[0])
    gsize = gens.x.reshape(-1, 12).shape[0]
    t0 = time.perf_counter()
    err = point_err(g1.add_bits(bits, gens), g1.add_bits_plain(bits, gens))
    if err:
        raise AssertionError(f"g1_add (bit mode) differs from plain on the witness bits: {err}")
    plain_s = time.perf_counter() - t0
    ms = cuda_ms(lambda: g1.add_bits(bits, gens), 10)
    bms, by = add_bits_bound(bits, gsize)
    shapes["K6 witness bits, level 1"] = {"pairs": bits.shape[0] // 2, "gen": gsize, "ms": ms, "bound_ms": bms,
                                          "bound_by": by}
    log(f"[attention] g1_add in bit mode at the witness bits' first level ({bits.shape[0] // 2} pairs over {gsize} "
        f"generators, {k6_tile(bits.shape[0] // 2)} pairs a block): {ms:.4f} ms, bound {bms:.4f} ms by {by} "
        f"({100 * bms / ms:.2f}%); the whole launch bit-equal to plain (plain {plain_s:.1f}s)")


def phase_attention(records: dict) -> None:
    """The attention block at seq 128, d 128 through bench.run("attention"),
    the tampers, the commitments' launches and the tiny block on both
    devices."""
    import torch
    from zkdl_tpu_torch import bench
    from zkdl_tpu_torch.curve import g1
    from zkdl_tpu_torch.field import kernels

    for k in (*kernels.KERNELS, *g1.KERNELS):
        k.launches = 0
    res = bench.run("attention", device="cuda")
    torch.cuda.synchronize()
    launches = {k: v for k, v in bench.launch_counts().items() if k != kernels.COLLECT.name}  # K9: multi-device only
    log(f"[attention] seq 128, d 128, committed witness: build {res['build_s']:.3f}s, forward {res['forward_s']:.3f}s, "
        f"prove warm {res['warm_prove_s']:.3f}s, steady {res['prove_s']:.3f}s ({res['prover_s_per_row']:.6f} s/row), "
        f"peak device memory of the prove {res['prove_peak_gib']:.3f} GiB")
    log(f"[attention] stage seconds of one more prove, with a synchronize a stage: {json.dumps(res['stage_s'])}")
    log(f"[attention] launches in this run (build, 3 proves, verify): {json.dumps(launches)}; per prove: "
        f"{json.dumps(res['launches_per_prove'])}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the attention path")
    if res["launches_per_prove"]["fr_batch_inverse"] != 1:
        raise AssertionError(f"the attention prove made {res['launches_per_prove']['fr_batch_inverse']} K7 calls, "
                             "expected 1 (the lookup's two sides in one call)")
    if (res["verify_ok"], res["verify_msg"]) != (True, ""):
        raise AssertionError(f"the port's verifier rejected the attention proof: {res['verify_msg']}")
    log(f"[attention] proof {res['proof_bytes']} bytes; accepted by ZkAttention.verify(X, Y, FiatShamir()) in "
        f"{res['verify_s']:.3f}s; kernel launches in the verify: {json.dumps(res['verify_launches'])}")
    vl = res["verify_launches"]
    log(f"[attention] the verify made {vl['g1_scalar_mul_glv']} K8 launches (its openings' generator MSMs) and "
        f"{vl['g1_scalar_mul']} K5 launches, {vl['g1_scalar_mul_glv'] + vl['g1_scalar_mul']} in all")
    if vl["g1_scalar_mul_glv"] <= 0:
        raise AssertionError("the attention verify launched no K8")
    records["fr_batch_inverse"]["launches"] = launches["fr_batch_inverse"]
    records["_attention_S"] = (res["trace"]["S"], res["model"].seq, res["model"].d_model)  # phase 10: cheap softmax
    t_max = int(res["trace"]["sm_wit"]["t"].max())
    log(f"[attention] the softmax witness's largest t is {t_max} (< 2^32: no value loses bits to the 32-bit "
        f"Montgomery tensors of the JAX package's convention)")
    if t_max >= 1 << 32:
        raise AssertionError(f"softmax witness t = {t_max} does not fit 32 bits")

    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir

    attn, X, Y = res["model"], res["X"], res["Y"]
    for name, path, index, args, reason in ATTENTION_FAULTS:
        bad = tampered_copy(res["proof"], path, index, X.device)
        Y_used = Y
        if "Y_bad" in args:
            from zkdl_tpu_torch.field import mp

            a = mp.host(Y).copy()
            a[0] = fr_limbs_mont(7 << 16)
            Y_used = torch.from_numpy(a).to(Y.device)
        t0 = time.perf_counter()
        got = attn.verify(bad, X=X if "X" in args else None, Y=Y_used if ("Y" in args or "Y_bad" in args) else None,
                          transcript=FiatShamir() if "transcript" in args else None)
        if got != (False, reason):
            raise AssertionError(f"tampered {name}: verifier returned {got}, expected (False, {reason!r})")
        log(f"[attention] tampered {name}: rejected in {time.perf_counter() - t0:.3f}s: {reason}")
    time_commit_launches(res, records)
    check_tiny_attention()
    records["_attention"] = {
        **{k: res[k] for k in ("build_s", "forward_s", "warm_prove_s", "prove_s", "prover_s_per_row", "stage_s",
                               "launches_per_prove", "prove_peak_gib", "proof_bytes", "verify_s",
                               "verify_launches")},
        "launches": launches, "k7_shapes": records["_fr_batch_inverse_shapes"],
        "commit_launches": records["_attention_commit_launches"],
    }


def fr_limbs_mont(v: int):
    from zkdl_tpu_torch.field import fr

    return fr.from_ints([v], mont_form=True)[0]


# ---------------------------------------------------------------------------
# phase 10: the NTT (K10), G2 (K11, K12), windowed G1 (K13), the cheap softmax
# ---------------------------------------------------------------------------

NTT_CHECK_LOGS = tuple(range(13)) + (NTT_LOG_N,)  # n = 1 ... 4096 and 2^20
G2_SIZES = (1, 2, 3, 5, 255, 256, 257, 4097, VAR_MSM_POINTS)  # K11/K12 launch sizes held against plain
G2_PLAIN_ROWS = 256  # the plain G2 walk's rows: every edge combination, then random scalars
G2_MSM_SIZES = (4096, VAR_MSM_POINTS)  # K11/K12 timed through g2.msm (18,432: relu[1]'s G1 MSM)
G2_DBL_FP_MULS, G2_ADD_FP_MULS = 16, 43  # dbl-2009-l and add-2007-bl over Fp2 (an Fp2 product 3, a square 2)
G2_POINT_BYTES = 6 * 48
SOFTMAX_CHEAP_JAX = os.path.join("tests", "port", "fixtures", "slice14_jax.json")


def tower_kernels() -> tuple:
    """K10-K13, the kernels of phase 10's path."""
    from zkdl_tpu_torch.curve import g1, g2
    from zkdl_tpu_torch.tensor import fft

    return (*fft.KERNELS, *g2.KERNELS, g1.WINDOWED)


def port_kernels() -> tuple:
    """Every hand-written kernel of the port, K1-K13, in the kernels line's
    order."""
    from zkdl_tpu_torch.curve import g1
    from zkdl_tpu_torch.field import kernels

    return (*kernels.KERNELS, *g1.KERNELS, *tower_kernels())


def g2_host_add(a, b):
    """a + b on the host in affine form (None the identity), on
    y^2 = x^3 + 4(1 + u) over HostFp2."""
    from zkdl_tpu_torch.field.fp2 import HostFp2 as F

    if a is None or b is None:
        return a if b is None else b
    (x1, y1), (x2, y2) = a, b
    if x1 == x2:
        if y1 != y2 or y1 == (0, 0):
            return None
        lam = F.mul(F.mul((3, 0), F.sqr(x1)), F.inv(F.add(y1, y1)))
    else:
        lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    x3 = F.sub(F.sub(F.sqr(lam), x1), x2)
    return x3, F.sub(F.mul(lam, F.sub(x1, x3)), y1)


def g2_host_mul(xy, k: int):
    """k xy on the host in affine form for any integer k >= 0 (MSB-first
    double-and-add)."""
    acc = None
    for bit in bin(k)[2:] if k else "":
        acc = g2_host_add(acc, acc)
        if bit == "1":
            acc = g2_host_add(acc, xy)
    return acc


def g2_bound(pts, scal) -> tuple[float, str]:
    """K11's least time on this data: points and scalars read and the
    products written once, against the multiply-adds of its double-and-add
    (top(k) doubles and popcount(k) - 1 generic adds a scalar k, the first
    add taking the point as it is), an Fp product each FP_MUL_IMAD."""
    import torch
    from zkdl_tpu_torch.curve import g1

    n = pts.x.c0.shape[0]
    bits = g1._scalar_bits((scal.reshape(-1, 8).expand(n, 8) if scal.dim() == 1 else scal).cpu())
    top = torch.where(bits, torch.arange(256), -1).max(1).values
    dbl = int(top.clamp(min=0).sum().item())
    adds = int((bits.sum(1) - 1).clamp(min=0).sum().item())
    return bound_ms(n * (2 * G2_POINT_BYTES + 32),
                    (dbl * G2_DBL_FP_MULS + adds * G2_ADD_FP_MULS) * FP_MUL_IMAD)


def g2_add_bound(pairs: int) -> tuple[float, str]:
    """K12's least time on generic pairs: two points read and one written a
    pair, against a generic add's products."""
    return bound_ms(pairs * 3 * G2_POINT_BYTES, pairs * G2_ADD_FP_MULS * FP_MUL_IMAD)


def g2_slice(p, idx):
    """The points of p at a slice or an integer index tensor (uint32 has no
    indexing on the card: a tensor index gathers on the int32 view)."""
    from zkdl_tpu_torch.curve import g2
    from zkdl_tpu_torch.field import mp

    if isinstance(idx, slice):
        return g2.G2Jac(*(g2.Fp2(f.c0[idx], f.c1[idx]) for f in p))
    return g2.G2Jac(*(g2.Fp2(mp.take(f.c0, idx, 0), mp.take(f.c1, idx, 0)) for f in p))


def g2_cat(*ps):
    import torch
    from zkdl_tpu_torch.curve import g2

    return g2.G2Jac(*(g2.Fp2(torch.cat([getattr(p, c).c0 for p in ps]), torch.cat([getattr(p, c).c1 for p in ps]))
                      for c in "xyz"))


def g2_words(p):
    import torch

    return torch.cat([torch.cat([f.c0, f.c1], -1) for f in p], -1)


def g2_edge_points(dev):
    """[P, Q, R, O, P + (-P), 2P, P + Q, 2Q] for P, Q, R = find_point_host(3,
    11, 29) (off the r-torsion subgroup), built by the plain formulas."""
    from zkdl_tpu_torch.curve import g2

    P, Q, R = (g2.jac_from_host(g2.find_point_host(s), (1,)) for s in (3, 11, 29))
    E = g2_cat(P, Q, R, g2.identity((1,)), g2.add(P, g2.neg(P)), g2.double(P), g2.add(P, Q), g2.double(Q))
    return g2.G2Jac(*(g2.Fp2(f.c0.to(dev), f.c1.to(dev)) for f in E))


def random_below_r(rng, m: int, dev):
    import torch
    from zkdl_tpu_torch.field import fr

    raw = rng.integers(0, 1 << 32, size=(m, 8), dtype=np.uint32)
    raw[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    return torch.from_numpy(raw).to(dev)


def g2_msm_inputs(dev, m: int):
    """m points cycling through the edge batch's six points that are not
    the identity, random scalars below r (seeded by m)."""
    import torch

    E = g2_edge_points(dev)
    live = torch.tensor([0, 1, 2, 5, 6, 7], device=dev)
    return g2_slice(E, live[torch.arange(m, device=dev) % 6]), random_below_r(np.random.default_rng(m), m, dev)


def g2_forms() -> dict:
    """K11's forms in this checkout (SCALAR_MUL_FORMS; a checkout without
    them has one layout, called without a form)."""
    from zkdl_tpu_torch.curve import g2

    return getattr(g2, "SCALAR_MUL_FORMS", {"auto": 0})


def windowed_forms() -> dict:
    """K13's forms in this checkout (WINDOWED_FORMS; a checkout without
    them has one layout, called without a form)."""
    from zkdl_tpu_torch.curve import g1

    return getattr(g1, "WINDOWED_FORMS", {"auto": 0})


def g2_smul(pts, scal, form: str = "auto"):
    from zkdl_tpu_torch.curve import g2

    return g2.scalar_mul(pts, scal) if form == "auto" else g2.scalar_mul(pts, scal, form)


def g1_windowed(pts, scal, form: str = "auto"):
    from zkdl_tpu_torch.curve import g1

    return g1.scalar_mul_windowed(pts, scal) if form == "auto" else g1.scalar_mul_windowed(pts, scal, form)


def phase_tower_kernels(records: dict) -> None:
    """Phase 2's rows of K10-K13, each against its plain version on the card,
    bit for bit, and timed beside its bound:
    K10 (fr_ntt) at n = 1 ... 4096 and 2^20, forward and inverse, on zeros,
    every value p - 1 and random values, intt(ntt(x)) == x, timed at 2^20;
    K11 (g2_scalar_mul) on every edge scalar (0, 1, 2, 5, r - 1, r,
    2^256 - 1, random) on every edge point (P, Q, R, O, P + (-P), 2P, P + Q,
    2Q) and random scalars after, at the sizes of G2_SIZES up to phase 10's
    18,432 points (plain on 256 rows; larger launches tile them), and one
    scalar for all; K12 (g2_add) on p + p, p + (-p), p + O, O + q, O + O
    and distinct points at those sizes, and g2_sum's tree at each against
    the CPU's; both timed through g2.msm at 4096 and 18,432 points, K12
    held against plain on each MSM's first tree level; K13
    (g1_scalar_mul_windowed) on K5's edge points and scalars at VAR_SIZES,
    and at the verify's MSM shape (glv_time_sets, phase 10's launch)
    against plain and timed beside K8 and K5 on the same inputs."""
    import torch
    from zkdl_tpu_torch.curve import g1, g2
    from zkdl_tpu_torch.field import fr, mp
    from zkdl_tpu_torch.tensor import fft

    dev = torch.device("cuda")
    rng = np.random.default_rng(14)
    t0 = time.perf_counter()

    # K10
    checked = 0
    for log_n in NTT_CHECK_LOGS:
        n = 1 << log_n
        for kind in ("zeros", "p-1", "random"):
            if kind == "random":
                x = random_below_r(rng, n, dev)
            else:
                x = torch.from_numpy(np.tile(fr.from_int(0 if kind == "zeros" else fr.P_INT - 1), (n, 1))).to(dev)
            for inverse in (False, True):
                same(f"fr_ntt n=2^{log_n} {kind} {'inverse' if inverse else 'forward'}",
                     fft._ntt_core(x, log_n, inverse), fft.ntt_plain(x, log_n, inverse))
                checked += 1
            if kind == "random" and not torch.equal(fft.intt(fft.ntt(x)), x):
                raise AssertionError(f"fr_ntt: intt(ntt(x)) != x at n=2^{log_n}")
    x = random_below_r(rng, 1 << NTT_LOG_N, dev)
    shapes = records["_fr_ntt_shapes"] = {}
    for inverse in (False, True):
        want, pms = plain_once(lambda: fft.ntt_plain(x, NTT_LOG_N, inverse))
        err = max_abs_err(fft._ntt_core(x, NTT_LOG_N, inverse), want)
        ms = cuda_ms(lambda: fft._ntt_core(x, NTT_LOG_N, inverse), 20)
        bms, by = ntt_bound(NTT_LOG_N, inverse)
        shapes["inverse" if inverse else "forward"] = {"n": 1 << NTT_LOG_N, "ms": ms, "plain_ms": pms,
                                                        "bound_ms": bms, "bound_by": by, "max_abs_err": err}
        log(f"[kernels] fr_ntt (K10) {'inverse' if inverse else 'forward'} at 2^{NTT_LOG_N}: {ms:.4f} ms (plain "
            f"{pms:.1f} ms, bound {bms:.4f} ms by {by}, {100 * bms / ms:.1f}% of it; no PyTorch call computes an Fr "
            "NTT)")
    records["fr_ntt"] = {**{k: v for k, v in shapes["forward"].items() if k != "n"}, "library_ms": None}
    log(f"[kernels] fr_ntt bit-equal to plain on {checked} transforms (n = 2^0 ... 2^12 and 2^{NTT_LOG_N}, forward "
        "and inverse, zeros, every value p - 1, random values); intt(ntt(x)) == x at each size")

    # K11 and K12 on the edges
    E = g2_edge_points(dev)
    edge_scalars = [0, 1, 2, 5, fr.P_INT - 1, fr.P_INT, (1 << 256) - 1]
    k = len(edge_scalars) + 1  # and one random scalar
    pidx = torch.arange(G2_PLAIN_ROWS) % 8
    sc = random_below_r(rng, G2_PLAIN_ROWS, "cpu")
    for i in range(8 * k):
        if i % k < len(edge_scalars):
            sc[i] = scalar_words(edge_scalars[i % k])
    pidx[: 8 * k] = torch.arange(8 * k) // k
    pidx, sc = pidx.to(dev), sc.to(dev)
    base = g2_slice(E, pidx)
    want_edges, pms_edges = plain_once(lambda: g2.scalar_mul_plain(base, sc))
    big = max(G2_SIZES)
    rows = torch.arange(big, device=dev) % G2_PLAIN_ROWS
    pts_big, sc_big, want_big = g2_slice(base, rows), mp.take(sc, rows, 0), g2_words(g2_slice(want_edges, rows))
    small = scalar_words(0x1234567).to(dev)
    want_small = g2_words(g2.scalar_mul_plain(base, small))
    for form in g2_forms():
        for m in G2_SIZES:
            same(f"g2_scalar_mul ({form}) n={m}",
                 g2_words(g2_smul(g2_slice(pts_big, slice(0, m)), sc_big[:m], form)), want_big[:m])
        same(f"g2_scalar_mul ({form}) one scalar for all", g2_words(g2_smul(base, small, form)), want_small)
    qE = g2_cat(E, g2.neg(E), g2_slice(E, torch.roll(torch.arange(8, device=dev), 1)), g2.identity((8,), dev))
    pE = g2_cat(E, E, E, E)
    radd = torch.arange(big, device=dev) % 32
    pa, qa = g2_slice(pE, radd), g2_slice(qE, radd)
    want_add = g2_words(g2.add_plain(pa, qa))
    for m in G2_SIZES:
        same(f"g2_add n={m}", g2_words(g2.add(g2_slice(pa, slice(0, m)), g2_slice(qa, slice(0, m)))), want_add[:m])
        part = g2_slice(pts_big, slice(0, m))
        with_plain = g2.G2Jac(*(g2.Fp2(f.c0.cpu(), f.c1.cpu()) for f in part))
        same(f"g2_sum n={m}", g2_words(g2.g2_sum(part)).cpu(), g2_words(g2.g2_sum(with_plain)))
    log(f"[kernels] g2_scalar_mul (K11) bit-equal to plain in each form ({', '.join(g2_forms())}) at n = "
        f"{', '.join(map(str, G2_SIZES))}: every scalar of "
        "0, 1, 2, 5, r-1, r, 2^256-1 and a random one on each of P, Q, R, O, P+(-P), 2P, P+Q, 2Q, then random "
        f"scalars ({G2_PLAIN_ROWS} plain rows, tiled; plain {pms_edges:.0f} ms), and one scalar for all; g2_add (K12) "
        "on p+p, p+(-p), p+O, O+q, O+O and distinct points, and g2_sum's tree (CPU plain) at each size")

    # K11 and K12 timed through g2.msm; K12 held against plain on each MSM's first tree level
    g2_shapes = records["_g2_shapes"] = {}
    for m in G2_MSM_SIZES:
        pts, scal = g2_msm_inputs(dev, m)
        smul = g2.scalar_mul(pts, scal)
        for form in g2_forms():
            if not torch.equal(g2_words(g2_smul(pts, scal, form)), g2_words(smul)):
                raise AssertionError(f"g2_scalar_mul's forms disagree at {m} points")
        forms_ms = {form: cuda_ms(lambda f=form: g2_smul(pts, scal, f), 3) for form in g2_forms()}
        ms = forms_ms["auto"]
        bms, by = g2_bound(pts, scal)
        level = g2.pack(smul)[: 2 * (m // 2)].contiguous()
        pa, qa = g2.unpack(level[0::2]), g2.unpack(level[1::2])
        want_l, apms = plain_once(lambda: g2.add_plain(pa, qa))
        aerr = max_abs_err(g2_words(g2.unpack(g2.sum_level(level))), g2_words(want_l))
        if aerr:
            raise AssertionError(f"g2_add at the first tree level of {m} points: max |err| {aerr}")
        ams = cuda_ms(lambda: g2.sum_level(level), 10)
        abms, aby = g2_add_bound(m // 2)
        total = cuda_ms(lambda: g2.msm(pts, scal), 2)
        g2_shapes[f"{m} points"] = {"scalar_mul_ms": ms, **{f"scalar_mul_ms_{f}": t for f, t in forms_ms.items()
                                                            if f != "auto"},
                                    "bound_ms": bms, "bound_by": by, "add_level_ms": ams,
                                    "add_level_plain_ms": apms, "add_level_bound_ms": abms,
                                    "add_level_bound_by": aby, "msm_ms": total}
        log(f"[kernels] g2.msm at {m} points, random scalars below r: {total:.3f} ms; g2_scalar_mul {ms:.3f} ms (forms: "
            f"{', '.join(f'{f} {t:.3f}' for f, t in forms_ms.items() if f != 'auto')}; bound "
            f"{bms:.4f} ms by {by}, {100 * bms / ms:.1f}%), g2_add at its first tree level ({m // 2} pairs) "
            f"{ams:.4f} ms (plain {apms:.1f} ms, bound {abms:.5f} ms by {aby}), bit-equal to plain; no PyTorch call "
            "computes a G2 product")
        if m == VAR_MSM_POINTS:
            records["g2_add"] = {"ms": ams, "plain_ms": apms, "bound_ms": abms, "bound_by": aby, "max_abs_err": aerr,
                                 "library_ms": None, "shape": f"the first tree level of g2.msm at {m} points"}
    # K11's record: the check set (its plain run above)
    forms_ms = {form: cuda_ms(lambda f=form: g2_smul(base, sc, f), 5) for form in g2_forms()}
    ms = forms_ms["auto"]
    bms, by = g2_bound(base, sc)
    records["g2_scalar_mul"] = {"ms": ms, "plain_ms": pms_edges, "bound_ms": bms, "bound_by": by,
                                "max_abs_err": max_abs_err(g2_words(g2.scalar_mul(base, sc)), g2_words(want_edges)),
                                "library_ms": None, "shape": f"the {G2_PLAIN_ROWS}-point check set"}
    g2_shapes["the check set"] = {"points": G2_PLAIN_ROWS, **{f"scalar_mul_ms_{f}": t for f, t in forms_ms.items()}}
    log(f"[kernels] on the {G2_PLAIN_ROWS}-point check set: g2_scalar_mul {ms:.3f} ms (forms: "
        f"{', '.join(f'{f} {t:.3f}' for f, t in forms_ms.items() if f != 'auto')}; plain {pms_edges:.0f} ms, "
        f"bound {bms:.5f} ms by {by}, {100 * bms / ms:.1f}%); bit-equal to plain")

    # K13 on K5's edges
    n = max(VAR_SIZES)
    raw = np.random.default_rng(13).integers(0, 1 << 32, size=(2 * n, 8), dtype=np.uint32)
    raw[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    pts, scw = g1_scalar_edge_set(dev, g1.generator_pow(torch.from_numpy(raw).to(dev)), raw, n)
    want, pms = plain_once(lambda: g1.scalar_mul_windowed_plain(pts, scw))
    for form in windowed_forms():
        for m in VAR_SIZES:
            idx = torch.arange(m, device=dev)
            same_points(f"g1_scalar_mul_windowed ({form}) n={m}", g1_windowed(_points(pts, idx), scw[:m], form),
                        _points(want, idx))
    ms = cuda_ms(lambda: g1.scalar_mul_windowed(pts, scw), 10)
    bms, by = windowed_bound(pts, scw)
    records["_g1_scalar_mul_windowed_edges"] = {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                                                "shape": f"the {n}-point check set"}
    log(f"[kernels] g1_scalar_mul_windowed (K13) bit-equal to plain in each form ({', '.join(windowed_forms())}) at "
        f"n = {', '.join(map(str, VAR_SIZES))}, each "
        "set headed by the scalars 0, 1, r-1, the cofactor, 2^256-1, r and 2^256-r on G, a NUMS candidate, O and "
        f"(r^2, -r^3, 0), random after; at {n}: {ms:.4f} ms (plain {pms:.0f} ms, bound {bms:.4f} ms by {by})")
    # K13's record: phase 10's shape, held against plain there (phase 10 compares its own launch with this)
    label, (pts, scal) = next(iter(glv_time_sets(dev).items()))
    want, pms = plain_once(lambda: g1.scalar_mul_windowed_plain(pts, scal))
    err = max(point_err(g1_windowed(pts, scal, form), want) for form in windowed_forms())
    if err:
        raise AssertionError(f"g1_scalar_mul_windowed at {label}: max |err| {err}")
    records["_g1_scalar_mul_windowed_want"] = want
    forms_ms = {form: cuda_ms(lambda f=form: g1_windowed(pts, scal, f), 10) for form in windowed_forms()}
    ms = forms_ms["auto"]
    k8 = cuda_ms(lambda: g1.scalar_mul_glv(pts, scal), 10)
    k5 = cuda_ms(lambda: g1.scalar_mul(pts, scal), 3)
    bms, by = windowed_bound(pts, scal)
    records["g1_scalar_mul_windowed"] = {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                                         "max_abs_err": err, "library_ms": None, "shape": label}
    records["_g1_scalar_mul_windowed_msm"] = {  # beside K13's record
        "k8_ms": k8, "k5_ms": k5, "shape": label, **{f"ms_{f}": t for f, t in forms_ms.items() if f != "auto"}}
    log(f"[kernels] g1_scalar_mul_windowed at {label}: {ms:.4f} ms (forms: "
        f"{', '.join(f'{f} {t:.4f}' for f, t in forms_ms.items() if f != 'auto')}; plain {pms:.0f} ms, bit-equal in "
        f"each form; bound {bms:.4f} ms by {by}, {100 * bms / ms:.1f}%); on the same inputs K8 {k8:.4f} ms, K5 "
        f"{k5:.4f} ms")
    log(f"[time] K10-K13 against plain: {time.perf_counter() - t0:.1f}s")


TOWER_TIME_SIZES = (G2_PLAIN_ROWS, 4096, VAR_MSM_POINTS)  # --tower-times' K11 launches
TOWER_SWEEP = (256, 1024, 2048, 4096, 8192, 12288, 18432)  # --tower's launch sizes for the forms' crossovers


def tower_form_sweep(dev) -> dict:
    """K11 (g2_msm_inputs) and K13 (points from K4, random scalars below r)
    in each form at each size of TOWER_SWEEP, every form's output equal to
    the others', timed over 3 launches: where each form is fastest (auto's
    thresholds in csrc/g2.cu and csrc/g1_team.cuh)."""
    import torch
    from zkdl_tpu_torch.curve import g1

    rng = np.random.default_rng(17)
    top = max(TOWER_SWEEP)
    g1p, g1s = g1.generator_pow(random_below_r(rng, top, dev)), random_below_r(rng, top, dev)
    out = {}
    for n in TOWER_SWEEP:
        pts, sc = g2_msm_inputs(dev, n)
        ref = g2_words(g2_smul(pts, sc))
        if any(not torch.equal(g2_words(g2_smul(pts, sc, f)), ref) for f in g2_forms()):
            raise AssertionError(f"g2_scalar_mul's forms disagree at {n} points")
        wp, ws = g1.G1Jac(*(c[:n] for c in g1p)), g1s[:n].contiguous()
        wref = torch.cat(list(g1_windowed(wp, ws)))
        if any(not torch.equal(torch.cat(list(g1_windowed(wp, ws, f))), wref) for f in windowed_forms()):
            raise AssertionError(f"g1_scalar_mul_windowed's forms disagree at {n} points")
        out[n] = {"g2_scalar_mul": {f: cuda_ms(lambda f=f: g2_smul(pts, sc, f), 3) for f in g2_forms()},
                  "g1_scalar_mul_windowed": {f: cuda_ms(lambda f=f: g1_windowed(wp, ws, f), 3)
                                             for f in windowed_forms()}}
        log(f"[tower-sweep] {n} points: " + "; ".join(
            f"{k} " + ", ".join(f"{f} {t:.4f} ms" for f, t in v.items()) for k, v in out[n].items()))
    return out


def phase_tower_times(dev) -> dict:
    """K11 at TOWER_TIME_SIZES points (g2_msm_inputs: the edge batch's six
    points that are not the identity, random scalars below r seeded by the
    size), K12 on the first tree level of the largest, K13 at the verify's
    MSM shape (glv_time_sets) beside K8 and K5 on the same inputs: each in
    every form of this checkout, the forms' outputs equal, timed with CUDA
    events (K11 5 launches, the others 10), beside its bound, with the
    SHA-256 of auto's output limbs (equal across checkouts where the bits
    are). Only functions that every checkout with K11-K13 has, so that two
    checkouts can be timed in one call."""
    import hashlib

    import torch
    from zkdl_tpu_torch.curve import g1, g2

    def digest(t) -> str:
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()

    out = {}
    for m in TOWER_TIME_SIZES:
        pts, scal = g2_msm_inputs(dev, m)
        ref = g2_words(g2.scalar_mul(pts, scal))
        for form in g2_forms():
            if not torch.equal(g2_words(g2_smul(pts, scal, form)), ref):
                raise AssertionError(f"g2_scalar_mul's forms disagree at {m} points")
        rec = {f: cuda_ms(lambda f=f: g2_smul(pts, scal, f), 5) for f in g2_forms()}
        bms, by = g2_bound(pts, scal)
        rec.update(bound_ms=bms, bound_by=by, sha256=digest(ref))
        out[f"g2_scalar_mul at {m} points"] = rec
        log(f"[tower-times] g2_scalar_mul at {m} points: " +
            ", ".join(f"{f} {t:.4f} ms" for f, t in rec.items() if f in g2_forms()) +
            f"; bound {bms:.4f} ms by {by} ({100 * bms / rec['auto']:.1f}% of auto); sha256 {rec['sha256'][:16]}")
        if m == VAR_MSM_POINTS:
            level = g2.pack(g2.scalar_mul(pts, scal))
            ms = cuda_ms(lambda: g2.sum_level(level), 10)
            bms, by = g2_add_bound(m // 2)
            out[f"g2_add at the first tree level of {m} points"] = {
                "auto": ms, "bound_ms": bms, "bound_by": by, "sha256": digest(g2.sum_level(level))}
            log(f"[tower-times] g2_add at the first tree level of {m} points ({m // 2} pairs): {ms:.4f} ms; bound "
                f"{bms:.5f} ms by {by}")
    label, (pts, scal) = next(iter(glv_time_sets(dev).items()))
    ref = torch.cat(list(g1.scalar_mul_windowed(pts, scal)))
    for form in windowed_forms():
        if not torch.equal(torch.cat(list(g1_windowed(pts, scal, form))), ref):
            raise AssertionError(f"g1_scalar_mul_windowed's forms disagree at {label}")
    rec = {f: cuda_ms(lambda f=f: g1_windowed(pts, scal, f), 10) for f in windowed_forms()}
    bms, by = windowed_bound(pts, scal)
    rec.update(bound_ms=bms, bound_by=by, sha256=digest(ref), k8_ms=cuda_ms(lambda: g1.scalar_mul_glv(pts, scal), 10),
               k5_ms=cuda_ms(lambda: g1.scalar_mul(pts, scal), 3))
    out[f"g1_scalar_mul_windowed at {label}"] = rec
    log(f"[tower-times] g1_scalar_mul_windowed at {label}: " +
        ", ".join(f"{f} {t:.4f} ms" for f, t in rec.items() if f in windowed_forms()) +
        f"; bound {bms:.4f} ms by {by} ({100 * bms / rec['auto']:.1f}% of auto); K8 {rec['k8_ms']:.4f} ms, K5 "
        f"{rec['k5_ms']:.4f} ms on the same inputs; sha256 {rec['sha256'][:16]}")
    return out


def attention_scores(dev):
    """bench.run_attention's block (seq 128, d 128, default_rng(0) weights,
    PRNGKey(0)) and its scores S from one forward."""
    from zkdl_tpu_torch import bench
    from zkdl_tpu_torch.models import quantize, zkattention
    from zkdl_tpu_torch.utils import prng

    seq, d = bench.ATTENTION_SEQ, bench.ATTENTION_D
    rng = np.random.default_rng(0)
    ws = [(rng.standard_normal((d, d)) * 0.2).astype(np.float32) for _ in range(4)]
    attn = zkattention.ZkAttention.from_float(seq, *ws, prng.PRNGKey(0), dev)
    X = bench.to_mont_rows(quantize.load_input(rng.standard_normal((seq, d)).astype(np.float32), dev))
    return attn.forward(X)[1]["S"], seq, d


def phase_tower(records: dict, scores=None) -> None:
    """Phase 10, the path of K10-K13, every count set to 0 first: a forward
    and an inverse NTT of 2^20 values and poly_mul of two 2^19-coefficient
    polynomials (held at a random point against the product of the
    factors' values, on the host); g2.msm at 4096 and 18,432 points, each
    sum equal in affine form to the host's sum over its six distinct points;
    scalar_mul_windowed at the verify's MSM shape, bit-equal to phase 2's
    plain run on the same inputs; the cheap softmax at the
    attention block's size on its scores S (phase 7's block): softmax_aux,
    softmax_prove under FiatShamir on the card and on the CPU (every array
    equal), softmax_verify, and three tampered copies rejected with the JAX
    verifier's reasons (tests/port/fixtures/slice14_jax.json). scores: (S,
    seq, d_model) of phase 7's block, or None to build the block here."""
    import dataclasses

    import torch
    from zkdl_tpu_torch.curve import g1, g2
    from zkdl_tpu_torch.field import fr, kernels
    from zkdl_tpu_torch.models import zkattention as za
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir
    from zkdl_tpu_torch.tensor import fft

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    path = (*kernels.FR_KERNELS, *tower_kernels())
    for kn in path:
        kn.launches = 0
    out = records["_tower"] = {}
    rng = np.random.default_rng(10)
    x = random_below_r(rng, 1 << NTT_LOG_N, dev)
    y = fft.ntt(x)
    if not torch.equal(fft.intt(y), x):
        raise AssertionError("intt(ntt(x)) != x at 2^20")
    half = 1 << (NTT_LOG_N - 1)
    a, b = random_below_r(rng, half, dev), random_below_r(rng, half, dev)
    t1 = time.perf_counter()
    c = fft.poly_mul(a, b)
    torch.cuda.synchronize()
    out["poly_mul_s"] = time.perf_counter() - t1
    z = int(rng.integers(2, 1 << 62))

    def at_z(t) -> int:  # Horner over the Montgomery coefficients' values
        acc = 0
        for v in reversed(fr.to_ints(t.cpu().numpy(), mont_form=True)):
            acc = (acc * z + v) % fr.P_INT
        return acc

    if c.shape[0] != 1 << NTT_LOG_N or at_z(c) != at_z(a) * at_z(b) % fr.P_INT:
        raise AssertionError("poly_mul of two 2^19-coefficient polynomials is not their product at a random point")
    log(f"[tower] ntt and intt at 2^{NTT_LOG_N} (intt(ntt(x)) == x); poly_mul of two 2^19-coefficient polynomials "
        f"(a 2^20 transform) in {out['poly_mul_s']:.4f}s, its value at a random point the product of theirs")
    for m in G2_MSM_SIZES:
        pts, scal = g2_msm_inputs(dev, m)
        t1 = time.perf_counter()
        s = g2.msm(pts, scal)
        torch.cuda.synchronize()
        out[f"g2_msm_{m}_s"] = time.perf_counter() - t1
        # point i is the edge batch's live point i mod 6: the sum is sum_j (sum_{i = j mod 6} k_i) P_j, the
        # coefficients taken as integers (the points lie off the r-torsion subgroup)
        ks = [sum(int(w) << (32 * j) for j, w in enumerate(row)) for row in scal.cpu().numpy().tolist()]
        want = None
        for j in range(6):
            pj = g2.to_affine_host(g2.G2Jac(*(g2.Fp2(f.c0[j].cpu(), f.c1[j].cpu()) for f in pts)))
            want = g2_host_add(want, g2_host_mul(pj, sum(ks[j::6])))
        got = g2.to_affine_host(g2.G2Jac(*(g2.Fp2(f.c0[0].cpu(), f.c1[0].cpu()) for f in s)))
        if got is None or got != want:
            raise AssertionError(f"g2.msm at {m} points is not sum_j c_j P_j on the host")
        log(f"[tower] g2.msm at {m} points: {out[f'g2_msm_{m}_s']:.4f}s, equal in affine form to the host's "
            "sum_j c_j P_j over its six distinct points")
    label, (pts, scal) = next(iter(glv_time_sets(dev).items()))
    w = g1.scalar_mul_windowed(pts, scal)
    same_points(f"g1_scalar_mul_windowed at {label}", w, records.pop("_g1_scalar_mul_windowed_want"))
    log(f"[tower] scalar_mul_windowed at {label}: bit-equal to plain (phase 2's run on these inputs)")

    # the cheap softmax at seq 128, d 128
    S, seq, d = scores or attention_scores(dev)
    t1 = time.perf_counter()
    P, q = za.softmax_aux(S, seq, seq, d)
    P_cpu, q_cpu = za.softmax_aux(S.cpu(), seq, seq, d)
    flips = int((q != q_cpu).sum())
    bits = za.p_range_bits(P)
    t2 = time.perf_counter()
    proof = za.softmax_prove(P, seq, seq, FiatShamir())
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t2
    ok = za.softmax_verify(proof)
    if ok != (True, ""):
        raise AssertionError(f"softmax_verify rejected the card's proof: {ok}")
    cpu = za.softmax_prove(P.cpu(), seq, seq, FiatShamir())
    for f in dataclasses.fields(proof):
        if not torch.equal(getattr(proof, f.name).cpu(), getattr(cpu, f.name)):
            raise AssertionError(f"cheap softmax proof: {f.name} differs between the card and the CPU")
    with open(SOFTMAX_CHEAP_JAX) as fh:
        jax_meta = json.load(fh)["recorded"]
    bad = dict(bin_poly=proof.bin_polys.clone(), ip_finals=proof.ip_finals.clone())
    for arr in bad.values():
        arr.view(torch.int32).reshape(-1)[0] ^= 1
    q_off = torch.from_numpy(q.astype(np.int64).reshape(-1)).to(dev)
    q_off[0] += 1
    from zkdl_tpu_torch.tensor import fr_ops

    tampers = {
        "bin_poly": dataclasses.replace(proof, bin_polys=bad["bin_poly"]),
        "ip_finals": dataclasses.replace(proof, ip_finals=bad["ip_finals"]),
        "row_sum": za.softmax_prove(fr_ops.to_mont(fr_ops.from_u32(q_off)), seq, seq, FiatShamir()),
    }
    for name, bad_proof in tampers.items():
        want = tuple(jax_meta[f"soft16_tamper_{name}"])
        got = za.softmax_verify(bad_proof)
        if got != (False, want[1]):
            raise AssertionError(f"cheap softmax tampered {name}: {got}, expected (False, {want[1]!r})")
        log(f"[tower] cheap softmax, tampered {name}: rejected: {got[1]}")
    out.update(softmax_seq=seq, softmax_d=d, softmax_entries=int(P.shape[0]), softmax_range_bits=int(bits.shape[0]),
               softmax_prove_s=prove_s, softmax_aux_and_bits_s=t2 - t1, softmax_card_cpu_P_flips=flips)
    log(f"[tower] cheap softmax at seq {seq}, d {d} on the block's scores: P of {P.shape[0]} entries "
        f"({bits.shape[0]} range bits; {flips} entries differ from the CPU's float32 softmax), aux and bits "
        f"{t2 - t1:.3f}s, prove {prove_s:.3f}s on the card, verified, every proof array equal to the CPU's proof of "
        "the same P")
    torch.cuda.synchronize()
    launches = {kn.name: kn.launches for kn in path}
    out["launches"] = launches
    log(f"[tower] kernel launches of phase 10: {json.dumps(launches)}")
    for kn in path:
        if kn.launches <= 0:
            raise AssertionError(f"kernel {kn.name} was not launched in phase 10")
        if kn in tower_kernels():
            records[kn.name]["launches"] = kn.launches
    out["seconds"] = time.perf_counter() - t0
    log(f"[time] phase 10 (tower, NTT, windowed, cheap softmax): {out['seconds']:.1f}s")


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one GPU", file=sys.stderr)
        return 2
    try:
        import zkdl_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    records: dict = {}
    args, k8_file = sys.argv[1:], None  # k8_file: one committed verify's K8 launches
    if len(args) == 2 and args[0] == "--save-k8-launches":  # the full run, writing k8_file
        args, k8_file = [], args[1]
    elif len(args) == 2 and args[0] == "--glv-times":  # and replaying it
        args, k8_file = args[:1], args[1]
    times_only = args in (["--comb"], ["--var-times"], ["--k7-times"], ["--glv-times"], ["--tower-times"])
    phase_build(host_library=not times_only, check_spills=not times_only)
    dev = torch.device("cuda")
    if args[:1] == ["--sharded"]:
        opts = dict(zip(args[1::2], args[2::2]))
        n, backend = int(opts.get("--ranks", 2)), opts.get("--backend", "gloo")
        if len(args) % 2 == 0 or set(opts) - {"--ranks", "--backend"} or backend not in ("gloo", "nccl"):
            print("usage: chip_smoke.py --sharded --ranks N --backend nccl|gloo", file=sys.stderr)
            return 2
        phase_sharded(records, n, backend, "cuda" if backend == "nccl" else "cuda:0")
        print(json.dumps({"sharded": records["_sharded"], "fr_collect_launches": records["fr_collect"]["launches"]}),
              flush=True)
        return 0
    if args == ["--comb"]:
        print(json.dumps({"g1_comb_shapes": phase_comb_times(dev, with_plain=False)}), flush=True)
        return 0
    if args == ["--var-times"]:
        times = {"g1_comb_shapes": phase_comb_times(dev, with_plain=False), **phase_var_times(dev)}
        print(json.dumps(times), flush=True)
        return 0
    if args == ["--k7-times"]:
        print(json.dumps({"fr_batch_inverse_shapes": phase_k7_times(dev)}), flush=True)
        return 0
    if args == ["--glv-times"]:
        print(json.dumps({"g1_scalar_mul_glv_times": phase_glv_times(dev, k8_file)}), flush=True)
        return 0
    if args == ["--tower-times"]:
        print(json.dumps({"tower_times": phase_tower_times(dev)}), flush=True)
        return 0
    if args == ["--attention"]:
        phase_k7(records)
        phase_attention(records)
        print(json.dumps({"attention": records["_attention"]}), flush=True)
        return 0
    if args == ["--glv"]:
        phase_glv(dev, records)
        for label, (pts, scal) in glv_time_sets(dev).items():
            time_glv(records, label, pts, scal)
        print(json.dumps({"g1_scalar_mul_glv_shapes": records["_g1_scalar_mul_glv_shapes"],
                          "g1_scalar_mul_glv_forms": glv_form_sweep(dev)}), flush=True)
        return 0
    if args == ["--tower"]:
        phase_tower_kernels(records)
        phase_tower(records)
        print(json.dumps({**{k: records[k] for k in ("fr_ntt", "g2_scalar_mul", "g2_add", "g1_scalar_mul_windowed",
                                                     "_fr_ntt_shapes", "_g2_shapes", "_g1_scalar_mul_windowed_edges",
                                                     "_g1_scalar_mul_windowed_msm", "_tower")},
                          "tower_forms": tower_form_sweep(dev)}), flush=True)
        return 0
    if args == ["--var"]:
        phase_var(dev, records)
        print(json.dumps({"g1_scalar_mul_shapes": records["_g1_scalar_mul_shapes"], **phase_var_times(dev)}),
              flush=True)
        return 0
    phase_kernels(records)
    phase_var(dev, records)
    phase_glv(dev, records)
    phase_collect(records)
    phase_tower_kernels(records)
    records["_var_times"] = phase_var_times(dev)
    log(f"[time] phases 1-2: {time.perf_counter() - t0:.1f}s")
    phase_small()
    log(f"[time] phase 3: {time.perf_counter() - t0:.1f}s")
    res = phase_zkdl256(records)
    log(f"[time] phase 4: {time.perf_counter() - t0:.1f}s")
    phase_sharded(records, 2, "gloo", "cuda:0", single_sha=proof_sha(res["proof"]), single_prove_s=res["prove_s"])
    phase_me_open(res, records)
    log(f"[time] phase 9 (sharded, me_open): {time.perf_counter() - t0:.1f}s")
    phase_committed(records, res, save_k8=k8_file)
    log(f"[time] phase 6 (committed): {time.perf_counter() - t0:.1f}s")
    phase_blinded(res, records)
    phase_checkpoint(res, records)
    log(f"[time] phase 8 (blinded, checkpoint): {time.perf_counter() - t0:.1f}s")
    phase_demo(records)
    phase_schedules(records, res)
    del res
    log(f"[time] phase 5: {time.perf_counter() - t0:.1f}s")
    phase_conv(records)
    log(f"[time] phase 8 (conv): {time.perf_counter() - t0:.1f}s")
    phase_k7(records)
    phase_attention(records)
    log(f"[time] phase 7 (attention): {time.perf_counter() - t0:.1f}s")
    phase_tower(records, records.pop("_attention_S"))
    log(f"[time] phase 10 (tower): {time.perf_counter() - t0:.1f}s")
    kernels_line = []
    for k in port_kernels():
        r = records[k.name]
        kernels_line.append({"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
                             "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                             "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                             "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels_line, "fr_dot_shapes": records["_fr_dot_shapes"],
                      "g1_comb_shapes": records["_g1_comb_shapes"],
                      "g1_scalar_mul_shapes": records["_g1_scalar_mul_shapes"],
                      "g1_add_shapes": records["_g1_add_shapes"], "var_times": records["_var_times"],
                      "zkdl256": records["_zkdl256"],
                      "committed": records["_committed"], "demo": records["_demo"],
                      "schedules": records["_schedules"], "attention": records["_attention"],
                      "g1_scalar_mul_glv_shapes": records["_g1_scalar_mul_glv_shapes"],
                      "fr_ntt_shapes": records["_fr_ntt_shapes"], "g2_shapes": records["_g2_shapes"],
                      "g1_scalar_mul_windowed_msm": records["_g1_scalar_mul_windowed_msm"],
                      "g1_scalar_mul_windowed_edges": records["_g1_scalar_mul_windowed_edges"],
                      "tower": records["_tower"],
                      "blinded": records["_blinded"], "checkpoint": records["_checkpoint"],
                      "conv": records["_conv"], "sharded": records["_sharded"],
                      "me_open": records["_me_open"]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
