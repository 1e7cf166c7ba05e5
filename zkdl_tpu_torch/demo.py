"""End-to-end demo CLI of the port (the port's copy of ``zkdl_tpu/demo.py``).

    python -m zkdl_tpu_torch.demo traced_model.pt sample_input.pt [--out demo.out]
        [--verify] [--interleave] [--commit-aux] [--device cuda]

Loads a TorchScript MLP, quantizes and commits the weights (generators from
PRNGKey(0), as the JAX demo draws them), runs quantized inference, writes
the raw field output to --out (one line per element: its 8 limbs, most
significant first, as %08x), then times the backwards proving loop and
prints seconds per data point; --verify checks the proof with Fiat-Shamir
replay and the public anchors on X and Y_hat. --interleave proves and
verifies with the round-interleaved Fiat-Shamir schedule. --commit-aux (or
ZKDL_COMMIT_AUX=1, read by the prover) proves the committed-aux tier: every
ReLU's auxiliary bits are committed over NUMS generators and opened where
the proof claims their values, and --verify checks those openings too.
Runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .commit.pedersen import from_mont_rows, to_mont_rows
from .field import mp
from .io import pt_loader
from .models import mlp, quantize
from .sumcheck.transcript import FiatShamir
from .utils import prng, profiling
from .utils.runtime import resolve_device


def write_output(path: str, Y_hat: torch.Tensor) -> None:
    """Y_hat's raw (non-Montgomery) values, one element a line, limbs most
    significant first."""
    vals = mp.host(from_mont_rows(Y_hat))
    with open(path, "w") as f:
        for row in vals:
            f.write("".join(f"{int(v):08x}" for v in reversed(row)) + "\n")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("model")
    parser.add_argument("input")
    parser.add_argument("--out", default="demo.out")
    parser.add_argument("--verify", action="store_true")
    parser.add_argument("--commit-aux", action="store_true",
                        help="committed-aux soundness tier (aux bit commitments and their openings)")
    parser.add_argument("--interleave", action="store_true",
                        help="round-interleaved Fiat-Shamir (textbook sumcheck "
                             "FS order; one host round trip per round)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain PyTorch versions)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    timer = profiling.PhaseTimer(dev)

    weights = pt_loader.load_mlp_weights(args.model, dev)
    n_params = sum(w.numel() for w in weights)
    print(f"Total number of parameters: {n_params}")

    with timer.phase("setup"):
        model = mlp.MLP.from_float_weights(weights, prng.PRNGKey(0), dev)
    print(f"Commit/setup time: {timer.totals['setup']:.2f}s")

    x = pt_loader.load_tensor(args.input, dev)
    batch = x.shape[0]
    X = to_mont_rows(quantize.load_input(x, dev))

    with timer.phase("inference"):
        Y_hat, Z_list, A_list, aux_list = model.infer(X)
    print(f"Inference time: {timer.totals['inference']:.2f}s")

    write_output(args.out, Y_hat)

    with timer.phase("proof"):
        proof = model.prove(X, Y_hat, Z_list, A_list, aux_list, FiatShamir(), interleave=args.interleave,
                            commit_aux=args.commit_aux or None)
    print(f"Proof time: {timer.totals['proof'] / batch} seconds per data point.")

    if args.verify:
        with timer.phase("verification"):
            # the claim chain from the public output Y_hat down to the public
            # input X, with every challenge re-derived from the transcript
            ok, msg = model.verify(proof, X=X, Y_hat=Y_hat, transcript=FiatShamir(),
                                   interleaved=args.interleave)
        print(f"Verification: {'OK' if ok else 'FAILED: ' + msg} ({timer.totals['verification']:.2f}s)")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
