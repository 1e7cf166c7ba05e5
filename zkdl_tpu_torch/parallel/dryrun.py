"""Multi-rank dry run: one sharded proving step on small shapes.

Counterpart of ``zkdl_tpu/parallel/dryrun.py:run`` (:13), the JAX
package's ``__graft_entry__.dryrun_multichip``. On a (dp, tp) mesh of every
rank ((n/2, 2) for an even n > 1, else (n, 1)) it runs the dp x tp sharded
field matmul forward, the zkReLU forward of each rank's dp block, and a
dp-sharded inner-product sumcheck with one modular all-reduce of its local
rounds, and checks each against the single-device function on the whole
tensors, bit for bit.

    python -m zkdl_tpu_torch.parallel.dryrun --ranks N [--backend gloo|nccl] [--device cpu|cuda|cuda:K]

starts its N ranks itself (``multihost.launch``): the device defaults to
"cuda" (rank r on card r), the backend to NCCL on cards and gloo on the
CPU; two ranks on one card need ``--device cuda:0 --backend gloo``. Prints
rank 0's summary line; exits nonzero if a rank fails.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def run(mesh) -> str:
    """The dry run on this rank of `mesh` (every rank calls it); returns
    the summary."""
    from ..commit.pedersen import to_mont_rows
    from ..models import quantize, zkfc, zkrelu
    from ..sumcheck import protocols as sc
    from ..tensor import fr_ops
    from ..utils import prng
    from . import sharded

    dev = mesh.device
    dp, tp = mesh.dp, mesh.tp
    rng = np.random.default_rng(0)
    in_s, out_s = 16, 16
    batch = max(4 * dp, 8)
    W = quantize.load_weights((rng.standard_normal((in_s, out_s)) * 0.3).astype(np.float32), dev)
    X = to_mont_rows(quantize.load_input(rng.standard_normal((batch, in_s)).astype(np.float32), dev))

    # dp x tp sharded forward: this rank's block, and the whole gathered
    Z_ref = zkfc.field_matmul(X, W, in_s, out_s)
    Z_blk = sharded.sharded_field_matmul(mesh, sharded.shard(mesh, X), W, in_s, out_s)
    b_local, out_local = batch // dp, out_s // tp
    ref_blk = Z_ref.reshape(batch, out_s, 8)[mesh.index("dp") * b_local:(mesh.index("dp") + 1) * b_local,
                                             mesh.index("tp") * out_local:(mesh.index("tp") + 1) * out_local]
    if not torch.equal(Z_blk, ref_blk):
        raise AssertionError("sharded matmul block differs")
    Z = sharded.sharded_field_matmul(mesh, sharded.shard(mesh, X), W, in_s, out_s, gather=True)
    if not torch.equal(Z, Z_ref):
        raise AssertionError("sharded matmul (gathered) differs")

    # dp-sharded zkReLU forward: elementwise, each rank its block
    A_blk, aux_blk = zkrelu.forward_compact(sharded.shard(mesh, Z))
    A_ref, aux_ref = zkrelu.forward_compact(Z)
    if not torch.equal(A_blk, sharded.shard(mesh, A_ref)) or any(
            not torch.equal(aux_blk[k], sharded.shard(mesh, aux_ref[k])) for k in aux_ref):
        raise AssertionError("sharded zkReLU forward differs")

    # dp-sharded inner-product sumcheck
    n = Z.shape[0]
    b = fr_ops.random_fr(prng.PRNGKey(1), n, dev)
    u = fr_ops.random_fr(prng.PRNGKey(2), fr_ops.ceil_log2(n), "cpu")
    polys, finals = sharded.sharded_inner_product_prove(mesh, sharded.shard(mesh, Z), sharded.shard(mesh, b), u)
    polys_ref, finals_ref = sc.inner_product_prove(Z, b, u)
    if not (torch.equal(polys, polys_ref) and torch.equal(finals, finals_ref)):
        raise AssertionError("sharded sumcheck stream differs")
    return (f"dryrun OK: mesh={mesh.shape} batch={batch} n={n} on {dev}: sharded matmul, zkReLU forward "
            f"and inner-product sumcheck ({polys.shape[0]} rounds) bit-identical to one device")


def _rank(argv) -> None:
    """multihost.launch target: the dry run on this rank; rank 0 prints."""
    from . import sharded

    line = run(sharded.make_mesh())
    if torch.distributed.get_rank() == 0:
        print(line, flush=True)


def main(argv=None) -> int:
    from . import multihost

    ap = argparse.ArgumentParser(prog="python -m zkdl_tpu_torch.parallel.dryrun")
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--device", default="cuda", help="cpu, cuda (rank r on card r) or cuda:K (every rank on card K)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on cards, gloo on the CPU")
    ap.add_argument("--timeout", type=float, default=multihost.DEFAULT_TIMEOUT_S)
    a = ap.parse_args(argv)
    backend = a.backend or ("gloo" if a.device == "cpu" else "nccl")
    outs = multihost.launch("zkdl_tpu_torch.parallel.dryrun:_rank", a.ranks, backend, a.device,
                            timeout_s=a.timeout)
    print(outs[0].strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
