"""One rank of the sharded tests' runs (``multihost.launch`` target): the
port's sharded functions on the recorded inputs of ``slice13_jax.npz`` and
the 8-wide model's sharded proofs, written to the run's directory for the
tests (``sharded_runs.py``) to hold against the recordings.

    main([out_dir])  # every rank; rank r writes kern_rank<r>.npz and
                     # <mode>_rank<r>.bin, each proof serialized by proof_io

The protocol functions run on the dp-only global mesh of every rank, the
matmul on the default (n/2, 2) one. At 4 ranks the chained Fiat-Shamir and the
committed-aux proofs are made too, and the fr_sum of random blocks.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import slice13_fixture as fx  # noqa: E402

FULL_MODES_AT = 4  # the rank count at which the chained and committed proofs are made


def kernels(mesh, n: int) -> dict:
    from zkdl_tpu_torch.commit import pedersen
    from zkdl_tpu_torch.field import kernels as fk
    from zkdl_tpu_torch.models import zkrelu
    from zkdl_tpu_torch.parallel import collectives
    from zkdl_tpu_torch.parallel import model as pmodel
    from zkdl_tpu_torch.parallel import multihost, sharded
    from zkdl_tpu_torch.tensor import fr_ops
    from zkdl_tpu_torch.utils import prng

    out = {}
    sh = lambda x: multihost.global_sharded(mesh, x)  # noqa: E731
    u, v, a, b = fx.t("kern/in.u"), fx.t("kern/in.v"), fx.t("kern/in.a"), fx.t("kern/in.b")
    out["binary.0"], out["binary.1"] = pmodel.sharded_binary_prove(mesh, sh(fx.t("kern/in.bits")), u, v)
    out["hadamard.0"], out["hadamard.1"] = pmodel.sharded_hadamard_prove(mesh, sh(a), sh(b), u, v)
    out["inner_product.0"], out["inner_product.1"] = sharded.sharded_inner_product_prove(mesh, sh(a), sh(b), u)
    out["me_eval.0"] = pmodel.sharded_me_eval(mesh, sh(a), u)
    out["partial_me.0"] = pmodel.sharded_partial_me(mesh, sh(a), u[:4], 4)
    out["commit_dlogs.0"] = pmodel.sharded_commit_dlogs(mesh, sh(fx.t("kern/in.t")), fx.t("kern/in.dlogs"))
    mesh2 = sharded.make_mesh()
    out["matmul.0"] = sharded.sharded_field_matmul(mesh2, multihost.global_sharded(mesh2, fx.rec("kern/in.X")),
                                                   multihost.global_replicated(mesh2, fx.rec("kern/in.W")), 16, 16,
                                                   gather=True)
    vals = fx.t(f"collect/values{n}")
    out["psum"] = collectives.psum_fr(vals[mesh.index("dp")], mesh, "dp")
    if n == FULL_MODES_AT:
        blocks = pedersen.to_mont_rows(fr_ops.random_fr(prng.PRNGKey(91), 64, "cpu"))
        out["fr_sum"] = collectives.fr_sum_local_then_psum(sh(blocks), mesh, "dp")
        out["fr_sum_whole"] = fr_ops.fr_sum(blocks)
    aux0 = zkrelu.compact_aux({k: fx.t(f"model/aux0.{k}") for k in ("sign", "mag_bin", "rem_bin")})
    com = pmodel.commit_aux_sharded(mesh, aux0)
    want = zkrelu.commit_aux(aux0)
    for name in ("sign", "mag", "rem"):
        for c in ("x", "y", "z"):
            out[f"commit_aux.{name}.{c}"] = getattr(getattr(com, name).points, c)
            out[f"commit_aux_single.{name}.{c}"] = getattr(getattr(want, name).points, c)
    out["_collect_launches"] = torch.tensor([fk.COLLECT.launches])
    return {k: v.numpy() for k, v in out.items()}


def proofs(mesh, n: int) -> dict:
    """{mode: serialized proof} of the 8-wide model proved by prove_sharded."""
    from zkdl_tpu_torch.io import proof_io
    from zkdl_tpu_torch.parallel import model as pmodel
    from zkdl_tpu_torch.sumcheck.transcript import FiatShamir, SeededRng

    model, X = fx.tiny_model()
    Y, Z, A, aux = model.infer(X)
    out = {"unchained": pmodel.prove_sharded(model, X, Y, Z, A, aux, mesh, SeededRng(7))}
    if n == FULL_MODES_AT:
        out["chained"] = pmodel.prove_sharded(model, X, Y, Z, A, aux, mesh, FiatShamir(), chain=True)
        out["committed"] = pmodel.prove_sharded(model, X, Y, Z, A, aux, mesh, FiatShamir(), chain=True,
                                                commit_aux=True)
    return {k: proof_io.serialize(p) for k, p in out.items()}


def main(argv) -> None:
    from zkdl_tpu_torch.parallel import multihost

    out = pathlib.Path(argv[0])
    n, r = dist.get_world_size(), dist.get_rank()
    mesh = multihost.global_mesh(tp=1)
    # the device the launch asked for reaches the mesh
    assert multihost._DEVICE == mesh.device == torch.device("cpu"), (multihost._DEVICE, mesh.device)
    np.savez(out / f"kern_rank{r}.npz", **kernels(mesh, n))
    for mode, blob in proofs(mesh, n).items():
        (out / f"{mode}_rank{r}.bin").write_bytes(blob)


def fail(argv) -> None:
    """A rank that raises while the others wait in a collective."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    t = torch.zeros(1)
    dist.all_reduce(t)
