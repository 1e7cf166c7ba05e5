"""Each sharded protocol function of the port (parallel/sharded.py,
parallel/model.py, parallel/collectives.py) on 2, 4 and 8 gloo ranks of
the CPU, against the JAX package's sharded functions at 4 devices
(tests/port/fixtures/slice13_jax.npz, each asserted there equal to its
single-device function) and against the port's single-device function on
the whole tensors; every rank's output the same."""

import numpy as np
import pytest
import torch

import sharded_runs
import slice13_fixture as fx
from zkdl_tpu_torch.commit import pedersen
from zkdl_tpu_torch.models import zkfc
from zkdl_tpu_torch.sumcheck import protocols as sc
from zkdl_tpu_torch.tensor import fr_ops


def _single() -> dict:
    """The port's single-device functions on the recorded inputs."""
    u, v, a, b = fx.t("kern/in.u"), fx.t("kern/in.v"), fx.t("kern/in.a"), fx.t("kern/in.b")
    return {
        "binary": lambda: sc.binary_prove(fx.t("kern/in.bits"), u, v),
        "hadamard": lambda: sc.hadamard_prove(a, b, u, v),
        "inner_product": lambda: sc.inner_product_prove(a, b, u),
        "me_eval": lambda: (fr_ops.me_eval(a, u),),
        "partial_me": lambda: (fr_ops.partial_me(a, u[:4], 4),),
        "commit_dlogs": lambda: (pedersen._commit_rows_fast(fx.t("kern/in.t").reshape(8, 8, 8),
                                                            fx.t("kern/in.dlogs")),),
        "matmul": lambda: (zkfc.field_matmul(fx.t("kern/in.X"), fx.t("kern/in.W"), 16, 16),),
    }


FUNCTIONS = ["binary", "hadamard", "inner_product", "me_eval", "partial_me", "commit_dlogs", "matmul"]


@pytest.fixture(scope="module")
def runs(shared_tmp):
    return lambda n: sharded_runs.kernel_outputs(sharded_runs.run_dir(shared_tmp, n), n)


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_function(runs, n, fn):
    outs = runs(n)
    keys = sorted(k for k in outs[0] if k.startswith(fn + "."))
    single = _single()[fn]()
    assert len(keys) == len(single)
    for k, s in zip(keys, single):
        np.testing.assert_array_equal(outs[0][k], fx.rec(f"kern/{k}"), err_msg=k)
        np.testing.assert_array_equal(outs[0][k], s.numpy(), err_msg=f"{k} vs the port's single device")
        for r, o in enumerate(outs[1:], 1):
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=f"{k} on rank {r}")


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_psum(runs, n):
    """psum_fr of each rank's recorded value equals the JAX psum_fr over
    n devices, on every rank."""
    for o in runs(n):
        np.testing.assert_array_equal(o["psum"], fx.rec(f"collect/psum{n}"))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_commit_aux_sharded(runs, n):
    """The row-sharded NUMS commitments of the 8-wide model's first ReLU aux
    (rows gathered; at 8 ranks the sign tensor's 8 rows one a rank) equal
    the single-device zkrelu.commit_aux limb for limb, on every rank."""
    for o in runs(n):
        for name in ("sign", "mag", "rem"):
            for c in ("x", "y", "z"):
                np.testing.assert_array_equal(o[f"commit_aux.{name}.{c}"], o[f"commit_aux_single.{name}.{c}"],
                                              err_msg=f"{name}.{c}")
