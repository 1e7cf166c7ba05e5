"""Module-level checks of the port against the JAX package on the same seeded
inputs: quantizer, eq tables, the exact field matmul, the ReLU forward, the
Pedersen commitment; plus the entry points' device rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_helpers import rand_fr
from zkdl_tpu.curve import host_g1 as jhost
from zkdl_tpu.models import quantize as jquantize
from zkdl_tpu.models import zkfc as jzkfc
from zkdl_tpu.models import zkrelu as jzkrelu
from zkdl_tpu.tensor import planar_ops as jpops
from zkdl_tpu_torch import bench
from zkdl_tpu_torch.commit import pedersen
from zkdl_tpu_torch.field import fp, fr, host, mp
from zkdl_tpu_torch.models import convert, mlp, quantize, zkfc, zkrelu
from zkdl_tpu_torch.tensor import planar_ops as pops
from zkdl_tpu_torch.utils import prng

RNG = np.random.default_rng(70)
W_FLOAT = (RNG.uniform(-1, 1, (8, 6)) / 3).astype(np.float32)  # padded to 8 x 8
X_FLOAT = RNG.standard_normal((3, 8)).astype(np.float32)  # batch padded to 4


def test_quantizer_matches_jax():
    np.testing.assert_array_equal(quantize.load_weights(W_FLOAT, "cpu").numpy(),
                                  np.asarray(jquantize.load_weights(W_FLOAT)))
    np.testing.assert_array_equal(quantize.load_input(X_FLOAT, "cpu").numpy(),
                                  np.asarray(jquantize.load_input(X_FLOAT)))


@pytest.mark.parametrize("name", ["eq_table", "eq_table_rev"])
def test_eq_tables_match_jax(name):
    u = rand_fr(71, 2)
    got = getattr(pops, name)(u, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jpops, name)(jnp.asarray(u))))


def test_bitrev_matches_jax():
    t = torch.arange(8 * 16, dtype=torch.int64).reshape(8, 16).to(torch.uint32)
    np.testing.assert_array_equal(pops.bitrev_axis(t, 1).numpy(), np.asarray(jpops.bitrev_axis(t.numpy(), 1)))


def test_matmul_and_relu_forward_match_jax():
    W = quantize.load_weights(W_FLOAT, "cpu")
    X = pedersen.to_mont_rows(quantize.load_input(X_FLOAT, "cpu"))
    Z = zkfc.field_matmul_fast(X, W, 8, 8)
    jZ = jzkfc.field_matmul_fast_jit(jnp.asarray(X.numpy()), jnp.asarray(W.numpy()), 8, 8)
    np.testing.assert_array_equal(Z.numpy(), np.asarray(jZ))
    A, aux = zkrelu.forward_compact(Z)
    jA, jaux = jzkrelu.forward_compact(jZ)
    np.testing.assert_array_equal(A.numpy(), np.asarray(jA))
    for k in ("sign_bits", "mag", "rem_bits16"):
        np.testing.assert_array_equal(aux[k].numpy(), np.asarray(jaux[k]), err_msg=k)


def test_commit_rows_are_generator_powers_of_the_dlog_sums():
    gens = pedersen.setup(prng.PRNGKey(72), 4, "cpu")
    t = torch.from_numpy(rand_fr(73, 8))  # 2 rows of 4
    com = pedersen.commit(gens, t)
    HF = host.fr
    d = fr.to_ints(gens.dlogs.numpy())
    for row in range(2):
        tv = fr.to_ints(t[4 * row : 4 * row + 4].numpy())
        sigma = 0
        for a, b in zip(tv, d):
            sigma = HF.add(sigma, HF.mul(a, b))
        assert fr.to_ints(com.dlogs[row].numpy()) == [sigma]
        pt = jhost.JacPoint(*(fp.SPEC.from_mont_int(mp.int_from_limbs(c[row].numpy())) for c in com.points))
        assert jhost.eq_points(pt, jhost.scalar_mul(jhost.GENERATOR, HF.unmont(sigma)))
    # generators: points[i] = G^unmont(dlogs[i])
    for i, dl in enumerate(d):
        pt = jhost.JacPoint(*(fp.SPEC.from_mont_int(mp.int_from_limbs(c[i].numpy())) for c in gens.points))
        assert jhost.eq_points(pt, jhost.scalar_mul(jhost.GENERATOR, HF.unmont(dl)))


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mlp.MLP.from_float_weights([W_FLOAT], prng.PRNGKey(0))
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run("micro")
    with pytest.raises(RuntimeError, match="cuda"):
        convert.layer_from_arrays(np.zeros((64, 8), np.uint32), np.zeros((8, 8), np.uint32), 8, 8)


# --- tensor/planar_ops.py's folds and evaluations (recorded by record_slice14.py)

PLANAR_OPS = {
    "to_rev": lambda t, x, u: pops.to_planar_rev(t, 4),
    "to_rev_pad": lambda t, x, u: pops.to_planar_rev(t[:11], 4),
    "from_rev": lambda t, x, u: pops.from_planar_rev(pops.to_planar_rev(t, 4)),
    "fold_half": lambda t, x, u: pops.fold_half(pops.to_planar_rev(t, 4), x),
    "fold_axis1": lambda t, x, u: pops.fold_axis(t.transpose(0, 1).reshape(8, 4, 4), x, 1),
    "fold_axis2": lambda t, x, u: pops.fold_axis(t.transpose(0, 1).reshape(8, 4, 4), x, 2),
    "me_eval_rev": lambda t, x, u: pops.me_eval_rev(pops.to_planar_rev(t, 4), u),
    "me_eval_rev_dot": lambda t, x, u: pops.me_eval_rev_dot(pops.to_planar_rev(t, 4), u),
    "inverse_scalar": lambda t, x, u: pops.inverse_scalar(x),
}


@pytest.mark.parametrize("op", sorted(PLANAR_OPS))
def test_planar_op_equals_jax(op):
    """On a 16-entry Montgomery tensor, a scalar and a 4-variable point."""
    from slice14_fixture import same, t

    got = PLANAR_OPS[op](t("planar/t"), t("planar/x"), t("planar/u"))
    assert same(got, f"planar/{op}")
