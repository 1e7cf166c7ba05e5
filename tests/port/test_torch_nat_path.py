"""The (n, 8) reference path of the port against the JAX package's
(tests/port/fixtures/slice13_jax.npz, recorded on the 8-wide model of
tests/test_sharded_model.py): zkrelu.forward's expanded aux; MLP.infer and
MLP.prove(chain=False), whose stream is the JAX (n, 8) path's (unchained
SeededRng(7), array for array), also checkpointed; the unchained requests
for committed aux that every prover refuses; and pedersen's me_open_fast,
open and me_open on transparent and NUMS generators of 8 and 16. me_open's
round points and final generator come from GLV (K8) on subgroup
generators, as the JAX package computes them on an accelerator, and are
held in affine form against the JAX CPU branch's double-and-add; with
glv_safe off (K5) and everywhere else, arrays are compared limb for limb."""

import numpy as np
import pytest
import torch

import slice13_fixture as fx
from zkdl_tpu_torch.commit import pedersen
from zkdl_tpu_torch.curve import convert, g1
from zkdl_tpu_torch.io import proof_io
from zkdl_tpu_torch.models import zkrelu
from zkdl_tpu_torch.parallel import model as pmodel
from zkdl_tpu_torch.sumcheck import protocols as sc
from zkdl_tpu_torch.sumcheck.transcript import FiatShamir, SeededRng
from zkdl_tpu_torch.tensor import fr_ops


@pytest.fixture(scope="module")
def tiny():
    return fx.tiny_model()


def test_forward_expanded_aux():
    Z, aux = zkrelu.forward(fx.t("model/Z0"))
    np.testing.assert_array_equal(Z.numpy(), fx.rec("model/A0"))
    assert sorted(aux) == ["mag_bin", "rem_bin", "sign"]
    for k, v in aux.items():
        np.testing.assert_array_equal(v.numpy(), fx.rec(f"model/aux0.{k}"), err_msg=k)


def test_infer_and_prove_nat_path(tiny):
    """MLP.infer's compact aux is the recorded expanded aux compacted, and
    MLP.prove(chain=False) is the recorded (n, 8) proof."""
    model, X = tiny
    np.testing.assert_array_equal(X.numpy(), fx.rec("model/X"))
    Y, Z, A, aux = model.infer(X)
    np.testing.assert_array_equal(Y.numpy(), fx.rec("model/Y"))
    want = zkrelu.compact_aux({k: fx.t(f"model/aux0.{k}") for k in ("sign", "mag_bin", "rem_bin")})
    assert sorted(aux[0]) == sorted(want)
    for k, v in aux[0].items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    proof = model.prove(X, Y, Z, A, aux, SeededRng(7), chain=False)
    assert fx.differing(fx.flat(proof), fx.proof_arrays("model/nat")) == []
    assert model.verify(proof) == fx.verdict("nat") == (True, "")


@pytest.mark.parametrize("prover", ["mlp", "checkpointed", "sharded"])
def test_nat_path_refuses(tiny, tmp_path, prover):
    """Committed aux without chaining raises in every prover, as in the JAX
    package, before anything is proved."""
    model, X = tiny
    Y, Z, A, aux = model.infer(X)
    call = {
        "mlp": lambda: model.prove(X, Y, Z, A, aux, SeededRng(7), chain=False, commit_aux=True),
        "checkpointed": lambda: proof_io.prove_mlp_checkpointed(model, X, Y, Z, A, aux, SeededRng(7),
                                                                proof_io.ProofCheckpoint(tmp_path), chain=False,
                                                                commit_aux=True),
        "sharded": lambda: pmodel.prove_sharded(model, X, Y, Z, A, aux, None, SeededRng(7), chain=False,
                                                commit_aux=True),
    }[prover]
    with pytest.raises(ValueError, match="committed aux requires chained mode"):
        call()


def test_checkpointed_nat_path(tiny, tmp_path):
    """prove_mlp_checkpointed(chain=False): the recorded (n, 8) proof, also
    after resuming from its first layer files."""
    model, X = tiny
    Y, Z, A, aux = model.infer(X)
    ckpt = proof_io.ProofCheckpoint(tmp_path)
    first = proof_io.prove_mlp_checkpointed(model, X, Y, Z, A, aux, SeededRng(7), ckpt, chain=False)
    (tmp_path / "fc_000.npz").unlink()
    resumed = proof_io.prove_mlp_checkpointed(model, X, Y, Z, A, aux, SeededRng(7), proof_io.ProofCheckpoint(tmp_path),
                                              chain=False)
    for p in (first, resumed):
        assert fx.differing(fx.flat(p), fx.proof_arrays("model/nat")) == []


def _points(prefix: str) -> g1.G1Jac:
    return g1.G1Jac(*(fx.t(f"{prefix}.{c}") for c in ("x", "y", "z")))


def _gens(size: int, kind: str) -> pedersen.Generators:
    p = f"open/{size}/{kind}"
    dlogs = fx.t(f"{p}/dlogs") if kind == "dlog" else None
    return pedersen.Generators(points=_points(f"{p}/gens"), dlogs=dlogs, glv_safe=True)


def _affine(p: g1.G1Jac):
    return convert.affine_from_device(g1.G1Jac(*(c.reshape(-1, 12) for c in p)))


def _check_split_fold(got, prefix: str, limbs: bool) -> None:
    """me_open's (round_points, final_gen, final_scalar) against the recorded
    ones: the points limb for limb, or in affine form."""
    rounds, final_gen, final_scalar = got
    n_rounds = len([k for k in fx.recorded()[0] if k.startswith(prefix + "/round") and k.endswith(".x")])
    assert len(rounds) == n_rounds
    for i, pts in enumerate([*rounds, final_gen]):
        want = _points(f"{prefix}/round{i}" if i < n_rounds else f"{prefix}/final_gen")
        if limbs:
            for c, w in zip(pts, want):
                np.testing.assert_array_equal(c.numpy(), w.numpy(), err_msg=f"{prefix} point {i}")
        else:
            assert _affine(pts) == _affine(want), f"{prefix} point {i}"
    np.testing.assert_array_equal(final_scalar.numpy(), fx.rec(f"{prefix}/final_scalar"))


@pytest.mark.parametrize("size", [8, 16])
def test_me_open_fast(size):
    p = f"open/{size}/dlog"
    log_g = fr_ops.ceil_log2(size)
    got = pedersen.me_open_fast(fx.t(f"open/{size}/t")[:size], fx.t(f"{p}/dlogs"), fx.t(f"open/{size}/u")[:log_g])
    _check_split_fold(got, f"{p}/me_open_fast", limbs=True)


@pytest.mark.parametrize("size", [8, 16])
def test_open_transparent(size):
    """open with dlogs: every array of the JAX opening, and open_planar's."""
    p = f"open/{size}/dlog"
    gens = _gens(size, "dlog")
    com = pedersen.RowCommitments(points=_points(f"{p}/com"), dlogs=fx.t(f"{p}/com.dlogs"))
    t, u = fx.t(f"open/{size}/t"), fx.t(f"open/{size}/u")
    got = fx.flat(pedersen.open(gens, t, com, u))
    assert fx.differing(got, fx.proof_arrays(f"{p}/open")) == []
    assert fx.differing(fx.flat(pedersen.open_planar(gens, t, com, u)), got) == []


@pytest.mark.parametrize("size", [8, 16])
def test_open_opaque(size):
    """open on NUMS generators (no dlogs): com(u_row) by the G1 MLE limb for
    limb, me_open's points by GLV in affine form, the final scalar exactly;
    the host verifier's verdict is the JAX verifier's."""
    p = f"open/{size}/nums"
    t, u = fx.t(f"open/{size}/t"), fx.t(f"open/{size}/u")
    proof = pedersen.open(_gens(size, "nums"), t, pedersen.RowCommitments(points=_points(f"{p}/com")), u)
    want = fx.proof_arrays(f"{p}/open")
    got = fx.flat(proof)
    for k in ("p.com_at_u_row.x", "p.com_at_u_row.y", "p.com_at_u_row.z", "p.final_scalar"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for i, pts in enumerate([*proof.round_points, proof.final_gen]):
        name = f"p.round_points[{i}]" if i < len(proof.round_points) else "p.final_gen"
        assert _affine(pts) == _affine(g1.G1Jac(*(torch.from_numpy(want[f"{name}.{c}"]) for c in "xyz"))), name
    value = sc.scalars_to_ints(fr_ops.me_eval(t, u)[None])[0]
    assert pedersen.verify_open(proof, sc.scalars_to_ints(u), value) == fx.verdict(f"{p}/open") == (True, "")


def test_me_open_double_and_add():
    """glv_safe off: every product by K5's double-and-add (its plain version
    here), the JAX CPU branch's limbs exactly."""
    p = "open/8/nums"
    got = pedersen.me_open(fx.t("open/8/t")[:8], _points(f"{p}/gens"), fx.t("open/8/u")[:3], glv_safe=False)
    _check_split_fold(got, f"{p}/me_open", limbs=True)


def test_me_open_glv():
    """glv_safe on transparent generators: GLV (K8) products, equal to the
    JAX CPU branch's points in affine form."""
    p = "open/16/dlog"
    got = pedersen.me_open(fx.t("open/16/t")[:16], _points(f"{p}/gens"), fx.t("open/16/u")[:4], glv_safe=True)
    _check_split_fold(got, f"{p}/me_open", limbs=False)
