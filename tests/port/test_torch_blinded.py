"""The port's blinded (hiding) commitment tier, held on the CPU against the
JAX package (``tests/test_blinded.py``'s setup and behaviours) through the
arrays and verdicts ``record_slice11.py`` recorded: the blinding point limb
for limb; H^b by GLV limb for limb against the JAX ``scalar_mul_glv`` (the
port's route, as the JAX package's on an accelerator) and the commitments
in affine form against the JAX CPU branch's (double-and-add); the opening
array for array; the verdicts and reasons; each package's verifier on the
other's opening. The JAX ``blinding_point`` never returns (its
try-and-increment loop never increments its counter, and counter 0 gives
no curve point), so the recorder ran the JAX blinded tier with that loop's
counter incremented, as the port's is."""

import functools
import hashlib
import json

import numpy as np
import pytest
import torch

import slice11_inputs
from slice11_fixture import proof_arrays, rec, verdict
from test_torch_chain import assert_same_arrays
from test_torch_chain import proof_arrays as flat
from zkdl_tpu_torch.commit import pedersen
from zkdl_tpu_torch.curve import convert, g1
from zkdl_tpu_torch.field import fp, fr
from zkdl_tpu_torch.io import proof_io
from zkdl_tpu_torch.sumcheck import protocols as sc
from zkdl_tpu_torch.tensor import fr_ops
from zkdl_tpu_torch.utils import prng

KEY = slice11_inputs.BLIND_KEYS[0]


def points(prefix: str) -> g1.G1Jac:
    return g1.G1Jac(*(torch.from_numpy(rec(f"{prefix}.{c}")) for c in "xyz"))


@functools.lru_cache(maxsize=None)
def setup():
    """tests/test_blinded.py:_setup and its opening point, in the port."""
    gens = pedersen.setup(prng.PRNGKey(3), 4, "cpu")
    t = pedersen.to_mont_rows(fr_ops.random_fr(prng.PRNGKey(4), 16, "cpu"))
    u = pedersen.to_mont_rows(fr_ops.random_fr(prng.PRNGKey(5), 4, "cpu"))
    return gens, t, u


@functools.lru_cache(maxsize=None)
def blinded(key: int):
    gens, t, _ = setup()
    return pedersen.commit_blinded(gens, t, prng.PRNGKey(key))


@functools.lru_cache(maxsize=None)
def opening():
    gens, t, u = setup()
    return pedersen.open_blinded(gens, t, blinded(KEY), u)


def ints(t) -> list[int]:
    return sc.scalars_to_ints(t)


def test_blinding_point_equals_jax():
    H = pedersen.blinding_point("cpu")
    assert H.x.shape == (1, 12)
    for c in "xyz":
        np.testing.assert_array_equal(getattr(H, c).numpy(), rec(f"blind/H.{c}"))
    assert pedersen.blinding_point("cpu") is H  # cached per device


def test_blinding_point_is_the_first_curve_candidate():
    """Counter 0 of the stream gives no curve point (so the JAX loop, which
    never moves on, never returns); counter 1 does, and the recorder's H
    came from it."""
    p = fp.P_INT
    on_curve = []
    for ctr in range(2):
        h = b"".join(hashlib.sha256(f"zkdl-tpu/nums-blind/v1/{ctr}{sfx}".encode()).digest() for sfx in ("", "/b"))
        x = int.from_bytes(h, "big") % p
        rhs = (x * x % p * x + 4) % p
        on_curve.append(pow(pow(rhs, (p + 1) // 4, p), 2, p) == rhs)
    assert on_curve == [False, True]
    assert int(rec("blind/H_counter")[0]) == 1


def test_setup_equals_jax():
    gens, t, u = setup()
    for c in "xyz":
        np.testing.assert_array_equal(getattr(gens.points, c).numpy(), rec(f"blind/gens.{c}"))
    for name, a in (("gens.dlogs", gens.dlogs), ("t", t), ("u", u)):
        np.testing.assert_array_equal(a.numpy(), rec(f"blind/{name}"))


@pytest.mark.parametrize("key", slice11_inputs.BLIND_KEYS)
def test_h_part_is_the_jax_glv_and_commitment_equals_jax(key):
    """H^b_row limb for limb as the JAX scalar_mul_glv computes it (the
    recorded GLV batch's rows for this key); the blinders limb for limb;
    the commitments in affine form (the JAX CPU branch computed H^b by
    double-and-add)."""
    com = blinded(key)
    np.testing.assert_array_equal(com.blinders.numpy(), rec(f"blind/com{key}.blinders"))
    raw = pedersen.from_mont_rows(com.blinders)
    H = pedersen.blinding_point("cpu")
    h_part = g1.scalar_mul_glv(g1.G1Jac(*(c.expand(4, 12) for c in H)), raw)
    at = 30 + 4 * slice11_inputs.BLIND_KEYS.index(key)  # glv_inputs' H^b rows
    np.testing.assert_array_equal(rec("glv/scalars")[at : at + 4], raw.numpy())
    for c in "xyz":
        np.testing.assert_array_equal(getattr(h_part, c).numpy(), rec(f"glv/out.{c}")[at : at + 4])
    assert convert.affine_from_device(com.points) == convert.affine_from_device(points(f"blind/com{key}"))


def test_blinded_commit_hides():
    gens, t, _ = setup()
    a1, a2 = (convert.affine_from_device(blinded(k).points) for k in slice11_inputs.BLIND_KEYS)
    ap = convert.affine_from_device(pedersen.commit(gens, t).points)
    assert ap == convert.affine_from_device(points("blind/plain"))
    assert a1 != a2, "same tensor, different blinders must differ"
    assert a1 != ap and a2 != ap, "blinded must differ from unblinded"


def test_blinded_opening_equals_jax():
    proof, b_fold = opening()
    assert_same_arrays(flat(proof), proof_arrays("blind/opening"))
    np.testing.assert_array_equal(b_fold.numpy(), rec("blind/b_fold"))


def _claims():
    gens, t, u = setup()
    want = ints(fr_ops.me_eval(t, u)[None])[0]
    return ints(u), want, ints(opening()[1][None])[0]


@pytest.mark.parametrize("case", ["blind_ok", "blind_wrong_b_fold", "blind_tampered_value"])
def test_verify_open_blinded_equals_jax(case):
    """The three verdicts of tests/test_blinded.py (the opening verifies, a
    wrong blinder fold is rejected as unblinded, a tampered value is
    rejected), each with the JAX verifier's reason."""
    u, want, b = _claims()
    proof, _ = opening()
    kwargs = {"blind_ok": dict(b_fold=b, expected_value=want),
              "blind_wrong_b_fold": dict(b_fold=(b + 1) % fr.P_INT),
              "blind_tampered_value": dict(b_fold=b, expected_value=(want + 1) % fr.P_INT)}[case]
    got = pedersen.verify_open_blinded(proof, blinded(KEY).public, u, **kwargs)
    assert got == verdict(case)
    if case == "blind_wrong_b_fold":
        assert got == (False, "unblinded com(u_row) mismatch")
    else:
        assert got[0] == (case == "blind_ok")


def test_verifiers_accept_each_others_openings(tmp_path, monkeypatch):
    """The JAX verify_open_blinded (host code, fed numpy arrays: no
    compile) accepts the port's opening against the JAX commitment, and the
    port's verifier accepts the JAX opening (read through a proof file).
    The JAX verifier's blinding_point is the recorded H (its own loop never
    returns)."""
    from zkdl_tpu.commit import pedersen as jpedersen
    from zkdl_tpu.curve import g1 as jg1

    H = jg1.G1Jac(*(rec(f"blind/H.{c}") for c in "xyz"))
    monkeypatch.setattr(jpedersen, "blinding_point", lambda: H)
    u, want, b = _claims()
    proof, _ = opening()
    jproof = jpedersen.OpeningProof(
        jg1.G1Jac(*(c.numpy() for c in proof.com_at_u_row)),
        [jg1.G1Jac(*(c.numpy() for c in rp)) for rp in proof.round_points],
        jg1.G1Jac(*(c.numpy() for c in proof.final_gen)), proof.final_scalar.numpy())
    jcom = jpedersen.RowCommitments(points=jg1.G1Jac(*(rec(f"blind/com{KEY}.{c}") for c in "xyz")))
    assert jpedersen.verify_open_blinded(jproof, jcom, u, b, expected_value=want) == (True, "")
    theirs = proof_io.load_proof(_jax_file(tmp_path), device="cpu")
    com = pedersen.RowCommitments(points=points(f"blind/com{KEY}"))
    assert pedersen.verify_open_blinded(theirs, com, u, b, expected_value=want) == (True, "")


def _jax_file(tmp_path) -> str:
    """The recorded JAX opening as the JAX package's proof file."""
    arrays = proof_arrays("blind/opening")
    keys = sorted(arrays)
    meta = {"tree": json.loads(bytes(rec("blind/opening:__skeleton__")).decode()),
            "keys": {k: f"a{i}" for i, k in enumerate(keys)}}
    path = str(tmp_path / "jax_opening.npz")
    np.savez(path, __skeleton__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             **{f"a{i}": arrays[k] for i, k in enumerate(keys)})
    return path
