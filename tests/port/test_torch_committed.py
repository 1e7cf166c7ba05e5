"""The committed-aux tier of the port against the JAX package on the CPU (the
port's plain versions of K5 and K6 there): the variable-base G1 operations
on edge points, NUMS generators, bit commitments, the aux expansion,
partial_me, revealed-fold openings and their verdicts; the 8-wide committed
proof of both schedules array for array against the JAX prover's; the
port's verifier on it with replay, and on single-fault tampered copies
against the JAX verifier's verdicts; the JAX verifier on the port's proof
read back through the proof file."""

import copy
import dataclasses
import hashlib
import io
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_helpers import jax_model, to_jax
from test_torch_chain import assert_same_arrays, proof_arrays
from zkdl_tpu.commit import pedersen as jpedersen
from zkdl_tpu.curve import g1 as jg1
from zkdl_tpu.io import proof_io as jproof_io
from zkdl_tpu.models import mlp as jmlp, zkrelu as jzkrelu
from zkdl_tpu.sumcheck.transcript import FiatShamir as JaxFiatShamir
from zkdl_tpu.tensor import fr_ops as jfr_ops
from zkdl_tpu_torch.commit import pedersen
from zkdl_tpu_torch.curve import g1
from zkdl_tpu_torch.field import fr, mp
from zkdl_tpu_torch.io import proof_io
from zkdl_tpu_torch.models import zkrelu
from zkdl_tpu_torch.sumcheck.transcript import FiatShamir
from zkdl_tpu_torch.tensor import fr_ops

NUMS_FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "nums_generators_jax.json"
COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB


def _jac(p: g1.G1Jac) -> jg1.G1Jac:
    return jg1.G1Jac(*(jnp.asarray(c.numpy()) for c in p))


def _cat(*ps) -> g1.G1Jac:
    return g1.G1Jac(*(torch.cat([getattr(p, c) for p in ps]) for c in "xyz"))


def _at(p: g1.G1Jac, *idx) -> g1.G1Jac:
    i = torch.tensor(idx)
    return g1.G1Jac(*(mp.take(c, i, 0) for c in p))


def assert_same_points(got: g1.G1Jac, want) -> None:
    for c in "xyz":
        np.testing.assert_array_equal(getattr(got, c).numpy(), np.asarray(getattr(want, c)), err_msg=c)


def _words(x: int) -> np.ndarray:
    return mp.limbs_from_int(x, 8)


def flip(t: torch.Tensor, idx) -> torch.Tensor:
    """A copy of the uint32 tensor t with the low bit of t[idx] flipped."""
    a = t.numpy().copy()
    a[idx] ^= 1
    return torch.from_numpy(a)


@pytest.fixture(scope="module")
def points():
    """8 random points of the subgroup, p + (-p) = (r^2, -r^3, 0) and O."""
    raw = np.random.default_rng(70).integers(0, 1 << 32, size=(8, 8), dtype=np.uint32)
    raw[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    P = g1.generator_pow(torch.from_numpy(raw))
    C = g1.add(_at(P, 0), g1.neg(_at(P, 0)))
    return P, C, g1.identity((1,))


def test_add_equals_jax(points):
    """O + O, O + q, p + O, p + p (double), p + (-p), (r^2, -r^3, 0) as
    either operand and both, and random pairs: limb for limb."""
    P, C, O = points
    assert bool(g1.is_identity(C)[0]) and int(C.x.to(torch.int64).sum()) > 0
    p = _cat(O, O, _at(P, 0), _at(P, 1), _at(P, 2), C, _at(P, 3), C, _at(P, 4, 5, 6))
    q = _cat(O, _at(P, 0), O, _at(P, 1), g1.neg(_at(P, 2)), _at(P, 3), C, C, _at(P, 7, 3, 5))
    got = g1.add(p, q)
    assert_same_points(got, jg1.add_jit(_jac(p), _jac(q)))
    assert int(got.x[4].to(torch.int64).sum()) > 0 and bool(g1.is_identity(_at(got, 4))[0])


def test_scalar_mul_equals_jax(points):
    """0, 1, r - 1, the cofactor, 2^256 - 1 and random scalars, on random
    points, O and (r^2, -r^3, 0); and one scalar for all points."""
    P, C, O = points
    pts = _cat(P, O, C, _at(P, 0, 1))
    sc = np.random.default_rng(71).integers(0, 1 << 32, size=(12, 8), dtype=np.uint32)
    sc[:, 7] %= np.uint32(fr.P_TOP_LIMB)
    sc[:5] = np.stack([_words(0), _words(1), _words(fr.P_INT - 1), _words(COFACTOR), _words((1 << 256) - 1)])
    sc[8], sc[9] = _words(COFACTOR), _words((1 << 256) - 1)
    assert_same_points(g1.scalar_mul(pts, torch.from_numpy(sc)), jg1.scalar_mul_jit(_jac(pts), jnp.asarray(sc)))
    one = sc[2]
    assert_same_points(g1.scalar_mul(pts, torch.from_numpy(one)),
                       jg1.scalar_mul_jit(_jac(pts), jnp.broadcast_to(jnp.asarray(one), (pts.x.shape[0], 8))))


@pytest.mark.parametrize("n", [1, 7])
def test_g1_sum_equals_jax(points, n):
    P, C, O = points
    pts = _at(_cat(P, C, O, P), *range(n))
    assert_same_points(g1.g1_sum(pts), jg1.g1_sum(_jac(pts)))


@pytest.mark.parametrize("n,r", [(5, 3), (2, 1)])
def test_me_eval_equals_jax(points, n, r):
    """me_eval of n points at an r-entry point; for n = 5 through me_evals,
    as the verifier runs it, folded side by side with a 2-point (r = 1) and
    a 1-point (r = 0) vector: each result equals the JAX me_eval of its
    vector alone (the short vectors padded up front)."""
    P, C, O = points
    pool = _cat(P, C, O)
    shapes = [(n, r), (2, 1), (1, 0)] if n == 5 else [(n, r)]
    vecs = [_at(pool, *[(5 * k + 3 * i + 1) % 10 for i in range(m)]) for k, (m, _) in enumerate(shapes)]
    us = [fr.from_ints([3 + 7 * i + 11 * k for i in range(rk)], mont_form=True) if rk else np.zeros((0, 8), np.uint32)
          for k, (_, rk) in enumerate(shapes)]
    if n == 5:
        got = g1.me_evals(vecs, [fr.to_ints(u) for u in us])
    else:
        got = [g1.me_eval(vecs[0], torch.from_numpy(us[0]))]
    for v, u, g in zip(vecs, us, got):
        assert_same_points(g, jg1.me_eval(_jac(v), jnp.asarray(u).reshape(-1, 8)))


def test_nums_generators_equal_jax():
    """nums_generators(32) limb for limb against the JAX function, and every
    power-of-two prefix against the digests recorded from the JAX package
    for chip_smoke.py (tests/port/record_committed.py)."""
    got = pedersen.nums_generators(32, torch.device("cpu")).points
    assert_same_points(got, jpedersen.nums_generators(32).points)
    recorded = json.loads(NUMS_FIXTURE.read_text())
    assert recorded["size"] == 4096
    for size in (1, 2, 4, 8, 16, 32):
        for c in "xyz":
            digest = hashlib.sha256(np.ascontiguousarray(getattr(got, c).numpy()[:size]).tobytes()).hexdigest()
            assert digest == recorded["prefixes"][str(size)][c], (size, c)


@pytest.mark.parametrize("m,gen", [(3, 4), (2, 1)])
def test_commit_bits_equals_jax(m, gen):
    """Masked row sums over NUMS generators: random bits, an all-zero and an
    all-one row (gen 1: one leaf a row, no add)."""
    bits = np.random.default_rng(72 + m).integers(0, 2, m * gen).astype(np.uint32)
    bits[:gen] = 0
    bits[gen : 2 * gen] = 1
    gens = pedersen.nums_generators(gen, torch.device("cpu"))
    got = pedersen.commit_bits(gens, torch.from_numpy(bits)).points
    assert_same_points(got, jpedersen.commit_bits(jpedersen.nums_generators(gen), jnp.asarray(bits)).points)


def test_expand_aux_equals_jax(chained):
    aux = chained.aux[0]
    args = (aux["sign_bits"], aux["mag"], aux["rem_bits16"], zkrelu.Q, zkrelu.R)
    jargs = tuple(jnp.asarray(a.numpy()) for a in args[:3]) + args[3:]
    for got, want in ((zkrelu._expand_aux_bits(*args), jzkrelu._expand_aux_bits(*jargs)),
                      (zkrelu._expand_aux(*args), jzkrelu._expand_aux(*jargs))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,window,r", [(40, 4, 4), (64, 8, 3), (9, 1, 4)])
def test_partial_me_equals_jax(n, window, r):
    from port_helpers import rand_fr

    t = rand_fr(73 + n, n)
    u = rand_fr(74 + r, r)
    got = fr_ops.partial_me(torch.from_numpy(t), torch.from_numpy(u), window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfr_ops.partial_me(jnp.asarray(t), jnp.asarray(u), window)))


def _opening_case():
    """A (5 * 8, 8) Montgomery tensor committed row by row over NUMS(8), as
    bits, and a 6-entry point (3 generator bits, 3 row bits)."""
    bits = np.random.default_rng(75).integers(0, 2, 40).astype(np.uint32)
    gens = pedersen.nums_generators(8, torch.device("cpu"))
    com = pedersen.commit_bits(gens, torch.from_numpy(bits))
    t = zkrelu._mont_bits(torch.from_numpy(bits))
    u = fr.from_ints([11 + 5 * i for i in range(6)], mont_form=True)
    return gens, com, t, u


def test_open_reveal_equals_jax():
    gens, com, t, u = _opening_case()
    got = pedersen.open_reveal(gens, t, com, torch.from_numpy(u))
    jcom = jpedersen.RowCommitments(points=_jac(com.points))
    want = jpedersen.open_reveal(jpedersen.nums_generators(8), jnp.asarray(t.numpy()), jcom, jnp.asarray(u))
    np.testing.assert_array_equal(got.t_folded.numpy(), np.asarray(want.t_folded))


def test_verify_reveal_verdicts_equal_jax():
    """The honest opening, with and without its value, and one fault each:
    a folded word, the claimed value, a short point, a wrong fold shape and
    the wrong commitment row. The port checks all of them in one
    verify_reveals call (shared group math); each verdict and reason equals
    the JAX verify_reveal's, and verify_reveal alone gives the first's."""
    gens, com, t, u = _opening_case()
    op = pedersen.open_reveal(gens, t, com, torch.from_numpy(u))
    pt = fr.to_ints(u)
    value = fr.to_ints(fr_ops.me_eval(t, torch.from_numpy(u)).numpy()[None])[0]
    bad_fold = flip(op.t_folded, (0, 0))
    moved = pedersen.RowCommitments(points=_at(com.points, 1, 0, 2, 3, 4))
    cases = [
        (op, com, pt, value),
        (op, com, pt, None),
        (pedersen.FoldOpening(bad_fold), com, pt, value),
        (op, com, pt, (value + 1) % fr.P_INT),
        (op, com, pt[1:], value),
        (pedersen.FoldOpening(op.t_folded[:4]), com, pt, value),
        (op, moved, pt, value),
    ]
    got = pedersen.verify_reveals([(o, gens, c, p, v) for o, c, p, v in cases])
    jgens = jpedersen.nums_generators(8)
    want = [jpedersen.verify_reveal(jpedersen.FoldOpening(jnp.asarray(o.t_folded.numpy())), jgens,
                                    jpedersen.RowCommitments(points=_jac(c.points)), p, expected_value=v)
            for o, c, p, v in cases]
    assert got == want
    assert want[0] == (True, "") and not any(ok for ok, _ in want[2:])
    assert pedersen.verify_reveal(op, gens, com, pt, value) == want[0]


@pytest.mark.parametrize("interleave", [False, True], ids=["grouped", "interleaved"])
def test_port_verifier_accepts_committed_proof(chained, committed, interleave):
    c = chained
    proof = committed[interleave]
    assert all(p.aux_coms is not None for p in proof.relu_proofs)
    assert c.model.verify(proof, X=c.X, Y_hat=c.Y, transcript=FiatShamir(), interleaved=interleave) == (True, "")


@pytest.mark.parametrize("interleave", [False, True], ids=["grouped", "interleaved"])
def test_jax_verifier_accepts_port_committed_proof_file(chained, committed, interleave):
    """The port's committed proof, written by the port's proof_io and read by
    the JAX package's, passes the JAX verifier with replay."""
    c = chained
    jp = jproof_io.load_proof(io.BytesIO(proof_io.serialize(committed[interleave])))
    ok, msg = jax_model(c.model).verify(jp, X=to_jax(c.X), Y_hat=to_jax(c.Y), transcript=JaxFiatShamir(),
                                        interleaved=interleave)
    assert ok, msg


def _flip_fold(op, idx):
    return dataclasses.replace(op, t_folded=flip(op.t_folded, idx))


def _tamper(case: str, proof):
    bad = copy.deepcopy(proof)
    rp = bad.relu_proofs[0]
    if case == "open_mag_bin.t_folded":
        rp.open_mag_bin = _flip_fold(rp.open_mag_bin, (0, 0))
    elif case == "swapped mag and rem commitments":
        rp.aux_coms = zkrelu.AuxCommitments(sign=rp.aux_coms.sign, mag=rp.aux_coms.rem, rem=rp.aux_coms.mag)
    elif case == "open_sign_rec.t_folded":
        rp.open_sign_rec = _flip_fold(rp.open_sign_rec, (0, 0))
    elif case == "swapped mag_bits_at_u rows":
        rp.mag_bits_at_u = mp.take(rp.mag_bits_at_u, torch.tensor([1, 0, *range(2, rp.mag_bits_at_u.shape[0])]), 0)
    elif case == "aux_coms.sign.points.x":
        pts = rp.aux_coms.sign.points
        rp.aux_coms = dataclasses.replace(rp.aux_coms, sign=pedersen.RowCommitments(points=pts._replace(x=flip(pts.x, (0, 3)))))
    return bad


# (fault, replay, the JAX verifier's reason on the 8-wide proof): the four
# faults of tests/test_committed_aux.py, verified as it verifies them (no
# replay), and a flipped commitment limb under replay (the commitments are
# absorbed, so the draws move)
TAMPER_CASES = [
    ("open_mag_bin.t_folded", False,
     "relu[0] committed-aux: mag_bin@v_z: generator MSM != row-commitment MLE at u_row"),
    ("swapped mag and rem commitments", False,
     "relu[0] committed-aux: mag_bin@v_z: generator MSM != row-commitment MLE at u_row"),
    ("open_sign_rec.t_folded", False,
     "relu[0] committed-aux: sign@v_a: generator MSM != row-commitment MLE at u_row"),
    ("swapped mag_bits_at_u rows", False,
     "relu[0] committed-aux: mag_bin@w||u_rec: folded MLE value != expected"),
    ("aux_coms.sign.points.x", True, "transcript: relu[0].u_z_bin not derived from the transcript"),
]


@pytest.mark.parametrize("case,replay,reason", TAMPER_CASES, ids=[c[0] for c in TAMPER_CASES])
def test_committed_tamper_verdicts_equal_jax(chained, committed, case, replay, reason):
    """One fault each: the port's verdict and reason equal the JAX
    verifier's on the same tampered proof (chip_smoke.py holds the same
    reasons at zkdl256)."""
    c = chained
    bad = _tamper(case, committed[False])
    kw = {"transcript": FiatShamir()} if replay else {}
    jkw = {"transcript": JaxFiatShamir()} if replay else {}
    got = c.model.verify(bad, X=c.X, Y_hat=c.Y, **kw)
    want = jax_model(c.model).verify(to_jax(bad), X=to_jax(c.X), Y_hat=to_jax(c.Y), **jkw)
    assert got == want == (False, reason)
    if case == "swapped mag_bits_at_u rows":  # the JAX test calls verify_committed itself
        assert zkrelu.verify_committed(bad.relu_proofs[0]) == jzkrelu.verify_committed(to_jax(bad).relu_proofs[0])


def test_committed_prove_needs_chained_mode(chained):
    c = chained
    with pytest.raises(ValueError, match="committed aux requires chained mode"):
        c.model.prove(c.X, c.Y, c.Z, c.A, c.aux, FiatShamir(), chain=False, commit_aux=True)
    with pytest.raises(ValueError, match="committed aux requires chained mode"):
        jmlp.MLP.prove(jax_model(c.model), to_jax(c.X), to_jax(c.Y), [], [], [], JaxFiatShamir(), chain=False,
                       commit_aux=True)


@pytest.mark.parametrize("interleave", [False, True], ids=["grouped", "interleaved"])
def test_committed_proof_equals_jax_prover(committed, jax_chained, interleave):
    """(Last in the file: it waits for the JAX prover's proof file, which
    conftest's jax_proofs processes write beside the other tests.) Every
    array of the port's committed proof (each aux commitment's
    Jacobian x, y, z and each FoldOpening.t_folded among them) equals the
    JAX prover's, read from its proof file by both packages."""
    path = jax_chained.committed_proof_file(interleave)
    got = proof_arrays(committed[interleave])
    assert any(".aux_coms.mag.points.z" in k for k in got) and any(".open_sign_rec.t_folded" in k for k in got)
    assert_same_arrays(got, proof_arrays(jproof_io.load_proof(path)))
    assert_same_arrays(proof_arrays(proof_io.load_proof(path, device="cpu")), got)
