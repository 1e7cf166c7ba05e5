"""The port's cheap softmax (``models/zkattention.py``: ``softmax_aux``,
``p_range_bits``, ``softmax_prove``, ``softmax_verify``) against the JAX
package's (``zkdl_tpu/models/zkattention.py:49-231``), recorded by
``record_slice14.py`` at seq 4, d_model 8 and seq 16, d_model 16: P, its
bits, the proofs under SeededRng and FiatShamir array for array, and the
JAX verifier's verdicts and reasons on three tampered proofs."""

import dataclasses

import numpy as np
import pytest
import torch

from slice14_fixture import meta, rec, same, t
from zkdl_tpu_torch.field import fr
from zkdl_tpu_torch.models import quantize
from zkdl_tpu_torch.models import zkattention as za
from zkdl_tpu_torch.sumcheck.transcript import FiatShamir, SeededRng

CASES = [(4, 8), (16, 16)]  # (seq, d_model)


@pytest.mark.parametrize("seq,d", CASES)
def test_softmax_aux_equals_jax(seq, d):
    """P from the float32 softmax of the recorded scores: the JAX P and q
    exactly (0 float32 flips at these inputs; a flipped floor would change
    an entry of P, and the count would show here), and the range bits."""
    P, q = za.softmax_aux(t(f"soft{seq}/S"), seq, seq, d)
    flips = int((q != rec(f"soft{seq}/q")).sum())
    assert flips == 0, f"{flips} entries of P differ from the JAX P"
    assert same(P, f"soft{seq}/P") and q.dtype == np.uint32
    assert (q.sum(1) == quantize.SCALE).all()
    assert same(za.p_range_bits(P), f"soft{seq}/bits")


def test_softmax_aux_padding_rows():
    """Rows at and past real_rows become 2^16 e_0 (zkattention.py:86-95).
    The JAX function raises there (it writes into np.asarray of a JAX array,
    which is read-only; recorded), so the port is held to the documented
    rows."""
    assert "read-only" in meta("soft4_pad_error")
    P, q = za.softmax_aux(t("soft4/S"), 4, 4, 8, real_rows=3)
    want = rec("soft4/q").copy()
    want[3:] = 0
    want[3:, 0] = quantize.SCALE
    assert np.array_equal(q, want)
    assert np.array_equal(fr.to_ints(P.numpy(), mont_form=True), [int(v) for v in want.reshape(-1)])


def _fields(proof) -> dict:
    return {f.name: getattr(proof, f.name) for f in dataclasses.fields(proof)}


@pytest.mark.parametrize("seq,d", CASES)
@pytest.mark.parametrize("transcript", ["seeded", "fs"])
def test_softmax_proof_equals_jax(seq, d, transcript):
    ch = SeededRng(5489) if transcript == "seeded" else FiatShamir()
    proof = za.softmax_prove(t(f"soft{seq}/P"), seq, seq, ch)
    for name, v in _fields(proof).items():
        assert same(v, f"soft{seq}/{transcript}/{name}"), name
    ok, msg = meta(f"soft{seq}_{transcript}_ok")
    assert ok and za.softmax_verify(proof) == (True, "")


def _recorded_proof(pre: str) -> za.SoftmaxProof:
    return za.SoftmaxProof(**{f.name: t(f"{pre}/{f.name}") for f in dataclasses.fields(za.SoftmaxProof)})


@pytest.mark.parametrize("seq", [4, 16])
@pytest.mark.parametrize("tamper", ["bin_poly", "ip_finals", "row_sum"])
def test_tampered_proofs_get_the_jax_reasons(seq, tamper):
    """One bit polynomial's limb, one ip_finals limb, and P with row 0
    summing to 2^16 + 1 (proved honestly): the JAX verifier's verdict and
    reason ("range: ...", "norm: ...")."""
    if tamper == "row_sum":
        P = t(f"soft{seq}/P_off")
        proof = za.softmax_prove(P, seq, seq, FiatShamir())
        for name, v in _fields(proof).items():
            assert same(v, f"soft{seq}/off/{name}"), name
    else:
        proof = _recorded_proof(f"soft{seq}/fs")
        key = "bin_polys" if tamper == "bin_poly" else "ip_finals"
        arr = getattr(proof, key).clone()
        arr.view(torch.int32).reshape(-1)[0] ^= 1
        proof = dataclasses.replace(proof, **{key: arr})
    ok, msg = meta(f"soft{seq}_tamper_{tamper}")
    assert za.softmax_verify(proof) == (ok, msg) and not ok
