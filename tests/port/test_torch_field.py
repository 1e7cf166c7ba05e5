"""Port Fr arithmetic and kernels K1-K3 (plain versions on the CPU) against the
JAX package: zkdl_tpu.field.planar and the Pallas kernels in interpret mode."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_helpers import rand_planar
from zkdl_tpu.field import fp as jfp
from zkdl_tpu.field import mp as jmp
from zkdl_tpu.field import pallas_fr as jpf
from zkdl_tpu.field import planar as jplanar
from zkdl_tpu_torch.field import fp, fr, kernels, planar
from zkdl_tpu_torch.tensor import fr_ops
from zkdl_tpu_torch.utils import build

N = 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mask(seed, shape):
    return np.random.default_rng(seed).integers(0, 2, size=shape).astype(bool)


A, B = rand_planar(1, N), rand_planar(2, N)
S = rand_planar(3, 1)[:, 0]
BATCH, TABLE = rand_planar(4, 4 * N).reshape(8, 4, N), rand_planar(5, N).reshape(8, 1, N)
MASK, MASK2 = _mask(6, (N,)), _mask(7, (3, N))

# (port result, JAX result) per op on the same seeded inputs
CASES = {
    "add": lambda: (planar.add(_t(A), _t(B)), jplanar.add(A, B)),
    "sub": lambda: (planar.sub(_t(A), _t(B)), jplanar.sub(A, B)),
    "neg": lambda: (planar.neg(_t(A)), jplanar.neg(A)),
    "double": lambda: (planar.double(_t(A)), jplanar.double(A)),
    "select": lambda: (planar.select(_t(MASK), _t(A), _t(B)), jplanar.select(MASK, A, B)),
    "mul": lambda: (planar.mul(_t(A), _t(B)), jplanar.mul(A, B)),
    "mul_scalar": lambda: (planar.mul_scalar(_t(A), S), jplanar.mul_scalar(A, S)),
    "dot": lambda: (planar.dot(_t(A), _t(B)), jplanar.dot(A, B)),
    "dot_batched": lambda: (planar.dot(_t(BATCH), _t(TABLE)), jplanar.dot(BATCH, TABLE)),
    "masked_sum": lambda: (planar.masked_sum(_t(MASK2), _t(A)), jplanar.masked_sum(MASK2, A[:, None, :])),
    "lazy_sum": lambda: (planar.lazy_sum(_t(BATCH)), jplanar.lazy_sum(BATCH)),
    "tree_sum": lambda: (planar.tree_sum(_t(A)), jplanar.tree_sum(A)),
    "to_mont": lambda: (planar.to_mont(_t(A)), jplanar.to_mont(A)),
    "from_mont": lambda: (planar.from_mont(_t(A)), jplanar.from_mont(A)),
}


@pytest.mark.parametrize("op", sorted(CASES))
def test_planar_op_matches_jax(op):
    got, want = CASES[op]()
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("ZKDL_PALLAS_INTERPRET", "1")


def test_k1_plain_matches_pallas_mul(interpret):
    a, b = rand_planar(10, 8192), rand_planar(11, 8192)
    np.testing.assert_array_equal(kernels.mul_plain(_t(a), _t(b)).numpy(), np.asarray(jpf.mul(a, b)))


def test_k2_plain_matches_pallas_mul_scalar(interpret):
    a, s = rand_planar(12, 8192), rand_planar(13, 1)[:, 0]
    np.testing.assert_array_equal(kernels.mul_scalar_plain(_t(a), s).numpy(), np.asarray(jpf.mul_scalar(a, s)))


def test_k3_plain_matches_pallas_dot_many(interpret):
    a, b = rand_planar(14, 8192), rand_planar(15, 8192)
    want = np.asarray(jpf.dot_many([(a, b)]))
    got = torch.stack([kernels.dot_plain(_t(a), _t(b))], dim=1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fp_mul_matches_mp():
    rng = np.random.default_rng(20)
    a = rng.integers(0, 1 << 32, size=(N, 12), dtype=np.uint32)
    a[:, 11] %= np.uint32(jfp.SPEC.P_limbs[11])
    a[:4] = np.stack([fp.ZERO, fp.SPEC.from_int(1), fp.SPEC.from_int(fp.P_INT - 1), fp.ONE_MONT])
    b = np.roll(a, 1, axis=0)
    want = np.asarray(jmp.mont_mul(jfp.SPEC, jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(fp.mul(_t(a), _t(b)).numpy(), want)


def test_cuda_sources_carry_the_field_constants():
    """The CUDA sources hard-code p, -p^-1 mod 2^32 and R mod p: check them
    against the Python constants (the sources cannot be compiled here)."""
    hdr = (build.CSRC / "field.cuh").read_text()
    team = (build.CSRC / "fp_team.cuh").read_text()  # the G1 kernels' lane teams (K4, K5)

    def arrays(text, name):
        return [[int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", body)]
                for body in re.findall(rf"{name}\[\w+\] = \{{(.*?)\}};", text, re.S)]

    fr_p, fp_p = arrays(hdr, "P")
    assert fr_p == [int(x) for x in fr.SPEC.P_limbs]
    assert fp_p == [int(x) for x in fp.SPEC.P_limbs]
    np0 = [int(v, 16) for v in re.findall(r"NP0 = 0x([0-9a-f]+)u", hdr)]
    assert np0 == [(-pow(fr.P_INT, -1, 1 << 32)) % (1 << 32), (-pow(fp.P_INT, -1, 1 << 32)) % (1 << 32)]
    assert arrays(team, "ONE") == [[int(x) for x in fp.ONE_MONT]]


def test_wrappers_reject_bad_operands():
    a = _t(rand_planar(30, 8))
    with pytest.raises(ValueError):
        kernels.mul(a, a[:, :4])
    with pytest.raises(ValueError):
        kernels.mul(a.to(torch.int64), a)
    with pytest.raises(ValueError):
        kernels.dot(a.to("meta"), a.to("meta"))


# --- the (n, 8) element ops of zkdl_tpu/field/fr.py (recorded by record_slice14.py)

FR_OPS = {
    "double": lambda a, b, m: fr_ops.double(a),
    "sqr": lambda a, b, m: fr_ops.sqr(a),
    "unmont": lambda a, b, m: fr_ops.unmont(a),
    "mont": lambda a, b, m: fr_ops.to_mont(a),
    "pow5": lambda a, b, m: fr_ops.pow_static(a, 5),
    "pow_inv": lambda a, b, m: fr_ops.pow_static(a, fr.P_INT - 2),
    "is_zero": lambda a, b, m: fr_ops.is_zero(a),
    "eq": lambda a, b, m: fr_ops.eq(a, b),
    "select": lambda a, b, m: fr_ops.select(m, a, b),
    "zeros": lambda a, b, m: fr_ops.zeros(3, "cpu"),
    "ones_mont": lambda a, b, m: fr_ops.ones_mont(3, "cpu"),
}


@pytest.mark.parametrize("op", sorted(FR_OPS))
def test_fr_element_op_equals_jax(op):
    """On 0, 1, 2, p - 1, p - 2 and random values (a, b equal at one entry)."""
    from slice14_fixture import same, t

    got = FR_OPS[op](t("fr/a"), t("fr/b"), t("fr/mask"))
    assert same(got, f"fr/{op}")
