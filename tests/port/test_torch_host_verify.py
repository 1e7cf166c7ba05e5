"""The verifier's host pieces: the native G1 library against the pure-Python
formulas, the G1 host <-> tensor conversions and the planar MLE evaluation
against the JAX package, and a failed native build, which raises."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_helpers import rand_fr
from zkdl_tpu.curve import convert as jconvert, host_g1 as jhost_g1
from zkdl_tpu.tensor import fr_ops as jfr_ops
from zkdl_tpu_torch import native
from zkdl_tpu_torch.curve import convert, host_g1
from zkdl_tpu_torch.field import fr
from zkdl_tpu_torch.tensor import fr_ops
from zkdl_tpu_torch.utils import build

R = fr.P_INT


def test_scalar_mul_batch_equals_python_double_and_add():
    rng = random.Random(5)
    scalars = [0, 1, R - 1, R, (1 << 256) - 1] + [rng.getrandbits(256) for _ in range(3)]
    base = host_g1.scalar_mul(host_g1.GENERATOR, 0xC0FFEE)
    points = [p for p in (host_g1.IDENTITY, host_g1.GENERATOR, base) for _ in scalars]
    got = host_g1.scalar_mul_batch(points, scalars * 3)
    want = [host_g1.scalar_mul(p, k) for p, k in zip(points, scalars * 3)]
    assert [host_g1.to_affine(p) for p in got] == [host_g1.to_affine(p) for p in want]
    assert host_g1.to_affine(got[len(scalars) + 3]) is None  # r * G
    assert all(host_g1.on_curve(p) for p in got)


def test_scalar_mul_batch_split_over_threads(monkeypatch):
    monkeypatch.setattr(native, "_MIN_PER_THREAD", 2)
    points = [host_g1.scalar_mul(host_g1.GENERATOR, k + 2) for k in range(9)]
    scalars = [random.Random(k).getrandbits(255) for k in range(9)]
    want = [host_g1.scalar_mul(p, k) for p, k in zip(points, scalars)]
    assert host_g1.scalar_mul_batch(points, scalars) == want


def test_g1_conversions_equal_jax():
    pts = [host_g1.IDENTITY, host_g1.GENERATOR, host_g1.scalar_mul(host_g1.GENERATOR, 1234567)]
    got = convert.jac_to_device(pts)
    want = jconvert.jac_to_device([jhost_g1.JacPoint(p.x, p.y, p.z) for p in pts])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert convert.jac_from_device(got) == pts
    assert convert.affine_from_device(got) == [host_g1.to_affine(p) for p in pts]


@pytest.mark.parametrize("n", [1, 5, 8, 37])
def test_me_eval_equals_jax(n):
    t, u = rand_fr(n, n), rand_fr(100 + n, fr_ops.ceil_log2(n))
    want = np.asarray(jfr_ops.me_eval(jnp.asarray(t), jnp.asarray(u)))
    np.testing.assert_array_equal(fr_ops.me_eval(torch.from_numpy(t), torch.from_numpy(u)).numpy(), want)
    if n > 1:
        step = fr_ops.me_step(torch.from_numpy(t), torch.from_numpy(u[0]))
        np.testing.assert_array_equal(step.numpy(), np.asarray(jfr_ops.me_step(jnp.asarray(t), jnp.asarray(u[0]))))
    with pytest.raises(ValueError):
        fr_ops.me_eval(torch.from_numpy(t), torch.from_numpy(rand_fr(1, fr_ops.ceil_log2(n) + 1)))


def test_failed_native_build_raises(monkeypatch, tmp_path):
    (tmp_path / "zkdl_host.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "NATIVE", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="g[+][+] failed for zkdl_host.cpp"):
        host_g1.scalar_mul_batch([host_g1.GENERATOR], [3])


# --- the library's other entry points (recorded from the JAX package's
# native library by record_slice14.py)


def _native_case():
    from slice14_fixture import meta

    m = meta("native")

    def pts(v):
        return [tuple(int(c, 16) for c in p) for p in v]

    return m, pts


@pytest.mark.parametrize("entry", ["g1_msm", "g1_sum", "g1_add_batch", "g1_eq", "fr_mont_mul_batch"])
def test_native_entry_point_equals_jax(entry):
    """On G, 2G, random multiples of G (z != 1), O and (r^2, -r^3, 0), the
    scalars 0, 1, r - 1, 2^256 - 1 and random ones; equality on an equal
    pair with other limbs, unequal points and identities."""
    from zkdl_tpu_torch import native

    m, pts = _native_case()
    P, Q = pts(m["points"]), pts(m["qs"])
    if entry == "g1_msm":
        assert native.g1_msm(P, [int(k, 16) for k in m["scalars"]]) == pts([m["g1_msm"]])[0]
    elif entry == "g1_sum":
        assert native.g1_sum(P) == pts([m["g1_sum"]])[0]
    elif entry == "g1_add_batch":
        assert native.g1_add_batch(P, Q) == pts(m["g1_add_batch"])
    elif entry == "g1_eq":
        assert [native.g1_eq(pts([p])[0], pts([q])[0]) for p, q in m["eq_pairs"]] == m["g1_eq"]
    else:
        got = native.fr_mont_mul_batch([int(v, 16) for v in m["fa"]], [int(v, 16) for v in m["fb"]])
        assert got == [int(v, 16) for v in m["fr_mont_mul_batch"]]
