"""The port's zkConv2D on the CPU, held against the JAX package
(``tests/test_conv.py``'s three cases) through the arrays and verdicts
``record_slice11.py`` recorded: the forward against a float64 convolution
and limb for limb against the JAX layer's, the proof array for array, the
verdicts; and im2col against a direct loop over the patches."""

import numpy as np
import pytest
import torch

from slice11_inputs import CONV_FORWARD, CONV_PROVE, CONV_TAMPER, conv_case
from slice11_fixture import proof_arrays, rec, verdict
from test_torch_chain import assert_same_arrays
from test_torch_chain import proof_arrays as flat
from zkdl_tpu_torch.commit import pedersen
from zkdl_tpu_torch.field import fr, planar
from zkdl_tpu_torch.models import quantize, zkconv
from zkdl_tpu_torch.sumcheck.transcript import FiatShamir
from zkdl_tpu_torch.tensor import fr_ops
from zkdl_tpu_torch.utils import prng


def case(seed: int, pad: int, stride: int, small: bool):
    shape, batch, x, k = conv_case(seed, pad, stride, small)
    return zkconv.ConvShape(**shape), batch, x, k


def conv_input(x: np.ndarray) -> torch.Tensor:
    """The flat input at scale 2^16, Montgomery (batch*H*W*C_in, 8)."""
    raw = planar.from_planar(quantize.float_to_fr(torch.from_numpy(x.reshape(-1)))).contiguous()
    return pedersen.to_mont_rows(raw)


def float_conv(x, k, stride: int, pad: int) -> np.ndarray:
    b, h, w, _ = x.shape
    kh, kw, _, cout = k.shape
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    oh, ow = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1
    out = np.zeros((b, oh, ow, cout))
    for i in range(oh):
        for j in range(ow):
            patch = xp[:, i * stride : i * stride + kh, j * stride : j * stride + kw, :]
            out[:, i, j, :] = np.tensordot(patch, k, axes=([1, 2, 3], [0, 1, 2]))
    return out


def dequantized(Z: torch.Tensor, shape, batch: int, out_p: int) -> np.ndarray:
    vals = fr.to_ints(pedersen.from_mont_rows(Z).numpy())
    got = np.array([(v if v < fr.P_INT // 2 else v - fr.P_INT) / 2.0**32 for v in vals]).reshape(-1, out_p)
    return got[:, : shape.c_out].reshape(batch, shape.oh, shape.ow, shape.c_out)


@pytest.mark.parametrize("seed,pad,stride", CONV_FORWARD)
def test_conv_forward_matches_float_and_jax(seed, pad, stride):
    """Z equals the JAX layer's limb for limb, and dequantized lies within
    the quantization error of a float64 convolution: the input and the
    kernel are rounded to 2^-16 (error <= 2^-17 each), so each output's
    error is at most 2^-17 sum(|x| + |w|) + n 2^-34 over its n = 18 taps,
    under 1e-3 at these values (tests/test_conv.py's tolerance)."""
    shape, batch, x, k = case(seed, pad, stride, small=False)
    layer = zkconv.ZkConv2D.from_float(k, shape, prng.PRNGKey(0), device="cpu")
    Z = layer(conv_input(x), batch)
    np.testing.assert_array_equal(Z.numpy(), rec(f"conv_fwd_{pad}_{stride}/Z"))
    want = float_conv(x.astype(np.float64), k.astype(np.float64), stride, pad)
    bound = shape.patch_size * (2.0**-17 * (np.abs(x).max() + np.abs(k).max()) + 2.0**-34)
    assert bound < 1e-3
    assert np.max(np.abs(dequantized(Z, shape, batch, layer.fc.out_size) - want)) < 1e-3


@pytest.mark.parametrize("name", ["conv_prove", "conv_tamper"])
def test_conv_proof_equals_jax_and_verdict(name):
    """tests/test_conv.py's prove/verify case (accepted) and its tampered
    output (Z + 1 at every entry: rejected), each proof array for array the
    JAX prover's, each verdict and reason the JAX verifier's."""
    seed, pad, stride, key = {"conv_prove": CONV_PROVE, "conv_tamper": CONV_TAMPER}[name]
    shape, batch, x, k = case(seed, pad, stride, small=True)
    layer = zkconv.ZkConv2D.from_float(k, shape, prng.PRNGKey(key), device="cpu")
    for c in "xyz":
        np.testing.assert_array_equal(getattr(layer.fc.com.points, c).numpy(), rec(f"{name}/com.{c}"))
    X = conv_input(x)
    Z = layer(X, batch)
    if name == "conv_tamper":
        Z = fr_ops.add(Z, fr_ops.ones_mont(Z.shape[0], "cpu"))
    np.testing.assert_array_equal(Z.numpy(), rec(f"{name}/Z"))
    proof = layer.prove(X, Z, FiatShamir(), batch)
    assert_same_arrays(flat(proof), proof_arrays(f"{name}/proof"))
    got = layer.verify(proof)
    assert got == verdict(name)
    assert got[0] == (name == "conv_prove")


@pytest.mark.parametrize("pad,stride", [(0, 1), (1, 2), (2, 3)])
def test_im2col_is_the_patch_gather(pad, stride):
    shape = zkconv.ConvShape(h=5, w=7, c_in=3, c_out=2, kh=3, kw=2, stride=stride, pad=pad)
    batch = 2
    X = torch.from_numpy(np.random.default_rng(7).integers(0, 1 << 32, size=(batch * 5 * 7 * 3, 8), dtype=np.uint32))
    got = zkconv.im2col(X, shape, batch).numpy().reshape(batch, shape.oh, shape.ow, 32, 8)
    x = X.numpy().reshape(batch, 5, 7, 3, 8)
    for b in range(batch):
        for i in range(shape.oh):
            for j in range(shape.ow):
                want = np.zeros((3, 2, 3, 8), np.uint32)
                for di in range(3):
                    for dj in range(2):
                        y, xx = i * stride + di - pad, j * stride + dj - pad
                        if 0 <= y < 5 and 0 <= xx < 7:
                            want[di, dj] = x[b, y, xx]
                np.testing.assert_array_equal(got[b, i, j, :18], want.reshape(18, 8))
                assert not got[b, i, j, 18:].any()
