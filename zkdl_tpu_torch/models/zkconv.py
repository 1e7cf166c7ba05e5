"""zkConv2D: a quantized 2-D convolution proved as a matrix product over its
patch matrix.

Counterpart of ``zkdl_tpu/models/zkconv.py``: ``ConvShape``,
``_patch_indices``, ``im2col`` and ``ZkConv2D`` (``from_float``,
``__call__``, ``prove``, ``verify``). For X (batch, H, W, C_in) and a kernel
(kh, kw, C_in, C_out), Z[(b, oh, ow), o] = sum_(i, j, c) P[(b, oh, ow), (i,
j, c)] W[(i, j, c), o], where the patch matrix P = im2col(X) is a public
gather (zero rows past the borders, each patch zero-padded to a power of
two): the prover and the verifier derive it from X alike, so the matmul
sumcheck of zkFC proves the layer, its kernel committed as FC weights are.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..sumcheck.transcript import ChallengeSource
from ..tensor import fr_ops
from ..utils.runtime import resolve_device
from . import zkfc


@dataclasses.dataclass(frozen=True)
class ConvShape:
    """Geometry of one conv layer: explicit zero padding and stride, no
    dilation."""

    h: int
    w: int
    c_in: int
    c_out: int
    kh: int
    kw: int
    stride: int = 1
    pad: int = 0

    @property
    def oh(self) -> int:
        return (self.h + 2 * self.pad - self.kh) // self.stride + 1

    @property
    def ow(self) -> int:
        return (self.w + 2 * self.pad - self.kw) // self.stride + 1

    @property
    def patch_size(self) -> int:
        return self.kh * self.kw * self.c_in


@functools.lru_cache(maxsize=None)
def _patch_indices(shape: ConvShape) -> np.ndarray:
    """(OH*OW*kh*kw,) indices into the (H*W + 1) plane of a zero-extended
    image; index H*W (the appended zero row) marks a tap past the border."""
    oh, ow = np.meshgrid(np.arange(shape.oh), np.arange(shape.ow), indexing="ij")
    i, j = np.meshgrid(np.arange(shape.kh), np.arange(shape.kw), indexing="ij")
    y = oh[:, :, None, None] * shape.stride + i[None, None] - shape.pad
    x = ow[:, :, None, None] * shape.stride + j[None, None] - shape.pad
    inside = (y >= 0) & (y < shape.h) & (x >= 0) & (x < shape.w)
    return np.where(inside, y * shape.w + x, shape.h * shape.w).astype(np.int64).reshape(-1)


def im2col(X: torch.Tensor, shape: ConvShape, batch: int) -> torch.Tensor:
    """X (batch*H*W*C_in, 8) Fr -> the patch matrix (batch*OH*OW*patch_p, 8),
    patch_p = the next power of two of kh*kw*C_in, zero-padded (the layout
    of zkconv.py:im2col): one gather on X's device."""
    xi = X.view(torch.int32).reshape(batch, shape.h * shape.w, shape.c_in * 8)  # uint32 moves as int32 bits
    xi = torch.cat([xi, xi.new_zeros((batch, 1, shape.c_in * 8))], dim=1)
    idx = torch.from_numpy(_patch_indices(shape)).to(X.device)
    patches = xi.index_select(1, idx).reshape(batch * shape.oh * shape.ow, shape.patch_size, 8)
    patch_p = 1 << fr_ops.ceil_log2(shape.patch_size)
    if patch_p != shape.patch_size:
        patches = torch.cat([patches, patches.new_zeros((patches.shape[0], patch_p - shape.patch_size, 8))], dim=1)
    return patches.reshape(-1, 8).view(torch.uint32)


@dataclasses.dataclass
class ZkConv2D:
    """A conv layer: its geometry and a ZkFC over the patch matrix."""

    shape: ConvShape
    fc: zkfc.ZkFC

    @classmethod
    def from_float(cls, kernel: np.ndarray, shape: ConvShape, key: np.ndarray, device="cuda") -> "ZkConv2D":
        """kernel: float (kh, kw, C_in, C_out); key: the prng key of its
        generators (as ZkFC.from_float takes it)."""
        if kernel.shape != (shape.kh, shape.kw, shape.c_in, shape.c_out):
            raise ValueError(f"kernel {kernel.shape} for {shape}")
        w2d = kernel.reshape(shape.patch_size, shape.c_out)
        return cls(shape, zkfc.ZkFC.from_float(w2d, key, resolve_device(device)))

    def __call__(self, X: torch.Tensor, batch: int) -> torch.Tensor:
        """X (batch*H*W*C_in, 8) Montgomery -> Z (batch*OH*OW*out_p, 8)."""
        return self.fc(im2col(X, self.shape, batch))

    def prove(self, X: torch.Tensor, Z: torch.Tensor, challenges: ChallengeSource, batch: int) -> zkfc.ZkFCProof:
        """zkfc.prove over the patch matrix (draws u_bs, u_in, u_out)."""
        return zkfc.prove(self.fc, im2col(X, self.shape, batch), Z, challenges)

    def verify(self, proof: zkfc.ZkFCProof) -> tuple[bool, str]:
        return zkfc.verify(self.fc.com, proof)
