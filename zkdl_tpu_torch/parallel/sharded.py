"""Sharded provers: the inner-product sumcheck and the field matmul over a
mesh of torch.distributed ranks.

Counterpart of ``zkdl_tpu/parallel/sharded.py`` (``_local_ip_rounds`` and
``sharded_inner_product_prove``, ``sharded_field_matmul``, ``make_mesh``).
The JAX version is one program over a ``jax.sharding.Mesh``; here every
rank runs the same code on its own block, and a ``Mesh`` holds the rank's
process groups along each axis:

- Data parallel ("dp") shards the leading (batch, flat element) axis: rank
  d of the axis holds the contiguous natural-order block d. A sumcheck
  binds the low index bits first, which lie inside a block, so the first
  log2(n_local) rounds are local: the rank reverses the bits of its own
  block (never the global tensor's) and runs the planar round code
  (``sumcheck/planar_protocols.py``) on it, and the rounds' coefficient sums
  become one modular all-reduce (``collectives.psum_fr``). Then each rank
  holds one residue; the n_dev residues are all-gathered and the last
  log2(n_dev) rounds run replicated on every rank.
- Tensor parallel ("tp") shards the output-feature axis of the weights:
  Z = X @ W on a column block needs no collective; the output is gathered
  only where a caller asks for it.
- Challenges are host values, the same on every rank: the transcript needs
  no communication.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..field import mp
from ..sumcheck import planar_protocols as pp
from ..sumcheck import protocols as sc
from ..tensor import fr_ops
from . import collectives


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, tp) grid of ranks: rank = i_dp * tp + i_tp (the JAX mesh's
    row-major device order). groups[axis] is this rank's process group
    along the axis (the ranks that differ from it in that index only), or
    None where the axis has one rank. device: where this rank's tensors live."""

    dp: int
    tp: int
    rank: int
    device: torch.device
    groups: dict

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's index along the axis."""
        return self.rank // self.tp if axis == "dp" else self.rank % self.tp

    def group(self, axis: str):
        return self.groups.get(axis)


def make_mesh(n_devices: int | None = None, shape: tuple[int, ...] | None = None, device=None) -> Mesh:
    """The (dp, tp) mesh over the process group's ranks (sharded.py:make_mesh):
    shape (dp, tp), or (dp,) for tp 1; by default (n/2, 2) for an even n > 1,
    else (n, 1). n_devices defaults to the world size (1 without a process
    group). Every rank must call it, with the same arguments: each creates
    every group of both axes, in the same order (dist.new_group).
    device defaults to the rank's device (multihost.rank_device)."""
    from . import multihost

    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    if shape is None:
        shape = (n // 2, 2) if n % 2 == 0 and n > 1 else (n, 1)
    dp, tp = (tuple(shape) + (1,))[:2]
    if dp * tp != n or len(shape) > 2:
        raise ValueError(f"mesh shape {shape} for {n} ranks")
    rank = dist.get_rank() if dist.is_initialized() else 0
    groups = {}
    if dp > 1:
        for j in range(tp):  # the dp axis of each tp column
            g = dist.new_group([i * tp + j for i in range(dp)])
            if rank % tp == j:
                groups["dp"] = g
    if tp > 1:
        for i in range(dp):  # the tp axis of each dp row
            g = dist.new_group([i * tp + j for j in range(tp)])
            if rank // tp == i:
                groups["tp"] = g
    dev = torch.device(device) if device is not None else multihost.rank_device()
    return Mesh(dp, tp, rank, dev, groups)


def shard(mesh: Mesh, x: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    """This rank's contiguous block of x along dim 0 (x: the whole tensor,
    present on every rank)."""
    n = mesh.size(axis)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
    k = x.shape[0] // n
    return x[mesh.index(axis) * k : (mesh.index(axis) + 1) * k]


def local_bits(n_local: int, n_dev: int, r: int) -> tuple[int, int]:
    """(local rounds, device rounds) of an r-variable sumcheck whose 2^r
    entries split into n_dev blocks of n_local."""
    lr, ld = fr_ops.ceil_log2(n_local), fr_ops.ceil_log2(n_dev)
    if n_local != 1 << lr or n_dev != 1 << ld or lr + ld != r:
        raise ValueError(f"{n_dev} blocks of {n_local} for a {r}-variable sumcheck")
    return lr, ld


def sharded_inner_product_prove(mesh: Mesh, a: torch.Tensor, b: torch.Tensor, u, axis: str = "dp"):
    """Distributed inner_product_prove (sharded.py:sharded_inner_product_prove):
    a, b are this rank's natural-order blocks (n_local, 8) of the axis, u
    host (r, 8). The stream equals protocols.inner_product_prove's on the
    whole tensors: (polys (r, 3, 8), finals (2, 8)), the same on every rank.
    The local rounds (sharded.py:_local_ip_rounds) are the planar rounds
    of the rank's block; their polys are summed over the axis in one psum."""
    u = mp.host(u)
    lr, ld = local_bits(a.shape[0], mesh.size(axis), u.shape[0])
    polys, res = pp._ip_rounds(sc._rev(a, lr), sc._rev(b, lr), lr, pp._given(u[:lr]))
    polys = collectives.psum_fr(polys, mesh, axis)
    g = collectives.all_gather(res, mesh, axis).reshape(-1, 2, 8)
    dev_polys, finals = pp._ip_rounds(sc._rev(g[:, 0], ld), sc._rev(g[:, 1], ld), ld, pp._given(u[lr:]))
    return torch.cat([polys, dev_polys]), finals


def sharded_field_matmul(mesh: Mesh, X: torch.Tensor, W: torch.Tensor, in_size: int, out_size: int,
                         dp_axis: str = "dp", tp_axis: str = "tp", gather: bool = False) -> torch.Tensor:
    """Z = X @ W over Fr (sharded.py:sharded_field_matmul), batch on dp and
    output features on tp. X: this rank's dp block of rows (b_local * in, 8);
    W: the whole (in * out, 8), of which the rank multiplies its tp block of
    columns. Returns the rank's (b_local, out / n_tp, 8) block of Z, or with
    gather=True the whole (batch * out, 8) Z on every rank."""
    from ..models import zkfc

    n_tp = mesh.size(tp_axis)
    if out_size % n_tp:
        raise ValueError(f"{out_size} columns over {n_tp} ranks")
    out_local = out_size // n_tp
    j = mesh.index(tp_axis)
    W_cols = W.reshape(in_size, out_size, 8)[:, j * out_local : (j + 1) * out_local].reshape(-1, 8)
    Z = zkfc.field_matmul(X, W_cols.contiguous(), in_size, out_local).reshape(-1, out_local, 8)
    if not gather:
        return Z
    cols = collectives.all_gather(Z.transpose(0, 1).contiguous(), mesh, tp_axis)  # (out, b_local, 8)
    rows = collectives.all_gather(cols.transpose(0, 1).contiguous(), mesh, dp_axis)  # (batch, out, 8)
    return rows.reshape(-1, 8)
