"""Process bring-up, meshes over every rank, and a launcher for the
distributed prover.

Counterpart of ``zkdl_tpu/parallel/multihost.py`` (``init_distributed``
:42, ``global_mesh`` :68, ``global_sharded`` :86, ``global_replicated``
:95). The JAX package joins a multi-process JAX runtime; here each rank is
a process of a ``torch.distributed`` group, one device each:

- ``init_distributed`` calls ``dist.init_process_group`` with an explicit
  backend and timeout, from a file store or, without one, from the torchrun
  variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``). Device "cuda" gives rank r the card cuda:(local rank);
  "cuda:K" puts every rank of the host on card K (two ranks sharing one
  card: gloo only, NCCL refuses a duplicate GPU); "cpu" runs the plain
  versions. A missing card, a card index past the host's, or NCCL on the
  CPU or on a shared card raises.
- ``global_mesh`` lays the ranks out as a (dp, tp) mesh, rank-major (a
  host's ranks are consecutive, so the high bits of dp are the hosts).
- ``global_sharded`` / ``global_replicated`` take data present on every
  process and keep this rank's block of it, or all of it, on its device.
- ``launch`` starts the ranks of one job as processes of this host
  (``python -m zkdl_tpu_torch.parallel.multihost``), each joining through
  a file store, and joins them with a deadline: the first rank that fails
  or outlives it has every rank killed, and ``launch`` raises.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import importlib.util
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from . import sharded

DEFAULT_TIMEOUT_S = 300.0
_DEVICE: torch.device | None = None


def rank_device() -> torch.device:
    """The device init_distributed gave this rank (the CPU before it ran)."""
    return _DEVICE if _DEVICE is not None else torch.device("cpu")


def _pick_device(device: str, local_rank: int, world: int, backend: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL carries CUDA tensors only: use gloo on the CPU")
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is False")
    index = local_rank if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"rank with local rank {local_rank} was told to use cuda:{index}, "
                           f"but this host has {torch.cuda.device_count()} card(s)")
    if backend == "nccl" and dev.index is not None and world > 1:
        raise ValueError(f"NCCL cannot put several ranks on one card ({device}): use gloo")
    return torch.device("cuda", index)


def init_distributed(backend: str, device: str = "cuda", store: str | None = None, rank: int | None = None,
                     world_size: int | None = None, local_rank: int | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> tuple[int, int, torch.device]:
    """Join the process group; returns (rank, world size, this rank's device).

    backend: "gloo" or "nccl", never chosen here. store: a file path every
    rank of the job shares (a file store); without it the torchrun
    variables rendezvous (env://). rank, world_size and local_rank default
    to RANK, WORLD_SIZE and LOCAL_RANK (local rank: the rank). timeout_s
    bounds the rendezvous and every collective."""
    global _DEVICE
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = _pick_device(device, local_rank, world_size, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_method = f"file://{os.path.abspath(store)}" if store else "env://"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE = dev
    return rank, world_size, dev


def global_mesh(dp: int = 0, tp: int = 1) -> sharded.Mesh:
    """The (dp, tp) mesh over every rank (multihost.py:global_mesh), dp 0
    meaning the world size over tp."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp <= 0:
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"mesh ({dp}, {tp}) for {world} ranks")
    return sharded.make_mesh(world, (dp, tp))


def global_sharded(mesh: sharded.Mesh, data, axis: str = "dp") -> torch.Tensor:
    """This rank's block along dim 0 of data that every process holds (a
    numpy array or a tensor), on the rank's device; nothing is gathered."""
    t = torch.from_numpy(np.ascontiguousarray(data)) if isinstance(data, np.ndarray) else data
    return sharded.shard(mesh, t, axis).to(mesh.device)


def global_replicated(mesh: sharded.Mesh, data) -> torch.Tensor:
    """All of data (challenges, folded operands, weights) on the rank's device."""
    t = torch.from_numpy(np.ascontiguousarray(data)) if isinstance(data, np.ndarray) else data
    return t.to(mesh.device)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------


def _resolve(target: str):
    """'package.module:function' or 'path/to/file.py:function'."""
    where, _, name = target.rpartition(":")
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(pathlib.Path(where).stem, where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def launch(target: str, n_ranks: int, backend: str, device: str, args=(), timeout_s: float = DEFAULT_TIMEOUT_S,
           workdir: str | None = None) -> list[str]:
    """Run target(args) on n_ranks ranks of this host, each a process that
    joins the group through a file store in workdir (a new temporary
    directory by default) and the loopback interface, with one intra-op
    thread. Returns each rank's
    output (stdout and stderr). Raises RuntimeError, with the outputs, when
    a rank exits nonzero or the job outlives timeout_s (the rendezvous and
    every collective have the same timeout); every rank is killed first."""
    work = pathlib.Path(workdir or tempfile.mkdtemp(prefix="zkdl_ranks_"))
    work.mkdir(parents=True, exist_ok=True)
    store = work / "store"
    store.unlink(missing_ok=True)
    root = str(pathlib.Path(__file__).resolve().parents[2])
    base = dict(os.environ)
    base["PYTHONPATH"] = root + os.pathsep + base.get("PYTHONPATH", "")
    # the ranks of one host connect over the loopback interface: a sealed
    # host's name may resolve to an address that no rank can reach
    base.setdefault("GLOO_SOCKET_IFNAME", "lo")
    base.setdefault("NCCL_SOCKET_IFNAME", "lo")
    procs, logs = [], []
    try:
        for r in range(n_ranks):
            log = open(work / f"rank{r}.log", "w+b")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "zkdl_tpu_torch.parallel.multihost", "--target", target,
                 "--backend", backend, "--device", device, "--store", str(store), "--timeout", str(timeout_s),
                 "--", *map(str, args)],
                env={**base, "RANK": str(r), "WORLD_SIZE": str(n_ranks), "LOCAL_RANK": str(r)},
                cwd=root, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with code {procs[bad[0]].returncode}"
            elif time.monotonic() > deadline:
                failed = f"the ranks outlived their {timeout_s:.0f}s deadline"
            else:
                time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with code {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read().decode(errors="replace"))
        log.close()
    if failed:
        raise RuntimeError(f"{target} on {n_ranks} ranks: {failed}\n" + "\n".join(
            f"--- rank {r} ---\n{o[-4000:]}" for r, o in enumerate(outs)))
    return outs


def _rank_main(argv=None) -> int:
    """One rank of a launch: join the group, run the target, leave."""
    ap = argparse.ArgumentParser(prog="python -m zkdl_tpu_torch.parallel.multihost")
    ap.add_argument("--target", required=True)
    ap.add_argument("--backend", required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S)
    ap.add_argument("args", nargs="*")
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    init_distributed(a.backend, a.device, store=a.store, timeout_s=a.timeout)
    try:
        _resolve(a.target)(a.args)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    # run as the package's module, so that rank_device() (read by make_mesh)
    # sees the device init_distributed sets, not a copy in __main__
    from zkdl_tpu_torch.parallel import multihost

    sys.exit(multihost._rank_main())
