"""The sharded tests' runs: the ranks of ``sharded_rank.py`` launched once
per session and rank count (under a file lock, in a directory that the
session's xdist workers share), their outputs read back."""

from __future__ import annotations

import pathlib

import numpy as np

RANK_SCRIPT = pathlib.Path(__file__).resolve().parent / "sharded_rank.py"
DEADLINE_S = 900  # a run's ranks are killed past it (the machine is shared with the other tests)


def run_dir(root: pathlib.Path, n: int) -> pathlib.Path:
    """The directory of the n-rank run, launched here if no worker has yet.
    A run that failed raises again in every test that needs it."""
    from filelock import FileLock

    from zkdl_tpu_torch.parallel import multihost

    d = root / f"sharded_ranks{n}"
    with FileLock(str(d) + ".lock"):
        if (d / "failed").exists():
            raise RuntimeError((d / "failed").read_text())
        if not (d / "done").exists():
            d.mkdir(parents=True, exist_ok=True)
            try:
                multihost.launch(f"{RANK_SCRIPT}:main", n, "gloo", "cpu", args=[str(d)], timeout_s=DEADLINE_S,
                                 workdir=str(d))
            except Exception as e:
                (d / "failed").write_text(str(e))
                raise
            (d / "done").write_text("ok\n")
    return d


def kernel_outputs(d: pathlib.Path, n: int) -> list[dict]:
    """Each rank's kernel-level outputs."""
    out = []
    for r in range(n):
        with np.load(d / f"kern_rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def proof_bytes(d: pathlib.Path, n: int, mode: str) -> list[bytes]:
    """Each rank's serialized proof of a mode."""
    return [(d / f"{mode}_rank{r}.bin").read_bytes() for r in range(n)]
