"""Build the CUDA sources of ``csrc/`` into shared libraries and load them.

Each ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so`` through ``nvcc``
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers: a build
takes seconds). The hash covers the sources, the headers and the flags, so a
changed kernel is rebuilt and an unchanged one is reused. Building happens at
first use, never at import; ``build_all`` compiles every missing library at
once, one ``nvcc`` process per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("fr_kernels", "g1_comb")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every missing library in parallel; returns the wall seconds.
    Raises with the compiler's output if one fails. The ptxas report of each
    build is kept beside it as ``<lib>.log``."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            tmp.replace(out)  # atomic: a reader never sees a partial library
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def ptxas_report(name: str) -> str:
    """The register / spill lines of the last build of csrc/<name>.cu."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(l for l in log.read_text().splitlines() if "registers" in l or "spill" in l)
