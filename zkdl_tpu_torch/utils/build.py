"""Build the native sources of the port into shared libraries and load them.

Each CUDA source ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so``
through ``nvcc``, and each host source ``native/<name>.cpp`` (the verifier's
G1 library) through ``g++``. Both have a plain C interface, loaded with
``ctypes`` (no PyTorch headers: a build takes seconds). The hash covers the
source, its headers and the flags, so a changed source is rebuilt and an
unchanged one is reused. Building happens at first use, never at import;
``build_all`` compiles every missing library at once, one compiler process
per source. A failed build raises with the compiler's output: nothing falls
back to a Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PACKAGE = pathlib.Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
NATIVE = PACKAGE / "native"
BUILD_DIR = PACKAGE / "_build"
SOURCES = ("fr_kernels", "g1_comb", "g1_var", "fr_inverse", "g1_glv", "fr_collect", "fr_ntt", "g2", "g1_win")  # CUDA kernels, csrc/<name>.cu
HOST_SOURCES = ("zkdl_host",)  # host libraries, native/<name>.cpp
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

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


def gxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found; the native host library cannot be built")
    return found


def _recipe(name: str) -> tuple[pathlib.Path, list[pathlib.Path], list[str]]:
    """(source, headers hashed with it, flags) of one library."""
    if name in HOST_SOURCES:
        return NATIVE / f"{name}.cpp", [], GXX_FLAGS
    if name in SOURCES:
        return CSRC / f"{name}.cu", sorted(CSRC.glob("*.cuh")), FLAGS
    raise ValueError(f"unknown native source {name!r}")


def library_path(name: str) -> pathlib.Path:
    src, headers, flags = _recipe(name)
    h = hashlib.sha256()
    for f in headers + [src]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every missing library in parallel; returns the wall seconds.
    Raises with the compiler's output if one fails. The compiler's output of
    each build (for nvcc, the ptxas report) is kept beside it as ``<lib>.log``."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src, _, flags = _recipe(name)
        cmd = [gxx_path(), *flags] if name in HOST_SOURCES else [nvcc_path(), *flags, "-I", str(CSRC)]
        cmd += ["-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"{pathlib.Path(proc.args[0]).name} failed for {src.name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            tmp.replace(out)  # atomic: a reader never sees a partial library
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source <name>, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load {path.name}: {e}") from e
        _loaded[name] = lib
    return lib


def ptxas_report(name: str) -> str:
    """The register / spill lines of the last build of csrc/<name>.cu."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(l for l in log.read_text().splitlines() if "registers" in l or "spill" in l)
