"""The port and its chip smoke test import nothing of JAX or the JAX package."""

import subprocess
import sys
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = ("jax", "jaxlib", "zkdl_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"forbidden import: {name}")
        return None

for m in [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())
import zkdl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(zkdl_tpu_torch.__path__, "zkdl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 40  # every module of the package was imported
