"""The port stands alone: no module of ``cupyimg_tpu_torch``, and not
``chip_smoke.py``, imports JAX or anything of ``cupyimg_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import cupyimg_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cupyimg_tpu_torch.__path__,
                                               "cupyimg_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "cupyimg_tpu"))
print(len(names), bad)
"""


def _forbidden(name):
    return name.split(".")[0] in ("jax", "jaxlib", "cupyimg_tpu")


def test_every_port_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.split(None, 1)
    assert int(out[0]) >= 30  # every module of the package was imported
    assert out[1].strip() == "[]"


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "cupyimg_tpu_torch.scipy.signal" in names
    assert [n for n in names if _forbidden(n)] == []
