"""The port stands alone: no module of ``cupyimg_tpu_torch``, and not
``chip_smoke.py``, imports JAX or anything of ``cupyimg_tpu``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import cupyimg_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cupyimg_tpu_torch.__path__,
                                               "cupyimg_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "cupyimg_tpu"))
print(json.dumps({"names": names, "bad": bad}))
"""

# modules of the measurements, signal and skimage slice, named so that a
# module left out of the package fails here
SLICE_6 = [
    "cupyimg_tpu_torch.scipy.ndimage.measurements",
    "cupyimg_tpu_torch.scipy.signal._upfirdn",
    "cupyimg_tpu_torch.scipy.signal.signaltools",
    "cupyimg_tpu_torch.skimage._shared.utils",
    "cupyimg_tpu_torch.skimage.morphology.misc",
    "cupyimg_tpu_torch.skimage.morphology.greyreconstruct",
    "cupyimg_tpu_torch.skimage.morphology.convex_hull",
    "cupyimg_tpu_torch.skimage.measure",
    "cupyimg_tpu_torch.skimage.measure._label",
]

# modules of the gap-fillers and skimage's base
SLICE_7 = [
    "cupyimg_tpu_torch.numpy",
    "cupyimg_tpu_torch.numpy.core",
    "cupyimg_tpu_torch.numpy.core.fromnumeric",
    "cupyimg_tpu_torch.numpy.core.multiarray",
    "cupyimg_tpu_torch.numpy.core.numeric",
    "cupyimg_tpu_torch.numpy.lib",
    "cupyimg_tpu_torch.numpy.lib.function_base",
    "cupyimg_tpu_torch.numpy.lib.histograms",
    "cupyimg_tpu_torch.numpy.lib.shape_base",
    "cupyimg_tpu_torch.scipy.special",
    "cupyimg_tpu_torch.scipy.special._convex_analysis",
    "cupyimg_tpu_torch.scipy.stats",
    "cupyimg_tpu_torch.scipy.stats.distributions",
    "cupyimg_tpu_torch.scipy.interpolate",
    "cupyimg_tpu_torch.scipy.interpolate.interpolate",
    "cupyimg_tpu_torch.skimage.util.dtype",
    "cupyimg_tpu_torch.skimage.util.shape",
    "cupyimg_tpu_torch.skimage.util._invert",
    "cupyimg_tpu_torch.skimage.util.noise",
    "cupyimg_tpu_torch.skimage.util._map_array",
    "cupyimg_tpu_torch.skimage._shared._warnings",
    "cupyimg_tpu_torch.skimage._shared.coord",
    "cupyimg_tpu_torch.skimage._shared.fft",
]


def _forbidden(name):
    return name.split(".")[0] in ("jax", "jaxlib", "cupyimg_tpu")


def test_every_port_module_imports_without_jax():
    out = json.loads(subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True).stdout)
    assert len(out["names"]) >= 65  # every module of the package was imported
    assert set(SLICE_6) <= set(out["names"])
    assert set(SLICE_7) <= set(out["names"])
    assert out["bad"] == []


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
