"""The port stands alone: no module of ``cupyimg_tpu_torch``, and not
``chip_smoke.py``, imports JAX or anything of ``cupyimg_tpu`` (a spawned
rank of ``parallel.run_world`` neither: ``test_torch_parallel.py``
asserts it on its world), nor ``ml_dtypes``, which the card's machine
lacks (the port's bfloat16 is torch's own)."""

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
             if k.split(".")[0] in ("jax", "jaxlib", "cupyimg_tpu",
                                    "ml_dtypes"))
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


# modules of the rest of skimage.measure, skimage.color and
# skimage.exposure
SLICE_8 = [
    "cupyimg_tpu_torch.skimage.measure.entropy",
    "cupyimg_tpu_torch.skimage.measure.block",
    "cupyimg_tpu_torch.skimage.measure._moments",
    "cupyimg_tpu_torch.skimage.measure._regionprops_utils",
    "cupyimg_tpu_torch.skimage.measure._regionprops",
    "cupyimg_tpu_torch.skimage.measure._polygon",
    "cupyimg_tpu_torch.skimage.measure.profile",
    "cupyimg_tpu_torch.skimage.color",
    "cupyimg_tpu_torch.skimage.color.colorconv",
    "cupyimg_tpu_torch.skimage.color.rgb_colors",
    "cupyimg_tpu_torch.skimage.color.colorlabel",
    "cupyimg_tpu_torch.skimage.color.delta_e",
    "cupyimg_tpu_torch.skimage.color.adapt_rgb",
    "cupyimg_tpu_torch.skimage.exposure",
    "cupyimg_tpu_torch.skimage.exposure.exposure",
    "cupyimg_tpu_torch.skimage.exposure.histogram_matching",
    "cupyimg_tpu_torch.skimage.exposure._adapthist",
]


# modules of skimage.transform, skimage.feature (all but canny) and
# skimage.metrics
SLICE_9 = [
    "cupyimg_tpu_torch.skimage.transform",
    "cupyimg_tpu_torch.skimage.transform._geometric",
    "cupyimg_tpu_torch.skimage.transform.integral",
    "cupyimg_tpu_torch.skimage.transform._warps",
    "cupyimg_tpu_torch.skimage.transform.pyramids",
    "cupyimg_tpu_torch.skimage.feature",
    "cupyimg_tpu_torch.skimage.feature.peak",
    "cupyimg_tpu_torch.skimage.feature.corner",
    "cupyimg_tpu_torch.skimage.feature.template",
    "cupyimg_tpu_torch.skimage.feature._daisy",
    "cupyimg_tpu_torch.skimage.metrics",
    "cupyimg_tpu_torch.skimage.metrics.simple_metrics",
    "cupyimg_tpu_torch.skimage.metrics._structural_similarity",
]


# modules of skimage.filters, feature.canny and skimage.restoration
SLICE_10 = [
    "cupyimg_tpu_torch.skimage.filters",
    "cupyimg_tpu_torch.skimage.filters.edges",
    "cupyimg_tpu_torch.skimage.filters._gaussian",
    "cupyimg_tpu_torch.skimage.filters._median",
    "cupyimg_tpu_torch.skimage.filters._unsharp_mask",
    "cupyimg_tpu_torch.skimage.filters._rank_order",
    "cupyimg_tpu_torch.skimage.filters._window",
    "cupyimg_tpu_torch.skimage.filters._gabor",
    "cupyimg_tpu_torch.skimage.filters.lpi_filter",
    "cupyimg_tpu_torch.skimage.filters.thresholding",
    "cupyimg_tpu_torch.skimage.filters.ridges",
    "cupyimg_tpu_torch.skimage.feature._canny",
    "cupyimg_tpu_torch.skimage.restoration",
    "cupyimg_tpu_torch.skimage.restoration.uft",
    "cupyimg_tpu_torch.skimage.restoration.deconvolution",
    "cupyimg_tpu_torch.skimage.restoration._denoise",
    "cupyimg_tpu_torch.skimage.restoration.j_invariant",
]


# modules of skimage.registration, skimage.segmentation, the pipelines and
# the root helpers
SLICE_11 = [
    "cupyimg_tpu_torch._misc",
    "cupyimg_tpu_torch.version",
    "cupyimg_tpu_torch.models",
    "cupyimg_tpu_torch.models.pipeline",
    "cupyimg_tpu_torch.skimage.registration",
    "cupyimg_tpu_torch.skimage.registration._optical_flow_utils",
    "cupyimg_tpu_torch.skimage.registration._masked_phase_cross_correlation",
    "cupyimg_tpu_torch.skimage.registration._phase_cross_correlation",
    "cupyimg_tpu_torch.skimage.registration._optical_flow",
    "cupyimg_tpu_torch.skimage.segmentation",
    "cupyimg_tpu_torch.skimage.segmentation._join",
    "cupyimg_tpu_torch.skimage.segmentation.boundaries",
    "cupyimg_tpu_torch.skimage.segmentation.morphsnakes",
]


# modules of the multi-device package, the dual-backend test oracle and
# the graft entry
SLICE_12 = [
    "cupyimg_tpu_torch.parallel",
    "cupyimg_tpu_torch.parallel.halo",
    "cupyimg_tpu_torch.parallel._world",
    "cupyimg_tpu_torch.testing",
    "cupyimg_tpu_torch.testing.helper",
    "cupyimg_tpu_torch.graft_entry",
]


def _forbidden(name):
    return name.split(".")[0] in ("jax", "jaxlib", "cupyimg_tpu", "ml_dtypes")


def test_every_port_module_imports_without_jax():
    out = json.loads(subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True).stdout)
    assert len(out["names"]) >= 125  # every module of the package was imported
    assert set(SLICE_6) <= set(out["names"])
    assert set(SLICE_7) <= set(out["names"])
    assert set(SLICE_8) <= set(out["names"])
    assert set(SLICE_9) <= set(out["names"])
    assert set(SLICE_10) <= set(out["names"])
    assert set(SLICE_11) <= set(out["names"])
    assert set(SLICE_12) <= set(out["names"])
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
