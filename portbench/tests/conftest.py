"""Shared set-up of the benchmark's tests: the checkout on the path, the
spec, and the tiny shapes a CPU run uses.  Whether a card is there is
decided inside each card-only test, never here."""

import json
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

#: a small shape of each configuration, for CPU runs
TINY = {"vol256_f32": (12, 14, 16), "img4096_f32": (40, 36)}


@pytest.fixture(scope="session")
def spec():
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def tiny_shape(spec, workload):
    cell = {w["name"]: w for w in spec["workloads"]}[workload]
    return TINY[cell["config"]]


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
