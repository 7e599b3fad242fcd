"""``skimage.filters.try_all_threshold`` of the torch port on a CPU
tensor: every global threshold drawn on a matplotlib figure (Agg).  A
file of its own, as importing pyplot costs about two seconds."""

import numpy as np
import pytest
import torch

from cupyimg_tpu_torch.core.config import config
from cupyimg_tpu_torch.skimage import filters


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def test_try_all_threshold():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.normal(0.2, 0.05, 500),
                        rng.normal(0.8, 0.05, 500)]).reshape(20, 50)
    fig, ax = filters.try_all_threshold(torch.from_numpy(x), verbose=False)
    assert len(ax) >= 8
    import matplotlib.pyplot as plt
    plt.close(fig)
