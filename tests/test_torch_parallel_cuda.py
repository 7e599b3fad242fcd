"""The parallel package on the card: a 2-rank world on ``cuda:0`` (gloo,
the halo slabs staged through pinned host memory), where each rank's
``sharded_uniform_filter`` of a 3-D float32 volume is one launch of the
fused separable kernel and agrees with the single-device call within
1e-5 of max|ref| (float32 sums in another order).  Carries the ``cuda``
marker and skips without a card; imports no JAX (run it on the card with
``python3 -m pytest --noconftest -p no:cacheprovider -q -m cuda
tests/test_torch_parallel_cuda.py``).
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _rank(world):
    import cupyimg_tpu_torch.scipy.ndimage as ndi
    from cupyimg_tpu_torch import parallel
    from cupyimg_tpu_torch.ops import fused_separable as fs

    x = torch.from_numpy(np.random.RandomState(0).rand(64, 48, 40).astype(
        np.float32)).to(world.device)
    mesh = world.mesh((2,), ("x",))
    fs.fused_separable_correlate.launches = 0
    y = parallel.sharded_uniform_filter(x, 5, mesh, ("x", None, None))
    torch.cuda.synchronize()
    launches = fs.fused_separable_correlate.launches
    full = parallel.full_tensor(y)
    ref = ndi.uniform_filter(x, 5)
    err = float((full - ref).abs().max()) / float(ref.abs().max())
    return {"launches": launches, "err": err, "transport": world.transport}


@pytest.mark.cuda
def test_sharded_uniform_filter_one_launch_a_rank(cuda):
    from cupyimg_tpu_torch.parallel import run_world

    out = run_world(_rank, 2, "cuda")
    assert out["launches"] == 1
    assert out["err"] <= 1e-5
    want = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    assert out["transport"] == want
