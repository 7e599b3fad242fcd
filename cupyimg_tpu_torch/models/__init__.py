"""Composite pipelines of the image operators: the single-device
``edge_enhance_pipeline`` and ``richardson_lucy_step``.  The sharded
``sharded_edge_enhance`` comes with ``parallel``."""

from cupyimg_tpu_torch.models.pipeline import (  # noqa: F401
    edge_enhance_pipeline,
    richardson_lucy_step,
)
