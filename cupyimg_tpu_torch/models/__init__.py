"""Composite pipelines of the image operators: the single-device
``edge_enhance_pipeline`` and ``richardson_lucy_step``, and
``sharded_edge_enhance`` over a device mesh (``parallel``)."""

from cupyimg_tpu_torch.models.pipeline import (  # noqa: F401
    edge_enhance_pipeline,
    richardson_lucy_step,
    sharded_edge_enhance,
)
