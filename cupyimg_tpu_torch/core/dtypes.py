"""dtype-promotion policy for filters (``dtype_mode``), numpy <-> torch.

- ``'ndimage'``: SciPy parity: accumulate in float64 (complex128 for
  complex data).
- ``'float'``: accumulate in the nearest floating type of the input, at
  least float32/complex64.

The policy is reckoned in numpy dtypes; :func:`to_torch` and
:func:`to_numpy` cross between the two libraries.
"""

from __future__ import annotations

import numpy as np
import torch

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def to_numpy(dtype) -> np.dtype:
    """numpy dtype of a torch dtype or any numpy dtype-like."""
    if isinstance(dtype, torch.dtype):
        return _TORCH_TO_NP[dtype]
    return np.dtype(dtype)


def to_torch(dtype) -> torch.dtype:
    """torch dtype of a numpy dtype-like or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


def promote_weights_dtype(input_dtype, weights_dtype, dtype_mode: str):
    """Compute the numpy dtype used for the filter weights/accumulation."""
    input_dtype = to_numpy(input_dtype)
    weights_dtype = to_numpy(weights_dtype)
    is_complex = input_dtype.kind == "c" or weights_dtype.kind == "c"
    if dtype_mode == "ndimage":
        return np.dtype(np.complex128 if is_complex else np.float64)
    elif dtype_mode == "float":
        real = _real_dtype(input_dtype)
        if is_complex:
            return np.promote_types(real, np.complex64)
        return np.promote_types(real, np.float32)
    else:
        raise ValueError(f"unsupported dtype_mode: {dtype_mode}")


def _real_dtype(dtype):
    dtype = np.dtype(dtype)
    if dtype.kind == "c":
        return np.dtype(f"f{dtype.itemsize // 2}")
    return dtype


def is_integer_dtype(dtype) -> bool:
    return to_numpy(dtype).kind in "iu"


def is_complex_dtype(dtype) -> bool:
    return to_numpy(dtype).kind == "c"


def resolve_output_dtype(output, input_dtype, weights_dtype=None):
    """Resolve the numpy output dtype of a filter call.

    ``output`` may be None (default: input dtype, promoted to complex if
    the weights are complex) or a dtype-like.  Every op returns a fresh
    tensor; passing a tensor or ndarray as ``output`` raises.
    """
    input_dtype = to_numpy(input_dtype)
    if isinstance(output, (np.ndarray, torch.Tensor)):
        raise NotImplementedError(
            "cupyimg_tpu_torch is functional: preallocated `output` arrays "
            "are not supported; pass a dtype instead"
        )
    if weights_dtype is not None:
        weights_dtype = to_numpy(weights_dtype)
        if output is None:
            if weights_dtype.kind == "c":
                return np.promote_types(input_dtype, np.complex64)
            return input_dtype
        out_dtype = to_numpy(output)
        if (
            input_dtype.kind == "c" or weights_dtype.kind == "c"
        ) and out_dtype.kind != "c":
            raise RuntimeError(
                "output must have complex dtype if either the input or "
                "weights are complex-valued."
            )
        return out_dtype
    return input_dtype if output is None else to_numpy(output)
