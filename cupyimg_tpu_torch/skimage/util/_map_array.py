"""skimage.util.map_array and ArrayMap on torch tensors: a sort of the
input values, ``searchsorted`` and a gather on the device."""

from __future__ import annotations

import numpy as np
import torch

from cupyimg_tpu_torch.core import util

__all__ = ["map_array", "ArrayMap"]


def map_array(input_arr, input_vals, output_vals, out=None):
    """Map the values of ``input_arr`` from ``input_vals`` to
    ``output_vals`` (skimage.util.map_array); values not in
    ``input_vals`` map to 0.  ``out`` is not supported (the result is a
    new tensor)."""
    if out is not None:
        raise NotImplementedError(
            "cupyimg_tpu_torch is functional: `out` is not supported")
    input_arr = util.as_tensor(input_arr)
    dev = input_arr.device
    input_vals = util.as_tensor(input_vals, device=dev)
    output_vals = util.as_tensor(output_vals, device=dev)
    if input_arr.is_floating_point() or input_arr.is_complex() or (
            input_arr.dtype == torch.bool):
        raise TypeError(
            "The dtype of an array to be remapped should be integer.")
    common = torch.promote_types(input_arr.dtype, input_vals.dtype)
    keys = input_vals.reshape(-1).to(common)
    sorted_in, order = torch.sort(keys)
    sorted_out = output_vals.reshape(-1)[order]
    flat = input_arr.reshape(-1).to(common)
    pos = torch.searchsorted(sorted_in, flat).clamp_max(
        max(sorted_in.shape[0] - 1, 0))
    hit = sorted_in[pos] == flat
    mapped = torch.where(hit, sorted_out[pos],
                         torch.zeros((), dtype=output_vals.dtype,
                                     device=dev))
    return mapped.reshape(input_arr.shape)


class ArrayMap:
    """A mapping that indexes like an array without a dense lookup table
    (skimage.util._map_array.ArrayMap): ``ArrayMap(in_values,
    out_values)[labels]`` maps each element of ``labels`` through the
    sparse ``in -> out`` table with :func:`map_array`."""

    def __init__(self, in_values, out_values):
        self.in_values = util.as_tensor(in_values)
        self.out_values = util.as_tensor(out_values,
                                         device=self.in_values.device)
        self._max_str_lines = 4
        self._array = None
        self._max_label = int(self.in_values.max())

    def __len__(self):
        """One more than the largest label remapped."""
        return self._max_label + 1

    def _asarray(self, dtype=None):
        """The dense lookup table equivalent to this map."""
        dtype = self.out_values.dtype if dtype is None else dtype
        output = torch.zeros(self._max_label + 1, dtype=dtype,
                             device=self.in_values.device)
        output[self.in_values.long()] = self.out_values.to(dtype)
        return output

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._asarray().cpu().numpy(), dtype=dtype)

    @property
    def dtype(self):
        return self.out_values.dtype

    def __repr__(self):
        return f"ArrayMap({repr(self.in_values)}, {repr(self.out_values)})"

    def __str__(self):
        ins = self.in_values.tolist()
        outs = self.out_values.tolist()
        if len(ins) <= self._max_str_lines + 1:
            rows = list(range(len(ins)))
            gap = []
        else:
            rows = list(range(0, self._max_str_lines // 2))
            gap = list(range(-self._max_str_lines // 2, 0))
        lines = ["ArrayMap:"] + [f"  {ins[i]} → {outs[i]}" for i in rows]
        if gap:
            lines += ["  ..."] + [f"  {ins[i]} → {outs[i]}" for i in gap]
        return "\n".join(lines)

    def __call__(self, arr):
        return self.__getitem__(arr)

    def __getitem__(self, index):
        scalar = np.isscalar(index)
        dev = self.in_values.device
        if scalar:
            index = torch.as_tensor([index], device=dev)
        elif isinstance(index, slice):
            start = index.start or 0
            stop = index.stop if index.stop is not None else len(self)
            step = index.step or 1
            index = torch.arange(start, stop, step, device=dev)
        index = util.as_tensor(index, device=dev)
        if index.dtype == torch.bool:
            index = torch.nonzero(index).reshape(-1)
        out = map_array(index, self.in_values.to(index.dtype),
                        self.out_values)
        return out[0] if scalar else out

    def __setitem__(self, indices, values):
        if self._array is None:
            self._array = self._asarray()
        dev = self._array.device
        if isinstance(indices, (torch.Tensor, np.ndarray)):
            indices = util.as_tensor(indices, device=dev)
            if indices.dtype == torch.bool:
                indices = torch.nonzero(indices).reshape(-1)
        if isinstance(values, (torch.Tensor, np.ndarray)):
            values = util.as_tensor(values, device=dev).to(self._array.dtype)
        self._array[indices] = values
        self.in_values = torch.nonzero(self._array).reshape(-1)
        self._max_label = int(self.in_values.max())
        self.out_values = self._array[self.in_values]
