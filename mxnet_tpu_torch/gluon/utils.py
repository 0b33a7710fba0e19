"""gluon.utils (the port of ``mxnet_tpu/gluon/utils.py``'s
``split_data``, ``split_and_load`` and ``clip_global_norm``; there is no
``download``: the port fetches nothing)."""
from __future__ import annotations

import warnings

import numpy as np

from .. import ndarray as nd
from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split one batch along ``batch_axis`` into ``num_slice`` pieces
    (the last takes the remainder unless ``even_split``)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        lo = i * step
        hi = (i + 1) * step if i < num_slice - 1 else size
        idx = [slice(None)] * data.ndim
        idx[batch_axis] = slice(lo, hi)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split a batch and load each slice onto one context."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` so that their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling (one host sync)."""
    if not arrays:
        return 0.0
    acc = (arrays[0] * arrays[0]).sum()
    for a in arrays[1:]:
        acc = acc + (a * a).sum()
    total = float(np.sqrt(float(acc.asnumpy())))
    if check_isfinite and not np.isfinite(total):
        warnings.warn("nan or inf found in gradients — clip skipped")
        return total
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a *= scale
    return total
