"""Indexing ops (the port of the part of ``mxnet_tpu/ops/matrix.py`` the
classification losses and BERT use)."""
from __future__ import annotations

import torch

__all__ = ["pick", "Embedding", "gather_nd"]


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data[..., index, ...]`` along ``axis``, one entry per row; the
    index is clipped into range, as the JAX op clips it."""
    if mode != "clip":
        raise ValueError(f"pick: mode {mode!r} is not ported (clip only)")
    idx = index.long().clamp(0, data.shape[axis] - 1).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)


def Embedding(data, weight, input_dim=None, output_dim=None,
              dtype="float32", sparse_grad=False):
    """Rows of ``weight`` at the integer ``data``, the indices clipped
    into ``[0, input_dim)`` as the JAX op clips them."""
    idx = data.long().clamp(0, weight.shape[0] - 1)
    return torch.nn.functional.embedding(idx, weight)


def gather_nd(data, indices):
    """``data[indices[0], ..., indices[M-1]]``: ``indices`` of shape
    ``(M, ...)`` index the first M dims of ``data``.  Negative indices
    count from the end and out-of-range ones clamp, as JAX's gather
    treats them."""
    idx = indices.long()
    parts = []
    for i in range(idx.shape[0]):
        n = data.shape[i]
        parts.append(torch.where(idx[i] < 0, idx[i] + n, idx[i])
                     .clamp(0, n - 1))
    return data[tuple(parts)]
