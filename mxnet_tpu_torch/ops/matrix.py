"""Indexing ops (the port of the part of ``mxnet_tpu/ops/matrix.py`` the
classification losses use)."""
from __future__ import annotations

import torch

__all__ = ["pick"]


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data[..., index, ...]`` along ``axis``, one entry per row; the
    index is clipped into range, as the JAX op clips it."""
    if mode != "clip":
        raise ValueError(f"pick: mode {mode!r} is not ported (clip only)")
    idx = index.long().clamp(0, data.shape[axis] - 1).unsqueeze(axis)
    out = torch.gather(data, axis, idx)
    return out if keepdims else out.squeeze(axis)
