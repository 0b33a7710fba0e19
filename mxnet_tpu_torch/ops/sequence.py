"""Sequence ops (the port of ``mxnet_tpu/ops/sequence.py``):
``SequenceMask``, ``SequenceLast`` and ``SequenceReverse`` over the
time axis, with optional per-batch lengths.  The lengths index through
``torch.where`` and ``gather`` (no boolean-mask indexing, which reads
the mask on the host), so the ops run inside a captured graph."""
from __future__ import annotations

import torch

from .registry import register_op

__all__ = ["SequenceMask", "SequenceLast", "SequenceReverse"]


def _steps_and_lens(x, sequence_length):
    """``(T, 1, ...)`` time indices and ``(1, N, 1, ...)`` lengths."""
    t = x.shape[0]
    tail = (1,) * (x.ndim - 2)
    steps = torch.arange(t, device=x.device).reshape((t, 1) + tail)
    lens = sequence_length.to(torch.int32).reshape((1, -1) + tail)
    return steps, lens


@register_op("SequenceMask", aliases=("sequence_mask",))
def SequenceMask(data, sequence_length=None, use_sequence_length=False,
                 value=0.0, axis=0):
    """Steps at or past each sequence's length set to ``value``."""
    if sequence_length is None or not use_sequence_length:
        return data
    x = data.transpose(0, axis) if axis != 0 else data
    steps, lens = _steps_and_lens(x, sequence_length)
    out = torch.where(steps < lens, x,
                      torch.full((), value, dtype=x.dtype, device=x.device))
    return out.transpose(0, axis) if axis != 0 else out


@register_op("SequenceLast", aliases=("sequence_last",))
def SequenceLast(data, sequence_length=None, use_sequence_length=False,
                 axis=0):
    """Each sequence's last valid step (``length - 1``, clipped)."""
    x = data.transpose(0, axis) if axis != 0 else data
    if sequence_length is None or not use_sequence_length:
        return x[-1]
    idx = (sequence_length.to(torch.int64) - 1).clamp(0, x.shape[0] - 1)
    idx = idx.reshape((1, -1) + (1,) * (x.ndim - 2)).expand((1,)
                                                             + x.shape[1:])
    return torch.gather(x, 0, idx)[0]


@register_op("SequenceReverse", aliases=("sequence_reverse",))
def SequenceReverse(data, sequence_length=None, use_sequence_length=False,
                    axis=0):
    """Each sequence's valid prefix reversed in time; the steps past its
    length stay where they are (``axis`` is accepted as in the JAX op,
    which reverses the first axis)."""
    if sequence_length is None or not use_sequence_length:
        return torch.flip(data, (0,))
    steps, lens = _steps_and_lens(data, sequence_length)
    src = torch.where(steps < lens, lens - 1 - steps, steps)
    return torch.gather(data, 0, src.to(torch.int64).expand(data.shape))
