"""Loss ops (the port of ``mxnet_tpu/ops/loss.py``'s
``softmax_cross_entropy``)."""
from __future__ import annotations

import torch

from .matrix import pick

__all__ = ["softmax_cross_entropy"]


def softmax_cross_entropy(data, label):
    """Cross entropy of ``softmax(data)`` against integer labels, summed
    over the batch."""
    return -pick(torch.log_softmax(data, dim=-1), label, axis=-1).sum()
