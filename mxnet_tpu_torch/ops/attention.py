"""Attention ops on ``(B, S, H*D)`` projections — the port of
``mxnet_tpu/ops/attention.py``'s ``multi_head_attention`` and
``flash_attention``.

``multi_head_attention`` is the dense op (the ``attention_impl="dense"``
path), written with ``torch.matmul`` and ``torch.softmax`` rather than
``scaled_dot_product_attention``: masked scores are filled with
``-1e30``, not ``-inf``, so a row whose keys are all masked (a padded
row of a prefill batch) gets finite uniform weights exactly as the JAX
reference does, where SDPA's ``-inf`` masking would give NaN.

``flash_attention`` reshapes to ``(B*H, S, D)`` (batch major, head
minor, contiguous) and calls ``ops.flash_attention``'s kernels.

Both drop attention probabilities in training mode only: the dense op
through the ``Dropout`` op (its mask from ``random.generator`` of the
data's device), the flash op inside its kernels from a seed the device's
counter gives per call (``random.next_seed_tensor``: a device tensor, so
a captured graph of the step draws new masks on every replay).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd as _autograd
from .. import random as _random
from .flash_attention import flash_attention as _flash_bhsd
from .nn import Dropout

__all__ = ["multi_head_attention", "flash_attention"]

_NEG = -1e30


def multi_head_attention(q, k, v, mask=None, heads=1, causal=False,
                         dropout=0.0, training=None):
    """Attention over ``(B, S, H*D)`` projections.

    ``scale = 1/sqrt(D)`` (float32-rounded) multiplies q before the
    product, as in the JAX package.  ``causal`` masks keys after each
    query; ``mask`` (broadcastable to ``(B, H, Sq, Sk)``, nonzero =
    keep) masks keys, e.g. padding.  ``dropout`` drops attention
    probabilities (inverted), in training mode only.  Returns
    ``(B, Sq, H*D)``."""
    if training is None:
        training = _autograd.is_training()
    b, sq, hd = q.shape
    d = hd // heads

    def to_bhsd(x):
        return x.reshape(b, -1, heads, d).permute(0, 2, 1, 3)

    qh, kh, vh = to_bhsd(q), to_bhsd(k), to_bhsd(v)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    scores = torch.matmul(qh * scale, kh.transpose(-1, -2))
    neg = torch.full((), _NEG, dtype=scores.dtype, device=scores.device)
    if causal:
        sk = kh.shape[2]
        cm = torch.ones((sq, sk), dtype=torch.bool,
                        device=scores.device).tril()
        scores = torch.where(cm, scores, neg)
    if mask is not None:
        scores = torch.where(mask.to(torch.bool), scores, neg)
    attn = torch.softmax(scores, dim=-1)
    if dropout > 0.0 and training:
        attn = Dropout(attn, p=dropout, training=True)
    out = torch.matmul(attn, vh)
    return out.permute(0, 2, 1, 3).reshape(b, sq, hd)


def flash_attention(q, k, v, heads=1, causal=False, block_q=128,
                    block_k=128, dropout=0.0, training=None):
    """Flash attention over ``(B, S, H*D)`` projections through the
    ``(B*H, S, D)`` kernels: O(S*D) memory instead of the dense op's
    O(S^2) scores.  ``dropout`` drops attention probabilities inside the
    kernels in training mode only, seeded per call from the framework's
    stream.  Returns ``(B, S, H*D)``."""
    if training is None:
        training = _autograd.is_training()
    b, sq, hd = q.shape
    d = hd // heads

    def to_bhsd(x):
        return x.reshape(b, -1, heads, d).permute(0, 2, 1, 3) \
            .reshape(b * heads, -1, d).contiguous()

    drop = float(dropout) if training else 0.0
    seed = _random.next_seed_tensor(q.device) if drop > 0.0 else None
    out = _flash_bhsd(to_bhsd(q), to_bhsd(k), to_bhsd(v), None, causal,
                      block_q, block_k, drop, seed)
    return out.reshape(b, heads, sq, d).permute(0, 2, 1, 3) \
        .reshape(b, sq, hd)
