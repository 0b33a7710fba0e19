"""Dense multi-head attention — the port of ``mxnet_tpu/ops/attention.py``
``multi_head_attention``, inference only (no dropout).

Written with ``torch.matmul`` and ``torch.softmax`` rather than
``scaled_dot_product_attention``: masked scores are filled with
``-1e30``, not ``-inf``, so a row whose keys are all masked (a padded
row of a prefill batch) gets finite uniform weights exactly as the JAX
reference does, where SDPA's ``-inf`` masking would give NaN.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["multi_head_attention"]

_NEG = -1e30


def multi_head_attention(q, k, v, mask=None, heads=1, causal=False):
    """Attention over ``(B, S, H*D)`` projections.

    ``scale = 1/sqrt(D)`` (float32-rounded) multiplies q before the
    product, as in the JAX package.  ``causal`` masks keys after each
    query; ``mask`` (broadcastable to ``(B, H, Sq, Sk)``, nonzero =
    keep) masks keys, e.g. padding.  Returns ``(B, Sq, H*D)``."""
    b, sq, hd = q.shape
    d = hd // heads

    def to_bhsd(x):
        return x.reshape(b, -1, heads, d).permute(0, 2, 1, 3)

    qh, kh, vh = to_bhsd(q), to_bhsd(k), to_bhsd(v)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    scores = torch.matmul(qh * scale, kh.transpose(-1, -2))
    neg = torch.tensor(_NEG, dtype=scores.dtype, device=scores.device)
    if causal:
        sk = kh.shape[2]
        cm = torch.ones((sq, sk), dtype=torch.bool,
                        device=scores.device).tril()
        scores = torch.where(cm, scores, neg)
    if mask is not None:
        scores = torch.where(mask.to(torch.bool), scores, neg)
    attn = torch.softmax(scores, dim=-1)
    out = torch.matmul(attn, vh)
    return out.permute(0, 2, 1, 3).reshape(b, sq, hd)
