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

Both are registered ops (``nd.multi_head_attention``,
``nd.flash_attention``), beside the rest of the JAX module's names: the
reference's interleaved self-attention pair
(``interleaved_matmul_selfatt_qk``/``_valatt`` over ``(S, B, H*3*D)``
projections) and ``div_sqrt_dim``.  ``ring_attention`` and
``ulysses_attention`` run over the current mesh's ``sp`` axis
(``parallel.sequence``).

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
from .registry import register_op

__all__ = ["multi_head_attention", "flash_attention"]

_NEG = -1e30


def _split_interleaved(qkv, heads):
    """``(S, B, H*3*D)`` -> three ``(B*H, S, D)`` tensors, the
    reference's layout."""
    s, b, hd3 = qkv.shape
    d = hd3 // (heads * 3)
    x = qkv.reshape(s, b, heads, 3, d)
    return tuple(x[:, :, :, i, :].permute(1, 2, 0, 3).reshape(b * heads, s, d)
                 for i in range(3))


@register_op("interleaved_matmul_selfatt_qk",
             aliases=("_contrib_interleaved_matmul_selfatt_qk",))
def _selfatt_qk(queries_keys_values, heads=1):
    """``(1/sqrt(D)) Q K^T`` -> ``(B*H, S, S)``."""
    q, k, _ = _split_interleaved(queries_keys_values, heads)
    scale = 1.0 / torch.sqrt(torch.tensor(q.shape[-1], dtype=q.dtype,
                                          device=q.device))
    return torch.matmul(q * scale, k.transpose(-1, -2))


@register_op("interleaved_matmul_selfatt_valatt",
             aliases=("_contrib_interleaved_matmul_selfatt_valatt",))
def _selfatt_valatt(queries_keys_values, attention, heads=1):
    """``attention @ V`` -> ``(S, B, H*D)``."""
    _, _, v = _split_interleaved(queries_keys_values, heads)
    s, b = queries_keys_values.shape[0], queries_keys_values.shape[1]
    d = v.shape[-1]
    out = torch.matmul(attention, v).reshape(b, heads, s, d)
    return out.permute(2, 0, 1, 3).reshape(s, b, heads * d)


@register_op("div_sqrt_dim", aliases=("_contrib_div_sqrt_dim",))
def _div_sqrt_dim(x):
    return x / torch.sqrt(torch.tensor(x.shape[-1], dtype=x.dtype,
                                       device=x.device))


@register_op("ring_attention")
def _ring_attention(q, k, v, heads=1, causal=False, axis="sp",
                    batch_axis="dp", dropout=0.0, training=None):
    """Sequence-parallel attention over the current mesh's ``sp`` axis
    (``parallel.sequence.ring_attention``); needs a ``MeshScope`` (or a
    ``TrainStep``/``EvalStep``, which open one)."""
    from ..parallel.sequence import ring_attention
    if training is None:
        training = _autograd.is_training()
    return ring_attention(q, k, v, heads, axis=axis, batch_axis=batch_axis,
                          causal=causal, dropout=dropout, training=training)


@register_op("ulysses_attention")
def _ulysses_attention(q, k, v, heads=1, causal=False, axis="sp",
                       batch_axis="dp", dropout=0.0, training=None):
    """Ulysses head-split attention over the current mesh (see above)."""
    from ..parallel.sequence import ulysses_attention
    if training is None:
        training = _autograd.is_training()
    return ulysses_attention(q, k, v, heads, axis=axis, batch_axis=batch_axis,
                             causal=causal, dropout=dropout,
                             training=training)


@register_op("multi_head_attention", needs_rng=True)
def multi_head_attention(q, k, v, mask=None, heads=1, dropout=0.0,
                         causal=False, training=None):
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


@register_op("flash_attention")
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
