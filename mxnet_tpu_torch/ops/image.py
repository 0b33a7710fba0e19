"""Image ops on HWC / NHWC tensors (the port of ``mxnet_tpu/ops/image.py``:
9 ops, 18 names).

``image_resize`` is ``jax.image.resize``'s function, not torch's
default interpolation: bilinear weights from a triangle kernel at
half-pixel centres, widened by the scale on a downscale (antialiased),
each output's weights normalised to sum to 1, computed in float32
(integer images are resized in float32 and rounded, then clipped back
to uint8); a size that does not change is left alone.  Nearest picks
``floor((i + 0.5) * in / out)``.

The random ops (``image_random_*``) draw from the data device's seeded
stream (``random.generator``), not from threefry keys, so one seed gives
other draws than the JAX package's; what holds in both is that the
output is the input or its flip, and that the factor lies in its range.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import random as _random
from .registry import register_op

__all__ = ["image_resize", "image_normalize", "image_to_tensor",
           "image_crop"]


_INV_255 = float(np.float32(1.0 / 255.0))


def _weights(n_in, n_out, device):
    """``jax.image.resize``'s linear weight matrix ``(n_in, n_out)``,
    antialiased, in float32 (``compute_weight_mat`` with no
    translation)."""
    f32 = torch.float32
    inv = torch.tensor(1.0 / (n_out / n_in), dtype=f32)
    kernel_scale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, dtype=f32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs() \
        / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _nearest(n_in, n_out, device):
    """``floor((i + 0.5) * n_in / n_out)`` in float32 as XLA computes it
    for the JAX op: one multiply by the constant ``n_in * (1 / n_out)``
    folded in float32, which decides the exact boundaries."""
    scale = float(np.float32(n_in) * np.float32(1.0 / n_out))
    idx = torch.floor((torch.arange(n_out, dtype=torch.float32) + 0.5)
                      * scale).to(torch.int64)
    return idx.to(device)


@register_op("image_resize", aliases=("resize",))
def image_resize(data, size=None, keep_ratio=False, interp=1):
    """Resize HWC or NHWC to ``size`` (an int, or ``(w, h)``); with an
    int and ``keep_ratio`` the short side becomes ``size``.  Bilinear
    (``interp=1``) or nearest (``interp=0``)."""
    hwc = data.ndim == 3
    x = data[None] if hwc else data
    _, h, w, _ = x.shape
    if isinstance(size, int):
        if keep_ratio:
            if h < w:
                new_h, new_w = size, int(w * size / h)
            else:
                new_h, new_w = int(h * size / w), size
        else:
            new_h = new_w = size
    else:
        new_w, new_h = size
    if interp == 0:
        if new_h != h:
            x = x.index_select(1, _nearest(h, new_h, x.device))
        if new_w != w:
            x = x.index_select(2, _nearest(w, new_w, x.device))
        return x[0] if hwc else x
    out = x if x.is_floating_point() else x.to(torch.float32)
    if new_h != h:
        out = torch.einsum("nhwc,hH->nHwc", out,
                           _weights(h, new_h, x.device).to(out.dtype))
    if new_w != w:
        out = torch.einsum("nhwc,wW->nhWc", out,
                           _weights(w, new_w, x.device).to(out.dtype))
    if data.dtype == torch.uint8:
        out = out.round().clamp(0, 255).to(torch.uint8)
    return out[0] if hwc else out


@register_op("image_normalize", aliases=("normalize",))
def image_normalize(data, mean=0.0, std=1.0):
    """``(data - mean) / std`` per channel of CHW / NCHW data."""
    mean = torch.as_tensor(mean, dtype=data.dtype).to(data.device)
    std = torch.as_tensor(std, dtype=data.dtype).to(data.device)
    if mean.ndim == 1:
        mean = mean.reshape(-1, 1, 1)
        std = std.reshape(-1, 1, 1)
    return (data - mean) / std


@register_op("image_to_tensor", aliases=("to_tensor",))
def image_to_tensor(data):
    """HWC uint8 [0, 255] -> CHW float32 [0, 1] (NHWC -> NCHW).  The
    scale is a multiply by float32(1/255), which is what XLA makes of the
    JAX op's division by a constant: the same bits."""
    x = data.to(torch.float32) * _INV_255
    if x.ndim == 3:
        return x.permute(2, 0, 1)
    return x.permute(0, 3, 1, 2)


@register_op("image_crop", aliases=("crop",))
def image_crop(data, x=0, y=0, width=1, height=1):
    if data.ndim == 3:
        return data[y:y + height, x:x + width, :]
    return data[:, y:y + height, x:x + width, :]


@register_op("image_flip_left_right", aliases=("flip_left_right",))
def _flip_lr(data):
    return torch.flip(data, dims=(-2,))


@register_op("image_flip_top_bottom", aliases=("flip_top_bottom",))
def _flip_tb(data):
    return torch.flip(data, dims=(-3,))


def _uniform(data, lo=0.0, hi=1.0):
    """One draw in ``[lo, hi)`` on the data's device (no host sync)."""
    u = torch.rand((), generator=_random.generator(data.device),
                   device=data.device)
    return lo + (hi - lo) * u


@register_op("image_random_flip_left_right",
             aliases=("random_flip_left_right",), needs_rng=True)
def _random_flip_lr(data):
    return torch.where(_uniform(data) < 0.5, torch.flip(data, dims=(-2,)),
                       data)


@register_op("image_random_brightness", aliases=("random_brightness",),
             needs_rng=True)
def _random_brightness(data, min_factor=0.5, max_factor=1.5):
    return data * _uniform(data, min_factor, max_factor).to(data.dtype)


@register_op("image_random_contrast", aliases=("random_contrast",),
             needs_rng=True)
def _random_contrast(data, min_factor=0.5, max_factor=1.5):
    f = _uniform(data, min_factor, max_factor)
    x = data.to(torch.float32)
    mean = x.mean(dim=(-3, -2), keepdim=True)
    out = (x - mean) * f + mean
    return out.to(data.dtype) if data.dtype == torch.uint8 else out
