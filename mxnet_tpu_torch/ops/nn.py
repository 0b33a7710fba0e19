"""Neural-network ops on tensors (the port of ``mxnet_tpu/ops/nn.py``).

Convolutions, deconvolutions and pooling take the JAX package's
layouts: channel-first ``NCW``/``NCHW``/``NCDHW`` (the default) with
``OI*k`` weights, or channel-last ``NWC``/``NHWC``/``NDHWC`` with
``O*kI`` weights; they run ``F.convNd`` on the matching channel-first
view (the JAX package leaves these to XLA, outside any Pallas kernel).
``FusedNormReluConv`` folds the BN statistics into ``scale``/``shift``
and calls ``ops.norm_relu_conv``, the hand-written kernels on the card.
``BatchNorm`` and ``FusedNormReluConv`` are functional, as in the JAX
package: they return the new running statistics and the Gluon layer
writes them back.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import autograd as _autograd
from .. import random as _random
from .fused_conv import norm_relu_conv
from .registry import register_op

__all__ = ["FullyConnected", "Convolution", "Deconvolution", "Pooling",
           "BatchNorm", "FusedNormReluConv", "LayerNorm", "Activation",
           "Dropout", "log_softmax", "softmax", "moments"]


def _tup(v, n):
    if v is None or (isinstance(v, (tuple, list)) and len(v) == 0):
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


_LAYOUTS = {"NCW": False, "NCHW": False, "NCDHW": False,
            "NWC": True, "NHWC": True, "NDHWC": True}


def _channels_last(layout, nd):
    """True for a channel-last ``layout`` of ``nd`` spatial dims."""
    if layout is None:
        return False
    if layout not in _LAYOUTS or len(layout) != nd + 2:
        raise ValueError(f"unsupported layout {layout!r} for {nd}-D data")
    return _LAYOUTS[layout]


def _to_first(x):
    """Channel-last data or weight as its channel-first view."""
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _to_last(x):
    return x.permute(0, *range(2, x.dim()), 1)


def _bias_shape(nd, last):
    return ((1,) * (nd + 1) + (-1,)) if last else ((1, -1) + (1,) * nd)


# -------------------------------------------------------------- linear ------
@register_op("FullyConnected", aliases=("fully_connected",))
def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True):
    """``data @ weight.T (+ bias)``; weight ``(num_hidden, in_units)``."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    out = torch.matmul(x, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


# ---------------------------------------------------------------- conv ------
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register_op("Convolution", aliases=("convolution",))
def Convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                workspace=1024, no_bias=False, cudnn_tune=None,
                cudnn_off=False, layout=None, **_unused):
    """1-D, 2-D or 3-D convolution with symmetric padding ``pad``
    (``workspace``/``cudnn_tune``/``cudnn_off`` are the reference's, in
    its order, and ignored)."""
    nd = data.dim() - 2
    last = _channels_last(layout, nd)
    stride, dilate = _tup(stride, nd), _tup(dilate, nd)
    pad = _tup(pad, nd) if pad else (0,) * nd
    x = _to_first(data) if last else data
    w = _to_first(weight) if last else weight
    out = _CONV[nd](x, w, None, stride, pad, dilate, num_group)
    if last:
        out = _to_last(out)
    if bias is not None and not no_bias:
        out = out + bias.reshape(_bias_shape(nd, last))
    return out


@register_op("Deconvolution", aliases=("deconvolution",))
def Deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, target_shape=None,
                  num_filter=None, num_group=1, workspace=512, no_bias=True,
                  cudnn_tune=None, cudnn_off=False, layout=None, **_unused):
    """Transposed convolution; weight ``(in, out/group, *k)`` (channel
    last: ``(in, *k, out/group)``).  The output is ``(in-1)*stride -
    2*pad + dilate*(k-1) + 1`` long, then ``adj`` zeros are appended at
    the end of each spatial dim, as the JAX op pads them."""
    nd = data.dim() - 2
    last = _channels_last(layout, nd)
    stride, dilate = _tup(stride, nd), _tup(dilate, nd)
    pad = _tup(pad, nd) if pad else (0,) * nd
    adj = _tup(adj, nd) if adj else (0,) * nd
    x = _to_first(data) if last else data
    w = _to_first(weight) if last else weight
    out = _DECONV[nd](x, w, None, stride, pad, 0, num_group, dilate)
    if any(adj):
        flat = []
        for a in reversed(adj):
            flat += [0, a]
        out = F.pad(out, flat)
    if last:
        out = _to_last(out)
    if bias is not None and not no_bias:
        out = out + bias.reshape(_bias_shape(nd, last))
    return out


# ------------------------------------------------------------- pooling ------
_AVG = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@register_op("Pooling", aliases=("pooling",))
def Pooling(data, kernel=None, pool_type="max", global_pool=False,
            cudnn_off=False, pooling_convention="valid", stride=None,
            pad=None, p_value=2, count_include_pad=True, layout=None,
            **_unused):
    """Max, average, sum or Lp pooling over 1-3 spatial dims, or a
    global max/sum/mean.  Padding is explicit, as the JAX package's
    ``reduce_window`` pads: ``-inf`` for max, zeros otherwise, plus the
    extra right padding of ``pooling_convention="full"``; averages
    divide by the window size unless ``count_include_pad`` is False."""
    nd = data.dim() - 2
    last = _channels_last(layout, nd)
    x = _to_first(data) if last else data
    if global_pool:
        axes = tuple(range(2, 2 + nd))
        if pool_type == "max":
            out = x.amax(dim=axes, keepdim=True)
        elif pool_type == "sum":
            out = x.sum(dim=axes, keepdim=True)
        else:
            out = x.mean(dim=axes, keepdim=True)
        return _to_last(out) if last else out
    kernel = _tup(kernel, nd)
    stride = _tup(stride, nd) if stride else kernel
    pad = _tup(pad, nd) if pad else (0,) * nd
    extra = [0] * nd
    if pooling_convention == "full":
        for i in range(nd):
            rem = (x.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            extra[i] = (stride[i] - rem) % stride[i] if rem else 0
    flat = []
    for p, e in zip(reversed(pad), reversed(extra)):
        flat += [p, p + e]
    window = math.prod(kernel)
    if pool_type == "max":
        low = float("-inf") if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        out = _MAX[nd](F.pad(x, flat, value=low), kernel, stride)
    elif pool_type in ("avg", "sum"):
        out = _AVG[nd](F.pad(x, flat), kernel, stride)
        if pool_type == "sum":
            out = out * window
        elif not count_include_pad:
            ones = F.pad(torch.ones_like(x[:1, :1]), flat)
            out = out / _AVG[nd](ones, kernel, stride)
    elif pool_type == "lp":
        p = float(p_value)
        out = (_AVG[nd](F.pad(torch.abs(x) ** p, flat), kernel, stride)
               * window) ** (1.0 / p)
    else:
        raise ValueError(f"unknown pool_type {pool_type}")
    return _to_last(out) if last else out


# ---------------------------------------------------------- normalisation ---
class _Moments(torch.autograd.Function):
    """Mean and variance over ``axes`` with wide accumulators; the
    backward recomputes the centred values instead of keeping a widened
    copy of the activation (the JAX ``_moments`` custom VJP)."""

    @staticmethod
    def forward(ctx, data, axes):
        if data.dtype in (torch.bfloat16, torch.float16):
            # one pass, f32 accumulators: the E[x^2] - E[x]^2
            # cancellation sits far below bf16's own quantisation
            x = data.float()
            mean = x.mean(dim=axes, keepdim=True)
            var = (x * x).mean(dim=axes, keepdim=True) - mean * mean
            var = var.clamp_min(0.0)
        else:
            # full precision: centred two-pass
            acc = torch.float64 if data.dtype == torch.float64 \
                else torch.float32
            x = data.to(acc)
            mean = x.mean(dim=axes, keepdim=True)
            var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
        ctx.axes = axes
        ctx.save_for_backward(data, mean)
        keep = [i for i in range(data.dim()) if i not in axes]
        shape = [data.shape[i] for i in keep]
        return mean.reshape(shape), var.reshape(shape)

    @staticmethod
    def backward(ctx, dmean, dvar):
        data, mean = ctx.saved_tensors
        n = 1
        for a in ctx.axes:
            n *= data.shape[a]
        dmean = dmean.reshape(mean.shape).to(mean.dtype)
        dvar = dvar.reshape(mean.shape).to(mean.dtype)
        xm = data.to(mean.dtype) - mean
        return (dmean / n + xm * (2.0 * dvar / n)).to(data.dtype), None


def moments(data, axes, keepdims=False):
    """``(mean, var)`` of ``data`` over ``axes``, f32 for half-precision
    data; the reduced axes are dropped unless ``keepdims``."""
    axes = tuple(sorted(a % data.dim() for a in axes))
    mean, var = _Moments.apply(data, axes)
    if keepdims:
        shape = [1 if i in axes else s for i, s in enumerate(data.shape)]
        mean, var = mean.reshape(shape), var.reshape(shape)
    return mean, var


@register_op("BatchNorm", aliases=("batch_norm",))
def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, cudnn_off=False, training=None,
              **_unused):
    """Batch normalisation over every axis but ``axis``.  Returns
    ``(out, new_moving_mean, new_moving_var)`` (with
    ``output_mean_var``: ``(out, mean, rsqrt(var + eps))``); the Gluon
    layer writes the running statistics back.  The per-channel scale is
    computed in f32 and applied to the activation in its own dtype."""
    if training is None:
        training = _autograd.is_training()
    axis = axis % data.dim()
    axes = tuple(i for i in range(data.dim()) if i != axis)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    bshape = [1] * data.dim()
    bshape[axis] = data.shape[axis]
    if training and not use_global_stats:
        mean, var = moments(data, axes)
        new_mm = moving_mean * momentum \
            + mean.to(moving_mean.dtype) * (1 - momentum)
        new_mv = moving_var * momentum \
            + var.to(moving_var.dtype) * (1 - momentum)
    else:
        mean, var = moving_mean.float(), moving_var.float()
        new_mm, new_mv = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    scale = (inv * g.to(var.dtype)).to(data.dtype)
    out = ((data - mean.to(data.dtype).reshape(bshape))
           * scale.reshape(bshape) + beta.reshape(bshape))
    if output_mean_var:
        return out, mean.to(data.dtype), inv.to(data.dtype)
    return out, new_mm, new_mv


@register_op("FusedNormReluConv", aliases=("fused_norm_relu_conv",))
def FusedNormReluConv(data, weight, gamma, beta, moving_mean, moving_var,
                      residual=None, eps=1e-5, momentum=0.9, relu=True,
                      stride=1, training=None):
    """BatchNorm(+residual)+ReLU folded into the following conv through
    ``norm_relu_conv``: NHWC data, HWIO weight, 1x1/3x3, stride 1 or 2.
    Returns ``(out, new_moving_mean, new_moving_var)`` like
    ``BatchNorm``; the statistics' gradients reach ``data`` through the
    folded scale and shift."""
    if training is None:
        training = _autograd.is_training()
    axes = tuple(range(data.dim() - 1))
    if training:
        mean, var = moments(data, axes)
        new_mm = moving_mean * momentum \
            + mean.detach().to(moving_mean.dtype) * (1 - momentum)
        new_mv = moving_var * momentum \
            + var.detach().to(moving_var.dtype) * (1 - momentum)
    else:
        mean, var = moving_mean.float(), moving_var.float()
        new_mm, new_mv = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    scale = gamma.float() * inv
    shift = beta.float() - mean.float() * scale
    out = norm_relu_conv(data, scale, shift, weight, residual=residual,
                         relu=relu, stride=stride)
    return out, new_mm, new_mv


@register_op("LayerNorm", aliases=("layer_norm",))
def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Layer normalisation over ``axis``: the statistics from ``moments``
    (f32 for half-precision data), then, in the JAX op's order and in
    the data's dtype, ``(x - mean) * rsqrt(var + eps) * gamma + beta``."""
    axis = axis % data.dim()
    mean, var = moments(data, (axis,), keepdims=True)
    inv = torch.rsqrt(var + eps)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    out = ((data - mean.to(data.dtype)) * inv.to(data.dtype)
           * gamma.reshape(shape) + beta.reshape(shape))
    if output_mean_var:
        return (out, mean.squeeze(axis).to(data.dtype),
                inv.squeeze(axis).to(data.dtype))
    return out


@register_op("RMSNorm", aliases=("rms_norm",))
def _rms_norm(data, gamma, axis=-1, eps=1e-6):
    ms = torch.mean(torch.square(data.float()), dim=axis, keepdim=True)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return data * torch.rsqrt(ms + eps).to(data.dtype) * gamma.reshape(shape)


@register_op("GroupNorm", aliases=("group_norm",))
def _group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    n, c = data.shape[0], data.shape[1]
    rest = data.shape[2:]
    x = data.reshape(n, num_groups, c // num_groups, *rest)
    mean, var = moments(x, tuple(range(2, x.dim())), keepdims=True)
    x = (x - mean.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype)
    x = x.reshape(data.shape)
    bshape = (1, c) + (1,) * len(rest)
    return x * gamma.reshape(bshape) + beta.reshape(bshape)


@register_op("InstanceNorm", aliases=("instance_norm",))
def _instance_norm(data, gamma, beta, eps=1e-3):
    mean, var = moments(data, tuple(range(2, data.dim())), keepdims=True)
    bshape = (1, data.shape[1]) + (1,) * (data.dim() - 2)
    return ((data - mean.to(data.dtype))
            * torch.rsqrt(var + eps).to(data.dtype)
            * gamma.reshape(bshape) + beta.reshape(bshape))


# ------------------------------------------------------------ activation ----
@register_op("Activation", aliases=("activation",))
def Activation(data, act_type="relu"):
    """``gelu`` is the exact erf form (``jax.nn.gelu(approximate=False)``,
    the JAX op's choice), ``tanh`` the plain ``tanh``."""
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return F.softsign(data)
    if act_type == "gelu":
        return F.gelu(data)
    if act_type in ("silu", "swish"):
        return F.silu(data)
    raise ValueError(f"unknown act_type {act_type}")


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register_op("LeakyReLU", aliases=("leaky_relu",))
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334):
    """leaky / prelu / elu / selu / gelu / rrelu (rrelu with the mid
    slope, its inference form)."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "prelu":
        g = gamma
        if g.dim() == 1 and data.dim() > 1:
            g = g.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(data >= 0, data, g * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(data >= 0, data,
                                         _SELU_ALPHA * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data)
    if act_type == "rrelu":
        mid = (lower_bound + upper_bound) / 2.0
        return torch.where(data >= 0, data, mid * data)
    raise ValueError(f"unknown act_type {act_type}")


@register_op("gelu_tanh")
def _gelu_tanh(data):
    return F.gelu(data, approximate="tanh")


@register_op("silu")
def _silu(data):
    return F.silu(data)


# --------------------------------------------------------------- softmax ----
@register_op("softmax")
def softmax(data, axis=-1, temperature=None, length=None, use_length=False,
            dtype=None):
    """Softmax over ``axis``; with ``length``, positions at or past each
    row's length get weight 0."""
    x = data / temperature if temperature else data
    if length is None:
        return torch.softmax(x, dim=axis)
    axis = axis % x.dim()
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    pos = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    mask = pos < length.long().unsqueeze(axis)
    out = torch.softmax(x.masked_fill(~mask, float("-inf")), dim=axis)
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


@register_op("log_softmax")
def log_softmax(data, axis=-1, temperature=None, dtype=None):
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis)


@register_op("softmin")
def _softmin(data, axis=-1, temperature=None, dtype=None):
    return softmax(-data, axis=axis, temperature=temperature)


# --------------------------------------------------------------- dropout ----
@register_op("Dropout", aliases=("dropout",), needs_rng=True)
def Dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False,
            training=None, **_unused):
    """Inverted dropout in training mode (or ``mode="always"``): keep
    with probability ``1 - p`` (the mask broadcast over ``axes``), drawn
    from the data's device stream (``random.generator``), and divide by
    ``1 - p`` in the data's dtype."""
    if training is None:
        training = _autograd.is_training()
    if (not training and mode != "always") or p == 0:
        return data
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    u = torch.rand(shape, generator=_random.generator(data.device),
                   device=data.device)
    div = torch.full((), 1.0 - p, dtype=data.dtype, device=data.device)
    return torch.where(u < 1.0 - p, data / div,
                       torch.zeros((), dtype=data.dtype, device=data.device))


# ------------------------------------------------------------- legacy fused -
@register_op("SoftmaxOutput", aliases=("softmax_output",))
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0):
    """The forward only: the softmax (over axis 1 with
    ``multi_output``); train with ``SoftmaxCrossEntropyLoss``."""
    return torch.softmax(data, dim=1 if multi_output else -1)
