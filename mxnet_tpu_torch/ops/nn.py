"""Neural-network ops on tensors (the port of ``mxnet_tpu/ops/nn.py``,
the ones the ResNet training step runs).

Convolutions take the JAX package's layouts — ``NHWC`` activations with
``OHWI`` weights, or ``NCHW`` with ``OIHW`` — and run ``F.conv2d`` on
the matching ``channels_last`` view (the JAX package leaves these convs
to XLA, outside any Pallas kernel).  ``FusedNormReluConv`` folds the BN
statistics into ``scale``/``shift`` and calls ``ops.norm_relu_conv``,
the hand-written kernels on the card.  ``BatchNorm`` and
``FusedNormReluConv`` are functional, as in the JAX package: they return
the new running statistics and the Gluon layer writes them back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import autograd as _autograd
from .fused_conv import norm_relu_conv

__all__ = ["FullyConnected", "Convolution", "Pooling", "BatchNorm",
           "FusedNormReluConv", "Activation", "log_softmax", "moments"]


def _tup(v, n):
    if v is None or (isinstance(v, (tuple, list)) and len(v) == 0):
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _channels_last(layout):
    if layout in (None, "NCHW"):
        return False
    if layout == "NHWC":
        return True
    raise ValueError(f"unsupported layout {layout!r}: the port takes 2-D "
                     f"NCHW or NHWC")


# -------------------------------------------------------------- linear ------
def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True):
    """``data @ weight.T (+ bias)``; weight ``(num_hidden, in_units)``."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    out = torch.matmul(x, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


# ---------------------------------------------------------------- conv ------
def Convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None, **_unused):
    """2-D convolution with symmetric padding ``pad``.  ``NHWC`` data
    takes an ``OHWI`` weight; ``NCHW`` data an ``OIHW`` weight."""
    if data.dim() != 4:
        raise ValueError("the port's Convolution is 2-D (4-d data)")
    last = _channels_last(layout)
    stride, dilate = _tup(stride, 2), _tup(dilate, 2)
    pad = _tup(pad, 2) if pad else (0, 0)
    x = data.permute(0, 3, 1, 2) if last else data
    w = weight.permute(0, 3, 1, 2) if last else weight
    out = F.conv2d(x, w, None, stride, pad, dilate, num_group)
    if last:
        out = out.permute(0, 2, 3, 1)
    if bias is not None and not no_bias:
        out = out + (bias if last else bias.reshape(1, -1, 1, 1))
    return out


# ------------------------------------------------------------- pooling ------
def Pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, layout=None, **_unused):
    """Max pooling over 2-D windows (padded with ``-inf``, as the JAX
    package's ``reduce_window`` pads), or a global max/average."""
    last = _channels_last(layout)
    x = data.permute(0, 3, 1, 2) if last else data
    if global_pool and pool_type in ("max", "avg"):
        out = x.amax(dim=(2, 3), keepdim=True) if pool_type == "max" \
            else x.mean(dim=(2, 3), keepdim=True)
    elif pool_type == "max":
        kernel = _tup(kernel, 2)
        stride = _tup(stride, 2) if stride else kernel
        pad = _tup(pad, 2) if pad else (0, 0)
        out = F.max_pool2d(F.pad(x, (pad[1], pad[1], pad[0], pad[0]),
                                 value=float("-inf")), kernel, stride)
    else:
        raise ValueError(f"the port's Pooling takes max windows or a "
                         f"global max/avg, got pool_type={pool_type!r} "
                         f"global_pool={global_pool}")
    return out.permute(0, 2, 3, 1) if last else out


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


def moments(data, axes):
    """``(mean, var)`` of ``data`` over ``axes`` (the other axes kept),
    f32 for half-precision data."""
    axes = tuple(sorted(a % data.dim() for a in axes))
    return _Moments.apply(data, axes)


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              axis=1, training=None, **_unused):
    """Batch normalisation over every axis but ``axis``.  Returns
    ``(out, new_moving_mean, new_moving_var)``; the Gluon layer writes
    the running statistics back.  The per-channel scale is computed in
    f32 and applied to the activation in its own dtype."""
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
    return out, new_mm, new_mv


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


# ------------------------------------------------------------ activation ----
def Activation(data, act_type="relu"):
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


def log_softmax(data, axis=-1):
    return torch.log_softmax(data, dim=axis)
