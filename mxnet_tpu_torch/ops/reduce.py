"""Reduction, sorting and cumulative ops (the port of
``mxnet_tpu/ops/reduce.py``).

Output dtypes follow the JAX package: an integer sum or product keeps
its integer dtype (torch would widen it to int64), a mean of integers
is float32, and indices (``argmax``, ``topk``, ``argsort``) are float32
unless a ``dtype`` is asked for.
"""
from __future__ import annotations

import torch

from ..base import dtype_torch
from .registry import register_op

__all__ = []


def _dims(x, axis, exclude=False):
    """``axis`` (None, int, tuple or list) as a tuple of dims; None is
    every dim; ``exclude`` takes the complement."""
    if axis is None:
        return tuple(range(x.dim()))
    ax = (int(axis),) if isinstance(axis, int) else tuple(axis)
    if exclude:
        return tuple(i for i in range(x.dim())
                     if i not in ax and i - x.dim() not in ax)
    return ax


def _int_keep(fn):
    """A sum-like reduction that keeps an integer input's dtype."""
    def op(x, axis=None, keepdims=False, exclude=False):
        dims = _dims(x, axis, exclude)
        if not dims:
            return x.clone()
        dt = None if x.is_floating_point() else (
            torch.int32 if x.dtype == torch.bool else x.dtype)
        return fn(x, dims, keepdims, dt)
    return op


def _prod(x, dims, keepdims, dt):
    for d in sorted((d % x.dim() for d in dims), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdims, dtype=dt)
    return x


def _reduce(fn):
    def op(x, axis=None, keepdims=False, exclude=False):
        dims = _dims(x, axis, exclude)
        if not dims:
            return x.clone()
        return fn(x, dims, keepdims)
    return op


def _mean(x, dims, keepdims):
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=dims, keepdim=keepdims)


def _nanprod(x, dims, keepdims, dt):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dims,
                 keepdims, dt)


register_op("sum", _int_keep(lambda x, d, k, dt: torch.sum(
    x, dim=d, keepdim=k, dtype=dt)), aliases=("sum_axis",))
register_op("mean", _reduce(_mean))
register_op("prod", _int_keep(_prod))
register_op("max", _reduce(lambda x, d, k: torch.amax(x, dim=d, keepdim=k)),
            aliases=("max_axis",))
register_op("min", _reduce(lambda x, d, k: torch.amin(x, dim=d, keepdim=k)),
            aliases=("min_axis",))
register_op("nansum", _int_keep(lambda x, d, k, dt: torch.nansum(
    x, dim=d, keepdim=k, dtype=dt)))
register_op("nanprod", _int_keep(_nanprod))


@register_op("norm")
def _norm(x, ord=2, axis=None, keepdims=False):
    dims = _dims(x, axis)
    if ord == 1:
        return torch.sum(torch.abs(x), dim=dims, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(x), dim=dims, keepdim=keepdims))


@register_op("argmax")
def _argmax(x, axis=None, keepdims=False):
    return torch.argmax(x, dim=axis, keepdim=keepdims).to(torch.float32)


@register_op("argmin")
def _argmin(x, axis=None, keepdims=False):
    return torch.argmin(x, dim=axis, keepdim=keepdims).to(torch.float32)


@register_op("argmax_channel")
def _argmax_channel(x):
    return torch.argmax(x, dim=-1).to(torch.float32)


@register_op("topk")
def _topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    vals, idx = torch.topk(x, k, dim=axis, largest=not is_ascend,
                           sorted=True)
    idxc = idx.to(dtype_torch(dtype))
    if ret_typ == "indices":
        return idxc
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idxc
    if ret_typ == "mask":
        return torch.zeros_like(x).scatter(axis, idx, 1)
    raise ValueError(f"unknown ret_typ {ret_typ}")


@register_op("sort")
def _sort(x, axis=-1, is_ascend=True):
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, dims=(axis,))


@register_op("argsort")
def _argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    idx = torch.argsort(x, dim=axis, stable=True)
    if not is_ascend:
        idx = torch.flip(idx, dims=(axis,))
    return idx.to(dtype_torch(dtype))


def _scan(fn, x, axis, dtype):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    keep = None if x.is_floating_point() else (
        torch.int32 if x.dtype == torch.bool else x.dtype)
    out = fn(x, dim=axis, dtype=keep)
    return out.to(dtype_torch(dtype)) if dtype is not None else out


@register_op("cumsum")
def _cumsum(x, axis=None, dtype=None):
    return _scan(torch.cumsum, x, axis, dtype)


@register_op("cumprod")
def _cumprod(x, axis=None):
    return _scan(torch.cumprod, x, axis, None)


@register_op("L2Normalization", aliases=("l2_normalization",))
def _l2norm(x, eps=1e-10, mode="instance"):
    if mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif mode == "channel":
        axes = (1,)
    else:  # spatial
        axes = tuple(range(2, x.dim()))
    denom = torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True)
                       + eps)
    return x / denom
